"""Chip smoke test of transmogrifai_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the package from its sources (``nvcc``, one
process per source, all started together), holds each kernel against its
plain torch version on the card, then trains and scores the ported main
paths at the repo's scale on the card and on the CPU, and checks that the
two agree:

* the passenger AutoML workflow, transmogrify -> SanityChecker ->
  OpLogisticRegression -> AuROC, on 1M rows (kernel ``fused_moments``);
* the tree slice, transmogrify(label=...) (one decision-tree bucketizer per
  numeric column) -> SanityChecker -> OpGBTClassifier -> AuROC, on the same
  1M rows (kernels ``fused_moments`` and ``bin_matrix``).

Every phase asserts; any failure exits non-zero.

Output: progress lines; then, on lines of their own, the card's name and
power limit as ``nvidia-smi`` gives them, one JSON object ``{"kernels":
[...]}`` with each kernel's launches on the main paths, error against its
plain version, times and bound, and last one JSON object
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: the H100 SXM's published memory rate and float32 rate outside the
#: tensor cores (NVIDIA data sheet), for the kernels' lower bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SLICE_ROWS = 1_000_000
SCALE_SHAPE = (10_000_000, 39)  # the repo's scale: bench.py, text_dims=32
SUM_RTOL, SUM_ATOL_PER_1K_ROWS = 3e-5, 3e-3
AUROC_RANGE = (0.72, 0.755)
TREE_AUROC_RANGE = (0.70, 0.755)
TREE_PROB_ATOL = 1e-3  # card vs CPU: float32 scans and sums in other orders
BIN_MAX_BINS = 32      # the tree learner's default


def log(msg: str) -> None:
    print(msg, flush=True)


#: a timing window: at least MIN_CALLS back-to-back calls and
#: MIN_WINDOW_MS of device work, at most MAX_CALLS calls (the launch queue
#: must hold a window while the card sleeps); the median of WINDOWS windows
WINDOWS, MIN_CALLS, MIN_WINDOW_MS, MAX_CALLS = 5, 20, 2.0, 800
#: the cold state rotates over copies of a call's inputs that together
#: exceed three times the card's 50 MB L2, so every call reads HBM
COLD_BYTES = 150e6
_sleep_cycles_per_ms: list = []


def sleep_cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep``, in cycles per device ms."""
    if not _sleep_cycles_per_ms:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)  # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        _sleep_cycles_per_ms.append(cycles / a.elapsed_time(b))
    return _sleep_cycles_per_ms[0]


def _window(call, arg_sets, calls: int, sleep_ms: float):
    """(device ms, host ms) of ``calls`` back-to-back calls rotating over
    ``arg_sets``, enqueued while the card sleeps, so that the events see
    the calls back to back with no host work between them."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
    a.record()
    h0 = time.perf_counter()
    for i in range(calls):
        call(*arg_sets[i % len(arg_sets)])
    h1 = time.perf_counter()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), 1e3 * (h1 - h0)


def timed(call, arg_sets) -> dict:
    """Device ms and host us per call of ``call(*args)``, rotating over
    ``arg_sets``: one warm-up call, a probe window that sizes N (at least
    MIN_CALLS calls and MIN_WINDOW_MS of device work), then the median of
    WINDOWS windows of N back-to-back calls, each divided by N.  The host
    time is ``time.perf_counter`` around the same N enqueues; the card
    sleeps meanwhile, so a window is rerun with a longer sleep when the
    card may have waited on the host."""
    call(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(*arg_sets[0])
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    calls = MIN_CALLS
    dev, host = _window(call, arg_sets, calls, 2.0 * calls * host_ms + 1.0)
    calls = max(MIN_CALLS, min(MAX_CALLS, int(np.ceil(
        MIN_WINDOW_MS * calls / max(dev, 1e-6)))))
    devs, hosts, gaps = [], [], 0
    for _ in range(WINDOWS):
        sleep_ms = 2.0 * calls * host / MIN_CALLS + 1.0
        for _ in range(3):
            dev_w, host_w = _window(call, arg_sets, calls, sleep_ms)
            # back to back: every call was enqueued before the card woke,
            # or one call keeps the card at least twice as long as the
            # host takes to enqueue it (a long call fills the launch queue
            # and the host then waits on the busy card)
            if host_w < sleep_ms or 2.0 * host_ms < dev_w / calls:
                break
            sleep_ms = 3.0 * host_w + 1.0
        else:
            gaps += 1
        devs.append(dev_w / calls)
        hosts.append(host_w / calls)
    return {"ms": float(np.median(devs)), "host_us": 1e3 * float(np.median(hosts)),
            "calls": calls, "windows_with_host_gaps": gaps}


def cold_sets(*args) -> list:
    """``args`` and enough clones of its tensors that all of them together
    exceed COLD_BYTES."""
    size = sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))
    copies = max(1, int(np.ceil(COLD_BYTES / max(size, 1) + 1e-9)))
    if copies * size <= COLD_BYTES:
        copies += 1
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(copies - 1)]


def measure(call, *args) -> dict:
    """``call(*args)`` cold (rotating over COLD_BYTES of input copies, the
    headline) and warm (the same inputs again): {"ms", "ms_warm",
    "host_us"}, host us from the warm windows."""
    sets = cold_sets(*args)
    cold = timed(call, sets)
    del sets
    warm = timed(call, [args])
    gaps = cold["windows_with_host_gaps"] + warm["windows_with_host_gaps"]
    if gaps:
        log(f"[timing] {gaps} windows of {getattr(call, '__name__', call)} "
            "may hold host gaps: the card may have waited on the host")
    return {"ms": cold["ms"], "ms_warm": warm["ms"], "host_us": warm["host_us"],
            "calls": cold["calls"], "windows_with_host_gaps": gaps}


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_moments(kernels, x: torch.Tensor, y: torch.Tensor) -> dict:
    """fused_moments kernel vs its plain version on the same card tensors:
    sums within rtol 3e-5 and atol 3e-3 per thousand rows (a float32
    sum's error grows with its length; below 1000 rows this is the JAX
    package's own Pallas test tolerance), min/max exact and NaN-equal."""
    got = kernels.fused_moments(x, y)
    torch.cuda.synchronize()
    want = kernels.fused_moments_plain(x, y)
    atol = SUM_ATOL_PER_1K_ROWS * max(1.0, x.shape[0] / 1000.0)
    abs_err = rel_err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32, (k, g.shape)
        if k >= 5:  # x_min, x_max
            assert nan_equal(g, w), f"moment {k} differs at {tuple(x.shape)}"
            continue
        g64, w64 = g.double(), w.double()
        both_nan = torch.isnan(g64) & torch.isnan(w64)
        diff = torch.where(both_nan, torch.zeros_like(g64), (g64 - w64).abs())
        assert not bool(torch.isnan(diff).any()), f"moment {k}: NaN mismatch"
        ok = diff <= SUM_RTOL * w64.abs().nan_to_num() + atol
        assert bool(ok.all()), (
            f"moment {k} at {tuple(x.shape)}: max |diff| {float(diff.max())}"
        )
        abs_err = max(abs_err, float(diff.max()))
        rel = diff / w64.abs().nan_to_num().clamp_min(1e-30)
        rel_err = max(rel_err, float(rel.max()))
    return {"max_abs_err": abs_err, "max_rel_err": rel_err}


def moments_bound_ms(n: int, d: int) -> float:
    """Least time for the sweep on this card: read x and y once, write
    5d + 2 floats; 8 operations per element (3 multiply-adds counted as
    two each, 2 compares) at the float32 rate - the bytes bound wins."""
    bytes_ = 4 * n * (d + 1) + 4 * (5 * d + 2)
    ops = 8 * n * d
    return 1e3 * max(bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def time_moments(kernels, x, y) -> dict:
    """The kernel, its plain version and the read-bandwidth anchor
    ``x.sum(0)``, each cold and warm (``measure``)."""
    n, d = x.shape
    k = measure(kernels.fused_moments, x, y)
    plain = measure(kernels.fused_moments_plain, x, y)
    anchor = measure(lambda a: a.sum(0), x)
    return {
        "shape": [n, d], **k,
        "plain_ms": plain["ms"], "plain_ms_warm": plain["ms_warm"],
        "anchor_ms": anchor["ms"], "anchor_ms_warm": anchor["ms_warm"],
        "bound_ms": moments_bound_ms(n, d),
    }


def bin_bound_ms(n: int, d: int, n_edges: int, out_bytes: int) -> float:
    """Least time for the binning pass on this card: read x once, write
    the bins once, read the edges; n*d*E compares at the float32 rate -
    the bytes bound wins."""
    bytes_ = 4 * n * d + out_bytes * n * d + 4 * d * n_edges
    return 1e3 * max(bytes_ / HBM_BYTES_PER_S, n * d * n_edges / FP32_OPS_PER_S)


def check_bins(kernels, x: torch.Tensor, edges: torch.Tensor, dtype) -> int:
    """bin_matrix kernel vs its plain version on the same card tensors:
    exactly equal, and bit-identical from launch to launch.  Returns the
    largest |bin difference| (0 when it passes)."""
    got = kernels.bin_matrix(x, edges, dtype)
    torch.cuda.synchronize()
    want = kernels.bin_matrix_plain(x, edges, dtype)
    err = int((got.int() - want.int()).abs().max())
    assert got.dtype == dtype and err == 0, (
        f"bin_matrix differs from its plain version at {tuple(x.shape)}, "
        f"{edges.shape[1]} edges: {int((got != want).sum())} bins, by up "
        f"to {err}"
    )
    assert torch.equal(kernels.bin_matrix(x, edges, dtype), got), \
        "bin_matrix is not bit-identical from launch to launch"
    return err


def time_bins(kernels, x: torch.Tensor, edges: torch.Tensor, dtype,
              causes: bool = False) -> dict:
    """The kernel, its plain version and the library yardstick, each cold
    and warm (``measure``): torch.searchsorted over the sorted edge rows
    of a pre-transposed NaN-free x (it ranks a NaN x at 0, so it is a
    yardstick, not a substitute).  With ``causes``, what tells compares
    from bytes: the
    kernel on the same x against the edge rows reversed (not sorted, so
    every element takes the linear count) and ``x.to(torch.int8)``, a pass
    that moves the same bytes and compares nothing."""
    n, d = x.shape
    assert not bool(torch.isnan(x).any()) and not bool(torch.isnan(edges).any())
    xt = x.T.contiguous()
    out_bytes = 1 if dtype == torch.int8 else 4
    k = measure(kernels.bin_matrix, x, edges, dtype)
    plain = measure(kernels.bin_matrix_plain, x, edges, dtype)
    lib = measure(lambda e, a: torch.searchsorted(e, a, side="left"), edges, xt)
    del xt
    out = {
        "shape": [n, d], "edges": int(edges.shape[1]), **k,
        "plain_ms": plain["ms"], "plain_ms_warm": plain["ms_warm"],
        "library_ms": lib["ms"], "library_ms_warm": lib["ms_warm"],
        "library_host_us": lib["host_us"],
        "bound_ms": bin_bound_ms(n, d, int(edges.shape[1]), out_bytes),
    }
    if causes:
        rev = edges.flip(1).contiguous()
        out["reversed_edges_ms"] = measure(kernels.bin_matrix, x, rev, dtype)["ms"]
        out["cast_ms"] = measure(lambda a: a.to(torch.int8), x)["ms"]
    return out


def log_moments_times(where: str, m: dict) -> None:
    log(f"[kernel] fused_moments {where}: {m['ms']:.4f} ms cold "
        f"({100 * m['bound_ms'] / m['ms']:.0f}% of the {m['bound_ms']:.4f} ms "
        f"bound), {m['ms_warm']:.4f} warm, host {m['host_us']:.1f} us a call; "
        f"x.sum(0) {m['anchor_ms']:.4f} cold, {m['anchor_ms_warm']:.4f} warm; "
        f"plain {m['plain_ms']:.4f} cold")


def log_bins_times(where: str, b: dict) -> None:
    causes = (f"; reversed edges (linear count) {b['reversed_edges_ms']:.4f}, "
              f"x.to(int8) {b['cast_ms']:.4f}" if "cast_ms" in b else "")
    log(f"[kernel] bin_matrix {where}: {b['ms']:.4f} ms cold "
        f"({100 * b['bound_ms'] / b['ms']:.0f}% of the {b['bound_ms']:.4f} ms "
        f"bound), {b['ms_warm']:.4f} warm, host {b['host_us']:.1f} us a call; "
        f"torch.searchsorted {b['library_ms']:.4f} cold, "
        f"{b['library_ms_warm']:.4f} warm, host {b['library_host_us']:.1f} us; "
        f"plain {b['plain_ms']:.4f} cold{causes}")


def ptxas_report(log_text: str) -> list:
    """Each kernel's registers, static shared memory and spills, from
    ``nvcc -Xptxas -v``'s output."""
    rows, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return rows


@contextlib.contextmanager
def kernel_inputs(kernels):
    """Within the block, keep a copy of the arguments of every call of a
    kernel wrapper: each loaded module of the package that holds a wrapper
    by name gets a shim that copies the arguments and calls the wrapper,
    so the launches and their counts are unchanged.  Yields wrapper name
    -> list of argument tuples."""
    seen = {w.__name__: [] for w in kernels.WRAPPERS}
    patched = []
    for mod in list(sys.modules.values()):
        if mod is kernels or not getattr(mod, "__name__", "").startswith(
                "transmogrifai_tpu_torch."):
            continue
        for w in kernels.WRAPPERS:
            if getattr(mod, w.__name__, None) is w:
                def shim(*args, _w=w):
                    seen[_w.__name__].append(tuple(
                        a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args))
                    return _w(*args)
                setattr(mod, w.__name__, shim)
                patched.append((mod, w))
    try:
        yield seen
    finally:
        for mod, w in patched:
            setattr(mod, w.__name__, w)


def bin_cases(rng):
    """(x, edges, dtype) of the kernel check's small shapes: (1, 1);
    (513, 129) with NaN every 13th row of one column and one all-NaN
    column (whose edges are all NaN); (1000, 37) at max_bins 255; (700, 9)
    with edge rows the binary search must not take or must take exactly:
    reversed, NaN in the middle, duplicates, +-inf and -0.0."""
    from transmogrifai_tpu_torch.models.tree_kernel import quantile_bin_edges

    cases = []
    for n, d, max_bins, dtype in ((1, 1, 32, torch.int8),
                                  (513, 129, 32, torch.int8),
                                  (1000, 37, 255, torch.int32),
                                  (700, 9, 32, torch.int8)):
        x = (rng.randn(n, d) * 3.0 + 1.0).astype(np.float32)
        if d == 129:
            x[::13, 17] = np.nan
            x[:, 100] = np.nan
        edges = np.ascontiguousarray(quantile_bin_edges(x, max_bins))
        if d == 9:
            x[::5, 3] = 0.0
            x[1::5, 3] = -0.0
            x[2::7, 4] = np.inf
            edges[0] = edges[0][::-1]
            edges[1, 10] = np.nan
            edges[2, 5:9] = edges[2, 5]
            edges[3, :3] = (-np.inf, -0.0, 0.0)
            edges[3] = np.sort(edges[3])
            edges[4, -1] = np.inf
        cases.append((x, np.ascontiguousarray(edges), dtype))
    assert np.isnan(cases[1][1][100]).all()
    return cases


def passenger_features():
    """(label, predictors) of both slices: age, height, weight (Real) and
    gender (PickList) against survived (RealNN)."""
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder

    survived = FeatureBuilder.RealNN("survived").as_response()
    preds = [FeatureBuilder.Real(c).as_predictor()
             for c in ("age", "height", "weight")]
    preds.append(FeatureBuilder.PickList("gender").as_predictor())
    return survived, preds


def build_slice(device: str):
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker

    survived, preds = passenger_features()
    vec = transmogrify(preds)
    checked = SanityChecker().set_input(survived, vec).get_output()
    pred = OpLogisticRegression().set_input(survived, checked).get_output()
    wf = OpWorkflow(device=device).set_result_features(pred)
    return wf, survived, vec, checked, pred


def identified(beta: np.ndarray, intercept: float, x: np.ndarray, meta):
    """(beta, intercept) with each one-hot group whose kept columns sum to
    1 on every row centred to mean 0, the shift moved into the intercept.
    Such a group and the intercept are collinear, so an unregularized fit
    pins its common level only by float32 rounding; the probabilities and
    these contrasts are what the data determine."""
    beta = beta.copy()
    for idx in meta.grouping_indices().values():
        idx = list(idx)
        if len(idx) > 1 and np.all(x[:, idx].sum(axis=1) == 1.0):
            shift = beta[idx].mean()
            beta[idx] -= shift
            intercept += shift
    return beta, intercept


def run_slice(device: str, data) -> dict:
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )

    wf, survived, vec, checked, pred = build_slice(device)
    wf.set_input_dataset(data)
    t0 = time.perf_counter()
    model = wf.train()
    t1 = time.perf_counter()
    scored = model.score(data)
    t2 = time.perf_counter()
    metrics = OpBinaryClassificationEvaluator().evaluate(
        scored, label_col=survived.name, pred_col=pred.name
    )
    (checker,) = [s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel"]
    params = model.stages[-1].model_params
    x_kept = scored[checked.name]
    beta, b0 = identified(np.asarray(params["beta"], np.float64),
                          float(params["intercept"]), x_kept.values,
                          x_kept.metadata)
    return {
        "model": model, "vec": vec.name,
        "train_s": t1 - t0, "score_s": t2 - t1,
        "keep": checker.indices_to_keep,
        "beta": beta, "intercept": b0,
        "prob": np.asarray(scored[pred.name].probability, np.float64),
        "auroc": float(metrics.AuROC),
    }


def build_tree_slice(device: str):
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker

    survived, preds = passenger_features()
    vec = transmogrify(preds, label=survived)
    checked = SanityChecker().set_input(survived, vec).get_output()
    pred = OpGBTClassifier().set_input(survived, checked).get_output()
    wf = OpWorkflow(device=device).set_result_features(pred)
    return wf, survived, vec, checked, pred


def run_tree_slice(device: str, data, kernels) -> dict:
    """Train and score the tree slice on ``device``, counting each
    kernel's launches in train() and in score()."""
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )

    wf, survived, _, checked, pred = build_tree_slice(device)
    wf.set_input_dataset(data)
    kernels.reset_launches()
    t0 = time.perf_counter()
    model = wf.train()
    t1 = time.perf_counter()
    train_launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    kernels.reset_launches()
    scored = model.score(data)
    t2 = time.perf_counter()
    score_launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    metrics = OpBinaryClassificationEvaluator().evaluate(
        scored, label_col=survived.name, pred_col=pred.name
    )
    (checker,) = [s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel"]
    return {
        "model": model, "checked": checked.name,
        "train_s": t1 - t0, "score_s": t2 - t1,
        "train_launches": train_launches, "score_launches": score_launches,
        "bucketizers": sum(type(s).__name__ == "NumericBucketizerModel"
                           for s in model.stages),
        "splits": [s.splits for s in model.stages
                   if type(s).__name__ == "NumericBucketizerModel"],
        "keep": checker.indices_to_keep,
        "heaps": model.stages[-1].model_params["heaps"],
        "prob": np.asarray(scored[pred.name].probability, np.float64),
        "auroc": float(metrics.AuROC),
    }


def profile(fn):
    """Run ``fn()`` under the torch profiler; returns (its result, device
    ms by op name).  Device-side activity only (kernels and copies, one
    stream, so no overlap); the profiler's own buffer requests are not the
    program's."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != "Activity Buffer Request"):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out, by_name


def log_profile(tag: str, wall_ms: float, by_name: dict, top: int) -> float:
    device_ms = 1e-3 * sum(sum(v) for v in by_name.values())
    log(f"[{tag}] cuda, profiled run: train+score {wall_ms:.1f} ms, device "
        f"busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.2f}% of it)")
    for k, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]:
        log(f"[{tag}]   device time {1e-3 * sum(v):.3f} ms in {len(v)} x "
            f"{k[:70]}")
    return device_ms


def stage_walls(build, device: str, data) -> list:
    """Fit and transform wall of every stage of the slice ``build`` makes
    on ``device`` (host clock; each device stage returns host arrays, so
    its wall ends with the device work)."""
    from transmogrifai_tpu_torch.stages.base import Estimator
    from transmogrifai_tpu_torch.workflow.dag import compute_dag

    wf = build(device)[0]
    ds = wf.set_input_dataset(data).generate_raw_data()
    out = []
    for layer in compute_dag(wf.result_features):
        for stage in layer:
            if hasattr(stage, "device"):
                stage.device = device
            t0 = time.perf_counter()
            model = stage.fit(ds) if isinstance(stage, Estimator) else stage
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ds = model.transform(ds)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out.append({"stage": type(stage).__name__,
                        "fit_ms": 1e3 * (t1 - t0),
                        "transform_ms": 1e3 * (t2 - t1)})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from transmogrifai_tpu_torch.examples.synthetic import (
        BAYES_AUROC_OBSERVED,
        synthetic_design_matrix,
        synthetic_passengers,
    )
    from transmogrifai_tpu_torch.models.trees import _sampled_bin_edges
    from transmogrifai_tpu_torch.parallel import kernels

    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    # -- 1. header and build ------------------------------------------------
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    log(f"[header] card: {smi}")
    log(f"[header] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"[header] kernels built in {build_s:.1f} s: {', '.join(kernels.KERNELS)}")
    ptxas = {}
    for kname in kernels.KERNELS:
        ptxas[kname] = ptxas_report(kernels.BUILD_LOG.get(kname, ""))
        for row in ptxas[kname] or [{"function": "(built earlier: no report)"}]:
            log(f"[build] {kname}: {row['function']}: {row.get('registers')} "
                f"registers, {row.get('static_smem_bytes')} bytes static "
                f"shared memory, {row.get('spill_bytes')} bytes spilled")

    # -- 2. kernel check ----------------------------------------------------
    rng = np.random.RandomState(0)
    cases = []
    for n, d in ((1, 1), (513, 129), (1000, 37), (1500, 1100)):
        x = (rng.randn(n, d) * 3.0 + 1.0).astype(np.float32)
        if d == 37:
            x[::7, 5] = np.nan
        cases.append((x, rng.rand(n).astype(np.float32)))
    for n, text_dims in (((1 << 22) + 3, 4), (SCALE_SHAPE[0], 32)):
        x, yv, _ = synthetic_design_matrix(n, seed=1, text_dims=text_dims)
        cases.append((x, yv.astype(np.float32)))
    errs = []
    for x_np, y_np in cases:
        x = torch.from_numpy(x_np).to(dev)
        y = torch.from_numpy(y_np).to(dev)
        # the matrix, then row-offset views that start off 16-byte alignment
        for off in (0, 1, 3) if x.shape[0] > 3 else (0,):
            err = check_moments(kernels, x[off:], y[off:])
            errs.append(err)
            log(f"[kernel] fused_moments {tuple(x.shape)}[{off}:]: matches "
                f"plain, max abs err {err['max_abs_err']:.3g}, "
                f"max rel err {err['max_rel_err']:.3g}")
    assert tuple(x.shape) == SCALE_SHAPE
    first = [t.clone() for t in kernels.fused_moments(x, y)]
    again = kernels.fused_moments(x, y)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), \
        "fused_moments is not bit-identical from run to run"
    at_scale = time_moments(kernels, x, y)
    log_moments_times(f"at {SCALE_SHAPE}", at_scale)

    # bin_matrix: the small shapes, then the repo's scale with the tree
    # learner's own edges (a seeded host sample, max_bins 32, int8 out)
    bin_errs = []
    for xb_np, eb_np, dtype in bin_cases(rng):
        xb = torch.from_numpy(xb_np).to(dev)
        eb = torch.from_numpy(eb_np).to(dev)
        for off in (0, 1, 3) if xb.shape[0] > 3 else (0,):
            bin_errs.append(check_bins(kernels, xb[off:], eb, dtype))
            log(f"[kernel] bin_matrix {tuple(xb.shape)}[{off}:] x "
                f"{eb.shape[1]} edges -> {dtype}: equal to plain, "
                "bit-identical twice")
    edges = torch.from_numpy(np.ascontiguousarray(
        _sampled_bin_edges(x_np, BIN_MAX_BINS, 42))).to(dev)
    bin_errs.append(check_bins(kernels, x, edges, torch.int8))
    bins_at_scale = time_bins(kernels, x, edges, torch.int8, causes=True)
    log_bins_times(f"at {SCALE_SHAPE} x {edges.shape[1]} edges -> int8",
                   bins_at_scale)
    del x, y, first, again, cases, edges, x_np

    # -- 3. the LR slice on the card, counted -----------------------------------
    data = synthetic_passengers(SLICE_ROWS, seed=42, with_text=False)
    kernels.reset_launches()
    gpu = run_slice("cuda", data)
    launches = kernels.fused_moments.launches
    assert launches >= 1, "train() did not launch fused_moments"
    assert AUROC_RANGE[0] <= gpu["auroc"] <= AUROC_RANGE[1], gpu["auroc"]
    log(f"[slice] cuda: train {gpu['train_s']:.3f} s "
        f"({SLICE_ROWS / gpu['train_s']:.0f} rows/s), score "
        f"{gpu['score_s']:.3f} s ({SLICE_ROWS / gpu['score_s']:.0f} rows/s), "
        f"AuROC {gpu['auroc']:.6f} (observable ceiling "
        f"{BAYES_AUROC_OBSERVED}), fused_moments launches {launches}, on {name}")
    warm = run_slice("cuda", data)
    log(f"[slice] cuda, second run: train {warm['train_s']:.3f} s "
        f"({SLICE_ROWS / warm['train_s']:.0f} rows/s), score "
        f"{warm['score_s']:.3f} s ({SLICE_ROWS / warm['score_s']:.0f} rows/s)")
    traced, by_name = profile(lambda: run_slice("cuda", data))
    log_profile("slice", 1e3 * (traced["train_s"] + traced["score_s"]),
                by_name, 6)
    for s in stage_walls(build_slice, "cuda", data):
        log(f"[slice] cuda stage {s['stage']}: fit {s['fit_ms']:.1f} ms, "
            f"transform {s['transform_ms']:.1f} ms")

    # the kernel at the shape the main path gave it
    design = gpu["model"].score()[gpu["vec"]].values  # the train data
    x = torch.from_numpy(np.ascontiguousarray(design, np.float32)).to(dev)
    y = torch.from_numpy(
        np.asarray(data["survived"].values, np.float32)).to(dev)
    main_err = check_moments(kernels, x, y)
    main = time_moments(kernels, x, y)
    log_moments_times(f"at the main path's {tuple(x.shape)}", main)

    # -- 4. the same LR slice on the CPU agrees -----------------------------------
    cpu = run_slice("cpu", data)
    log(f"[slice] cpu: train {cpu['train_s']:.3f} s, score "
        f"{cpu['score_s']:.3f} s, AuROC {cpu['auroc']:.6f}")
    assert cpu["keep"] == gpu["keep"], (cpu["keep"], gpu["keep"])
    # identified coefficients (see identified()): the raw betas of the
    # complete gender group differ by a common shift that the intercept
    # absorbs
    np.testing.assert_allclose(gpu["beta"], cpu["beta"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gpu["intercept"], cpu["intercept"],
                               rtol=1e-4, atol=1e-5)
    prob_diff = float(np.abs(gpu["prob"] - cpu["prob"]).max())
    assert prob_diff <= 1e-4, prob_diff
    assert abs(gpu["auroc"] - cpu["auroc"]) <= 1e-4
    log(f"[slice] cuda vs cpu: same kept columns {gpu['keep']}, max |beta "
        f"diff| {float(np.abs(gpu['beta'] - cpu['beta']).max()):.3g}, max "
        f"|prob diff| {prob_diff:.3g}, AuROC diff "
        f"{abs(gpu['auroc'] - cpu['auroc']):.3g}")
    del x, y, design

    # -- 5. the tree slice on the card, counted ---------------------------------
    tg = run_tree_slice("cuda", data, kernels)
    tl, sl = tg["train_launches"], tg["score_launches"]
    assert tl["fused_moments"] >= 1, "tree train() did not launch fused_moments"
    assert tg["bucketizers"] == 3, tg["bucketizers"]
    # once per bucketizer fit, once for the GBT fit, and once more where
    # train() passes its training rows through the fitted model
    assert tl["bin_matrix"] == tg["bucketizers"] + 2, (
        f"tree train() launched bin_matrix {tl['bin_matrix']} times, not once "
        f"per bucketizer ({tg['bucketizers']}), once for the GBT fit and once "
        "for its transform of the training rows")
    assert sl["bin_matrix"] >= 1, "tree score() did not launch bin_matrix"
    assert TREE_AUROC_RANGE[0] <= tg["auroc"] <= TREE_AUROC_RANGE[1], tg["auroc"]
    log(f"[trees] cuda: train {tg['train_s']:.3f} s "
        f"({SLICE_ROWS / tg['train_s']:.0f} rows/s), score "
        f"{tg['score_s']:.3f} s ({SLICE_ROWS / tg['score_s']:.0f} rows/s), "
        f"AuROC {tg['auroc']:.6f} (observable ceiling {BAYES_AUROC_OBSERVED}); "
        f"launches in train() {tl}, in score() {sl}; kept columns "
        f"{len(tg['keep'])}, splits {tg['splits']}, on {name}")
    with kernel_inputs(kernels) as path_inputs:
        tg2 = run_tree_slice("cuda", data, kernels)
    for k, calls in path_inputs.items():
        launched = tg2["train_launches"][k] + tg2["score_launches"][k]
        assert len(calls) == launched, (
            f"kept the inputs of {len(calls)} {k} calls, but the tree path "
            f"launched it {launched} times")
    assert all(np.array_equal(a, b) for a, b in zip(tg["heaps"], tg2["heaps"])), \
        "the card's GBT heaps differ between two identical trainings"
    log(f"[trees] cuda, second run: train {tg2['train_s']:.3f} s "
        f"({SLICE_ROWS / tg2['train_s']:.0f} rows/s), score "
        f"{tg2['score_s']:.3f} s ({SLICE_ROWS / tg2['score_s']:.0f} rows/s); "
        "heaps bit-identical to the first run")
    ttraced, tby_name = profile(lambda: run_tree_slice("cuda", data, kernels))
    log_profile("trees", 1e3 * (ttraced["train_s"] + ttraced["score_s"]),
                tby_name, 14)
    for s in stage_walls(build_tree_slice, "cuda", data):
        log(f"[trees] cuda stage {s['stage']}: fit {s['fit_ms']:.1f} ms, "
            f"transform {s['transform_ms']:.1f} ms")

    # each kernel on every input the tree path gave it in the second run,
    # timed once at each distinct shape
    bin_shapes = {}
    for xb, eb, dtype in path_inputs["bin_matrix"]:
        key = (tuple(xb.shape), int(eb.shape[1]), str(dtype))
        err = check_bins(kernels, xb, eb, dtype)
        bin_errs.append(err)
        if key not in bin_shapes:
            bin_shapes[key] = {
                **time_bins(kernels, xb, eb, dtype, causes=xb.shape[1] > 1),
                "dtype": str(dtype), "path_calls": 0, "max_abs_err": 0}
        seen = bin_shapes[key]
        seen["path_calls"] += 1
        seen["max_abs_err"] = max(seen["max_abs_err"], err)
    for b in bin_shapes.values():
        log_bins_times(
            f"at the tree path's {tuple(b['shape'])} x {b['edges']} edges -> "
            f"{b['dtype']} ({b['path_calls']} calls, each equal to plain and "
            "bit-identical twice)", b)
    # the headline shape: the GBT's design matrix, the widest
    bins_main = max(bin_shapes.values(),
                    key=lambda b: b["shape"][0] * b["shape"][1])
    tree_moments = {}
    for xm, ym in path_inputs["fused_moments"]:
        err = check_moments(kernels, xm, ym)
        errs.append(err)
        if tuple(xm.shape) not in tree_moments:
            tree_moments[tuple(xm.shape)] = {
                **time_moments(kernels, xm, ym), **err}
    for m in tree_moments.values():
        log_moments_times(
            f"at the tree path's {tuple(m['shape'])} (matches plain, max abs "
            f"err {m['max_abs_err']:.3g}, max rel err {m['max_rel_err']:.3g})",
            m)
    del path_inputs

    # each kernel also at the other kernel's main-path shapes, so that both
    # are timed at 1M x 1, 1M x 9, 1M x 11, 1M x 15 and 10M x 39 (seeded
    # normal data; the tree learner's edges, int8 bins)
    other_moments, other_bins = [], []
    table_rng = np.random.RandomState(3)
    for d in (1, 9):
        xo = torch.from_numpy(
            table_rng.randn(SLICE_ROWS, d).astype(np.float32)).to(dev)
        yo = torch.from_numpy(
            table_rng.rand(SLICE_ROWS).astype(np.float32)).to(dev)
        errs.append(check_moments(kernels, xo, yo))
        other_moments.append({**errs[-1], **time_moments(kernels, xo, yo)})
        log_moments_times(f"at {tuple(xo.shape)} (matches plain)",
                          other_moments[-1])
    for d in (11, 15):
        xo_np = table_rng.randn(SLICE_ROWS, d).astype(np.float32)
        eo = torch.from_numpy(np.ascontiguousarray(
            _sampled_bin_edges(xo_np, BIN_MAX_BINS, 42))).to(dev)
        xo = torch.from_numpy(xo_np).to(dev)
        bin_errs.append(check_bins(kernels, xo, eo, torch.int8))
        other_bins.append({**time_bins(kernels, xo, eo, torch.int8),
                           "max_abs_err": bin_errs[-1]})
        log_bins_times(f"at {tuple(xo.shape)} x {eo.shape[1]} edges -> int8 "
                       "(equal to plain, bit-identical twice)", other_bins[-1])
    del xo, yo, eo, xo_np

    # -- 6. the same tree slice on the CPU agrees ---------------------------------
    tc = run_tree_slice("cpu", data, kernels)
    log(f"[trees] cpu: train {tc['train_s']:.3f} s, score "
        f"{tc['score_s']:.3f} s, AuROC {tc['auroc']:.6f}")
    assert tc["splits"] == tg["splits"], (tc["splits"], tg["splits"])
    assert tc["keep"] == tg["keep"], (tc["keep"], tg["keep"])
    tprob_diff = float(np.abs(tg["prob"] - tc["prob"]).max())
    assert tprob_diff <= TREE_PROB_ATOL, tprob_diff
    assert abs(tg["auroc"] - tc["auroc"]) <= 1e-4
    nodes_differ = int(sum((a != b).sum() for a, b in
                           zip(tg["heaps"][:3], tc["heaps"][:3])))
    log(f"[trees] cuda vs cpu: same splits and kept columns, max |prob diff| "
        f"{tprob_diff:.3g}, AuROC diff {abs(tg['auroc'] - tc['auroc']):.3g}, "
        f"heap entries (feature, bin, leaf) that differ: {nodes_differ} of "
        f"{3 * tg['heaps'][0].size}")

    # -- 7. result lines ----------------------------------------------------
    kernel_line = {"kernels": [{
        "name": "fused_moments",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/fused_moments.cu",
        "replaces": "transmogrifai_tpu/parallel/pallas_kernels.py:123",
        "launches": launches + tl["fused_moments"] + sl["fused_moments"],
        "launches_by_path": {
            "lr_slice": launches,
            "tree_slice": tl["fused_moments"] + sl["fused_moments"]},
        "max_abs_err": max([main_err["max_abs_err"]]
                           + [e["max_abs_err"] for e in errs]),
        "max_rel_err": max([main_err["max_rel_err"]]
                           + [e["max_rel_err"] for e in errs]),
        "checked": True,
        "ms": main["ms"],
        "ms_warm": main["ms_warm"],
        "host_us": main["host_us"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no one torch call computes all seven moments
        "anchor_ms": main["anchor_ms"],
        "anchor_ms_warm": main["anchor_ms_warm"],
        "ptxas": ptxas["fused_moments"],
        "shape": main["shape"],
        "tree_path_shapes": list(tree_moments.values()),
        "at_scale": at_scale,
        "other_shapes": other_moments,
    }, {
        "name": "bin_matrix",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/bin_matrix.cu",
        "replaces": "transmogrifai_tpu/parallel/pallas_kernels.py:324",
        "launches": tl["bin_matrix"] + sl["bin_matrix"],
        "launches_by_path": {"tree_slice_train": tl["bin_matrix"],
                             "tree_slice_score": sl["bin_matrix"]},
        "max_abs_err": max(bin_errs),
        "checked": True,
        "ms": bins_main["ms"],
        "ms_warm": bins_main["ms_warm"],
        "host_us": bins_main["host_us"],
        "plain_ms": bins_main["plain_ms"],
        "bound_ms": bins_main["bound_ms"],
        "bound_by": "bytes",
        # torch.searchsorted on NaN-free, pre-transposed x (int64 out)
        "library_ms": bins_main["library_ms"],
        "library_ms_warm": bins_main["library_ms_warm"],
        "library_host_us": bins_main["library_host_us"],
        "ptxas": ptxas["bin_matrix"],
        "shape": bins_main["shape"],
        "tree_path_shapes": list(bin_shapes.values()),
        "at_scale": bins_at_scale,
        "other_shapes": other_bins,
    }]}
    print(smi)
    print(json.dumps(kernel_line))
    # the run used one card, whatever the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
