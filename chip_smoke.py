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
  1M rows (kernels ``fused_moments`` and ``bin_matrix``);
* the selector, transmogrify(label=...) -> SanityChecker ->
  BinaryClassificationModelSelector (3-fold CV over logistic regression's
  8-point and the GBT's 9-point default grids) -> holdout AuROC -> score(),
  on 200k rows, and under workflow-level CV on 100k rows (both kernels, K1
  once per fold under workflow CV); its device rank metrics on the card
  against the CPU; and at 100k rows on the card against the CPU, whose
  training runs in a child process (``python3 chip_smoke.py --selector-cpu
  N``, CPU only) started at the beginning so that it overlaps the card's
  phases;
* the parameterless selector, the same front ->
  BinaryClassificationModelSelector.with_cross_validation(num_folds=3) over
  its four default families (logistic regression and the linear SVM at 8
  grid points, the random forest with per-node feature subsets at 18, the
  GBT at 9) on 1M rows on the card, counted, every kernel call held
  against its plain version, and profiled; under workflow CV on 100k rows
  (its in-fold kernel shapes timed); and at 20k rows twice on the card
  (the forest and GBT grid heaps bit-identical) against a CPU child
  (``--default-selector-cpu N``);
* the multiclass and regression selectors on the planted labels of
  ``synthetic_passengers_labelled``: transmogrify(label=...) ->
  SanityChecker -> the parameterless MultiClassificationModelSelector
  (label ``tier``; LR, the forest, the decision tree, naive Bayes: 36
  candidates) or RegressionModelSelector (label ``response``; linear
  regression, the forest and GBT regressors: 35) -> train(), score(),
  evaluate() on 1M rows on the card, counted, every kernel call held
  against its plain version, the holdout F1 or RMSE held against the
  planted ceiling; and at 20k rows with cut tree grids twice on the card
  (the grid heaps bit-identical) against a CPU child each
  (``--multiclass-selector-cpu N``, ``--regression-selector-cpu N``); and
  one one-vs-rest LR fit on the card against the CPU.

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
import io
import json
import os
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


_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, after the seconds since the script started."""
    print(f"{time.perf_counter() - _START:7.1f} s {msg}", flush=True)


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
    # a call that keeps the card at least twice as long as the host takes
    # to enqueue it never lets the card wait, so its windows need no sleep
    # (its enqueues block on the full launch queue: sleeping in proportion
    # to them would only idle the card)
    long_call = 2.0 * host_ms < dev / calls
    calls = max(MIN_CALLS, min(MAX_CALLS, int(np.ceil(
        MIN_WINDOW_MS * calls / max(dev, 1e-6)))))
    devs, hosts, gaps = [], [], 0
    for _ in range(WINDOWS):
        sleep_ms = 1.0 if long_call else 2.0 * calls * host / MIN_CALLS + 1.0
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
    us by op name).  Device-side activity only (kernels and copies, one
    stream, so no overlap); the profiler's own buffer requests are not the
    program's.  Only the card's activity is recorded and the raw trace
    events are read as they are: a selector training launches some 10^6
    kernels, and recording every host op too, or building the profiler's
    per-event Python objects, would take minutes."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        t0 = time.perf_counter()
    t1 = time.perf_counter()
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.name() != "Activity Buffer Request"):
            by_name.setdefault(e.name(), []).append(1e-3 * e.duration_ns())
    assert by_name, "the profiled run recorded no device activity"
    log(f"[profiler] {sum(map(len, by_name.values()))} device events: "
        f"stopping took {t1 - t0:.1f} s, reading them {time.perf_counter() - t1:.1f} s")
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


# -- the selector -----------------------------------------------------------------

#: the LR and GBT selector's plain run (1M rows until the parameterless
#: selector's 1M-row run came to drive the same families; cut to keep the
#: whole run in its limit as the multiclass and regression phases came)
SELECTOR_ROWS = 200_000
SELECTOR_CMP_ROWS = 100_000       # card against CPU
SELECTOR_TYPES = ["OpLogisticRegression", "OpGBTClassifier"]
SELECTOR_AUROC_RANGE = (0.70, 0.755)  # the holdout AuROC gate of PERF.md
CMP_RANK_MODE = "approx"          # TX_CV_RANK_METRICS in both card-vs-CPU runs
#: card against CPU: each candidate's mean CV metric within the CPU tests'
#: tolerance for its mode, the winner's probabilities by family
CMP_METRIC_ATOL = {"approx": 1e-3, "exact": 1e-5}
#: (the margins of a winner without probabilities, the linear SVM)
CMP_PROB_ATOL = {"OpLogisticRegression": 1e-4, "OpGBTClassifier": 1e-3,
                 "OpRandomForestClassifier": 1e-3, "OpLinearSVC": 1e-4}
#: the fits inside a validation (its scoring is the rest)
FIT_PHASES = ("lr_batch", "lr_folds", "svc_batch", "linreg_batch",
              "nb_folds", "gbt_grid", "rf_grid", "dt_grid")
#: trees deeper than this split nodes of a few dozen rows, where the card's
#: and the CPU's float32 roundings (exp, reduction orders) flip near-tied
#: splits: their mean metrics are held to CMP_DEEP_TREE_ATOL (the depth-12
#: GBT candidate differed by 2.7e-5 at 100k rows on an H100)
CMP_DEEP_TREE_DEPTH, CMP_DEEP_TREE_ATOL = 6, 1e-4


def cmp_metric_atol(candidate: dict) -> float:
    if candidate["params"].get("max_depth", 0) > CMP_DEEP_TREE_DEPTH:
        return CMP_DEEP_TREE_ATOL
    return CMP_METRIC_ATOL[candidate["rank_metric_mode"]]
RANK_METRICS_ATOL = 1e-6          # device rank metrics, card against CPU

#: both selectors' runs under workflow CV (the 1M-row runs' fold loop
#: repeats their fits, so a smaller size keeps the whole run in its limit)
WCV_ROWS = 100_000
#: the parameterless selector (LR 8, forest 18 at 50 trees, GBT 9 at 20
#: trees, linear SVM 8 grid points): at SLICE_ROWS plain, under workflow
#: CV at WCV_ROWS, and card against CPU at DEFAULT_CMP_ROWS
DEFAULT_CMP_ROWS = 20_000
DEFAULT_CANDIDATES = 8 + 18 + 9 + 8


def build_selector(device: str, model_types=SELECTOR_TYPES):
    """The selector workflow over ``model_types`` (None: the parameterless
    selector's default families)."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.selector.factories import (
        BinaryClassificationModelSelector,
    )

    survived, preds = passenger_features()
    vec = transmogrify(preds, label=survived)
    checked = SanityChecker().set_input(survived, vec).get_output()
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, model_types_to_use=model_types)
    pred = selector.set_input(survived, checked).get_output()
    wf = OpWorkflow(device=device).set_result_features(pred)
    return wf, survived, checked, pred


@contextlib.contextmanager
def selector_walls(sync: bool, keep_grid: bool = False):
    """Within the block, time the selector's phases by a shim on each
    method (the card synchronised at both ends of a call, so a wall holds
    its device work): the linear families' fold x grid fits (LR, SVM and
    linear regression batches, the multiclass LR's fold fits, naive
    Bayes' fold fits), the GBT, forest and decision-tree grid fits, the
    whole validation, the winner's refit, workflow CV and the selector's
    fit.  A fit inside another fit or a refit counts as the outer one
    only.  With ``keep_grid``, also keep what every GBT, forest and tree
    grid fit returned.  Yields {"walls": {phase: s}, "grid": [GBT grid
    fits], "rf_grid": [forest grid fits], "dt_grid": [tree grid fits]}."""
    from transmogrifai_tpu_torch.models.linear_regression import (
        OpLinearRegression,
    )
    from transmogrifai_tpu_torch.models.linear_svc import OpLinearSVC
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.models.naive_bayes import OpNaiveBayes
    from transmogrifai_tpu_torch.models.trees import _GBT, _RandomForest
    from transmogrifai_tpu_torch.selector.model_selector import ModelSelector
    from transmogrifai_tpu_torch.selector.validator import OpValidator

    rec = {"walls": {}, "grid": [], "rf_grid": [], "dt_grid": []}
    targets = [(OpLogisticRegression, "fit_arrays_batched", "lr_batch"),
               (OpLogisticRegression, "fit_arrays_folds", "lr_folds"),
               (OpLinearSVC, "fit_arrays_batched", "svc_batch"),
               (OpLinearRegression, "fit_arrays_batched", "linreg_batch"),
               (OpNaiveBayes, "fit_arrays_folds", "nb_folds"),
               (_GBT, "fit_arrays_folds_grid", "gbt_grid"),
               (_RandomForest, "fit_arrays_folds_grid", "rf_grid"),
               (OpValidator, "validate", "validate"),
               (OpLogisticRegression, "fit_arrays", "refit"),
               (OpLinearSVC, "fit_arrays", "refit"),
               (OpLinearRegression, "fit_arrays", "refit"),
               (OpNaiveBayes, "fit_arrays", "refit"),
               (_GBT, "fit_arrays", "refit"),
               (_RandomForest, "fit_arrays", "refit"),
               (ModelSelector, "find_best_estimator", "workflow_cv"),
               (ModelSelector, "fit_model", "selector_fit")]
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in targets]
    containers = ("validate", "workflow_cv", "selector_fit")
    active: list = []

    def shim(fn, phase):
        def timed_call(*args, **kw):
            name = phase
            if phase == "rf_grid" and getattr(args[0], "single_tree", False):
                name = "dt_grid"
            counted = not any(a not in containers for a in active)
            active.append(name)
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
            finally:
                active.pop()
            if sync:
                torch.cuda.synchronize()
            if counted:
                rec["walls"][name] = (rec["walls"].get(name, 0.0)
                                      + time.perf_counter() - t0)
                if keep_grid and name in ("gbt_grid", "rf_grid", "dt_grid"):
                    rec["grid" if name == "gbt_grid" else name].append(out)
            return out
        return timed_call

    for cls, name, phase in targets:
        setattr(cls, name, shim(cls.__dict__[name], phase))
    try:
        yield rec
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def winner_scores(col) -> np.ndarray:
    """What a scored prediction column is compared by: the probabilities,
    or the margins of a winner without them (the linear SVM)."""
    out = col.probability if col.probability is not None else col.raw_prediction
    return np.asarray(out, np.float64)


def run_selector(device: str, data, kernels=None, workflow_cv: bool = False,
                 keep_grid: bool = False, model_types=SELECTOR_TYPES) -> dict:
    """Train and score the selector workflow over ``model_types`` on
    ``device``; with ``kernels``, count each kernel's launches in train()
    and score()."""
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )

    wf, survived, _, pred = build_selector(device, model_types)
    if workflow_cv:
        wf.with_workflow_cv()
    wf.set_input_dataset(data)
    counts = {}
    if kernels is not None:
        kernels.reset_launches()
    with selector_walls(device == "cuda", keep_grid) as rec:
        t0 = time.perf_counter()
        model = wf.train()
        t1 = time.perf_counter()
    if kernels is not None:
        counts["train"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
        kernels.reset_launches()
    t2 = time.perf_counter()
    scored = model.score(data)
    t3 = time.perf_counter()
    if kernels is not None:
        counts["score"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
    (chosen,) = [s for s in model.stages if type(s).__name__ == "SelectedModel"]
    summary = chosen.metadata["model_selector_summary"]
    walls = rec["walls"]
    fits = sum(walls.get(k, 0.0) for k in FIT_PHASES)
    # validation scoring: the validation (or, under workflow CV, the fold
    # loop with its in-fold refits of the stages above the selector) less
    # its batched fits
    walls["scoring"] = walls.get("workflow_cv" if workflow_cv else "validate",
                                 0.0) - fits
    return {
        "model": model, "train_s": t1 - t0, "score_s": t3 - t2,
        "walls": walls, "grid": rec["grid"], "rf_grid": rec["rf_grid"],
        "dt_grid": rec["dt_grid"],
        "launches": counts,
        "summary": summary, "chosen": chosen,
        "results": summary["validation_results"],
        "modes": sorted({r.get("rank_metric_mode", "exact (workflow CV)")
                         for r in summary["validation_results"]}),
        "holdout_auroc": float(summary["holdout_metrics"][
            "OpBinaryClassificationEvaluator"]["AuROC"]),
        "auroc": float(OpBinaryClassificationEvaluator().evaluate(
            scored, label_col=survived.name, pred_col=pred.name).AuROC),
        "prob": winner_scores(scored[pred.name]),
    }


def log_selector(tag: str, r: dict) -> None:
    w = r["walls"]
    log(f"[{tag}] train {r['train_s']:.3f} s, score {r['score_s']:.3f} s; "
        f"LR fold x grid fit {w.get('lr_batch', 0.0):.3f} s, GBT grid fit "
        f"{w.get('gbt_grid', 0.0):.3f} s"
        + (f", forest grid fit {w['rf_grid']:.3f} s" if "rf_grid" in w else "")
        + (f", SVM fold x grid fit {w['svc_batch']:.3f} s"
           if "svc_batch" in w else "")
        + f", validation scoring "
        f"{w['scoring']:.3f} s, refit {w.get('refit', 0.0):.3f} s, "
        f"selector fit {w.get('selector_fit', 0.0):.3f} s"
        + (f", workflow CV {w['workflow_cv']:.3f} s" if "workflow_cv" in w
           else "")
        + f"; rank-metric mode {r['modes']}")
    for c in r["results"]:
        log(f"[{tag}]   {c['model_type']} {json.dumps(c['params'], sort_keys=True)}: "
            f"mean {c['metric']:.6f}, folds "
            f"{', '.join(f'{m:.6f}' for m in c['fold_metrics'])}")
    s = r["summary"]
    log(f"[{tag}] winner {s['best_model_type']} "
        f"{json.dumps(s['best_params'], sort_keys=True)} (mean "
        f"{s['validation_metric']['value']:.6f}); holdout AuROC "
        f"{r['holdout_auroc']:.6f}; AuROC on all rows {r['auroc']:.6f}; "
        f"launches {r['launches']}")


def selector_cpu_main(rows: int, model_types=SELECTOR_TYPES) -> int:
    """``--selector-cpu N`` (``--default-selector-cpu N``: the default
    families): train and score the selector workflow on the CPU at N rows
    with the card's rank-metric mode and write what the card's run is held
    against to stdout as an npz archive."""
    os.environ["TX_CV_RANK_METRICS"] = CMP_RANK_MODE
    torch.set_num_threads(3)  # the card's phases run beside this process
    torch.set_float32_matmul_precision("highest")
    from transmogrifai_tpu_torch.examples.synthetic import synthetic_passengers

    r = run_selector("cpu", synthetic_passengers(rows, seed=42, with_text=False),
                     model_types=model_types)
    meta = {k: r[k] for k in ("train_s", "score_s", "walls", "results",
                              "modes", "holdout_auroc", "auroc")}
    meta["winner"] = [r["summary"]["best_model_type"],
                      r["summary"]["best_params"]]
    buf = io.BytesIO()
    np.savez(buf, prob=r["prob"], meta=np.array(json.dumps(meta)))
    sys.stdout.buffer.write(buf.getvalue())
    return 0


def start_selector_cpu(rows: int, flag: str = "--selector-cpu") -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, __file__, flag, str(rows)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def finish_selector_cpu(child: subprocess.Popen) -> dict:
    out, err = child.communicate(timeout=900)
    assert child.returncode == 0, (
        f"the CPU selector run failed ({child.returncode}): "
        f"{err.decode()[-3000:]}")
    z = np.load(io.BytesIO(out))
    return {"prob": z["prob"], **json.loads(str(z["meta"]))}


def hold_path_inputs(kernels, kept: dict, shapes: dict, errs: list,
                     bin_errs: list, timed: bool = True,
                     timings: dict | None = None) -> None:
    """Each kernel on every input a path gave it (``kernel_inputs``):
    held against its plain version, and, with ``timed``, timed once per
    distinct shape (fold splits differ by a row or two: one timing per 10k
    rows) into ``shapes``, keyed (kernel, (rows, width)); a shape that
    ``timings`` holds already (another path's, in this run) takes that
    timing."""
    for kname, calls in kept.items():
        for args in calls:
            if kname == "fused_moments":
                err = check_moments(kernels, *args)
                errs.append(err)
                err = err["max_abs_err"]
            else:
                err = check_bins(kernels, *args)
                bin_errs.append(err)
            if not timed:
                continue
            n_rows, width = args[0].shape
            key = (kname, (int(round(n_rows, -4)), width))
            if key not in shapes:
                timing = (timings or {}).get(key) or (
                    time_moments(kernels, *args) if kname == "fused_moments"
                    else time_bins(kernels, *args))
                shapes[key] = {**timing, "path_calls": 0, "max_abs_err": 0.0}
            seen = shapes[key]
            seen["path_calls"] += 1
            seen["max_abs_err"] = max(seen["max_abs_err"], float(err))


def log_path_shapes(what: str, shapes: dict) -> None:
    for (kname, shape), v in sorted(shapes.items()):
        where = (f"{what} ~{shape} ({v['path_calls']} calls, each matching "
                 f"plain, max abs err {v['max_abs_err']:.3g})")
        if kname == "fused_moments":
            log_moments_times(where, v)
        else:
            log_bins_times(where, v)


def assert_counted(run: dict, kept: dict) -> None:
    """The shim kept the inputs of every launch the run counted."""
    for k, calls in kept.items():
        launched = run["launches"]["train"][k] + run["launches"]["score"][k]
        assert len(calls) == launched, (k, len(calls), launched)


def default_selector_phase(kernels, data, wdata, errs: list, bin_errs: list,
                           cpu_child: subprocess.Popen,
                           timings: dict) -> dict:
    """``[default_selector]``: the parameterless selector's four families
    trained and scored on the card on ``data`` (counted and profiled, every
    kernel call held against its plain version and timed per shape unless
    ``timings``, the [selector] path's, hold the shape), under workflow
    CV on ``wdata``, and at DEFAULT_CMP_ROWS twice on the card (the forest
    and GBT grid heaps bit-identical) against the CPU child's training.
    Returns what the result lines need."""
    from transmogrifai_tpu_torch.examples.synthetic import synthetic_passengers

    tag = "default_selector"
    # one run, counted and profiled: a second 1M-row training costs
    # minutes, and the profiler's overhead is in its walls (PERF.md)
    with kernel_inputs(kernels) as kept:
        dp, by_name = profile(
            lambda: run_selector("cuda", data, kernels, model_types=None))
    log_selector(tag, dp)
    busy_ms = log_profile(tag, 1e3 * (dp["train_s"] + dp["score_s"]),
                          by_name, 14)
    assert len(dp["results"]) == DEFAULT_CANDIDATES, len(dp["results"])
    modes = {c["model_type"]: c["rank_metric_mode"] for c in dp["results"]}
    # CUDA and n >= 100 000: the linear families rank their margins on the
    # card, the trees on the host
    assert modes == {"OpLogisticRegression": "approx", "OpLinearSVC": "approx",
                     "OpRandomForestClassifier": "exact",
                     "OpGBTClassifier": "exact"}, modes
    dl = dp["launches"]
    assert dl["train"]["fused_moments"] == 1, dl
    # 3 bucketizer fits, one binning per GBT and forest depth group, and
    # the 27 GBT and 54 forest validation predictions
    assert dl["train"]["bin_matrix"] >= 3 + 3 + 3 + 27 + 54, dl
    assert (SELECTOR_AUROC_RANGE[0] <= dp["holdout_auroc"]
            <= SELECTOR_AUROC_RANGE[1]), dp["holdout_auroc"]
    assert_counted(dp, kept)
    shapes: dict = {}
    hold_path_inputs(kernels, kept, shapes, errs, bin_errs, timings=timings)
    del kept
    log_path_shapes(f"the {tag} path's", shapes)

    # under workflow CV
    with kernel_inputs(kernels) as wkept:
        dw = run_selector("cuda", wdata, kernels, workflow_cv=True,
                          model_types=None)
    log_selector(f"{tag}, workflow CV, {len(wdata)} rows", dw)
    assert len(dw["results"]) == DEFAULT_CANDIDATES
    assert dw["launches"]["train"]["fused_moments"] == 4, dw["launches"]
    assert (SELECTOR_AUROC_RANGE[0] <= dw["holdout_auroc"]
            <= SELECTOR_AUROC_RANGE[1]), dw["holdout_auroc"]
    assert_counted(dw, wkept)
    # the in-fold shapes (30-90k rows) timed too
    wshapes: dict = {}
    hold_path_inputs(kernels, wkept, wshapes, errs, bin_errs)
    del wkept
    log_path_shapes(f"the {tag} workflow CV path's", wshapes)

    # card against CPU at DEFAULT_CMP_ROWS, the rank-metric mode pinned
    cdata = synthetic_passengers(DEFAULT_CMP_ROWS, seed=42, with_text=False)
    os.environ["TX_CV_RANK_METRICS"] = CMP_RANK_MODE
    try:
        d1 = run_selector("cuda", cdata, keep_grid=True, model_types=None)
        d2 = run_selector("cuda", cdata, keep_grid=True, model_types=None)
    finally:
        del os.environ["TX_CV_RANK_METRICS"]
    ctag = f"{tag} {DEFAULT_CMP_ROWS} rows"
    log_selector(ctag, d1)
    assert len(d1["rf_grid"]) == len(d2["rf_grid"]) == 1
    assert len(d1["grid"]) == len(d2["grid"]) == 1
    n_heaps = 0
    for grid in ("rf_grid", "grid"):
        for by_grid1, by_grid2 in zip(d1[grid], d2[grid]):
            for folds1, folds2 in zip(by_grid1, by_grid2):
                for p1, p2 in zip(folds1, folds2):
                    assert all(np.array_equal(a, b)
                               for a, b in zip(p1["heaps"], p2["heaps"])), \
                        f"the card's {grid} heaps differ between two trainings"
                    n_heaps += int(p1["heaps"][0].shape[0])
    sc = finish_selector_cpu(cpu_child)
    log(f"[{ctag}] cpu: train {sc['train_s']:.3f} s (forest grid fit "
        f"{sc['walls'].get('rf_grid', 0.0):.3f} s, GBT grid fit "
        f"{sc['walls'].get('gbt_grid', 0.0):.3f} s), score "
        f"{sc['score_s']:.3f} s, holdout AuROC {sc['holdout_auroc']:.6f}")
    metric_diff = 0.0
    assert len(d1["results"]) == len(sc["results"]) == DEFAULT_CANDIDATES
    for c_gpu, c_cpu in zip(d1["results"], sc["results"]):
        assert (c_gpu["model_type"], c_gpu["params"]) == \
            (c_cpu["model_type"], c_cpu["params"])
        assert c_gpu["rank_metric_mode"] == c_cpu["rank_metric_mode"]
        diff = abs(c_gpu["metric"] - c_cpu["metric"])
        log(f"[{ctag}]   {c_gpu['model_type']} "
            f"{json.dumps(c_gpu['params'], sort_keys=True)}: card "
            f"{c_gpu['metric']:.6f}, cpu {c_cpu['metric']:.6f}, |diff| "
            f"{diff:.3g} (tolerance {cmp_metric_atol(c_gpu):g})")
        assert diff <= cmp_metric_atol(c_gpu), (c_gpu, c_cpu)
        metric_diff = max(metric_diff, diff)
    win_gpu = [d1["summary"]["best_model_type"], d1["summary"]["best_params"]]
    assert win_gpu == sc["winner"], (win_gpu, sc["winner"])
    pdiff = float(np.abs(d1["prob"] - sc["prob"]).max())
    assert pdiff <= CMP_PROB_ATOL[win_gpu[0]], pdiff
    log(f"[{ctag}] cuda vs cpu: the same winner {win_gpu}, max |mean metric "
        f"diff| {metric_diff:.3g}, max |winner score diff| {pdiff:.3g}; the "
        f"card's forest and GBT grid heaps ({n_heaps} trees) bit-identical "
        "across two trainings")
    return {"plain": dp, "workflow_cv": dw, "shapes": shapes,
            "wcv_shapes": wshapes, "busy_ms": busy_ms}


# -- the multiclass and regression selectors -------------------------------------

#: the planted labels of ``synthetic_passengers_labelled`` and the
#: parameterless selector of each problem
PROBLEM_LABEL = {"multiclass": "tier", "regression": "response"}
PROBLEM_CANDIDATES = {"multiclass": 8 + 18 + 9 + 1, "regression": 8 + 18 + 9}
PROBLEM_EVALUATOR = {"multiclass": "OpMultiClassificationEvaluator",
                     "regression": "OpRegressionEvaluator"}
#: card against CPU on PROBLEM_CMP_ROWS rows, the grids cut so that a CPU
#: child's level loops stay short (full grids of the linear families, the
#: decision tree and naive Bayes; the forest and the GBT at depths 3 and 6)
PROBLEM_CMP_ROWS = 20_000
CMP_F1_ATOL = 5e-4   # one flipped argmax row moves F1 by ~1.5e-4 here
CMP_RMSE_RTOL = {"OpLinearRegression": 1e-5}  # trees: CMP_TREE_RMSE_RTOL
CMP_TREE_RMSE_RTOL = 1e-4
#: winner scores card against CPU: probabilities (atol) of a classifier,
#: predictions (rtol) of a regressor, where an atol of the same size
#: times the predictions' standard deviation covers predictions near 0
#: (the response is centred near 0: a relative error alone is unbounded)
CMP_SCORE_TOL = {"OpLogisticRegression": 1e-4, "OpLinearRegression": 1e-4}
CMP_TREE_SCORE_TOL = 1e-3
#: the holdout gates against the planted ceilings
F1_GATE = (-0.05, 0.005)            # ceiling less 0.05, ceiling plus 0.005
RMSE_GATE = (0.98, 1.05)            # times the ceiling RMSE


def problem_cmp_models(problem: str, device: str):
    """The card-against-CPU grids of ``problem``'s default families."""
    from transmogrifai_tpu_torch.models import trees
    from transmogrifai_tpu_torch.selector import factories as fac

    forest = [{"max_depth": d, "num_trees": 50, "min_info_gain": 0.001,
               "min_instances_per_node": 10} for d in (3, 6)]
    if problem == "multiclass":
        from transmogrifai_tpu_torch.models.logistic_regression import (
            OpLogisticRegression,
        )
        from transmogrifai_tpu_torch.models.naive_bayes import OpNaiveBayes

        return [
            (OpLogisticRegression(device=device), fac.lr_grid()),
            (trees.OpRandomForestClassifier(device=device), forest),
            (trees.OpDecisionTreeClassifier(device=device),
             [{"max_depth": d, "min_info_gain": g}
              for d in fac.MAX_DEPTH for g in fac.MIN_INFO_GAIN]),
            (OpNaiveBayes(device=device), [{}]),
        ]
    from transmogrifai_tpu_torch.models.linear_regression import (
        OpLinearRegression,
    )

    return [
        (OpLinearRegression(device=device), fac.linreg_grid()),
        (trees.OpRandomForestRegressor(device=device), forest),
        (trees.OpGBTRegressor(device=device),
         [{"max_depth": d, "num_trees": 20, "min_info_gain": 0.001}
          for d in (3, 6)]),
    ]


def build_problem_selector(device: str, problem: str, models=None):
    """transmogrify(label=...) -> SanityChecker -> the parameterless
    multiclass or regression selector (``models``: other candidates)."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.selector import factories

    label = FeatureBuilder.RealNN(PROBLEM_LABEL[problem]).as_response()
    _, preds = passenger_features()
    vec = transmogrify(preds, label=label)
    checked = SanityChecker().set_input(label, vec).get_output()
    factory = (factories.MultiClassificationModelSelector
               if problem == "multiclass" else
               factories.RegressionModelSelector)
    selector = (factory() if models is None else
                factory.with_cross_validation(models_and_parameters=models))
    pred = selector.set_input(label, checked).get_output()
    wf = OpWorkflow(device=device).set_result_features(pred)
    return wf, label, checked, pred


def run_problem_selector(device: str, data, problem: str, kernels=None,
                         keep_grid: bool = False, models=None) -> dict:
    """train(), score() and evaluate() of ``problem``'s selector workflow
    on ``device``; with ``kernels``, count each kernel's launches in
    train() and score()."""
    from transmogrifai_tpu_torch.evaluators import multiclass, regression

    wf, label, checked, pred = build_problem_selector(device, problem, models)
    wf.set_input_dataset(data)
    counts = {}
    if kernels is not None:
        kernels.reset_launches()
    with selector_walls(device == "cuda", keep_grid) as rec:
        t0 = time.perf_counter()
        model = wf.train()
        t1 = time.perf_counter()
    if kernels is not None:
        counts["train"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
        kernels.reset_launches()
    t2 = time.perf_counter()
    scored = model.score(data)
    t3 = time.perf_counter()
    if kernels is not None:
        counts["score"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
    ev_mod = multiclass if problem == "multiclass" else regression
    evaluator = getattr(ev_mod, PROBLEM_EVALUATOR[problem])()
    train_metrics = model.evaluate(evaluator).to_json()  # the training rows
    (chosen,) = [s for s in model.stages if type(s).__name__ == "SelectedModel"]
    summary = chosen.metadata["model_selector_summary"]
    walls = rec["walls"]
    walls["scoring"] = walls.get("validate", 0.0) - sum(
        walls.get(k, 0.0) for k in FIT_PHASES)
    col = scored[pred.name]
    (checker,) = [s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel"]
    return {
        "train_s": t1 - t0, "score_s": t3 - t2, "walls": walls,
        "grid": rec["grid"], "rf_grid": rec["rf_grid"],
        "dt_grid": rec["dt_grid"], "launches": counts, "summary": summary,
        "results": summary["validation_results"],
        "keep": checker.indices_to_keep,
        "holdout": summary["holdout_metrics"][PROBLEM_EVALUATOR[problem]],
        "train_metrics": {k: v for k, v in train_metrics.items()
                          if isinstance(v, float)},
        "scores": np.asarray(col.probability if col.probability is not None
                             else col.prediction, np.float64),
        # the design matrix and label the card-against-CPU checks reuse
        "design": (np.asarray(scored[checked.name].values),
                   np.asarray(data[label.name].values)) if keep_grid else None,
    }


def log_problem_selector(tag: str, r: dict) -> None:
    w = r["walls"]
    fits = ", ".join(f"{k} {w[k]:.3f} s" for k in FIT_PHASES if k in w)
    log(f"[{tag}] train {r['train_s']:.3f} s, score {r['score_s']:.3f} s; "
        f"{fits}, validation scoring {w['scoring']:.3f} s, refit "
        f"{w.get('refit', 0.0):.3f} s, selector fit "
        f"{w.get('selector_fit', 0.0):.3f} s; kept columns {len(r['keep'])}")
    for c in r["results"]:
        log(f"[{tag}]   {c['model_type']} {json.dumps(c['params'], sort_keys=True)}: "
            f"mean {c['metric']:.6f}, folds "
            f"{', '.join(f'{m:.6f}' for m in c['fold_metrics'])}")
    s = r["summary"]
    log(f"[{tag}] winner {s['best_model_type']} "
        f"{json.dumps(s['best_params'], sort_keys=True)} (mean "
        f"{s['validation_metric']['name']} "
        f"{s['validation_metric']['value']:.6f}); holdout "
        f"{json.dumps(r['holdout'], sort_keys=True)}; evaluate() on the "
        f"training rows {json.dumps(r['train_metrics'], sort_keys=True)}; "
        f"launches {r['launches']}")


def problem_cpu_main(problem: str, rows: int) -> int:
    """``--multiclass-selector-cpu N`` / ``--regression-selector-cpu N``:
    train and score ``problem``'s selector workflow with the cut grids on
    the CPU at N rows and write what the card's run is held against (the
    metrics, the winner's scores, the grid fits' heaps) to stdout as a
    pickle."""
    import pickle

    torch.set_num_threads(2)  # the card's phases run beside this process
    torch.set_float32_matmul_precision("highest")
    from transmogrifai_tpu_torch.examples.synthetic import (
        synthetic_passengers_labelled,
    )

    data = synthetic_passengers_labelled(rows, seed=42, with_text=False)
    r = run_problem_selector("cpu", data, problem, keep_grid=True,
                             models=problem_cmp_models(problem, "cpu"))
    out = {k: r[k] for k in ("train_s", "score_s", "walls", "results",
                             "holdout", "scores", "grid", "rf_grid",
                             "dt_grid", "keep")}
    out["winner"] = [r["summary"]["best_model_type"],
                     r["summary"]["best_params"]]
    sys.stdout.buffer.write(pickle.dumps(out))
    return 0


def start_problem_cpu(problem: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, __file__, f"--{problem}-selector-cpu",
         str(PROBLEM_CMP_ROWS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def finish_problem_cpu(child: subprocess.Popen) -> dict:
    import pickle

    out, err = child.communicate(timeout=900)
    assert child.returncode == 0, (
        f"the CPU selector run failed ({child.returncode}): "
        f"{err.decode()[-3000:]}")
    return pickle.loads(out)


def heap_agreement(card: dict, cpu: dict, x: np.ndarray, rtol: float,
                   atol: float) -> dict:
    """Trees of one grid fit, card against CPU, as
    ``tests/torch_parity.compare_trees`` compares them but counting
    instead of asserting: trees equal node for node (stats within rtol,
    atol), nodes where the two split differently with the same children
    (exact ties: the same rows either way), nodes where they split
    differently with other children (near ties, float32 sums rounding
    apart), and the rows whose path passes either kind."""
    from transmogrifai_tpu_torch.models.tree_kernel import bin_data

    bins = bin_data(np.asarray(x, np.float32), cpu["edges"])
    rows = np.arange(bins.shape[0])
    out = {"trees": 0, "equal_trees": 0, "tie_nodes": 0, "near_tie_nodes": 0}
    off_rows = np.zeros(bins.shape[0], bool)
    depth = cpu["max_depth"]
    for t in range(cpu["heaps"][0].shape[0]):
        g = [np.asarray(h[t]) for h in card["heaps"]]
        w = [np.asarray(h[t]) for h in cpu["heaps"]]
        out["trees"] += 1
        stop, todo = [], [0]
        while todo:
            i = todo.pop()
            if w[2][i] or g[2][i] != w[2][i] or 2 * i + 2 >= len(w[0]):
                continue
            kids = [2 * i + 1, 2 * i + 2]
            if (g[0][i], g[1][i]) == (w[0][i], w[1][i]):
                todo.extend(kids)
                continue
            same = (np.allclose(g[3][kids], w[3][kids], rtol=rtol, atol=atol)
                    or np.allclose(g[3][kids], w[3][kids][::-1], rtol=rtol,
                                   atol=atol))
            out["tie_nodes" if same else "near_tie_nodes"] += 1
            stop.append(i)
        if not stop and all(np.array_equal(a, b) for a, b in zip(g[:3], w[:3])) \
                and np.allclose(g[3], w[3], rtol=rtol, atol=atol):
            out["equal_trees"] += 1
        for heap in (g, w):
            idx = np.zeros(bins.shape[0], np.int64)
            for _ in range(depth):
                halt = heap[2][idx] | np.isin(idx, stop)
                nxt = idx * 2 + 1 + (bins[rows, heap[0][idx]] > heap[1][idx])
                idx = np.where(halt, idx, nxt)
            off_rows |= np.isin(idx, stop)
    out["rows"] = int(off_rows.sum())
    return out


def problem_selector_phase(kernels, problem: str, data, errs: list,
                           bin_errs: list, cpu_child: subprocess.Popen,
                           timings: dict) -> dict:
    """``[multiclass_selector]`` / ``[regression_selector]``: the
    parameterless selector of ``problem`` trained, scored and evaluated on
    the card on ``data`` (counted, every kernel call held against its
    plain version and timed per shape unless ``timings`` hold the shape),
    its holdout metric held against the planted ceiling; then at
    PROBLEM_CMP_ROWS twice on the card (the grid fits' heaps
    bit-identical) against the CPU child's training."""
    from transmogrifai_tpu_torch.examples import synthetic

    tag = f"{problem}_selector"
    # import every module of the path first: kernel_inputs shims the
    # wrappers that loaded modules hold
    build_problem_selector("cuda", problem)
    with kernel_inputs(kernels) as kept:
        r = run_problem_selector("cuda", data, problem, kernels)
    log_problem_selector(tag, r)
    assert len(r["results"]) == PROBLEM_CANDIDATES[problem], len(r["results"])
    assert {c["rank_metric_mode"] for c in r["results"]} == {"exact"}
    rl = r["launches"]
    assert rl["train"]["fused_moments"] == 1, rl
    # 3 bucketizer fits, one binning per tree depth group, one per tree
    # validation prediction (3 folds x 18 forest and 9 tree or GBT points)
    assert rl["train"]["bin_matrix"] >= 3 + 3 + 3 + 3 * (18 + 9), rl
    assert_counted(r, kept)
    if problem == "multiclass":
        ceiling = synthetic.BAYES_F1_OBSERVED
        f1 = r["holdout"]["F1"]
        lo, hi = ceiling + F1_GATE[0], ceiling + F1_GATE[1]
        assert lo <= f1 <= hi, (f1, lo, hi)
        gate = (f"holdout F1 {f1:.6f} in [{lo:.4f}, {hi:.4f}] (planted "
                f"ceiling {ceiling})")
    else:
        ceiling = synthetic.BEST_RMSE_OBSERVED
        rmse = r["holdout"]["RootMeanSquaredError"]
        lo, hi = RMSE_GATE[0] * ceiling, RMSE_GATE[1] * ceiling
        assert lo <= rmse <= hi, (rmse, lo, hi)
        gate = (f"holdout RMSE {rmse:.6f} in [{lo:.6f}, {hi:.6f}] (planted "
                f"ceiling {ceiling}), R2 {r['holdout']['R2']:.6f} (ceiling "
                f"{synthetic.BEST_R2_OBSERVED})")
    log(f"[{tag}] gate: {gate}")
    shapes: dict = {}
    hold_path_inputs(kernels, kept, shapes, errs, bin_errs, timings=timings)
    del kept
    log_path_shapes(f"the {tag} path's", shapes)

    # card against CPU at PROBLEM_CMP_ROWS with the cut grids
    cdata = synthetic.synthetic_passengers_labelled(
        PROBLEM_CMP_ROWS, seed=42, with_text=False)
    d1, d2 = (run_problem_selector("cuda", cdata, problem, keep_grid=True,
                                   models=problem_cmp_models(problem, "cuda"))
              for _ in range(2))
    ctag = f"{tag} {PROBLEM_CMP_ROWS} rows"
    log_problem_selector(ctag, d1)
    n_heaps = 0
    for grid in ("grid", "rf_grid", "dt_grid"):
        assert len(d1[grid]) == len(d2[grid])
        for by_grid1, by_grid2 in zip(d1[grid], d2[grid]):
            for folds1, folds2 in zip(by_grid1, by_grid2):
                for p1, p2 in zip(folds1, folds2):
                    assert all(np.array_equal(a, b)
                               for a, b in zip(p1["heaps"], p2["heaps"])), \
                        f"the card's {grid} heaps differ between two trainings"
                    n_heaps += int(p1["heaps"][0].shape[0])
    sc = finish_problem_cpu(cpu_child)
    log(f"[{ctag}] cpu: train {sc['train_s']:.3f} s, score "
        f"{sc['score_s']:.3f} s, holdout {json.dumps(sc['holdout'], sort_keys=True)}")
    assert d1["keep"] == sc["keep"], (d1["keep"], sc["keep"])
    metric_diff = 0.0
    assert len(d1["results"]) == len(sc["results"])
    for c_gpu, c_cpu in zip(d1["results"], sc["results"]):
        assert (c_gpu["model_type"], c_gpu["params"]) == \
            (c_cpu["model_type"], c_cpu["params"])
        diff = abs(c_gpu["metric"] - c_cpu["metric"])
        if problem == "multiclass":
            tol = CMP_F1_ATOL
        else:
            tol = CMP_RMSE_RTOL.get(c_gpu["model_type"],
                                    CMP_TREE_RMSE_RTOL) * abs(c_cpu["metric"])
        log(f"[{ctag}]   {c_gpu['model_type']} "
            f"{json.dumps(c_gpu['params'], sort_keys=True)}: card "
            f"{c_gpu['metric']:.7f}, cpu {c_cpu['metric']:.7f}, |diff| "
            f"{diff:.3g} (tolerance {tol:.3g})")
        assert diff <= tol, (c_gpu, c_cpu)
        metric_diff = max(metric_diff, diff)
    win_gpu = [d1["summary"]["best_model_type"], d1["summary"]["best_params"]]
    assert win_gpu == sc["winner"], (win_gpu, sc["winner"])
    tol = CMP_SCORE_TOL.get(win_gpu[0], CMP_TREE_SCORE_TOL)
    if problem == "multiclass":
        sdiff = float(np.abs(d1["scores"] - sc["scores"]).max())
    else:
        scale = np.abs(sc["scores"]) + float(np.std(sc["scores"]))
        sdiff = float((np.abs(d1["scores"] - sc["scores"]) / scale).max())
    assert sdiff <= tol, (sdiff, tol)
    # the trees card against CPU (gini counts exact; variance channels
    # float32 sums in other orders), counted, not asserted: the metric
    # gates above are the check
    x_cmp = d1["design"][0]
    trees_cmp = {}
    for grid in ("grid", "rf_grid", "dt_grid"):
        tally: dict = {}
        for by_grid_c, by_grid_h in zip(d1[grid], sc[grid]):
            for folds_c, folds_h in zip(by_grid_c, by_grid_h):
                for p_c, p_h in zip(folds_c, folds_h):
                    for k, v in heap_agreement(p_c, p_h, x_cmp, 1e-4,
                                               1e-5).items():
                        tally[k] = tally.get(k, 0) + v
        if tally:
            trees_cmp[grid] = tally
    log(f"[{ctag}] cuda vs cpu: the same kept columns and winner {win_gpu}, "
        f"max |mean metric diff| {metric_diff:.3g}, max winner score diff "
        f"{sdiff:.3g} ({'abs' if problem == 'multiclass' else 'rel to |cpu| + sd'}, "
        f"tolerance {tol:g}); the card's grid heaps ({n_heaps} trees) "
        f"bit-identical across two trainings; trees card vs cpu {trees_cmp} "
        "(tie and near-tie nodes, the rows they touch summed over trees)")
    out = {"run": r, "shapes": shapes, "cmp": {
        "metric_diff": metric_diff, "score_diff": sdiff,
        "trees": trees_cmp, "cpu_train_s": sc["train_s"]}}
    if problem == "multiclass":
        out["ovr"] = ovr_card_vs_cpu(*d1["design"])
    return out


def ovr_card_vs_cpu(x: np.ndarray, y: np.ndarray) -> dict:
    """One ``family="ovr"`` multiclass LR fit on the card against the CPU
    on the 20k-row design matrix: betas within rtol 1e-4, atol 1e-5 (the
    binary Newton's card-against-CPU tolerance), probabilities within
    1e-4."""
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )

    kw = dict(family="ovr", reg_param=0.01, elastic_net_param=0.1)
    card = OpLogisticRegression(device="cuda", **kw)
    cpu = OpLogisticRegression(device="cpu", **kw)
    t0 = time.perf_counter()
    g = card.fit_arrays(x, y)
    t1 = time.perf_counter()
    w = cpu.fit_arrays(x, y)
    assert g["family"] == w["family"] == "ovr", (g["family"], w["family"])
    np.testing.assert_allclose(g["betas"], w["betas"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g["intercepts"], w["intercepts"], rtol=1e-4,
                               atol=1e-5)
    pdiff = float(np.abs(card.predict_arrays(g, x)[2]
                         - cpu.predict_arrays(w, x)[2]).max())
    assert pdiff <= 1e-4, pdiff
    bdiff = float(np.abs(g["betas"] - w["betas"]).max())
    log(f"[multiclass_selector] family='ovr' LR on {tuple(x.shape)}, "
        f"{len(w['classes'])} classes: card {1e3 * (t1 - t0):.1f} ms, max "
        f"|beta diff| {bdiff:.3g}, max |prob diff| {pdiff:.3g}")
    return {"beta_diff": bdiff, "prob_diff": pdiff}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--selector-cpu":
        return selector_cpu_main(int(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--default-selector-cpu":
        return selector_cpu_main(int(sys.argv[2]), None)
    for problem in PROBLEM_LABEL:
        if len(sys.argv) == 3 and sys.argv[1] == f"--{problem}-selector-cpu":
            return problem_cpu_main(problem, int(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the CPU sides of the selectors' card-against-CPU phases train from
    # the start, beside the card's phases (the [default_selector] phase's
    # launch-bound forest loop then runs with the host to itself)
    children = [start_selector_cpu(SELECTOR_CMP_ROWS),
                start_selector_cpu(DEFAULT_CMP_ROWS, "--default-selector-cpu"),
                start_problem_cpu("multiclass"),
                start_problem_cpu("regression")]
    try:
        return card_main(*children)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.communicate()


def card_main(cpu_child: subprocess.Popen,
              default_cpu_child: subprocess.Popen,
              multiclass_cpu_child: subprocess.Popen,
              regression_cpu_child: subprocess.Popen) -> int:
    from transmogrifai_tpu_torch.examples.synthetic import (
        BAYES_AUROC_OBSERVED,
        synthetic_design_matrix,
        synthetic_passengers,
        synthetic_passengers_labelled,
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

    # -- 7. the selector on the card, counted ---------------------------------
    from transmogrifai_tpu_torch.evaluators.binary import masked_rank_metrics
    from transmogrifai_tpu_torch.selector import validator as validator_mod

    sdata = synthetic_passengers(SELECTOR_ROWS, seed=42, with_text=False)
    wdata = synthetic_passengers(WCV_ROWS, seed=42, with_text=False)
    rank_inputs = []

    def keep_rank_inputs(scores, y, vmask):
        rank_inputs.append((scores.clone(), y.clone(), vmask.clone()))
        return masked_rank_metrics(scores, y, vmask)

    # one run, counted and profiled (the profiler's overhead is in its
    # walls, as in the [default_selector] phase)
    validator_mod.masked_rank_metrics = keep_rank_inputs
    try:
        with kernel_inputs(kernels) as sel_inputs:
            sp, sby_name = profile(lambda: run_selector("cuda", sdata, kernels))
    finally:
        validator_mod.masked_rank_metrics = masked_rank_metrics
    log_selector("selector", sp)
    log_profile("selector", 1e3 * (sp["train_s"] + sp["score_s"]), sby_name, 12)
    lr_modes = {c["rank_metric_mode"] for c in sp["results"]
                if c["model_type"] == "OpLogisticRegression"}
    assert lr_modes == {"approx"}, lr_modes  # CUDA and n >= 100 000
    assert len(rank_inputs) == 1, len(rank_inputs)
    spl = sp["launches"]
    assert spl["train"]["fused_moments"] == 1, spl
    # 3 bucketizer fits and one binning per GBT depth group at least
    assert spl["train"]["bin_matrix"] >= 6, spl
    assert (SELECTOR_AUROC_RANGE[0] <= sp["holdout_auroc"]
            <= SELECTOR_AUROC_RANGE[1]), sp["holdout_auroc"]
    with kernel_inputs(kernels) as cv_inputs:
        swc = run_selector("cuda", wdata, kernels, workflow_cv=True)
    log_selector(f"selector, workflow CV, {WCV_ROWS} rows", swc)
    swl = swc["launches"]
    # the SanityChecker refits in each of the 3 folds, then on all rows
    assert swl["train"]["fused_moments"] == 4, swl
    assert swl["train"]["bin_matrix"] >= 3 * 4 + 3 * 3, swl
    assert (SELECTOR_AUROC_RANGE[0] <= swc["holdout_auroc"]
            <= SELECTOR_AUROC_RANGE[1]), swc["holdout_auroc"]
    assert_counted(sp, sel_inputs)
    assert_counted(swc, cv_inputs)
    # each kernel on every input the two selector runs gave it, timed at
    # the plain run's shapes
    sel_shapes: dict = {}
    hold_path_inputs(kernels, sel_inputs, sel_shapes, errs, bin_errs)
    hold_path_inputs(kernels, cv_inputs, {}, errs, bin_errs, timed=False)
    del sel_inputs, cv_inputs
    log_path_shapes(f"the selector path's (the {SELECTOR_ROWS}-row run)",
                    sel_shapes)

    # (c) the device rank metrics on the plain run's LR margins and masks
    scores, yv, vmask = rank_inputs.pop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rank_card = masked_rank_metrics(scores, yv, vmask)
    t1 = time.perf_counter()
    rank_cpu = masked_rank_metrics(scores.cpu(), yv.cpu(), vmask.cpu())
    t2 = time.perf_counter()
    rank_err = max(float(np.abs(a - b).max()) for a, b in zip(rank_card, rank_cpu))
    assert rank_err <= RANK_METRICS_ATOL, rank_err
    log(f"[selector] masked_rank_metrics on the LR margins {tuple(scores.shape)}: "
        f"card {1e3 * (t1 - t0):.1f} ms, CPU {1e3 * (t2 - t1):.1f} ms (host "
        f"walls), max |card - CPU| {rank_err:.3g} over AuROC and AuPR")
    del scores, yv, vmask

    # (b) card against CPU at SELECTOR_CMP_ROWS, the rank-metric mode pinned
    cdata = synthetic_passengers(SELECTOR_CMP_ROWS, seed=42, with_text=False)
    os.environ["TX_CV_RANK_METRICS"] = CMP_RANK_MODE
    try:
        g1 = run_selector("cuda", cdata, keep_grid=True)
        g2 = run_selector("cuda", cdata, keep_grid=True)
    finally:
        del os.environ["TX_CV_RANK_METRICS"]
    log_selector(f"selector {SELECTOR_CMP_ROWS} rows", g1)
    assert len(g1["grid"]) == len(g2["grid"]) == 1
    for by_grid1, by_grid2 in zip(g1["grid"], g2["grid"]):
        for folds1, folds2 in zip(by_grid1, by_grid2):
            for p1, p2 in zip(folds1, folds2):
                assert all(np.array_equal(a, b)
                           for a, b in zip(p1["heaps"], p2["heaps"])), \
                    "the card's GBT grid heaps differ between two trainings"
    sc = finish_selector_cpu(cpu_child)
    log(f"[selector {SELECTOR_CMP_ROWS} rows] cpu: train {sc['train_s']:.3f} s "
        f"(GBT grid fit {sc['walls'].get('gbt_grid', 0.0):.3f} s), score "
        f"{sc['score_s']:.3f} s, holdout AuROC {sc['holdout_auroc']:.6f}")
    metric_diff = 0.0
    for c_gpu, c_cpu in zip(g1["results"], sc["results"]):
        assert (c_gpu["model_type"], c_gpu["params"]) == \
            (c_cpu["model_type"], c_cpu["params"])
        assert c_gpu["rank_metric_mode"] == c_cpu["rank_metric_mode"]
        diff = abs(c_gpu["metric"] - c_cpu["metric"])
        log(f"[selector {SELECTOR_CMP_ROWS} rows]   {c_gpu['model_type']} "
            f"{json.dumps(c_gpu['params'], sort_keys=True)}: card "
            f"{c_gpu['metric']:.6f}, cpu {c_cpu['metric']:.6f}, |diff| "
            f"{diff:.3g} (tolerance {cmp_metric_atol(c_gpu):g})")
        assert diff <= cmp_metric_atol(c_gpu), (c_gpu, c_cpu)
        metric_diff = max(metric_diff, diff)
    assert len(g1["results"]) == len(sc["results"]) == 17
    win_gpu = [g1["summary"]["best_model_type"], g1["summary"]["best_params"]]
    if win_gpu != sc["winner"]:
        top = sorted(g1["results"], key=lambda c: -c["metric"])[:2]
        assert abs(top[0]["metric"] - top[1]["metric"]) <= max(
            cmp_metric_atol(c) for c in top), (win_gpu, sc["winner"])
        cmp_prob = "not compared: the winners differ within the tolerance"
    else:
        pdiff = float(np.abs(g1["prob"] - sc["prob"]).max())
        assert pdiff <= CMP_PROB_ATOL[win_gpu[0]], pdiff
        cmp_prob = f"{pdiff:.3g}"
    log(f"[selector {SELECTOR_CMP_ROWS} rows] cuda vs cpu: winners {win_gpu} "
        f"and {sc['winner']}, max |mean metric diff| {metric_diff:.3g}, max "
        f"|prob diff| of the winner {cmp_prob}; the card's GBT grid heaps "
        "bit-identical across two trainings")

    # -- 8. the default selector ------------------------------------------
    dsel = default_selector_phase(kernels, data, wdata, errs, bin_errs,
                                  default_cpu_child, sel_shapes)
    dpl, dwl = dsel["plain"]["launches"], dsel["workflow_cv"]["launches"]
    del data

    # -- 9. the multiclass and regression selectors ---------------------------
    ldata = synthetic_passengers_labelled(SLICE_ROWS, seed=42, with_text=False)
    timings = {**sel_shapes, **dsel["shapes"]}
    problems = {}
    for problem, child in (("multiclass", multiclass_cpu_child),
                           ("regression", regression_cpu_child)):
        problems[problem] = problem_selector_phase(
            kernels, problem, ldata, errs, bin_errs, child, timings)
        timings.update(problems[problem]["shapes"])
    del ldata

    # -- 10. result lines ---------------------------------------------------
    def sel_by_path(k):
        return {"selector_train": spl["train"][k],
                "selector_score": spl["score"][k],
                "selector_workflow_cv_train": swl["train"][k],
                "selector_workflow_cv_score": swl["score"][k],
                "default_selector_train": dpl["train"][k],
                "default_selector_score": dpl["score"][k],
                "default_selector_workflow_cv_train": dwl["train"][k],
                "default_selector_workflow_cv_score": dwl["score"][k],
                **{f"{p}_selector_{phase}": v["run"]["launches"][phase][k]
                   for p, v in problems.items() for phase in ("train", "score")}}

    def sel_launches(k):
        return sum(sel_by_path(k).values())

    def sel_shape_rows(k, shapes=sel_shapes):
        return [{"shape": list(shape), **v}
                for (kname, shape), v in sorted(shapes.items()) if kname == k]

    kernel_line = {"kernels": [{
        "name": "fused_moments",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/fused_moments.cu",
        "replaces": "transmogrifai_tpu/parallel/pallas_kernels.py:123",
        "launches": (launches + tl["fused_moments"] + sl["fused_moments"]
                     + sel_launches("fused_moments")),
        "launches_by_path": {
            "lr_slice": launches,
            "tree_slice": tl["fused_moments"] + sl["fused_moments"],
            **sel_by_path("fused_moments")},
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
        "selector_path_shapes": sel_shape_rows("fused_moments"),
        "default_selector_path_shapes": sel_shape_rows("fused_moments",
                                                       dsel["shapes"]),
        "default_selector_workflow_cv_path_shapes": sel_shape_rows(
            "fused_moments", dsel["wcv_shapes"]),
        **{f"{p}_selector_path_shapes": sel_shape_rows(
            "fused_moments", v["shapes"]) for p, v in problems.items()},
        "at_scale": at_scale,
        "other_shapes": other_moments,
    }, {
        "name": "bin_matrix",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/bin_matrix.cu",
        "replaces": "transmogrifai_tpu/parallel/pallas_kernels.py:324",
        "launches": tl["bin_matrix"] + sl["bin_matrix"] + sel_launches("bin_matrix"),
        "launches_by_path": {"tree_slice_train": tl["bin_matrix"],
                             "tree_slice_score": sl["bin_matrix"],
                             **sel_by_path("bin_matrix")},
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
        "selector_path_shapes": sel_shape_rows("bin_matrix"),
        "default_selector_path_shapes": sel_shape_rows("bin_matrix",
                                                       dsel["shapes"]),
        "default_selector_workflow_cv_path_shapes": sel_shape_rows(
            "bin_matrix", dsel["wcv_shapes"]),
        **{f"{p}_selector_path_shapes": sel_shape_rows(
            "bin_matrix", v["shapes"]) for p, v in problems.items()},
        "at_scale": bins_at_scale,
        "other_shapes": other_bins,
    }]}
    print(smi)
    print(json.dumps(kernel_line))
    # the run used one card, whatever the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
