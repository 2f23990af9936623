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


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-call times over CUDA events, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
    n, d = x.shape
    return {
        "shape": [n, d],
        "ms": cuda_ms(lambda: kernels.fused_moments(x, y), 20),
        "plain_ms": cuda_ms(lambda: kernels.fused_moments_plain(x, y), 5),
        "anchor_ms": cuda_ms(lambda: x.sum(0), 20),  # read-bandwidth anchor
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


def time_bins(kernels, x: torch.Tensor, edges: torch.Tensor, dtype) -> dict:
    """Kernel, plain version and the library anchor: torch.searchsorted
    over the sorted edge rows of a pre-transposed NaN-free x (it ranks a
    NaN x at 0, so it is a yardstick, not a substitute)."""
    n, d = x.shape
    assert not bool(torch.isnan(x).any()) and not bool(torch.isnan(edges).any())
    xt = x.T.contiguous()
    out_bytes = 1 if dtype == torch.int8 else 4
    return {
        "shape": [n, d],
        "edges": int(edges.shape[1]),
        "ms": cuda_ms(lambda: kernels.bin_matrix(x, edges, dtype), 20),
        "plain_ms": cuda_ms(lambda: kernels.bin_matrix_plain(x, edges, dtype), 3),
        "library_ms": cuda_ms(
            lambda: torch.searchsorted(edges, xt, side="left"), 20),
        "bound_ms": bin_bound_ms(n, d, int(edges.shape[1]), out_bytes),
    }


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
    column (whose edges are all NaN); (1000, 37) at max_bins 255."""
    from transmogrifai_tpu_torch.models.tree_kernel import quantile_bin_edges

    cases = []
    for n, d, max_bins, dtype in ((1, 1, 32, torch.int8),
                                  (513, 129, 32, torch.int8),
                                  (1000, 37, 255, torch.int32)):
        x = (rng.randn(n, d) * 3.0 + 1.0).astype(np.float32)
        if d == 129:
            x[::13, 17] = np.nan
            x[:, 100] = np.nan
        edges = np.ascontiguousarray(quantile_bin_edges(x, max_bins))
        cases.append((x, edges, dtype))
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

    # -- 2. kernel check ----------------------------------------------------
    rng = np.random.RandomState(0)
    cases = []
    for n, d in ((1, 1), (513, 129), (1000, 37)):
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
        err = check_moments(kernels, x, y)
        errs.append(err)
        log(f"[kernel] fused_moments {tuple(x.shape)}: matches plain, "
            f"max abs err {err['max_abs_err']:.3g}, "
            f"max rel err {err['max_rel_err']:.3g}")
    assert tuple(x.shape) == SCALE_SHAPE
    first = [t.clone() for t in kernels.fused_moments(x, y)]
    again = kernels.fused_moments(x, y)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), \
        "fused_moments is not bit-identical from run to run"
    at_scale = time_moments(kernels, x, y)
    log(f"[kernel] fused_moments at {SCALE_SHAPE}: {at_scale['ms']:.4f} ms, "
        f"bound {at_scale['bound_ms']:.4f} ms, x.sum(0) "
        f"{at_scale['anchor_ms']:.4f} ms, plain {at_scale['plain_ms']:.4f} ms")

    # bin_matrix: the small shapes, then the repo's scale with the tree
    # learner's own edges (a seeded host sample, max_bins 32, int8 out)
    bin_errs = []
    for xb_np, eb_np, dtype in bin_cases(rng):
        xb = torch.from_numpy(xb_np).to(dev)
        eb = torch.from_numpy(eb_np).to(dev)
        bin_errs.append(check_bins(kernels, xb, eb, dtype))
        log(f"[kernel] bin_matrix {tuple(xb.shape)} x {eb.shape[1]} edges "
            f"-> {dtype}: equal to plain, bit-identical twice")
    edges = torch.from_numpy(np.ascontiguousarray(
        _sampled_bin_edges(x_np, BIN_MAX_BINS, 42))).to(dev)
    bin_errs.append(check_bins(kernels, x, edges, torch.int8))
    bins_at_scale = time_bins(kernels, x, edges, torch.int8)
    log(f"[kernel] bin_matrix at {SCALE_SHAPE} x {edges.shape[1]} edges "
        f"-> int8: equal to plain, bit-identical twice; "
        f"{bins_at_scale['ms']:.4f} ms, bound {bins_at_scale['bound_ms']:.4f} "
        f"ms, torch.searchsorted {bins_at_scale['library_ms']:.4f} ms, plain "
        f"{bins_at_scale['plain_ms']:.4f} ms")
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
    log(f"[kernel] fused_moments at the main path's {tuple(x.shape)}: "
        f"{main['ms']:.4f} ms, bound {main['bound_ms']:.4f} ms, x.sum(0) "
        f"{main['anchor_ms']:.4f} ms, plain {main['plain_ms']:.4f} ms")

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
            bin_shapes[key] = {**time_bins(kernels, xb, eb, dtype),
                               "dtype": str(dtype), "calls": 0,
                               "max_abs_err": 0}
        seen = bin_shapes[key]
        seen["calls"] += 1
        seen["max_abs_err"] = max(seen["max_abs_err"], err)
    for b in bin_shapes.values():
        log(f"[kernel] bin_matrix at the tree path's {tuple(b['shape'])} x "
            f"{b['edges']} edges -> {b['dtype']} ({b['calls']} calls): equal "
            f"to plain, bit-identical twice; {b['ms']:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms, torch.searchsorted "
            f"{b['library_ms']:.4f} ms, plain {b['plain_ms']:.4f} ms")
    # the headline shape: the GBT's design matrix, the widest
    bins_main = max(bin_shapes.values(),
                    key=lambda b: b["shape"][0] * b["shape"][1])
    tree_moments = {}
    for xm, ym in path_inputs["fused_moments"]:
        err = check_moments(kernels, xm, ym)
        errs.append(err)
        if tuple(xm.shape) not in tree_moments:
            tree_moments[tuple(xm.shape)] = {**time_moments(kernels, xm, ym),
                                             **err}
    for m in tree_moments.values():
        log(f"[kernel] fused_moments at the tree path's {tuple(m['shape'])}: "
            f"matches plain, max abs err {m['max_abs_err']:.3g}, max rel err "
            f"{m['max_rel_err']:.3g}; {m['ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms, x.sum(0) {m['anchor_ms']:.4f} ms, plain "
            f"{m['plain_ms']:.4f} ms")
    del path_inputs

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
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no one torch call computes all seven moments
        "anchor_ms": main["anchor_ms"],
        "shape": main["shape"],
        "tree_path_shapes": list(tree_moments.values()),
        "at_scale": at_scale,
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
        "plain_ms": bins_main["plain_ms"],
        "bound_ms": bins_main["bound_ms"],
        "bound_by": "bytes",
        # torch.searchsorted on NaN-free, pre-transposed x (int64 out)
        "library_ms": bins_main["library_ms"],
        "shape": bins_main["shape"],
        "tree_path_shapes": list(bin_shapes.values()),
        "at_scale": bins_at_scale,
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
