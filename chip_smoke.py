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
* the README example (README.md's first code block, the port's imports,
  ``OpWorkflow()`` on the card): a 1M-row CSV written by
  ``examples.synthetic.write_readme_csv`` read through
  ``CSVReader`` on the native scanner -> ``age.fill_missing_with_mean()
  .z_normalize()`` -> transmogrify -> ``survived.sanity_check(...)`` ->
  BinaryClassificationModelSelector.with_cross_validation(num_folds=3) over
  its four default families (logistic regression and the linear SVM at 8
  grid points, the random forest with per-node feature subsets at 18, the
  GBT at 9) -> train(), score(), ``summary_pretty()``, counted, every
  kernel call held against its plain version, one forest depth group
  profiled;
* the serving path (``[serve]``): the README model, and a 50-tree
  depth-12 forest and a 20-tree depth-12 GBT fitted on the README front at
  200k rows, each saved, loaded into its rebuilt workflow with
  ``OpWorkflowModel.load`` and served through ``score_function()`` - one
  torch program on the card per batch, every tree head binning its batch
  with ``bin_matrix`` - over 50k held-out CSV records at batches of 1,
  64, 1 024 and 16 384, row for row against the numpy-fused scorer,
  counted, every kernel call held against its plain version, ``bin_matrix``
  timed at the serving shapes (``--serve-only`` runs this phase alone);
* the same four families on the passenger data's front
  (transmogrify(label=...) -> SanityChecker), their forest and GBT grids
  cut to depths 3 and 6, at 200k rows on the card, counted; and under
  workflow CV on 100k rows (its in-fold kernel shapes timed);
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
  one one-vs-rest LR fit on the card against the CPU;
* every vectorizer group (``[full_schema]``, ``[type_lattice]``): the
  passenger data with its free-text description and boarding date
  (transmogrify(label=...) with the reference date pinned: 512 hash
  columns, circular dates and days since, K2 in the label-aware
  bucketizers) -> SanityChecker (K1 at the design matrix's full width,
  over 256 columns) -> OpLogisticRegression -> AuROC on 1M rows on the
  card, counted, every kernel call held against its plain version, and
  ``score_function()`` over 300 of its records (interpreted: the text and
  date models have no lowering); one feature of each of 24 types from the
  testkit on 10k rows (a label planted here, the numeric maps bucketized
  key by key on K2, about 4 200 columns into K1); both held against a CPU
  child (``--schema-cpu``: 100k full-schema rows and the same 10k lattice
  rows) - the design matrices bit-equal, the same kept columns and map
  splits, coefficients rtol 1e-4, probabilities 1e-4;
* the remaining model families and training services (``[families]``):
  1M rows of ``synthetic_passengers_labelled`` with a drill feature
  filled under the minimum fill rate, behind
  ``with_raw_feature_filter(RawFeatureFilter(scoring_data=...))`` over a
  100k-row scoring set whose ``weight`` moved past the JS-divergence
  limit (both blacklisted, the DAG cut) -> transmogrify ->
  SanityChecker -> a binary selector over the logistic regression and
  the MLP (the holdout AuROC gated, ``OpBinScoreEvaluator``,
  ``stageMetrics``); a regression selector over the gaussian GLM (the
  RMSE gated) and the poisson, gamma and tweedie (log and power link)
  GLMs; the CV checkpoint written and restored; RecordInsightsLOCO over
  10k rows of a 50-tree depth-12 forest (``backend="native"``: the host
  C++ learner; every zero-out pass binned by ``bin_matrix``) and of an
  MLP; ``score_function()`` of the MLP and GLM heads, torch-fused
  against numpy-fused within the JAX package's ULP budgets; LDA and
  word2vec over 20k descriptions; and at 100k rows against a CPU child
  (``--families-cpu N``; ``--families-only`` runs the phase alone);
* the ingestion layer (``[ingest]``; ``--ingest-only`` runs it alone):
  the README's 1M-row CSV through ``DeviceCSVIngest`` (pinned copies on
  a side stream, double-buffered against the C++ parse) onto the card,
  bit-equal to its CPU route, its parse, copy and total walls and their
  overlap beside ``CSVReader``'s read of the same file; the repo's scale
  path: ``synthetic_design_matrix_device`` makes 10M x 39 float32 on the
  card (only y crosses the bus), ``fused_moments`` sweeps it and
  ``OpCrossValidation.validate`` runs the LR grid on the card-resident
  matrix, counted, gated by ``planted_truth_report`` with the AuROC of a
  held-out 1M slice; and the conditional-aggregation example trained and
  scored on the card, its columns equal to the CPU's;
* the fused training programs (``[fused_train]``; ``--fused-train-only``
  runs it alone): ``OpCrossValidation(num_folds=3).validate`` of the LR
  grid (exact and approx rank metrics), the linear SVM at 3
  regularisations, linear regression, an 8-tree depth-6 forest classifier
  and regressor at two min info gains and a 10-tree depth-3 GBT at two
  step sizes, on 1M rows of the synthetic design matrix (39 columns) on
  the card, each forced through the fused programs and through the
  kernel-at-a-time path: every family fused, betas bit-equal, fold metrics
  within 1e-9, the same winners, K2's launches in the fused tree plans
  counted and held against plain.  Every selector phase also logs its
  ``train_fused`` trail (at 200 000 rows and more the auto gate takes
  the linear families through the fused programs).

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


#: at most this many copies: a serving batch of one row would need
#: millions to fill COLD_BYTES, and a launch that small is bound by the
#: launch, not by the reads
MAX_COLD_COPIES = 4096


def cold_sets(*args) -> list:
    """``args`` and enough clones of its tensors that all of them together
    exceed COLD_BYTES, or MAX_COLD_COPIES of them."""
    size = sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))
    copies = max(1, int(np.ceil(COLD_BYTES / max(size, 1) + 1e-9)))
    if copies * size <= COLD_BYTES:
        copies += 1
    copies = min(copies, MAX_COLD_COPIES)
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


def file_digest(path: str) -> tuple:
    """(mtime in ns, SHA-256) of a file."""
    import hashlib

    with open(path, "rb") as f:
        return os.stat(path).st_mtime_ns, hashlib.sha256(f.read()).hexdigest()


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


def log_profile(tag: str, wall_ms: float, by_name: dict, top: int,
                what: str = "train+score") -> float:
    device_ms = 1e-3 * sum(sum(v) for v in by_name.values())
    log(f"[{tag}] cuda, profiled run: {what} {wall_ms:.1f} ms, device "
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
#: the fits inside a validation (its scoring is the rest; a family's fused
#: training dispatch, ``fused_linear`` or ``fused_tree``, holds its scoring
#: and metrics too)
FIT_PHASES = ("lr_batch", "lr_folds", "svc_batch", "linreg_batch",
              "nb_folds", "gbt_grid", "rf_grid", "dt_grid", "fused_linear",
              "fused_tree")
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
#: trees, linear SVM 8 grid points), which the [readme] phase trains on
#: README_ROWS rows read from a CSV (its 20k-row card-against-CPU run in
#: [default_selector] was cut to make room for [fused_train])
DEFAULT_CANDIDATES = 8 + 18 + 9 + 8
#: [default_selector] trains the same families on the passenger front with
#: the forest and GBT grids cut to DEFAULT_CUT_DEPTHS (their depth-12 level
#: loops, launch-bound whatever the rows, took 60% of its walls) plain at
#: DEFAULT_SELECTOR_ROWS and under workflow CV at WCV_ROWS
DEFAULT_CUT = "default families, cut tree depths"
DEFAULT_CUT_DEPTHS = (3, 6)
DEFAULT_CUT_CANDIDATES = 8 + 12 + 6 + 8
DEFAULT_SELECTOR_ROWS = 200_000


def default_cut_models(device: str) -> list:
    """The parameterless binary selector's (estimator, grid) pairs with
    the tree grids cut to DEFAULT_CUT_DEPTHS."""
    from transmogrifai_tpu_torch.selector.factories import _binary_models

    return [(est, [p for p in grid
                   if p.get("max_depth", DEFAULT_CUT_DEPTHS[0])
                   in DEFAULT_CUT_DEPTHS])
            for est, grid in _binary_models(None, device)]


def build_selector(device: str, model_types=SELECTOR_TYPES):
    """The selector workflow over ``model_types`` (None: the parameterless
    selector's default families; DEFAULT_CUT: those with cut tree
    grids)."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.selector.factories import (
        BinaryClassificationModelSelector,
    )

    survived, preds = passenger_features()
    vec = transmogrify(preds, label=survived)
    checked = SanityChecker().set_input(survived, vec).get_output()
    if model_types == DEFAULT_CUT:
        selector = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3, models_and_parameters=default_cut_models(device))
    else:
        selector = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3, model_types_to_use=model_types)
    pred = selector.set_input(survived, checked).get_output()
    wf = OpWorkflow(device=device).set_result_features(pred)
    return wf, survived, checked, pred


@contextlib.contextmanager
def selector_walls(sync: bool, keep_grid: bool = False, extra=()):
    """Within the block, time the selector's phases by a shim on each
    method (the card synchronised at both ends of a call, so a wall holds
    its device work): the linear families' fold x grid fits (LR, SVM and
    linear regression batches, the multiclass LR's fold fits, naive
    Bayes' fold fits), the GBT, forest and decision-tree grid fits, the
    whole validation, the fused training dispatches (``local/fused_train``
    ``run_linear`` and ``run_tree``), the winner's refit, workflow CV and
    the selector's fit, and each (class, method, label) of ``extra``,
    summed by label.
    A fit inside another fit or a refit counts as the outer one only.
    With ``keep_grid``, also keep what every GBT, forest and tree grid fit
    returned.  Yields {"walls": {phase: s}, "grid": [GBT grid fits],
    "rf_grid": [forest grid fits], "dt_grid": [tree grid fits]}."""
    from transmogrifai_tpu_torch.local import fused_train
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
    targets = [(fused_train, "run_linear", "fused_linear"),
               (fused_train, "run_tree", "fused_tree"),
               (OpLogisticRegression, "fit_arrays_batched", "lr_batch"),
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
               (ModelSelector, "fit_model", "selector_fit"), *extra]
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in targets]
    containers = ("validate", "workflow_cv", "selector_fit")
    active: list = []

    def shim(fn, phase):
        if isinstance(fn, classmethod):
            return classmethod(shim(fn.__func__, phase))

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


def log_train_fused(tag: str, trail) -> None:
    """A validation's fused-training trail: per family the backend, with
    the reason of a kernel-at-a-time one, or the mode, shape bucket and
    wall of a fused one."""
    if trail is None:
        log(f"[{tag}] train_fused: no family reached the fused gate")
        return
    parts = [
        f"{fam} fused ({e['mode']}, {e['bucket']}, exec {e['exec_ms']:.1f} ms)"
        if e["backend"] == "fused" else f"{fam} existing ({e['reason']})"
        for fam, e in trail["families"].items()]
    log(f"[{tag}] train_fused {trail['backend']}: {'; '.join(parts)}")


def log_selector(tag: str, r: dict) -> None:
    w = r["walls"]
    log(f"[{tag}] train {r['train_s']:.3f} s, score {r['score_s']:.3f} s; "
        f"LR fold x grid fit {w.get('lr_batch', 0.0):.3f} s, GBT grid fit "
        f"{w.get('gbt_grid', 0.0):.3f} s"
        + (f", forest grid fit {w['rf_grid']:.3f} s" if "rf_grid" in w else "")
        + (f", SVM fold x grid fit {w['svc_batch']:.3f} s"
           if "svc_batch" in w else "")
        + (f", fused linear dispatches {w['fused_linear']:.3f} s"
           if "fused_linear" in w else "")
        + (f", fused tree dispatches {w['fused_tree']:.3f} s"
           if "fused_tree" in w else "")
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
    log_train_fused(tag, s.get("train_fused"))


def selector_cpu_main(rows: int) -> int:
    """``--selector-cpu N``: train and score the selector workflow on the
    CPU at N rows with the card's rank-metric mode and write what the
    card's run is held against to stdout as an npz archive."""
    os.environ["TX_CV_RANK_METRICS"] = CMP_RANK_MODE
    torch.set_num_threads(3)  # the card's phases run beside this process
    torch.set_float32_matmul_precision("highest")
    from transmogrifai_tpu_torch.examples.synthetic import synthetic_passengers

    r = run_selector("cpu", synthetic_passengers(rows, seed=42, with_text=False))
    meta = {k: r[k] for k in ("train_s", "score_s", "walls", "results",
                              "modes", "holdout_auroc", "auroc")}
    meta["winner"] = [r["summary"]["best_model_type"],
                      r["summary"]["best_params"]]
    buf = io.BytesIO()
    np.savez(buf, prob=r["prob"], meta=np.array(json.dumps(meta)))
    sys.stdout.buffer.write(buf.getvalue())
    return 0


def start_selector_cpu(rows: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, __file__, "--selector-cpu", str(rows)],
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
                           timings: dict) -> dict:
    """``[default_selector]``: the parameterless selector's four families,
    their tree grids cut to DEFAULT_CUT_DEPTHS, trained and scored on the
    card on ``data`` (counted, every kernel call held against its plain
    version and timed per shape unless ``timings``, the earlier paths',
    hold the shape) and under workflow CV on ``wdata``.  (Its card run of
    the full grids at 20k rows against a CPU child was cut to make room
    for [fused_train].)  Returns what the result lines need."""
    tag = "default_selector"
    with kernel_inputs(kernels) as kept:
        dp = run_selector("cuda", data, kernels, model_types=DEFAULT_CUT)
    log_selector(f"{tag}, {len(data)} rows", dp)
    assert len(dp["results"]) == DEFAULT_CUT_CANDIDATES, len(dp["results"])
    modes = {c["model_type"]: c["rank_metric_mode"] for c in dp["results"]}
    # CUDA and n >= 100 000: the linear families rank their margins on the
    # card, the trees on the host
    assert modes == {"OpLogisticRegression": "approx", "OpLinearSVC": "approx",
                     "OpRandomForestClassifier": "exact",
                     "OpGBTClassifier": "exact"}, modes
    dl = dp["launches"]
    assert dl["train"]["fused_moments"] == 1, dl
    # 3 bucketizer fits, one binning per GBT and forest depth group, and
    # the 18 GBT and 36 forest validation predictions
    assert dl["train"]["bin_matrix"] >= 3 + 2 + 2 + 18 + 36, dl
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
                          model_types=DEFAULT_CUT)
    log_selector(f"{tag}, workflow CV, {len(wdata)} rows", dw)
    assert len(dw["results"]) == DEFAULT_CUT_CANDIDATES
    assert dw["launches"]["train"]["fused_moments"] == 4, dw["launches"]
    assert (SELECTOR_AUROC_RANGE[0] <= dw["holdout_auroc"]
            <= SELECTOR_AUROC_RANGE[1]), dw["holdout_auroc"]
    assert_counted(dw, wkept)
    # the in-fold shapes (30-90k rows) timed too
    wshapes: dict = {}
    hold_path_inputs(kernels, wkept, wshapes, errs, bin_errs)
    del wkept
    log_path_shapes(f"the {tag} workflow CV path's", wshapes)

    return {"plain": dp, "workflow_cv": dw, "shapes": shapes,
            "wcv_shapes": wshapes}


# -- the README example -------------------------------------------------------

#: the README example's CSV (``examples.synthetic.write_readme_csv``): the
#: 1M-row default-selector run of the script (README.md's selector is the
#: parameterless one), read from a CSV through the native scanner
README_ROWS = 1_000_000


def readme_stage_targets() -> list:
    """The README path's host stages and the SanityChecker: each fit and
    each transform."""
    from transmogrifai_tpu_torch.ops import categorical, numeric, scalers
    from transmogrifai_tpu_torch.ops.vectorizer_base import (
        SequenceVectorizerModel,
    )
    from transmogrifai_tpu_torch.preparators import sanity_checker

    return [(scalers.FillMissingWithMean, "fit_model", "FillMissingWithMean fit"),
            (scalers._FillMeanModel, "transform_columns",
             "FillMissingWithMean transform"),
            (scalers.OpScalarStandardScaler, "fit_model",
             "OpScalarStandardScaler fit"),
            (scalers._ScaleModel, "transform_columns",
             "OpScalarStandardScaler transform"),
            (categorical.OneHotVectorizer, "fit_model", "vectorizers fit"),
            (numeric.RealVectorizer, "fit_model", "vectorizers fit"),
            (numeric.RealNNVectorizer, "fit_model", "vectorizers fit"),
            (SequenceVectorizerModel, "transform_columns",
             "vectorizers transform"),
            (sanity_checker.SanityChecker, "fit_model", "SanityChecker fit"),
            (sanity_checker.SanityCheckerModel, "transform_columns",
             "SanityChecker transform")]


def readme_example(path: str):
    """README.md's example, word for word with the port's imports and
    ``OpWorkflow()`` left at its default device (the card), over the CSV
    at ``path``; returns (workflow, reader, prediction)."""
    import transmogrifai_tpu_torch.dsl  # noqa: F401  feature operators
    from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
    from transmogrifai_tpu_torch.selector.factories import (
        BinaryClassificationModelSelector,
    )
    from transmogrifai_tpu_torch.types import feature_types as ft

    # Typed raw features
    survived = FeatureBuilder(ft.RealNN, "survived").as_response()
    sex = FeatureBuilder(ft.PickList, "sex").as_predictor()
    age = FeatureBuilder(ft.Real, "age").as_predictor()
    fare = FeatureBuilder(ft.Real, "fare").as_predictor()

    # Derived features (feature math DSL)
    normed_age = age.fill_missing_with_mean().z_normalize()

    # Automated feature engineering
    features = transmogrify([sex, age, fare, normed_age])

    # Automated feature validation
    checked = survived.sanity_check(features, remove_bad_features=True)

    # Automated model selection
    prediction = (
        BinaryClassificationModelSelector.with_cross_validation(num_folds=3)
        .set_input(survived, checked)
        .get_output()
    )

    reader = CSVReader(path)
    wf = OpWorkflow().set_result_features(prediction).set_reader(reader)
    return wf, reader, prediction


#: the [readme] train is profiled over one window: the forest grid's fit
#: of this depth group (its 6 grid points x 3 folds in one level loop)
def readme_phase(kernels, errs: list, bin_errs: list, timings: dict) -> dict:
    """``[readme]``: README.md's example on the card over a README_ROWS-row
    CSV: train() counted (K1 once, K2 for the GBT and forest depth groups
    and the 81 tree validation predictions), every kernel call held against
    its plain version and timed per shape unless ``timings`` hold the
    shape; the reader's native route, the holdout AuROC and
    ``summary_pretty()`` checked; score() of the CSV's rows.  (Its profiled
    forest depth group, 22 s of the profiler's stop and read, was cut to
    make room for [fused_train].)  Returns the run and its kernel
    shapes."""
    import tempfile

    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )
    from transmogrifai_tpu_torch.examples.synthetic import write_readme_csv
    from transmogrifai_tpu_torch.obs import trace as obs_trace

    tag = "readme"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_readme_csv(os.path.join(tmp, "titanic.csv"), README_ROWS)
        write_s = time.perf_counter() - t0
        log(f"[{tag}] wrote {README_ROWS} rows to a CSV in {write_s:.3f} s "
            f"({os.path.getsize(path) / 1e6:.1f} MB)")
        wf, reader, prediction = readme_example(path)
        tracer = obs_trace.reset_tracer()
        kernels.reset_launches()
        stage_targets = readme_stage_targets()
        with kernel_inputs(kernels) as kept, \
                selector_walls(True, extra=stage_targets) as rec:
            t0 = time.perf_counter()
            model = wf.train()
            train_s = time.perf_counter() - t0
        train_launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
        spans = tracer.spans()
        data = reader.generate_dataset(wf.raw_features)
        kernels.reset_launches()
        with kernel_inputs(kernels) as score_kept:
            t0 = time.perf_counter()
            scored = model.score(data)
            score_s = time.perf_counter() - t0
        score_launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    reads = {sp["attrs"]["format"]: sp for sp in spans
             if sp["name"] == "ingest.read"}
    assert reader.route == "native", reader.route
    assert set(reads) == {"csv", "csv_native"}, spans
    assert reads["csv"]["attrs"]["route"] == "native"
    assert reads["csv"]["attrs"]["rows"] == README_ROWS
    log(f"[{tag}] CSV read {reads['csv']['wall_ms']:.1f} ms (the native "
        f"scan and assembly {reads['csv_native']['wall_ms']:.1f} ms), "
        f"{README_ROWS / (1e-3 * reads['csv']['wall_ms']):.0f} rows/s; "
        f"route {reader.route}")

    walls = rec["walls"]
    fits = sum(walls.get(k, 0.0) for k in FIT_PHASES)
    walls["scoring"] = walls.get("validate", 0.0) - fits
    (chosen,) = [s for s in model.stages if type(s).__name__ == "SelectedModel"]
    summary = chosen.metadata["model_selector_summary"]
    run = {"train_s": train_s, "score_s": score_s, "walls": walls,
           "launches": {"train": train_launches, "score": score_launches},
           "summary": summary, "results": summary["validation_results"],
           "modes": sorted({r["rank_metric_mode"]
                            for r in summary["validation_results"]}),
           "holdout_auroc": float(summary["holdout_metrics"][
               "OpBinaryClassificationEvaluator"]["AuROC"])}
    run["auroc"] = float(OpBinaryClassificationEvaluator().evaluate(
        scored, label_col="survived", pred_col=prediction.name).AuROC)
    log_selector(tag, run)
    for label in sorted({label for _, _, label in stage_targets}):
        log(f"[{tag}] cuda stage {label}: {1e3 * walls.get(label, 0.0):.1f} ms")
    log(f"[{tag}] cuda: train {train_s:.3f} s ({README_ROWS / train_s:.0f} "
        f"rows/s), score {score_s:.3f} s ({README_ROWS / score_s:.0f} "
        "rows/s)")

    assert len(run["results"]) == DEFAULT_CANDIDATES, len(run["results"])
    assert train_launches["fused_moments"] == 1, train_launches
    # one binning per GBT and forest depth group, the 27 GBT and 54 forest
    # validation predictions (no label-aware bucketizers on this path)
    assert train_launches["bin_matrix"] >= 3 + 3 + 27 + 54, train_launches
    assert (SELECTOR_AUROC_RANGE[0] <= run["holdout_auroc"]
            <= SELECTOR_AUROC_RANGE[1]), run["holdout_auroc"]
    for k in kept:
        kept[k] += score_kept[k]
    assert_counted(run, kept)
    pretty = model.summary_pretty()
    best = summary["best_model_type"]
    assert pretty and f"Selected model {best}" in pretty, pretty[:2000]
    assert ("Evaluated 8 OpLogisticRegression, 18 OpRandomForestClassifier, "
            "9 OpGBTClassifier, 8 OpLinearSVC models with AuROC metric."
            in pretty), pretty[:2000]
    assert "Hold Out Set Value" in pretty
    for line in pretty.splitlines()[:24]:
        log(f"[{tag}] summary_pretty | {line}")

    shapes: dict = {}
    hold_path_inputs(kernels, kept, shapes, errs, bin_errs, timings=timings)
    del kept
    log_path_shapes(f"the {tag} path's", shapes)
    return {"run": run, "shapes": shapes, "model": model}


# -- the serving path ------------------------------------------------------------

#: held-out records the served models score (a CSV of its own seed; 50k,
#: not 100k, to keep the whole script well inside its 1 200 s), and the
#: rows the served forest and GBT are fitted on
SERVE_RECORDS = 50_000
SERVE_FIT_ROWS = 200_000
SERVE_SEED, SERVE_FIT_SEED = 7, 11
#: score_batch's batch sizes; batch-of-1 scores this many records
SERVE_BATCHES = (1, 64, 1024, 16384)
SERVE_ONE_CALLS = 200
#: torch-fused rows against numpy-fused rows, in ULPs of the numpy value:
#: the JAX package's tests/test_fused_xla.py ULP_BUDGETS (its XLA backend
#: against its numpy-fused one), copied, but for LR's, which the card
#: forces from 4 to 16: the margins agree to the bit, but CUDA's float64
#: exp differs from numpy's by an ULP, and probability_0 = 1 - p1 turns
#: that into 16 ULP of the smaller probability, the same in each of four
#: runs at 50k and 100k records on an NVIDIA H100 80GB HBM3 at 700 W
SERVE_ULP_BUDGETS = {"lr": 16, "svc": 1, "rf": 1, "gbt": 64}
#: torch-fused probabilities against the loaded model's interpreted
#: score() (the device DAG: float32 heads)
SERVE_SCORE_ATOL = 1e-6
#: the default grids' deepest points (JAX package selector/factories.py:
#: 26-29 and 42-53 for the forest, 56-60 for the GBT)
SERVE_FOREST = dict(num_trees=50, max_depth=12, min_info_gain=0.001,
                    min_instances_per_node=10)
SERVE_GBT = dict(num_trees=20, max_depth=12, min_info_gain=0.001)


def serve_front(path: str, head):
    """README.md's front over the CSV at ``path`` (``age.fill_missing_with
    _mean().z_normalize()``, the label-free ``transmogrify``,
    ``sanity_check``) and ``head`` on it, on the card; returns the
    workflow."""
    import transmogrifai_tpu_torch.dsl  # noqa: F401  feature operators
    from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
    from transmogrifai_tpu_torch.types import feature_types as ft

    survived = FeatureBuilder(ft.RealNN, "survived").as_response()
    sex = FeatureBuilder(ft.PickList, "sex").as_predictor()
    age = FeatureBuilder(ft.Real, "age").as_predictor()
    fare = FeatureBuilder(ft.Real, "fare").as_predictor()
    features = transmogrify([sex, age, fare,
                             age.fill_missing_with_mean().z_normalize()])
    checked = survived.sanity_check(features, remove_bad_features=True)
    pred = head.set_input(survived, checked).get_output()
    return OpWorkflow().set_result_features(pred).set_reader(CSVReader(path))


def serve_rows(rows: list) -> np.ndarray:
    """Result dicts of a one-Prediction model -> [n, k] float64 (prediction,
    rawPrediction_*, probability_*)."""
    return np.array([list(next(iter(r.values())).values()) for r in rows],
                    dtype=np.float64)


def max_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference in ULPs of the wanted float64 value."""
    diff = np.abs(got - want)
    return float(np.max(np.where(diff == 0.0, 0.0,
                                 diff / np.spacing(np.abs(want))),
                        initial=0.0))


def serve_batches(scorer, records: list, bs: int):
    """(rows, per-call walls in s) of ``score_batch`` over ``records`` in
    batches of ``bs`` (SERVE_ONE_CALLS records for a batch of 1)."""
    recs = records[:SERVE_ONE_CALLS] if bs == 1 else records
    rows, walls = [], []
    for i in range(0, len(recs), bs):
        t0 = time.perf_counter()
        rows += scorer.score_batch(recs[i: i + bs])
        walls.append(time.perf_counter() - t0)
    return rows, walls


def head_family(model) -> str:
    (head,) = [s for s in model.stages if hasattr(s, "estimator_ref")]
    kind = type(head.estimator_ref).__name__
    return {"OpLogisticRegression": "lr", "OpLinearSVC": "svc",
            "OpRandomForestClassifier": "rf", "OpGBTClassifier": "gbt"}[kind]


def serve_one(kernels, tag: str, model, rebuild, records: list, data,
              tmp: str, bin_errs: list) -> dict:
    """Save ``model``, load it into ``rebuild()``, serve ``records`` through
    the loaded model's ``score_function()`` on the card (torch-fused) and
    on the host (numpy-fused) at every SERVE_BATCHES size, counted and
    held; returns what the result lines need."""
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

    path = os.path.join(tmp, tag)
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    wf = rebuild()
    t0 = time.perf_counter()
    loaded = OpWorkflowModel.load(path, wf)
    load_s = time.perf_counter() - t0
    assert loaded.device == "cuda" and loaded.schema_contract is not None
    fam = head_family(loaded)
    budget = SERVE_ULP_BUDGETS[fam]
    # the device program's tensors: the served head's inputs and params
    (head,) = [s for s in loaded.stages if hasattr(s, "estimator_ref")]
    est, devices = head.estimator_ref, set()
    predict = est.predict_arrays_torch

    def seen_predict(params, X):
        devices.add(X.device.type)
        devices.update(v.device.type for v in params.values()
                       if isinstance(v, torch.Tensor))
        return predict(params, X)

    est.predict_arrays_torch = seen_predict
    scorer = loaded.score_function()
    numpy_scorer = loaded.score_function(fused_backend="numpy")
    assert scorer.fused_backend == "torch", scorer.fused_reason
    assert scorer.fused_reason is None and scorer.fused.cache == "none"
    assert scorer.fused.device.type == "cuda", scorer.fused.device
    assert numpy_scorer.fused_backend == "numpy"
    log(f"[serve {tag}] saved in {save_s:.3f} s ({size} bytes, files "
        f"{sorted(os.listdir(path))}), loaded in {load_s:.3f} s; head {fam}, "
        f"backend torch on {scorer.fused.device}, plan routes "
        f"{[e[-1]['route'] for e in scorer.fused.plan]}, cache "
        f"{scorer.fused.cache}")

    kernels.reset_launches()
    out = {"save_s": save_s, "load_s": load_s, "bytes": size, "family": fam,
           "batches": {}, "max_ulps": 0.0}
    n_batches = 0
    with kernel_inputs(kernels) as kept:
        for bs in SERVE_BATCHES:
            rows, walls = serve_batches(scorer, records, bs)
            n_batches += len(walls)
            out["batches"][bs] = {"rows": len(rows), "walls": walls,
                                  "torch": serve_rows(rows)}
        launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    est.predict_arrays_torch = predict
    assert devices == {"cuda"}, devices
    want_k2 = n_batches if fam in ("rf", "gbt") else 0
    assert launches == {"fused_moments": 0, "bin_matrix": want_k2}, launches
    assert len(kept["bin_matrix"]) == want_k2
    for args in kept["bin_matrix"]:
        assert args[0].is_cuda
        bin_errs.append(check_bins(kernels, *args))
    out["launches"] = launches
    # one input of each padded row count (the shape bucket), and the
    # launches at each
    out["k2_inputs"] = {int(args[0].shape[0]): args
                        for args in kept["bin_matrix"]}
    out["k2_launches_by_rows"] = {}
    for args in kept["bin_matrix"]:
        m = int(args[0].shape[0])
        out["k2_launches_by_rows"][m] = out["k2_launches_by_rows"].get(m, 0) + 1
    del kept

    for bs in SERVE_BATCHES:
        b = out["batches"][bs]
        rows, walls = serve_batches(numpy_scorer, records, bs)
        want = serve_rows(rows)
        got = b.pop("torch")
        assert got.shape == want.shape, (got.shape, want.shape)
        assert np.array_equal(got[:, 0], want[:, 0]), \
            f"[serve {tag}] predictions differ at batch {bs}"
        # each field's largest distance (raw margins, then probabilities),
        # asserted once every batch size is logged
        k = (got.shape[1] - 1) // 2
        b["ulps"] = {"raw": max_ulps(got[:, 1:1 + k], want[:, 1:1 + k]),
                     "prob": max_ulps(got[:, 1 + k:], want[:, 1 + k:])}
        ulps = max(b["ulps"].values())
        out["max_ulps"] = max(out["max_ulps"], ulps)
        b["numpy_walls"] = walls
        if bs == SERVE_BATCHES[-1]:
            out["rows"] = got
        t_ms = 1e3 * np.array(b["walls"])
        n_ms = 1e3 * np.array(walls)
        b["rows_per_s"] = b["rows"] / (t_ms.sum() / 1e3)
        b["numpy_rows_per_s"] = b["rows"] / (n_ms.sum() / 1e3)
        b["p50_ms"], b["p99_ms"] = (float(np.percentile(t_ms, 50)),
                                    float(np.percentile(t_ms, 99)))
        b["numpy_p50_ms"], b["numpy_p99_ms"] = (
            float(np.percentile(n_ms, 50)), float(np.percentile(n_ms, 99)))
        log(f"[serve {tag}] batch {bs}: {len(t_ms)} calls, torch-fused "
            f"{b['rows_per_s']:.0f} rows/s (p50 {b['p50_ms']:.3f} ms, p99 "
            f"{b['p99_ms']:.3f} ms a call), numpy-fused "
            f"{b['numpy_rows_per_s']:.0f} rows/s (p50 {b['numpy_p50_ms']:.3f}"
            f" ms, p99 {b['numpy_p99_ms']:.3f} ms); predictions equal, raw "
            f"within {b['ulps']['raw']:g} ULP and probabilities within "
            f"{b['ulps']['prob']:g} ULP of numpy-fused (budget {budget})")
    assert out["max_ulps"] <= budget, (
        f"[serve {tag}] torch-fused rows are {out['max_ulps']:g} ULP from "
        f"numpy-fused (budget {budget})")
    # one call of the largest batch, profiled: the card's busy share of
    # the call's wall and where its device time goes
    big = records[:SERVE_BATCHES[-1]]

    def one_call():
        t0 = time.perf_counter()
        scorer.score_batch(big)
        return time.perf_counter() - t0

    wall_s, by_name = profile(one_call)
    out["profiled"] = {"wall_ms": 1e3 * wall_s, "device_ms": log_profile(
        f"serve {tag}", 1e3 * wall_s, by_name, 6,
        what=f"score_batch of {len(big)} records")}
    for m, st in sorted(scorer.fused.bucket_stats.items()):
        log(f"[serve {tag}] bucket {m}: first call {st['compile_ms']:.3f} ms"
            f" (device program {st['first_exec_ms']:.3f} ms)")
    out["bucket_stats"] = dict(scorer.fused.bucket_stats)

    # the loaded model re-scores bit-identically to the model before save
    before = model.score_function(drift_policy=None)
    n_cmp = SERVE_BATCHES[-1]
    assert before.fused_backend == "torch"
    assert np.array_equal(serve_rows(before.score_batch(records[:n_cmp])),
                          out["rows"][:n_cmp]), \
        f"[serve {tag}] the loaded model scores differently from the saved"
    # the interpreted device DAG of the loaded model on the same records
    name = loaded.result_features[0].name
    prob = np.asarray(loaded.score(data)[name].probability, np.float64)
    k = prob.shape[1]
    pdiff = float(np.abs(out["rows"][:, -k:] - prob).max())
    assert pdiff <= SERVE_SCORE_ATOL, pdiff
    log(f"[serve {tag}] the loaded model re-scores {n_cmp} records "
        f"bit-identically to the saved one; torch-fused probabilities within "
        f"{pdiff:.3g} of the loaded model's score() (tolerance "
        f"{SERVE_SCORE_ATOL:g})")
    out["score_pdiff"] = pdiff
    del out["rows"]
    return out


def serve_phase(kernels, readme_model, bin_errs: list,
                readme_build=None) -> dict:
    """``[serve]``: three models served on the card through save ->
    ``OpWorkflowModel.load`` -> ``score_function()``: the README model,
    a forest and a GBT at the default grids' deepest points fitted on the
    README front at SERVE_FIT_ROWS.  Each scores SERVE_RECORDS held-out
    CSV records at every SERVE_BATCHES size, torch-fused against
    numpy-fused; K2 is launched once per tree-head batch and each launch
    is held against its plain version; K2 is timed at the serving shapes.
    ``readme_build(csv path)`` rebuilds the README model's workflow for the
    load (``readme_example``'s by default).  Returns the result lines'
    pieces."""
    import tempfile

    from transmogrifai_tpu_torch.examples.synthetic import write_readme_csv
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier,
        OpRandomForestClassifier,
    )
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        serve_csv = write_readme_csv(os.path.join(tmp, "serve.csv"),
                                     SERVE_RECORDS, seed=SERVE_SEED)
        fit_csv = write_readme_csv(os.path.join(tmp, "fit.csv"),
                                   SERVE_FIT_ROWS, seed=SERVE_FIT_SEED)
        raw = readme_example(serve_csv)[0].raw_features
        data = CSVReader(serve_csv).generate_dataset(raw)
        names = [f.name for f in raw if not f.is_response]
        records = [dict(zip(names, row))
                   for row in zip(*(data[n].to_list() for n in names))]
        log(f"[serve] {len(records)} held-out records from a CSV of seed "
            f"{SERVE_SEED}; fields {names}")
        build = readme_build or (lambda path: readme_example(path)[0])
        out["readme"] = serve_one(
            kernels, "readme", readme_model, lambda: build(serve_csv),
            records, data, tmp, bin_errs)
        for tag, cls, params in (("forest", OpRandomForestClassifier,
                                  SERVE_FOREST),
                                 ("gbt", OpGBTClassifier, SERVE_GBT)):
            t0 = time.perf_counter()
            kernels.reset_launches()
            model = serve_front(fit_csv, cls(**params)).train()
            fit = {w.__name__: w.launches for w in kernels.WRAPPERS}
            fit_s = time.perf_counter() - t0
            log(f"[serve {tag}] {cls.__name__}({params}) fitted on "
                f"{SERVE_FIT_ROWS} rows on the card in {fit_s:.3f} s "
                f"(launches {fit})")
            out[tag] = serve_one(
                kernels, tag, model,
                lambda c=cls, p=params: serve_front(serve_csv, c(**p)),
                records, data, tmp, bin_errs)
            out[tag]["fit_s"], out[tag]["fit_launches"] = fit_s, fit
            del model
    # K2 at the serving shapes: the served forest's own inputs
    shapes = []
    for m in SERVE_BATCHES:
        x, edges, dtype = out["forest"]["k2_inputs"][m]
        b = time_bins(kernels, x, edges, dtype)
        b["serve_launches"] = sum(v["k2_launches_by_rows"].get(m, 0)
                                  for v in (out["forest"], out["gbt"]))
        shapes.append(b)
        log_bins_times(f"serving {tuple(x.shape)} x {edges.shape[1]} edges "
                       f"-> {dtype}", b)
    for v in out.values():
        v.pop("k2_inputs", None)
    out["k2_shapes"] = shapes
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[serve] phase wall {out['wall_s']:.1f} s")
    return out


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
    log_train_fused(tag, s.get("train_fused"))


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


# -- the vectorizer slice: every transmogrify group ------------------------------

#: [full_schema]: the passenger data with its free text and date on the
#: card, and card against a CPU child at SCHEMA_CMP_ROWS; SCHEMA_RECORDS
#: of its rows through score_function()
SCHEMA_ROWS = 1_000_000
SCHEMA_CMP_ROWS = 100_000
SCHEMA_RECORDS = 300
#: [type_lattice]: one feature of each type, card against the CPU child
LATTICE_ROWS = 10_000
#: the date vectorizers' "now", pinned on both sides of every comparison
#: (left at None it is the time of each fit)
REFERENCE_DATE_MS = 1_500_000_000_000.0
LATTICE_TYPES = (
    "Real", "Integral", "Binary", "PickList", "MultiPickList", "Text",
    "TextArea", "Email", "URL", "Phone", "ID", "Date", "DateTime", "DateList",
    "TextList", "Geolocation", "RealMap", "IntegralMap", "BinaryMap",
    "TextMap", "PickListMap", "DateMap", "GeolocationMap", "MultiPickListMap",
)
LATTICE_MAP_BUCKETIZED = ("RealMap", "IntegralMap")
LATTICE_REG_PARAM = 0.1


def full_schema_features():
    """(label, predictors) of the passenger workflow at its full schema:
    the slices' four and boarded (Date) and description (Text)."""
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder

    survived, preds = passenger_features()
    preds += [FeatureBuilder.Date("boarded").as_predictor(),
              FeatureBuilder.Text("description").as_predictor()]
    return survived, preds


def lattice_features():
    """(label, one predictor ``f_<type>`` per LATTICE_TYPES type)."""
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder

    label = FeatureBuilder.RealNN("label").as_response()
    return label, [getattr(FeatureBuilder, t)(f"f_{t.lower()}").as_predictor()
                   for t in LATTICE_TYPES]


def lattice_dataset(n: int, seed: int = 100):
    """The testkit's ``random_dataset`` over one column of each
    LATTICE_TYPES type (``default_generator``, type i from seed
    ``seed + i``, a tenth of the values empty), and a 0/1 ``label``
    planted by this script on the real, integral and pick-list columns
    (a logistic draw; a null counts as the mean)."""
    from transmogrifai_tpu_torch.testkit.random_data import (
        default_generator,
        random_dataset,
    )
    from transmogrifai_tpu_torch.types import feature_types as ftm
    from transmogrifai_tpu_torch.types.columns import NumericColumn
    from transmogrifai_tpu_torch.types.dataset import Dataset

    gens = {f"f_{t.lower()}": (default_generator(
        getattr(ftm, t), seed=seed + i, probability_of_empty=0.1),
        getattr(ftm, t)) for i, t in enumerate(LATTICE_TYPES)}
    ds = random_dataset(gens, n)
    cols = {c: ds[c] for c in ds.column_names()}
    real, integral = cols["f_real"], cols["f_integral"]
    r = np.where(real.mask, real.values, 0.0)
    i = np.where(integral.mask, integral.values, 50.0)
    red = np.array([v == "red" for v in cols["f_picklist"].values], float)
    noise = np.random.RandomState(7).logistic(size=n)
    y = (1.0 * r + 0.03 * (i - 50.0) + 1.5 * red - 0.5 + noise > 0)
    cols["label"] = NumericColumn(y.astype(np.float64), np.ones(n, bool),
                                  ftm.RealNN)
    return Dataset(cols)


def build_vector_slice(device: str, case: str):
    """transmogrify(label=...) with the pinned reference date ->
    SanityChecker -> OpLogisticRegression over the full schema or the
    type lattice; the lattice also bucketizes its numeric maps against the
    label.  Returns (workflow, label, [vector, checked, prediction,
    *map bucketizers])."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.ops.bucketizers import (
        DecisionTreeNumericMapBucketizer,
    )
    from transmogrifai_tpu_torch.ops.transmogrifier import (
        TransmogrifierDefaults,
        transmogrify,
    )
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker

    label, preds = (full_schema_features() if case == "full_schema"
                    else lattice_features())
    vec = transmogrify(preds, label=label, defaults=TransmogrifierDefaults(
        reference_date_ms=REFERENCE_DATE_MS))
    checked = SanityChecker().set_input(label, vec).get_output()
    # the lattice's ~4 200 columns (five 512-wide hash spaces of random
    # words) separate its 10k rows: a ridge keeps the Newton fit identified
    lr_kw = {"reg_param": LATTICE_REG_PARAM} if case == "type_lattice" else {}
    pred = OpLogisticRegression(**lr_kw).set_input(label, checked).get_output()
    out = [vec, checked, pred]
    if case == "type_lattice":
        out += [DecisionTreeNumericMapBucketizer().set_input(label, f)
                .get_output() for f in preds
                if f.ftype.__name__ in LATTICE_MAP_BUCKETIZED]
    wf = OpWorkflow(device=device).set_result_features(*out)
    return wf, label, out


def matrix_digest(col) -> str:
    """SHA-256 of a vector column's float32 values and of every field of
    its metadata: two design matrices with one digest are bit-equal."""
    import dataclasses
    import hashlib

    h = hashlib.sha256(np.ascontiguousarray(col.values, np.float32).tobytes())
    h.update(repr([dataclasses.astuple(m)
                   for m in col.metadata.columns]).encode())
    return h.hexdigest()


def vector_stage_targets() -> list:
    """The slice's host stages and the SanityChecker: each fit and each
    transform."""
    from transmogrifai_tpu_torch.ops import bucketizers, dates, maps, text
    from transmogrifai_tpu_torch.ops.vectorizer_base import (
        SequenceVectorizerModel,
    )
    from transmogrifai_tpu_torch.preparators import sanity_checker
    from transmogrifai_tpu_torch.schema import contract

    return [(text.SmartTextVectorizer, "fit_model", "smart text fit"),
            (dates.DateVectorizer, "fit_model", "date fit"),
            (maps.MapVectorizer, "fit_model", "map fit"),
            (bucketizers.DecisionTreeNumericBucketizer, "fit_model",
             "bucketizers fit"),
            (bucketizers.DecisionTreeNumericMapBucketizer, "fit_model",
             "map bucketizers fit"),
            (SequenceVectorizerModel, "transform_columns",
             "vectorizers transform"),
            (sanity_checker.SanityChecker, "fit_model", "SanityChecker fit"),
            (sanity_checker.SanityCheckerModel, "transform_columns",
             "SanityChecker transform"),
            (contract.SchemaContract, "capture", "schema contract capture")]


def run_vector_slice(device: str, case: str, data, kernels=None) -> dict:
    """Train and score the full-schema or lattice workflow on ``device``
    (each kernel's launches counted in train() and in score() with
    ``kernels``); returns its walls, the design matrix's width and digest,
    the kept columns, the SanityChecker's summary, the map bucketizers'
    splits, the identified LR coefficients, the probabilities and AuROC,
    and the model."""
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )

    wf, label, (vec, checked, pred, *bucketized) = build_vector_slice(
        device, case)
    wf.set_input_dataset(data)
    launches = {}
    if kernels is not None:
        kernels.reset_launches()
    with selector_walls(device == "cuda",
                        extra=vector_stage_targets()) as rec:
        t0 = time.perf_counter()
        model = wf.train()
        t1 = time.perf_counter()
    if kernels is not None:
        launches["train"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
        kernels.reset_launches()
    scored = model.score(data)
    t2 = time.perf_counter()
    if kernels is not None:
        launches["score"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
    auroc = float(OpBinaryClassificationEvaluator().evaluate(
        scored, label_col=label.name, pred_col=pred.name).AuROC)
    (checker,) = [s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel"]
    (lr,) = [s for s in model.stages if s.output_name == pred.name]
    x_kept = scored[checked.name]
    beta, b0 = identified(np.asarray(lr.model_params["beta"], np.float64),
                          float(lr.model_params["intercept"]),
                          np.asarray(x_kept.values), x_kept.metadata)
    out = {
        "train_s": t1 - t0, "score_s": t2 - t1, "walls": rec["walls"],
        "launches": launches, "width": int(scored[vec.name].values.shape[1]),
        "digest": matrix_digest(scored[vec.name]),
        "keep": list(checker.indices_to_keep),
        "summary": checker.metadata["sanity_checker_summary"],
        "splits": [s.metadata["splits_by_key"] for s in model.stages
                   if type(s).__name__ ==
                   "DecisionTreeNumericMapBucketizerModel"],
        "beta": beta, "intercept": b0,
        "prob": np.asarray(scored[pred.name].probability, np.float64),
        "auroc": auroc, "model": model, "vec": vec.name, "pred": pred.name,
    }
    return out


def schema_cpu_main() -> int:
    """``--schema-cpu``: the full-schema workflow at SCHEMA_CMP_ROWS and
    the type lattice at LATTICE_ROWS on the CPU; writes what the card's
    runs are held against to stdout as a pickle."""
    import pickle

    torch.set_num_threads(2)  # the card's phases run beside this process
    torch.set_float32_matmul_precision("highest")
    from transmogrifai_tpu_torch.examples.synthetic import synthetic_passengers

    out = {}
    for case, data in (
            ("full_schema", synthetic_passengers(SCHEMA_CMP_ROWS, seed=42)),
            ("type_lattice", lattice_dataset(LATTICE_ROWS))):
        r = run_vector_slice("cpu", case, data)
        out[case] = {k: v for k, v in r.items() if k != "model"}
    sys.stdout.buffer.write(pickle.dumps(out))
    return 0


def start_schema_cpu() -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, __file__, "--schema-cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def log_vector_slice(tag: str, r: dict, rows: int) -> None:
    s = r["summary"]
    log(f"[{tag}] {'cuda' if r['launches'] else 'cpu'}: train "
        f"{r['train_s']:.3f} s ({rows / r['train_s']:.0f} rows/s), score "
        f"{r['score_s']:.3f} s ({rows / r['score_s']:.0f} rows/s), AuROC "
        f"{r['auroc']:.6f}; design matrix {rows} x {r['width']}, "
        f"SanityChecker kept {s['n_kept']} of {s['n_features']} columns "
        f"on {s['n_rows']} rows; launches {r['launches']}")
    for label, wall in sorted(r["walls"].items()):
        log(f"[{tag}]   stage {label}: {1e3 * wall:.1f} ms")


def compare_vector_slice(tag: str, card: dict, cpu: dict) -> None:
    """Card against CPU on the same rows: the design matrix bit-equal, the
    same kept columns and map splits, the LR's identified coefficients
    within rtol 1e-4, the probabilities within 1e-4, the SanityChecker's
    contingency statistics within 1e-6."""
    assert card["digest"] == cpu["digest"], "the design matrices differ"
    assert card["keep"] == cpu["keep"], (card["keep"], cpu["keep"])
    assert card["splits"] == cpu["splits"], (card["splits"], cpu["splits"])
    np.testing.assert_allclose(card["beta"], cpu["beta"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card["intercept"], cpu["intercept"],
                               rtol=1e-4, atol=1e-5)
    pdiff = float(np.abs(card["prob"] - cpu["prob"]).max())
    assert pdiff <= 1e-4, pdiff
    cv_card = card["summary"]["cramers_v_by_group"]
    cv_cpu = cpu["summary"]["cramers_v_by_group"]
    assert set(cv_card) == set(cv_cpu)
    cv_diff = max([abs(cv_card[g] - cv_cpu[g]) for g in cv_card] or [0.0])
    conf_diff = 0.0
    for a, b in zip(card["summary"]["column_stats"],
                    cpu["summary"]["column_stats"]):
        for k in ("max_rule_confidence", "support"):
            assert (a[k] is None) == (b[k] is None), (a["name"], k)
            if a[k] is not None:
                conf_diff = max(conf_diff, abs(a[k] - b[k]))
    assert cv_diff <= 1e-6 and conf_diff <= 1e-6, (cv_diff, conf_diff)
    log(f"[{tag}] cuda vs cpu: design matrix bit-equal ({card['width']} "
        f"columns, SHA-256 {card['digest'][:16]}), same kept columns "
        f"({len(card['keep'])}) and map splits, max |beta diff| "
        f"{float(np.abs(card['beta'] - cpu['beta']).max()):.3g}, max |prob "
        f"diff| {pdiff:.3g}, AuROC diff {abs(card['auroc'] - cpu['auroc']):.3g}"
        f", max |Cramer's V diff| {cv_diff:.3g}, max |rule confidence or "
        f"support diff| {conf_diff:.3g}")


def serve_full_schema(model, data, vec: str, pred: str) -> dict:
    """score_function() of the full-schema model over its first
    SCHEMA_RECORDS rows: the text and date models have no lowering, so
    the scorer serves interpreted, as the JAX package's does ("pipeline not
    fusable"); its rows equal score() of the same rows (the design matrix
    to the bit, the head's margins within float32 rounding and its
    probabilities within SERVE_SCORE_ATOL: the scorer predicts on numpy in
    float64)."""
    names = [f.name for f in model.raw_features]
    cols = {n: data[n].to_list()[:SCHEMA_RECORDS] for n in names}
    records = [{n: cols[n][r] for n in names} for r in range(SCHEMA_RECORDS)]
    t0 = time.perf_counter()
    scorer = model.score_function()
    t1 = time.perf_counter()
    rows = scorer.score_batch(records)
    t2 = time.perf_counter()
    assert scorer.fused is None and scorer.fused_backend is None, \
        scorer.fused_backend
    reason = scorer.fused_reason or ""
    assert reason.startswith("torch backend unavailable: ") and \
        "does not lower" in reason, reason
    scored = model.score(data.take(np.arange(SCHEMA_RECORDS)))
    want_vec = np.asarray(scored[vec].values)
    got_vec = np.array([r[vec] for r in rows], np.float32)
    assert np.array_equal(got_vec, want_vec), "served design matrix differs"
    want = scored[pred].to_list()
    assert [r[pred]["prediction"] for r in rows] == \
        [w["prediction"] for w in want]
    raw = max(abs(r[pred][k] - w[k]) / max(1.0, abs(w[k]))
              for r, w in zip(rows, want)
              for k in ("rawPrediction_0", "rawPrediction_1"))
    prob = max(abs(r[pred][k] - w[k]) for r, w in zip(rows, want)
               for k in ("probability_0", "probability_1"))
    assert raw <= 1e-6 and prob <= SERVE_SCORE_ATOL, (raw, prob)
    return {"compile_s": t1 - t0, "score_s": t2 - t1, "reason": reason,
            "raw_diff": raw, "prob_diff": prob}


def vector_phases(kernels, errs: list, bin_errs: list,
                  cpu_child: subprocess.Popen, timings: dict) -> dict:
    """``[full_schema]`` and ``[type_lattice]``: the passenger workflow at
    its full schema on SCHEMA_ROWS rows, and one feature of each
    LATTICE_TYPES type on LATTICE_ROWS, each trained and scored on the
    card, counted (K1 in the SanityChecker at the design matrix's full
    width, its d > 256 route; K2 in the label-aware bucketizers and in
    each numeric map key's tree), every kernel call held against its plain
    version and timed at the new shapes, and held against the CPU child;
    the full-schema model served through score_function().  Returns the
    runs and their kernel shapes."""
    import pickle

    from transmogrifai_tpu_torch.examples.synthetic import synthetic_passengers

    # kernel_inputs shims the modules loaded when it starts: load every
    # module of the slice's path first
    build_vector_slice("cuda", "type_lattice")
    out = {}
    # -- [full_schema] ------------------------------------------------------
    tag = "full_schema"
    t0 = time.perf_counter()
    data = synthetic_passengers(SCHEMA_ROWS, seed=42)
    log(f"[{tag}] made {SCHEMA_ROWS} passenger rows with their description "
        f"and boarding date in {time.perf_counter() - t0:.3f} s")
    with kernel_inputs(kernels) as kept:
        run = run_vector_slice("cuda", tag, data, kernels)
    log_vector_slice(tag, run, SCHEMA_ROWS)
    tl, sl = run["launches"]["train"], run["launches"]["score"]
    assert tl["fused_moments"] == 1, tl
    # age, height and weight: one label-aware bucketizer each
    assert tl["bin_matrix"] == 3, tl
    assert AUROC_RANGE[0] <= run["auroc"] <= AUROC_RANGE[1], run["auroc"]
    assert run["width"] > 512, run["width"]
    assert_counted(run, kept)
    shapes: dict = {}
    hold_path_inputs(kernels, kept, shapes, errs, bin_errs, timings=timings)
    del kept
    log_path_shapes(f"the {tag} path's", shapes)
    served = serve_full_schema(run["model"], data, run["vec"], run["pred"])
    log(f"[{tag}] score_function() over {SCHEMA_RECORDS} records: "
        f"interpreted (fused_backend None: {served['reason'][:160]}), "
        f"compiled in {served['compile_s']:.3f} s, scored in "
        f"{served['score_s']:.3f} s; design matrix equal to score()'s, "
        f"margins within {served['raw_diff']:.3g} relative, probabilities "
        f"within {served['prob_diff']:.3g}")
    del data, run["model"]
    out[tag] = {"run": run, "shapes": shapes, "served": served}

    cmp_card = run_vector_slice(
        "cuda", tag, synthetic_passengers(SCHEMA_CMP_ROWS, seed=42), kernels)
    log_vector_slice(f"{tag} {SCHEMA_CMP_ROWS} rows", cmp_card, SCHEMA_CMP_ROWS)
    t0 = time.perf_counter()
    cout, cerr = cpu_child.communicate(timeout=900)
    assert cpu_child.returncode == 0, (
        f"the CPU vector-slice run failed ({cpu_child.returncode}): "
        f"{cerr.decode()[-3000:]}")
    cpu = pickle.loads(cout)
    log(f"[{tag}] waited {time.perf_counter() - t0:.1f} s for the CPU child")
    log_vector_slice(f"{tag} {SCHEMA_CMP_ROWS} rows", cpu[tag], SCHEMA_CMP_ROWS)
    compare_vector_slice(f"{tag} {SCHEMA_CMP_ROWS} rows", cmp_card, cpu[tag])

    # -- [type_lattice] -----------------------------------------------------
    tag = "type_lattice"
    t0 = time.perf_counter()
    ldata = lattice_dataset(LATTICE_ROWS)
    log(f"[{tag}] the testkit drew {LATTICE_ROWS} rows of "
        f"{len(LATTICE_TYPES)} types in {time.perf_counter() - t0:.3f} s")
    with kernel_inputs(kernels) as kept:
        lat = run_vector_slice("cuda", tag, ldata, kernels)
    log_vector_slice(tag, lat, LATTICE_ROWS)
    tl = lat["launches"]["train"]
    n_keys = sum(len(s) for s in lat["splits"])
    assert tl["fused_moments"] == 1, tl
    # the real and integral bucketizers, and one tree per numeric map key
    assert n_keys == 2 * 3 and tl["bin_matrix"] == 2 + n_keys, (tl, n_keys)
    assert lat["width"] > 4000, lat["width"]
    assert_counted(lat, kept)
    lshapes: dict = {}
    hold_path_inputs(kernels, kept, lshapes, errs, bin_errs, timings=timings)
    del kept
    log_path_shapes(f"the {tag} path's", lshapes)
    log(f"[{tag}] map bucketizer splits by key: {lat['splits']}")
    del lat["model"]
    compare_vector_slice(tag, lat, cpu[tag])
    out[tag] = {"run": lat, "shapes": lshapes}
    return out


# -- the remaining model families and training services ------------------------
# ``[families]``: the RawFeatureFilter and its blacklist surgery, a
# binary selector over the logistic regression and the MLP, a regression
# selector over the GLM, the other GLM families, LOCO record insights, LDA
# and word2vec, the CV checkpoint and score_function() of the MLP and GLM
# heads, on the card, and against a CPU child (``--families-cpu N``).

FAMILIES_ROWS = 1_000_000
FAMILIES_SCORE_ROWS = 100_000      # the RawFeatureFilter's scoring set
FAMILIES_CMP_ROWS = 100_000        # card against the CPU child
FAMILIES_SPARSE_ROWS = 0.0001      # the drill feature's fill rate (< 0.001)
FAMILIES_MLP_GRID = [{"hidden_layers": (10, 10)}, {"hidden_layers": (20,)}]
FAMILIES_MLP_ITER = 200
FAMILIES_GLM_REGS = (0.0, 0.01, 0.1)
FAMILIES_CMP_MODE = "exact"        # TX_CV_RANK_METRICS on both sides
LOCO_FIT_ROWS = 100_000
LOCO_ROWS = 10_000
LOCO_FOREST = dict(num_trees=50, max_depth=12, min_info_gain=0.001,
                   backend="native")
LDA_DOCS = 20_000
LDA_K = 10
FAMILIES_RECORDS = 1_000
#: (ULP, absolute floor) of torch-fused against numpy-fused rows, copied
#: from the JAX package's tests/test_fused_xla.py:56-61
FAMILIES_ULP_BUDGETS = {"glm": (1, 0.0), "mlp": (64, 1e-9)}
CMP_GLM_RTOL = 1e-5                # GLM CV means, card against CPU
CMP_MLP_ATOL = 1e-3                # MLP CV means, the winner's probabilities
#: an MLP's own probabilities, card against CPU: full-batch Adam turns the
#: float32 sums' other order into sign-like steps where a gradient is near
#: zero, and after 100 steps the weights of two devices part as far as
#: those of one device's row-chunked and unchunked fits (2e-3 to 8e-3 at
#: 20k rows on an H100); measured and logged, held at this bound
CMP_MLP_PROB_ATOL = 5e-2
CMP_LDA_RTOL = 1e-4                # LDA topics
CMP_W2V_ATOL = 1e-3                # word2vec vectors (measured, recorded)


def families_data(n: int, n_score: int, seed: int = 42):
    """(train, scoring) for the families phase: ``synthetic_passengers_
    labelled`` with ``sparse`` (a Real filled on FAMILIES_SPARSE_ROWS of
    the rows, under the RawFeatureFilter's minimum fill rate); the scoring
    set from another seed with every ``weight`` at the training maximum
    (its distribution moved past the JS-divergence limit; weight is no
    part of the planted latent)."""
    from transmogrifai_tpu_torch.examples.synthetic import (
        synthetic_passengers_labelled,
    )
    from transmogrifai_tpu_torch.types.columns import NumericColumn
    from transmogrifai_tpu_torch.types.feature_types import Real

    out = []
    w_max = None
    for rows, s in ((n, seed), (n_score, seed + 1000)):
        ds = synthetic_passengers_labelled(rows, seed=s, with_text=False)
        if w_max is None:
            w_max = float(np.max(ds["weight"].values))
        else:
            ds = ds.with_column("weight", NumericColumn(
                np.full(rows, w_max), np.ones(rows, bool), Real))
        mask = np.random.RandomState(s + 7).rand(rows) < FAMILIES_SPARSE_ROWS
        ds = ds.with_column("sparse", NumericColumn(
            np.where(mask, 1.5, 0.0), mask, Real))
        out.append(ds)
    return tuple(out)


def families_predictors():
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder

    _, preds = passenger_features()
    return preds + [FeatureBuilder.Real("sparse").as_predictor()]


def run_families_binary(device: str, train, score, kernels=None) -> dict:
    """transmogrify -> SanityChecker -> BinaryClassificationModelSelector
    over the LR grid and the MLP's, behind with_raw_feature_filter(
    RawFeatureFilter(scoring_data=score)); train(), the holdout AuROC and
    bin scores, the stage metrics; with ``kernels``, each kernel's
    launches in train() and score()."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator, OpBinScoreEvaluator,
    )
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
    from transmogrifai_tpu_torch.filters.raw_feature_filter import (
        RawFeatureFilter,
    )
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.models.mlp import (
        OpMultilayerPerceptronClassifier,
    )
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.selector import factories

    survived = FeatureBuilder.RealNN("survived").as_response()
    vec = transmogrify(families_predictors())
    checked = SanityChecker().set_input(survived, vec).get_output()
    sel = factories.BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=[
            (OpLogisticRegression(), factories.lr_grid()),
            (OpMultilayerPerceptronClassifier(max_iter=FAMILIES_MLP_ITER),
             FAMILIES_MLP_GRID)])
    pred = sel.set_input(survived, checked).get_output()
    wf = (OpWorkflow(device=device).set_result_features(pred, checked)
          .set_input_dataset(train)
          .with_raw_feature_filter(RawFeatureFilter(scoring_data=score)))
    counts = {}
    if kernels is not None:
        kernels.reset_launches()
    mlp_cls = OpMultilayerPerceptronClassifier
    with selector_walls(device == "cuda", extra=(
            (mlp_cls, "fit_arrays_folds", "mlp_folds"),
            (mlp_cls, "predict_arrays", "mlp_predict"))) as rec:
        t0 = time.perf_counter()
        model = wf.train()
        t1 = time.perf_counter()
    if kernels is not None:
        counts["train"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
        kernels.reset_launches()
    t2 = time.perf_counter()
    scored = model.score(train)
    t3 = time.perf_counter()
    if kernels is not None:
        counts["score"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
    (chosen,) = [s for s in model.stages if type(s).__name__ == "SelectedModel"]
    (checker,) = [s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel"]
    summary = chosen.metadata["model_selector_summary"]
    bins = model.evaluate_holdout(OpBinScoreEvaluator())
    holdout = model.evaluate_holdout(OpBinaryClassificationEvaluator())
    col = scored[pred.name]
    return {
        "model": model, "train_s": t1 - t0, "score_s": t3 - t2,
        "walls": rec["walls"], "launches": counts, "summary": summary,
        "results": summary["validation_results"],
        "winner": [summary["best_model_type"], summary["best_params"]],
        "keep": checker.indices_to_keep,
        "blacklist": sorted(f.name for f in model.blacklisted_features
                            if f.is_raw()),
        "map_keys": wf.blacklisted_map_keys,
        "dropped": wf.rff_results["dropped"],
        "holdout_auroc": holdout.AuROC,
        "brier": bins.brier_score, "bin_counts": bins.n_per_bin,
        "stage_metrics": model.summary_json()["stageMetrics"],
        "prob": np.asarray(col.probability[:, 1], np.float64),
        "design": (np.asarray(scored[checked.name].values),
                   np.asarray(train["survived"].values)),
        "width": int(np.asarray(scored[vec.name].values).shape[1]),
        "pred": pred.name,
    }


def run_families_regression(device: str, data, kernels=None) -> dict:
    """transmogrify -> SanityChecker -> RegressionModelSelector over the
    gaussian GLM at FAMILIES_GLM_REGS, on ``response``."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.glm import OpGeneralizedLinearRegression
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.selector import factories

    label = FeatureBuilder.RealNN("response").as_response()
    _, preds = passenger_features()
    vec = transmogrify(preds)
    checked = SanityChecker().set_input(label, vec).get_output()
    sel = factories.RegressionModelSelector.with_cross_validation(
        models_and_parameters=[(OpGeneralizedLinearRegression(),
                                [{"reg_param": r} for r in FAMILIES_GLM_REGS])])
    pred = sel.set_input(label, checked).get_output()
    wf = OpWorkflow(device=device).set_result_features(pred, checked) \
        .set_input_dataset(data)
    counts = {}
    if kernels is not None:
        kernels.reset_launches()
    t0 = time.perf_counter()
    model = wf.train()
    t1 = time.perf_counter()
    if kernels is not None:
        counts["train"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
        kernels.reset_launches()
    scored = model.score(data)
    if kernels is not None:
        counts["score"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
    (chosen,) = [s for s in model.stages if type(s).__name__ == "SelectedModel"]
    summary = chosen.metadata["model_selector_summary"]
    return {
        "model": model, "train_s": t1 - t0, "launches": counts,
        "summary": summary, "results": summary["validation_results"],
        "winner": [summary["best_model_type"], summary["best_params"]],
        "holdout": summary["holdout_metrics"]["OpRegressionEvaluator"],
        "design": (np.asarray(scored[checked.name].values),
                   np.asarray(data["response"].values)),
        "pred": pred.name,
    }


def run_unsupervised(device: str, n_docs: int) -> dict:
    """OpLDA (k LDA_K) over the count vectors of the full-schema
    ``description`` tokens of ``n_docs`` passengers, and OpWord2Vec at its
    defaults over the same tokens."""
    import transmogrifai_tpu_torch.dsl  # noqa: F401 - the Feature methods
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.examples.synthetic import synthetic_passengers
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder

    data = synthetic_passengers(n_docs, seed=42)
    toks = FeatureBuilder.Text("description").as_predictor().tokenize()
    counts = toks.count_vec(vocab_size=1000)
    topics = counts.lda(k=LDA_K)
    emb = toks.word2vec()
    wf = OpWorkflow(device=device).set_result_features(topics, emb) \
        .set_input_dataset(data)
    t0 = time.perf_counter()
    model = wf.train()
    t1 = time.perf_counter()
    lda = [s for s in model.stages if type(s).__name__ == "OpLDAModel"][0]
    w2v = [s for s in model.stages if type(s).__name__ == "OpWord2VecModel"][0]
    scored = model.score()
    return {"train_s": t1 - t0, "topics": np.asarray(lda.topics),
            "theta": np.asarray(scored[topics.name].values),
            "vocab": dict(w2v.vocab), "vectors": np.asarray(w2v.vectors),
            "v": int(np.asarray(scored[counts.name].values).shape[1]),
            "similar": w2v.similar_words(sorted(w2v.vocab)[0], 3)}


def run_families_mlp(device: str, data) -> dict:
    """transmogrify -> SanityChecker -> the MLP (FAMILIES_MLP_GRID[0],
    FAMILIES_MLP_ITER Adam steps) trained on ``data``; its probabilities
    of the first LOCO_ROWS rows."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.mlp import (
        OpMultilayerPerceptronClassifier,
    )
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker

    survived = FeatureBuilder.RealNN("survived").as_response()
    _, preds = passenger_features()
    checked = SanityChecker().set_input(
        survived, transmogrify(preds)).get_output()
    mlp = OpMultilayerPerceptronClassifier(
        max_iter=FAMILIES_MLP_ITER, **FAMILIES_MLP_GRID[0]).set_input(
        survived, checked).get_output()
    t0 = time.perf_counter()
    model = OpWorkflow(device=device).set_result_features(mlp, checked) \
        .set_input_dataset(data).train()
    t1 = time.perf_counter()
    col = model.score()[mlp.name]
    return {"model": model, "pred": mlp.name, "vec": checked.name,
            "train_s": t1 - t0,
            "prob": np.asarray(col.probability[:LOCO_ROWS, 1], np.float64)}


def families_cmp_view(b: dict, r: dict, u: dict, m: dict) -> dict:
    """What the card's 100k runs are held against, as the CPU child
    pickles it."""
    return {
        "mlp": {k: m[k] for k in ("train_s", "prob")},
        "binary": {k: b[k] for k in ("train_s", "results", "winner", "keep",
                                     "blacklist", "map_keys", "dropped",
                                     "prob", "holdout_auroc")},
        "regression": {k: r[k] for k in ("train_s", "results", "winner",
                                         "holdout")},
        "unsupervised": {k: u[k] for k in ("train_s", "topics", "theta",
                                           "vocab", "vectors")},
    }


def families_cpu_main(rows: int) -> int:
    """``--families-cpu N``: the families selectors (N training rows, N / 10
    scoring rows) and LDA and word2vec (LDA_DOCS documents) on the CPU;
    writes what the card's runs are held against to stdout as a pickle."""
    import pickle

    os.environ["TX_CV_RANK_METRICS"] = FAMILIES_CMP_MODE
    torch.set_num_threads(2)  # the card's phases run beside this process
    torch.set_float32_matmul_precision("highest")
    train, score = families_data(rows, rows // 10)
    b = run_families_binary("cpu", train, score)
    r = run_families_regression("cpu", train)
    u = run_unsupervised("cpu", LDA_DOCS)
    m = run_families_mlp("cpu", train)
    sys.stdout.buffer.write(pickle.dumps(families_cmp_view(b, r, u, m)))
    return 0


def start_families_cpu() -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, __file__, "--families-cpu", str(FAMILIES_CMP_ROWS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def serve_family(model, data, pred: str, tag: str) -> dict:
    """score_function() of ``model`` over FAMILIES_RECORDS records of
    ``data``: torch-fused on the card against numpy-fused on the host, a
    classifier's predictions equal and every float of the result
    ``pred`` within the family's ULP budget (or its absolute floor)."""
    names = [f.name for f in model.raw_features if not f.is_response]
    cols = {n: data[n].to_list()[:FAMILIES_RECORDS] for n in names}
    records = [{n: cols[n][i] for n in names} for i in range(FAMILIES_RECORDS)]
    scorer = model.score_function()
    numpy_scorer = model.score_function(fused_backend="numpy")
    assert scorer.fused_backend == "torch", scorer.fused_reason
    assert scorer.fused.device.type == "cuda", scorer.fused.device
    def rows_of(rows):
        return np.array([list(r[pred].values()) for r in rows], np.float64)

    t0 = time.perf_counter()
    got = rows_of(scorer.score_batch(records))
    t1 = time.perf_counter()
    want = rows_of(numpy_scorer.score_batch(records))
    t2 = time.perf_counter()
    if got.shape[1] > 1:  # a classifier: the same class, then the floats
        assert np.array_equal(got[:, 0], want[:, 0]), \
            f"[{tag}] predictions differ"
        got, want = got[:, 1:], want[:, 1:]
    ulps = max_ulps(got, want)
    absd = float(np.abs(got - want).max())
    budget, floor = FAMILIES_ULP_BUDGETS[tag]
    assert ulps <= budget or absd <= floor, (tag, ulps, absd)
    return {"ulps": ulps, "abs": absd, "budget": budget, "floor": floor,
            "torch_s": t1 - t0, "numpy_s": t2 - t1}


def loco_run(kernels, model, data, vec: str, rows: int) -> dict:
    """RecordInsightsLOCO (top 20) over the first ``rows`` rows of
    ``data``'s vector column ``vec`` under ``model``'s fitted head;
    counted."""
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
    from transmogrifai_tpu_torch.insights.loco import RecordInsightsLOCO
    from transmogrifai_tpu_torch.types.dataset import Dataset

    (head,) = [s for s in model.stages if hasattr(s, "estimator_ref")
               and type(s).__name__ in ("PredictorModel", "SelectedModel")]
    col = data[vec].take(np.arange(rows))
    stage = RecordInsightsLOCO(head, top_k=20)
    feat = stage.set_input(FeatureBuilder.OPVector(vec).as_predictor()) \
        .get_output()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = stage.transform(Dataset({vec: col}))[feat.name].values
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    return {"wall_s": wall, "launches": launches, "width": col.values.shape[1],
            "first": out[0], "rows": len(out)}


def families_phase(kernels, errs: list, bin_errs: list,
                   cpu_child: subprocess.Popen, timings: dict) -> dict:
    """``[families]``: the remaining model families and training services on
    the card (see the block comment above), counted, every kernel call held
    against its plain version, then against the CPU child."""
    import pickle

    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.examples import synthetic
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.glm import OpGeneralizedLinearRegression
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.models.mlp import (
        OpMultilayerPerceptronClassifier,
    )
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.selector import factories
    from transmogrifai_tpu_torch.selector.validator import OpCrossValidation

    tag = "families"
    out: dict = {"shapes": {}, "launches": {}}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    train, score = families_data(FAMILIES_ROWS, FAMILIES_SCORE_ROWS)
    log(f"[{tag}] made {FAMILIES_ROWS} training and {FAMILIES_SCORE_ROWS} "
        f"scoring rows in {time.perf_counter() - t0:.3f} s")

    # -- the binary selector behind the RawFeatureFilter --------------------
    # kernel_inputs shims the modules loaded when it starts
    build_problem_selector("cuda", "regression")
    with kernel_inputs(kernels) as kept:
        b = run_families_binary("cuda", train, score, kernels)
    assert_counted(b, kept)
    out["launches"]["binary"] = b["launches"]
    assert b["launches"]["train"]["fused_moments"] == 1, b["launches"]
    assert {"weight", "sparse"} <= set(b["blacklist"]), b["blacklist"]
    assert TREE_AUROC_RANGE[0] <= b["holdout_auroc"] <= TREE_AUROC_RANGE[1], \
        b["holdout_auroc"]
    w = b["walls"]
    log(f"[{tag}] binary selector (LR {len(factories.lr_grid())}, MLP "
        f"{len(FAMILIES_MLP_GRID)}) behind the RawFeatureFilter: train "
        f"{b['train_s']:.3f} s (validate {w.get('validate', 0.0):.3f} s: "
        f"lr_batch {w.get('lr_batch', 0.0):.3f} s, mlp_folds "
        f"{w.get('mlp_folds', 0.0):.3f} s, mlp_predict "
        f"{w.get('mlp_predict', 0.0):.3f} s; refit {w.get('refit', 0.0):.3f} "
        f"s), score {b['score_s']:.3f} s; blacklist {b['blacklist']}, map keys {b['map_keys']}, dropped "
        f"{json.dumps(b['dropped'])[:300]}; width {b['width']}, kept "
        f"{len(b['keep'])}; winner {b['winner']}; holdout AuROC "
        f"{b['holdout_auroc']:.6f} (gate {TREE_AUROC_RANGE}); launches "
        f"{b['launches']}")
    for c in b["results"]:
        log(f"[{tag}]   {c['model_type']} {json.dumps(c['params'], sort_keys=True)}: "
            f"mean AuROC {c['metric']:.6f} ({c['rank_metric_mode']})")
    log_train_fused(tag, b["summary"].get("train_fused"))
    log(f"[{tag}] OpBinScoreEvaluator on the holdout: Brier "
        f"{b['brier']:.6f}, rows per bin (100 bins) "
        f"{[c for c in b['bin_counts'] if c][:12]}...")
    sm = b["stage_metrics"]
    log(f"[{tag}] stageMetrics: {len(sm['stages'])} records, total "
        f"{sm['total_wall_s']:.3f} s, by operation "
        f"{json.dumps({k: round(v, 4) for k, v in sm['by_operation'].items()})}")
    hold_path_inputs(kernels, kept, out["shapes"], errs, bin_errs,
                     timings=timings)
    del kept

    # -- the regression selector over the GLM -------------------------------
    with kernel_inputs(kernels) as kept:
        r = run_families_regression("cuda", train, kernels)
    assert_counted(r, kept)
    out["launches"]["regression"] = r["launches"]
    ceiling = synthetic.BEST_RMSE_OBSERVED
    rmse = r["holdout"]["RootMeanSquaredError"]
    lo, hi = RMSE_GATE[0] * ceiling, RMSE_GATE[1] * ceiling
    assert lo <= rmse <= hi, (rmse, lo, hi)
    assert r["winner"][0] == "OpGeneralizedLinearRegression", r["winner"]
    log(f"[{tag}] regression selector (GLM gaussian at regs "
        f"{FAMILIES_GLM_REGS}): train {r['train_s']:.3f} s, winner "
        f"{r['winner']}, holdout RMSE {rmse:.6f} in [{lo:.6f}, {hi:.6f}] "
        f"(planted ceiling {ceiling}); launches {r['launches']}")
    hold_path_inputs(kernels, kept, out["shapes"], errs, bin_errs,
                     timings=timings)
    del kept

    # -- the other GLM families on a count or positive target ---------------
    X, resp = r["design"]
    rng = np.random.RandomState(11)
    mu = np.exp(0.4 * resp)
    n_ev = rng.poisson(0.8 * mu)
    targets = {"poisson": rng.poisson(mu).astype(np.float64),
               "gamma": rng.gamma(2.0, mu / 2.0),
               "tweedie": np.where(n_ev > 0, rng.gamma(
                   np.maximum(2.0 * n_ev, 1e-9), 0.6), 0.0)}
    for fam, kw in (("poisson", {}), ("gamma", {}),
                    ("tweedie", {"link_power": 0.0}),
                    ("tweedie", {"link_power": -0.5})):
        y = targets[fam]
        est = OpGeneralizedLinearRegression(family=fam, reg_param=0.01, **kw)
        t0 = time.perf_counter()
        p = est.fit_arrays(X, y)
        fit_s = time.perf_counter() - t0
        pred = est.predict_arrays(p, X)[0]
        rel = abs(pred.mean() - y.mean()) / y.mean()
        assert np.isfinite(p["beta"]).all() and rel < 0.1, (fam, kw, rel)
        log(f"[{tag}] GLM {fam} {kw or ''}: fit {fit_s:.3f} s at "
            f"{X.shape}, mean prediction {pred.mean():.5f} against the "
            f"target's {y.mean():.5f} ({rel:.2e} apart)")

    # -- the CV checkpoint ----------------------------------------------------
    import tempfile

    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )

    Xb, yb = b["design"]
    Xb, yb = Xb[:FAMILIES_CMP_ROWS], yb[:FAMILIES_CMP_ROWS]
    models = [(OpLogisticRegression(), factories.lr_grid()),
              (OpMultilayerPerceptronClassifier(max_iter=FAMILIES_MLP_ITER),
               FAMILIES_MLP_GRID)]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "cv.json")
        cv = OpCrossValidation(evaluator=OpBinaryClassificationEvaluator(),
                               checkpoint_path=ckpt)
        t0 = time.perf_counter()
        first = cv.validate(models, Xb, yb)
        t1 = time.perf_counter()
        saved = json.load(open(ckpt))
        fits = []

        def no_fit(*args, **kw):
            fits.append(1)
            raise AssertionError("a restored candidate was refitted")

        patched = []
        for est, _ in models:
            for name in ("fit_arrays_batched", "fit_arrays_folds",
                         "fit_arrays"):
                if hasattr(type(est), name):
                    patched.append((type(est), name, getattr(type(est), name)))
                    setattr(type(est), name, no_fit)
        try:
            t2 = time.perf_counter()
            again = OpCrossValidation(
                evaluator=OpBinaryClassificationEvaluator(),
                checkpoint_path=ckpt).validate(models, Xb, yb)
            t3 = time.perf_counter()
        finally:
            for cls, name, fn in patched:
                setattr(cls, name, fn)
        assert not fits
        same = (again.best_params == first.best_params
                and again.best_metric == first.best_metric
                and [r_["fold_metrics"] for r_ in again.all_results]
                == [r_["fold_metrics"] for r_ in first.all_results])
        assert same, "the restored ValidationResult differs"
        assert os.path.exists(ckpt + ".heartbeat")
    log(f"[{tag}] CV checkpoint at {Xb.shape}: validate {t1 - t0:.3f} s "
        f"wrote {len(saved)} rows ({sorted(saved)[0][:60]}...); the second "
        f"validate restored every row in {t3 - t2:.3f} s, fitted nothing "
        "and gave the same ValidationResult")

    # -- LOCO over a forest (K2 each pass) and the MLP; serving ------------
    _, preds = passenger_features()
    survived = FeatureBuilder.RealNN("survived").as_response()
    lvec = transmogrify(preds, label=survived)
    forest = OpRandomForestClassifier(**LOCO_FOREST).set_input(
        survived, lvec).get_output()
    fdata = train.take(np.arange(LOCO_FIT_ROWS))
    with kernel_inputs(kernels) as kept:
        kernels.reset_launches()
        t0 = time.perf_counter()
        fmodel = OpWorkflow().set_result_features(forest, lvec) \
            .set_input_dataset(fdata).train()
        fit_s = time.perf_counter() - t0
        fit_launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
        fscored = fmodel.score()
        loco_f = loco_run(kernels, fmodel, fscored, lvec.name, LOCO_ROWS)
    assert loco_f["launches"]["bin_matrix"] == loco_f["width"] + 1, loco_f
    assert loco_f["launches"]["fused_moments"] == 0, loco_f
    assert len(kept["bin_matrix"]) == (fit_launches["bin_matrix"]
                                       + loco_f["launches"]["bin_matrix"])
    out["launches"]["loco_forest_fit"] = fit_launches
    out["launches"]["loco_forest"] = loco_f["launches"]
    log(f"[{tag}] a {LOCO_FOREST['num_trees']}-tree depth-"
        f"{LOCO_FOREST['max_depth']} forest on the host C++ learner "
        f"(backend='native') at {LOCO_FIT_ROWS} rows, width "
        f"{loco_f['width']}: train {fit_s:.3f} s, launches {fit_launches}; "
        f"LOCO over {LOCO_ROWS} rows in {loco_f['wall_s']:.3f} s, "
        f"{loco_f['launches']['bin_matrix']} K2 launches (one a zero-out "
        f"pass and the base pass); row 0's top keys "
        f"{list(loco_f['first'])[:4]}")
    hold_path_inputs(kernels, kept, out["shapes"], errs, bin_errs,
                     timings=timings)
    del kept

    # the MLP: trained on the card-against-CPU rows, so its probabilities
    # are held against the CPU child's below
    ctrain, cscore = families_data(FAMILIES_CMP_ROWS, FAMILIES_CMP_ROWS // 10)
    m = run_families_mlp("cuda", ctrain)
    mmodel = m["model"]
    loco_m = loco_run(kernels, mmodel, mmodel.score(), m["vec"], LOCO_ROWS)
    log(f"[{tag}] the MLP {FAMILIES_MLP_GRID[0]} at {FAMILIES_CMP_ROWS} "
        f"rows: train {m['train_s']:.3f} s; LOCO over {LOCO_ROWS} rows in "
        f"{loco_m['wall_s']:.3f} s (width {loco_m['width']}), row 0's top "
        f"keys {list(loco_m['first'])[:4]}")
    out["launches"]["loco_mlp"] = loco_m["launches"]
    served = {"mlp": serve_family(mmodel, ctrain, m["pred"], "mlp"),
              "glm": serve_family(r["model"], train, r["pred"], "glm")}
    for fam, s in served.items():
        log(f"[{tag}] score_function() of the {fam} head over "
            f"{FAMILIES_RECORDS} records: torch-fused on the card "
            f"{s['torch_s']:.3f} s, numpy-fused {s['numpy_s']:.3f} s; "
            f"predictions equal, {s['ulps']:g} ULP apart at most (budget "
            f"{s['budget']}, floor {s['floor']:g}; max |diff| {s['abs']:.3g})")
    out["served"] = served

    # -- LDA and word2vec -----------------------------------------------------
    u = run_unsupervised("cuda", LDA_DOCS)
    log(f"[{tag}] LDA (k {LDA_K}) over {LDA_DOCS} documents x {u['v']} terms "
        f"and word2vec (vocabulary {len(u['vocab'])}, {u['vectors'].shape[1]}"
        f" dimensions): train {u['train_s']:.3f} s; similar to "
        f"{sorted(u['vocab'])[0]!r}: {u['similar']}")

    # -- card against the CPU child -----------------------------------------
    os.environ["TX_CV_RANK_METRICS"] = FAMILIES_CMP_MODE
    try:
        cb = run_families_binary("cuda", ctrain, cscore)
        cr = run_families_regression("cuda", ctrain)
    finally:
        del os.environ["TX_CV_RANK_METRICS"]
    card = families_cmp_view(cb, cr, u, m)
    t0 = time.perf_counter()
    cout, cerr = cpu_child.communicate(timeout=900)
    assert cpu_child.returncode == 0, (
        f"the CPU families run failed ({cpu_child.returncode}): "
        f"{cerr.decode()[-3000:]}")
    cpu = pickle.loads(cout)
    log(f"[{tag}] waited {time.perf_counter() - t0:.1f} s for the CPU child "
        f"(binary train {cpu['binary']['train_s']:.3f} s, regression "
        f"{cpu['regression']['train_s']:.3f} s, unsupervised "
        f"{cpu['unsupervised']['train_s']:.3f} s)")
    cbin, pbin = card["binary"], cpu["binary"]
    for k in ("blacklist", "map_keys", "keep"):
        assert cbin[k] == pbin[k], (k, cbin[k], pbin[k])
    assert json.dumps(cbin["dropped"], sort_keys=True) == \
        json.dumps(pbin["dropped"], sort_keys=True)
    diffs = {"LR": 0.0, "MLP": 0.0, "GLM": 0.0}
    for c_gpu, c_cpu in zip(cbin["results"], pbin["results"]):
        assert (c_gpu["model_type"], c_gpu["params"]) == \
            (c_cpu["model_type"], c_cpu["params"])
        d = abs(c_gpu["metric"] - c_cpu["metric"])
        is_mlp = c_gpu["model_type"].startswith("OpMultilayer")
        assert d <= (CMP_MLP_ATOL if is_mlp else CMP_METRIC_ATOL["exact"]), \
            (c_gpu, c_cpu)
        key = "MLP" if is_mlp else "LR"
        diffs[key] = max(diffs[key], d)
    assert cbin["winner"] == pbin["winner"], (cbin["winner"], pbin["winner"])
    pdiff = float(np.abs(cbin["prob"] - pbin["prob"]).max())
    assert pdiff <= CMP_MLP_ATOL, pdiff
    mlp_d = float(np.abs(card["mlp"]["prob"] - cpu["mlp"]["prob"]).max())
    assert mlp_d <= CMP_MLP_PROB_ATOL, mlp_d
    creg, preg = card["regression"], cpu["regression"]
    assert creg["winner"] == preg["winner"]
    for c_gpu, c_cpu in zip(creg["results"], preg["results"]):
        d = abs(c_gpu["metric"] - c_cpu["metric"]) / abs(c_cpu["metric"])
        assert d <= CMP_GLM_RTOL, (c_gpu, c_cpu)
        diffs["GLM"] = max(diffs["GLM"], d)
    cu, pu = card["unsupervised"], cpu["unsupervised"]
    lda_d = float(np.max(np.abs(cu["topics"] - pu["topics"])
                         / np.abs(pu["topics"])))
    assert lda_d <= CMP_LDA_RTOL, lda_d
    theta_d = float(np.max(np.abs(cu["theta"] - pu["theta"])))
    assert cu["vocab"] == pu["vocab"]
    w2v_d = float(np.abs(cu["vectors"] - pu["vectors"]).max())
    assert w2v_d <= CMP_W2V_ATOL, w2v_d
    log(f"[{tag}] cuda vs cpu at {FAMILIES_CMP_ROWS} rows: the same "
        f"blacklist {cbin['blacklist']}, map keys, dropped reasons and kept "
        f"columns; the same winners {cbin['winner']} and {creg['winner']}; "
        f"max |mean AuROC diff| LR {diffs['LR']:.3g} (tolerance "
        f"{CMP_METRIC_ATOL['exact']:g}), MLP {diffs['MLP']:.3g} (tolerance "
        f"{CMP_MLP_ATOL:g}); winner probabilities {pdiff:.3g}; the MLP's "
        f"probabilities {mlp_d:.3g} (tolerance {CMP_MLP_PROB_ATOL:g}); GLM mean RMSE "
        f"relative {diffs['GLM']:.3g} (tolerance {CMP_GLM_RTOL:g}); LDA topics "
        f"relative {lda_d:.3g} (tolerance {CMP_LDA_RTOL:g}), mixtures "
        f"{theta_d:.3g}; word2vec vectors {w2v_d:.3g} (tolerance "
        f"{CMP_W2V_ATOL:g})")
    out["wall_s"] = time.perf_counter() - t_phase
    out["cmp"] = {"lr": diffs["LR"], "mlp": diffs["MLP"], "glm": diffs["GLM"],
                  "prob": pdiff, "mlp_prob": mlp_d, "lda": lda_d, "theta": theta_d, "w2v": w2v_d}
    log(f"[{tag}] phase wall {out['wall_s']:.1f} s")
    return out


# -- [ingest]: the ingestion layer on the card --------------------------------
#: the README's CSV (``write_readme_csv``, 29.4 MB at 1M rows) through
#: DeviceCSVIngest over its numeric columns, in 4 MB chunks: about eight
#: blocks through the double buffer (the default 64 MB chunk would be one)
INGEST_CSV_ROWS = 1_000_000
INGEST_COLUMNS = ("survived", "age", "fare")
INGEST_CHUNK_BYTES = 4 << 20
INGEST_REPEATS = 3                 # the walls: median of three
#: the repo's scale path (bench.py): the design matrix made on the card,
#: K1 over it, the LR grid's 3-fold CV on it, bench.py's planted-truth
#: refit at reg 1e-3 gated on a held-out 1M slice of another seed
INGEST_TEXT_DIMS = SCALE_SHAPE[1] - 7
INGEST_HOLDOUT_ROWS = 1_000_000
INGEST_HOLDOUT_SEED = 43
INGEST_GATE_REG = 1e-3


def median_wall(fn, repeats: int = INGEST_REPEATS):
    """(median host wall in s, the last result) of ``fn()`` run
    ``repeats`` times, the card synchronised at both ends of each."""
    walls, out = [], None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), out


def ingest_csv_walls(path: str, schema: dict) -> dict:
    """The CSV half of [ingest]: the producer's work alone (parse and block
    assembly), the consumer's alone (pinned copies and non_blocking sends
    on a side stream of the same blocks), both through the pump, the CPU
    route (bit-equal to the card's) and CSVReader's read of the same
    file."""
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
    from transmogrifai_tpu_torch.readers.fast_csv import (
        DeviceCSVIngest,
        chunk_to_block,
        iter_csv_chunks,
    )
    from transmogrifai_tpu_torch.types import feature_types as ft

    cols = list(INGEST_COLUMNS)
    dev = torch.device("cuda", 0)

    def ingest(device):
        return DeviceCSVIngest(path, cols, schema, device=device,
                               chunk_bytes=INGEST_CHUNK_BYTES).to_device()

    t0 = time.perf_counter()
    ingest("cuda")            # the side stream and pinned pool's first use
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    def parse():
        return [chunk_to_block(c, cols) for c in iter_csv_chunks(
            path, schema, chunk_bytes=INGEST_CHUNK_BYTES, wanted=cols)]

    read_s, blocks = median_wall(parse)
    side = torch.cuda.Stream(device=dev)

    def send():
        out = []
        for b, m in blocks:
            hb = torch.from_numpy(b).pin_memory()
            hm = torch.from_numpy(m).pin_memory()
            with torch.cuda.stream(side):
                out.append((hb.to(dev, non_blocking=True),
                            hm.to(dev, non_blocking=True)))
        side.synchronize()
        return out

    copy_s, _ = median_wall(send)
    total_s, (X, M, rows) = median_wall(lambda: ingest("cuda"))
    Xc, Mc, rows_c = ingest("cpu")
    assert X.device.type == dev.type and X.dtype == torch.float32
    assert rows == rows_c == INGEST_CSV_ROWS, (rows, rows_c)
    assert tuple(X.shape) == (INGEST_CSV_ROWS, len(cols))
    assert torch.equal(X.cpu(), Xc) and torch.equal(M.cpu(), Mc), \
        "the card's ingest differs from the CPU route"
    missing_age = int((~Mc[:, 1]).sum())
    assert 0 < missing_age < INGEST_CSV_ROWS // 5, missing_age
    feats = [FeatureBuilder(ft.RealNN, "survived").as_response(),
             FeatureBuilder(ft.PickList, "sex").as_predictor(),
             FeatureBuilder(ft.Real, "age").as_predictor(),
             FeatureBuilder(ft.Real, "fare").as_predictor()]
    t0 = time.perf_counter()
    ds = CSVReader(path).generate_dataset(feats)
    reader_s = time.perf_counter() - t0
    assert np.array_equal(ds["age"].mask, Mc[:, 1].numpy())
    return {"blocks": len(blocks), "first_s": first_s, "read_s": read_s,
            "copy_s": copy_s, "total_s": total_s, "reader_s": reader_s,
            "overlap": (read_s + copy_s - total_s) / copy_s,
            "bytes": X.numel() * 4 + M.numel(), "missing_age": missing_age}


def ingest_phase(kernels, errs: list, timings: dict) -> dict:
    """``[ingest]``: DeviceCSVIngest on the README's 1M-row CSV, bit-equal
    to its CPU route, with its walls and overlap; the repo's scale path -
    ``synthetic_design_matrix_device`` at 10M x 39 on the card, K1 over it
    (the SanityChecker's moment sweep) and ``OpCrossValidation.validate``
    of the LR grid on the card-resident matrix, counted, gated by
    ``planted_truth_report`` on a held-out 1M slice - and the
    conditional-aggregation example trained and scored on the card, its
    columns equal to the CPU's."""
    import tempfile

    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )
    from transmogrifai_tpu_torch.examples import synthetic
    from transmogrifai_tpu_torch.examples.conditional_aggregation import (
        conditional_aggregation_workflow,
    )
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.selector.factories import lr_grid
    from transmogrifai_tpu_torch.selector.validator import OpCrossValidation
    from transmogrifai_tpu_torch.types import feature_types as ft
    from transmogrifai_tpu_torch.types.columns import PredictionColumn

    tag = "ingest"
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)

    # (1) the CSV through the double-buffered pump
    schema = {"survived": ft.RealNN, "age": ft.Real, "fare": ft.Real}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = synthetic.write_readme_csv(os.path.join(tmp, "passengers.csv"),
                                          INGEST_CSV_ROWS)
        mb = os.path.getsize(path) / 1e6
        log(f"[{tag}] wrote the README's {INGEST_CSV_ROWS}-row CSV ({mb:.1f} "
            f"MB) in {time.perf_counter() - t0:.3f} s")
        csv = ingest_csv_walls(path, schema)
    log(f"[{tag}] DeviceCSVIngest {list(INGEST_COLUMNS)} of {mb:.1f} MB in "
        f"{INGEST_CHUNK_BYTES >> 20} MB chunks ({csv['blocks']} blocks, "
        f"{csv['bytes'] / 1e6:.1f} MB to the card), median of "
        f"{INGEST_REPEATS}: parse alone {csv['read_s']:.4f} s, copy alone "
        f"{csv['copy_s']:.4f} s, both through the pump {csv['total_s']:.4f} "
        f"s (first call {csv['first_s']:.4f} s); overlap (parse + copy - "
        f"total) / copy {csv['overlap']:.3f}; X, mask and rows bit-equal "
        f"to device='cpu' ({csv['missing_age']} missing ages); CSVReader's "
        f"read of the same file {csv['reader_s']:.4f} s")

    # (2) the scale path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    X, y, meta = synthetic.synthetic_design_matrix_device(
        SCALE_SHAPE[0], text_dims=INGEST_TEXT_DIMS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    yd = torch.from_numpy(y.astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    moments = kernels.fused_moments(X, yd)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - t0
    cv = OpCrossValidation(num_folds=3, stratify=True,
                           evaluator=OpBinaryClassificationEvaluator())
    grid = lr_grid()
    t0 = time.perf_counter()
    res = cv.validate([(OpLogisticRegression(), grid)], X, y)
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    launches = {k: getattr(kernels, k).launches
                for k in ("fused_moments", "bin_matrix")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert tuple(X.shape) == SCALE_SHAPE and X.device.type == dev.type, \
        (X.shape, X.device)
    assert launches == {"fused_moments": 1, "bin_matrix": 0}, launches
    assert len(res.all_results) == len(grid)
    assert {r["rank_metric_mode"] for r in res.all_results} == {"approx"}
    # the moments describe the planted columns: one gender a row, the
    # imputation indicator on ~10% of rows
    x_sum = moments[0].double().cpu().numpy() / SCALE_SHAPE[0]
    assert abs(x_sum[4:7].sum() - 1.0) < 1e-3, x_sum[4:7]
    assert abs(x_sum[1] - 0.1) < 0.01, x_sum[1]
    log(f"[{tag}] synthetic_design_matrix_device {SCALE_SHAPE} "
        f"({X.numel() * 4 / 1e9:.2f} GB on the card, y alone to the host) in "
        f"{gen_s:.3f} s; K1 over it {1e3 * k1_s:.2f} ms (host wall, first "
        f"call); OpCrossValidation.validate of the LR grid ({len(grid)} "
        f"points x 3 folds, approx rank metrics) on the card-resident X in "
        f"{cv_s:.3f} s, best {res.best_params} CV AuROC "
        f"{res.best_metric:.6f}; launches {launches}; peak device memory "
        f"{peak_gb:.2f} GB")
    log_train_fused(tag, res.train_fused)

    gate = OpLogisticRegression(reg_param=INGEST_GATE_REG, max_iter=25)
    t0 = time.perf_counter()
    params = gate.fit_arrays(X, y)
    fit_s = time.perf_counter() - t0
    err = check_moments(kernels, X, yd)
    errs.append(err)
    key = ("fused_moments", tuple(SCALE_SHAPE))
    timing = timings.get(key) or time_moments(kernels, X, yd)
    shapes = {key: {**timing, "path_calls": launches["fused_moments"],
                    "max_abs_err": err["max_abs_err"]}}
    del X, yd, moments
    Xh, yh, _ = synthetic.synthetic_design_matrix_device(
        INGEST_HOLDOUT_ROWS, seed=INGEST_HOLDOUT_SEED,
        text_dims=INGEST_TEXT_DIMS)
    pred, raw, prob = gate.predict_arrays(params, Xh)
    auroc = float(OpBinaryClassificationEvaluator().evaluate_arrays(
        yh, PredictionColumn(pred, raw, prob)).AuROC)
    del Xh
    torch.cuda.empty_cache()
    report = synthetic.planted_truth_report(params["beta"], meta, auroc)
    log(f"[{tag}] planted truth: LR(reg {INGEST_GATE_REG}) refit on the "
        f"card in {fit_s:.3f} s, AuROC {auroc:.6f} on {INGEST_HOLDOUT_ROWS} "
        f"held-out rows (seed {INGEST_HOLDOUT_SEED}); {json.dumps(report)}")
    assert report["ok"], report
    log_path_shapes("the [ingest] scale path's", shapes)

    # (3) the conditional-aggregation example, card against CPU
    scored = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        wf, feats = conditional_aggregation_workflow(device)
        cols = wf.train().score().columns()
        scored[device] = {f.name: cols[f.name].to_list() for f in feats}
    ex_s = time.perf_counter() - t0
    assert scored["cuda"] == scored["cpu"], scored
    assert scored["cuda"]["numVisitsWeekPrior"] == [3.0, None, 1.0]
    assert scored["cuda"]["numPurchasesNextDay"] == [1.0, 1.0, None]
    log(f"[{tag}] conditional_aggregation: trained and scored on the card "
        f"and the CPU in {ex_s:.3f} s, columns equal: {scored['cuda']}")
    wall = time.perf_counter() - t_phase
    log(f"[{tag}] phase wall {wall:.1f} s")
    return {"launches": launches, "shapes": shapes, "wall_s": wall,
            "csv": csv, "gen_s": gen_s, "cv_s": cv_s, "peak_gb": peak_gb,
            "report": report}


# -- the fused training programs -----------------------------------------------

#: the [fused_train] phase's design matrix: examples/synthetic.py's at the
#: repo's scale width (39 columns), 1M rows
FUSED_TRAIN_ROWS = 1_000_000
FUSED_TRAIN_TEXT_DIMS = SCALE_SHAPE[1] - 7
#: fused against existing: the JAX package's own bar for its fused path
FUSED_METRIC_ATOL = 1e-9
#: the GBT's trees: 2 step sizes x 3 folds x 10 trees = 60 fits, inside
#: one fused dispatch (``fits_per_dispatch``: 76 at 1M x 39, depth 3)
FUSED_GBT_TREES = 10


def fused_train_families() -> list:
    """(name, estimator, grid, regression, rank-metric mode) of the
    [fused_train] phase's families on the card."""
    from transmogrifai_tpu_torch.models.linear_regression import (
        OpLinearRegression,
    )
    from transmogrifai_tpu_torch.models.linear_svc import OpLinearSVC
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier,
        OpRandomForestClassifier,
        OpRandomForestRegressor,
    )
    from transmogrifai_tpu_torch.selector.factories import lr_grid

    forest_grid = [{"max_depth": 6, "min_info_gain": m} for m in (0.0, 0.01)]
    return [
        ("lr", OpLogisticRegression(), lr_grid(), False, "exact"),
        ("lr_approx", OpLogisticRegression(), lr_grid(), False, "approx"),
        ("svc", OpLinearSVC(), [{"reg_param": r} for r in (0.01, 0.1, 0.5)],
         False, "exact"),
        ("linreg", OpLinearRegression(), lr_grid(), True, "exact"),
        ("rf", OpRandomForestClassifier(num_trees=8, max_depth=6),
         forest_grid, False, "exact"),
        ("rf_reg", OpRandomForestRegressor(num_trees=8, max_depth=6),
         forest_grid, True, "exact"),
        ("gbt", OpGBTClassifier(num_trees=FUSED_GBT_TREES, max_depth=3),
         [{"step_size": s} for s in (0.1, 0.3)], False, "exact"),
    ]


@contextlib.contextmanager
def kept_betas(est):
    """Within the block, keep the betas of every fused linear dispatch
    (``run_linear``) and of every kernel-at-a-time batched fit of
    ``est``'s class.  Yields {"fused": [...], "existing": [...]}."""
    from transmogrifai_tpu_torch.local import fused_train

    kept = {"fused": [], "existing": []}
    if not hasattr(est, "fit_arrays_batched"):  # a tree family: no betas
        yield kept
        return
    run, fit = fused_train.run_linear, type(est).fit_arrays_batched

    def run_keep(*args, **kw):
        res = run(*args, **kw)
        kept["fused"].append((res.betas, res.b0s))
        return res

    def fit_keep(self, *args, **kw):
        out = fit(self, *args, **kw)
        kept["existing"].append(out)
        return out

    fused_train.run_linear = run_keep
    type(est).fit_arrays_batched = fit_keep
    try:
        yield kept
    finally:
        fused_train.run_linear = run
        type(est).fit_arrays_batched = fit


def fused_train_phase(kernels, errs: list, bin_errs: list,
                      timings: dict) -> dict:
    """``[fused_train]``: ``OpCrossValidation(num_folds=3).validate`` of
    each family of ``fused_train_families`` on FUSED_TRAIN_ROWS rows of the
    synthetic design matrix on the card, forced through the fused training
    programs (``train_fused=True``, K2 launches counted) and through the
    kernel-at-a-time path (``False``): every forced family reports
    ``backend == "fused"``, the betas are bit-equal, the fold metrics
    within FUSED_METRIC_ATOL and the winners the same; every K2 call of
    the fused runs held against its plain version."""
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )
    from transmogrifai_tpu_torch.evaluators.regression import (
        OpRegressionEvaluator,
    )
    from transmogrifai_tpu_torch.examples.synthetic import (
        synthetic_design_matrix,
    )
    from transmogrifai_tpu_torch.selector.validator import OpCrossValidation

    tag = "fused_train"
    t_phase = time.perf_counter()
    X, y, _ = synthetic_design_matrix(FUSED_TRAIN_ROWS, seed=0,
                                      text_dims=FUSED_TRAIN_TEXT_DIMS)
    X = np.asarray(X, np.float64)
    y_reg = X[:, 3] * 2.0 - X[:, 7] + 0.1 * np.random.RandomState(0).randn(
        FUSED_TRAIN_ROWS)
    log(f"[{tag}] design matrix {X.shape} made in "
        f"{time.perf_counter() - t_phase:.3f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {w.__name__: 0 for w in kernels.WRAPPERS}
    existing_launches = dict(launches)
    kept_all: dict = {w.__name__: [] for w in kernels.WRAPPERS}
    rows = []
    for name, est, grid, regression, mode in fused_train_families():
        ev = (OpRegressionEvaluator() if regression
              else OpBinaryClassificationEvaluator())
        yy = y_reg if regression else y
        runs, walls = {}, {}
        os.environ["TX_CV_RANK_METRICS"] = mode
        try:
            with kept_betas(est) as betas:
                for fused in (True, False):
                    cv = OpCrossValidation(num_folds=3, evaluator=ev,
                                           stratify=not regression)
                    cv.train_fused = fused
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    t0 = time.perf_counter()
                    with kernel_inputs(kernels) as kept:
                        runs[fused] = cv.validate([(est, grid)], X, yy)
                    torch.cuda.synchronize()
                    walls[fused] = time.perf_counter() - t0
                    counts = (launches if fused else existing_launches)
                    for w in kernels.WRAPPERS:
                        counts[w.__name__] += w.launches
                    if fused:
                        for k, calls in kept.items():
                            kept_all[k] += calls
                    del kept
        finally:
            del os.environ["TX_CV_RANK_METRICS"]
        fam = runs[True].train_fused["families"][est.model_type]
        assert fam["backend"] == "fused", (name, fam)
        assert fam["mode"] == mode, (name, fam)
        assert runs[False].train_fused["families"][est.model_type] == {
            "backend": "existing", "reason": "disabled"}
        diff = max(float(np.abs(np.subtract(a["fold_metrics"],
                                            b["fold_metrics"])).max())
                   for a, b in zip(runs[True].all_results,
                                   runs[False].all_results))
        assert diff <= FUSED_METRIC_ATOL, (name, diff)
        assert runs[True].best_params == runs[False].best_params, name
        same_betas = None
        if betas["fused"]:
            (fb, fb0), = betas["fused"]
            (eb, eb0), = betas["existing"]
            same_betas = bool(np.array_equal(fb, eb)
                              and np.array_equal(fb0, eb0))
            assert same_betas, f"{name}: fused and existing betas differ"
        rows.append({"family": name, "fused_s": walls[True],
                     "existing_s": walls[False], "max_metric_diff": diff,
                     "betas_equal": same_betas, "trail": fam,
                     "best": runs[True].best_params,
                     "best_metric": runs[True].best_metric})
        log(f"[{tag}] {name} ({est.model_type}, {len(grid)} points x 3 "
            f"folds, {mode}): fused {walls[True]:.3f} s (exec "
            f"{fam['exec_ms']:.1f} ms, {fam['bucket']}), existing "
            f"{walls[False]:.3f} s; max |fold metric diff| {diff:.3g} "
            f"(bar {FUSED_METRIC_ATOL:g}); betas bit-equal "
            f"{same_betas}; best {json.dumps(runs[True].best_params)} "
            f"{runs[True].metric_name} {runs[True].best_metric:.6f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one K2 binning a fused tree plan, none in a linear dispatch
    n_tree = sum(1 for r in rows if r["family"] in ("rf", "rf_reg", "gbt"))
    assert launches == {"fused_moments": 0, "bin_matrix": n_tree}, launches
    assert len(kept_all["bin_matrix"]) == launches["bin_matrix"]
    shapes: dict = {}
    hold_path_inputs(kernels, kept_all, shapes, errs, bin_errs,
                     timings=timings)
    log_path_shapes(f"the {tag} path's", shapes)
    wall = time.perf_counter() - t_phase
    log(f"[{tag}] launches in the fused runs {launches}, in the "
        f"kernel-at-a-time runs {existing_launches}; peak device memory "
        f"{peak_gb:.2f} GB; phase wall {wall:.1f} s")
    return {"launches": launches, "existing_launches": existing_launches,
            "shapes": shapes, "rows": rows, "peak_gb": peak_gb,
            "wall_s": wall}


def fused_train_only_main() -> int:
    """``--fused-train-only``: the kernels' build and the [fused_train]
    phase alone."""
    from transmogrifai_tpu_torch.parallel import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.set_float32_matmul_precision("highest")
    log("[header] card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip())
    kernels.build()
    ft = fused_train_phase(kernels, [], [], {})
    print(json.dumps({
        "launches": ft["launches"], "wall_s": ft["wall_s"],
        "peak_gb": ft["peak_gb"],
        "rows": [{k: v for k, v in r.items() if k != "trail"}
                 for r in ft["rows"]],
        "shapes": [[k, list(shape), t["ms"], t["bound_ms"], t["plain_ms"]]
                   for (k, shape), t in ft["shapes"].items()]}))
    return 0


def ingest_only_main() -> int:
    """``--ingest-only``: the kernels' build and the [ingest] phase alone."""
    from transmogrifai_tpu_torch.parallel import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.set_float32_matmul_precision("highest")
    log("[header] card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip())
    kernels.build()
    ing = ingest_phase(kernels, [], {})
    print(json.dumps({"launches": ing["launches"], "wall_s": ing["wall_s"],
                      "csv": ing["csv"], "gen_s": ing["gen_s"],
                      "cv_s": ing["cv_s"], "peak_gb": ing["peak_gb"],
                      "shapes": [[k, list(shape), t["ms"], t["bound_ms"],
                                  t["plain_ms"]]
                                 for (k, shape), t in ing["shapes"].items()]}))
    return 0


def families_by_path(fam: dict, k: str) -> dict:
    """A kernel's launches on the [families] phase's paths."""
    ln = fam["launches"]
    return {"families_binary_train": ln["binary"]["train"][k],
            "families_binary_score": ln["binary"]["score"][k],
            "families_regression_train": ln["regression"]["train"][k],
            "families_regression_score": ln["regression"]["score"][k],
            "families_loco_forest_fit": ln["loco_forest_fit"][k],
            "families_loco_forest": ln["loco_forest"][k],
            "families_loco_mlp": ln["loco_mlp"][k]}


def families_only_main() -> int:
    """``--families-only``: the kernels' build and the [families] phase
    alone, with its CPU child: a quick check of the phase while it
    changes."""
    from transmogrifai_tpu_torch.parallel import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    child = start_families_cpu()
    try:
        torch.set_float32_matmul_precision("highest")
        log("[header] card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip())
        kernels.build()
        errs, bin_errs = [], []
        fam = families_phase(kernels, errs, bin_errs, child, {})
    finally:
        if child.poll() is None:
            child.kill()
        child.communicate()
    print(json.dumps({k: families_by_path(fam, k)
                      for k in ("fused_moments", "bin_matrix")}))
    print(json.dumps({"shapes": [[k, list(shape), t["ms"], t["bound_ms"],
                                  t["path_calls"]]
                                 for (k, shape), t in fam["shapes"].items()],
                      "cmp": fam["cmp"], "wall_s": fam["wall_s"]}))
    return 0


def serve_by_path(serve: dict, k: str) -> dict:
    """A kernel's launches on the [serve] phase's paths: each served
    model's scoring, and the forest's and GBT's fits."""
    out = {f"serve_{tag}": serve[tag]["launches"][k]
           for tag in ("readme", "forest", "gbt")}
    out.update({f"serve_{tag}_fit": serve[tag]["fit_launches"][k]
                for tag in ("forest", "gbt")})
    return out


def serve_only_main() -> int:
    """``--serve-only``: the kernels' build and the [serve] phase alone,
    with a logistic regression on the README front in the README model's
    place: a quick check of the serving path while it changes.  Without
    arguments the script runs every phase."""
    import tempfile

    from transmogrifai_tpu_torch.examples.synthetic import write_readme_csv
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.parallel import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.set_float32_matmul_precision("highest")
    kernels.build()
    with tempfile.TemporaryDirectory() as tmp:
        csv = write_readme_csv(os.path.join(tmp, "t.csv"), 50_000)
        model = serve_front(csv, OpLogisticRegression()).train()
    bin_errs: list = []
    serve = serve_phase(kernels, model, bin_errs, readme_build=lambda path:
                        serve_front(path, OpLogisticRegression()))
    print(json.dumps({k: serve_by_path(serve, k) for k in
                      ("fused_moments", "bin_matrix")}))
    return 0


def vectors_only_main() -> int:
    """``--vectors-only``: the kernels' build and the [full_schema] and
    [type_lattice] phases alone (with their CPU child): a quick check of
    the vectorizer slice while it changes."""
    from transmogrifai_tpu_torch.parallel import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    child = start_schema_cpu()
    try:
        torch.set_float32_matmul_precision("highest")
        kernels.build()
        errs, bin_errs = [], []
        vectors = vector_phases(kernels, errs, bin_errs, child, {})
    finally:
        if child.poll() is None:
            child.kill()
        child.communicate()
    print(json.dumps({p: {"launches": v["run"]["launches"],
                          "shapes": [[k, list(shape), t["ms"], t["bound_ms"]]
                                     for (k, shape), t in v["shapes"].items()]}
                      for p, v in vectors.items()}))
    return 0


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--serve-only":
        return serve_only_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--vectors-only":
        return vectors_only_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--families-only":
        return families_only_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--ingest-only":
        return ingest_only_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--fused-train-only":
        return fused_train_only_main()
    if len(sys.argv) == 3 and sys.argv[1] == "--families-cpu":
        return families_cpu_main(int(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--selector-cpu":
        return selector_cpu_main(int(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == "--schema-cpu":
        return schema_cpu_main()
    for problem in PROBLEM_LABEL:
        if len(sys.argv) == 3 and sys.argv[1] == f"--{problem}-selector-cpu":
            return problem_cpu_main(problem, int(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the CPU sides of the selectors' card-against-CPU phases train from
    # the start, beside the card's phases (the [readme] and
    # [default_selector] phases' launch-bound forest loops then run with
    # the host to themselves)
    children = [start_selector_cpu(SELECTOR_CMP_ROWS),
                start_problem_cpu("multiclass"),
                start_problem_cpu("regression"),
                start_schema_cpu(),
                start_families_cpu()]
    try:
        return card_main(*children)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.communicate()


def card_main(cpu_child: subprocess.Popen,
              multiclass_cpu_child: subprocess.Popen,
              regression_cpu_child: subprocess.Popen,
              schema_cpu_child: subprocess.Popen,
              families_cpu_child: subprocess.Popen) -> int:
    from transmogrifai_tpu_torch.examples.synthetic import (
        BAYES_AUROC_OBSERVED,
        synthetic_design_matrix,
        synthetic_passengers,
        synthetic_passengers_labelled,
    )
    from transmogrifai_tpu_torch.models.trees import _sampled_bin_edges
    from transmogrifai_tpu_torch.parallel import kernels
    from transmogrifai_tpu_torch.utils import native as native_bridge

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
    # the CSV scanner's host library: built by the port's own bridge into
    # its _build/, never over the JAX package's native/libtxkernels.so
    native_so = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "native", "libtxkernels.so")
    native_before = file_digest(native_so)
    t0 = time.perf_counter()
    lib = native_bridge.get_lib()
    native_s = time.perf_counter() - t0
    assert lib is not None and lib._name == native_bridge.lib_path(), \
        "the port's native CSV scanner did not build"
    log(f"[header] card: {smi}")
    log(f"[header] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"[header] kernels built in {build_s:.1f} s: {', '.join(kernels.KERNELS)}")
    log(f"[header] the CSV scanner's host library "
        f"{os.path.relpath(native_bridge.lib_path())} built and loaded in "
        f"{native_s:.1f} s")
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

    del data

    # -- 8. the README example, 1M rows from a CSV -----------------------------
    readme = readme_phase(kernels, errs, bin_errs, sel_shapes)
    rml = readme["run"]["launches"]

    # -- 8b. the serving path: save, load, score_function() -------------------
    serve = serve_phase(kernels, readme.pop("model"), bin_errs)

    # -- 9. the default selector ------------------------------------------
    dsel = default_selector_phase(
        kernels, synthetic_passengers(DEFAULT_SELECTOR_ROWS, seed=42,
                                      with_text=False),
        wdata, errs, bin_errs,
        {**sel_shapes, **readme["shapes"]})
    dpl, dwl = dsel["plain"]["launches"], dsel["workflow_cv"]["launches"]

    # -- 10. the multiclass and regression selectors ---------------------------
    ldata = synthetic_passengers_labelled(SLICE_ROWS, seed=42, with_text=False)
    timings = {**sel_shapes, **readme["shapes"], **dsel["shapes"]}
    problems = {}
    for problem, child in (("multiclass", multiclass_cpu_child),
                           ("regression", regression_cpu_child)):
        problems[problem] = problem_selector_phase(
            kernels, problem, ldata, errs, bin_errs, child, timings)
        timings.update(problems[problem]["shapes"])
    del ldata

    # -- 10b. every vectorizer group: the full schema and the type lattice ----
    vectors = vector_phases(kernels, errs, bin_errs, schema_cpu_child, timings)
    for v in vectors.values():
        timings.update(v["shapes"])

    families = families_phase(kernels, errs, bin_errs, families_cpu_child,
                              timings)

    # -- 10c. the ingestion layer (K1 at the scale shape timed in section 2) --
    timings[("fused_moments", SCALE_SHAPE)] = at_scale
    ingest = ingest_phase(kernels, errs, timings)

    # -- 10d. the fused training programs ----------------------------------
    fused = fused_train_phase(kernels, errs, bin_errs, timings)

    # -- 11. result lines ---------------------------------------------------
    def sel_by_path(k):
        return {"selector_train": spl["train"][k],
                "selector_score": spl["score"][k],
                "selector_workflow_cv_train": swl["train"][k],
                "selector_workflow_cv_score": swl["score"][k],
                "readme_train": rml["train"][k],
                "readme_score": rml["score"][k],
                "default_selector_train": dpl["train"][k],
                "default_selector_score": dpl["score"][k],
                "default_selector_workflow_cv_train": dwl["train"][k],
                "default_selector_workflow_cv_score": dwl["score"][k],
                **{f"{p}_selector_{phase}": v["run"]["launches"][phase][k]
                   for p, v in problems.items() for phase in ("train", "score")},
                **{f"{p}_{phase}": v["run"]["launches"][phase][k]
                   for p, v in vectors.items() for phase in ("train", "score")},
                **families_by_path(families, k),
                "ingest_scale": ingest["launches"][k],
                "fused_train": fused["launches"][k],
                **serve_by_path(serve, k)}

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
        "readme_path_shapes": sel_shape_rows("fused_moments",
                                             readme["shapes"]),
        "default_selector_path_shapes": sel_shape_rows("fused_moments",
                                                       dsel["shapes"]),
        "default_selector_workflow_cv_path_shapes": sel_shape_rows(
            "fused_moments", dsel["wcv_shapes"]),
        **{f"{p}_selector_path_shapes": sel_shape_rows(
            "fused_moments", v["shapes"]) for p, v in problems.items()},
        **{f"{p}_path_shapes": sel_shape_rows("fused_moments", v["shapes"])
           for p, v in vectors.items()},
        "families_path_shapes": sel_shape_rows("fused_moments",
                                               families["shapes"]),
        "ingest_path_shapes": sel_shape_rows("fused_moments",
                                             ingest["shapes"]),
        "fused_train_existing_launches": fused["existing_launches"][
            "fused_moments"],
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
        "readme_path_shapes": sel_shape_rows("bin_matrix", readme["shapes"]),
        "default_selector_path_shapes": sel_shape_rows("bin_matrix",
                                                       dsel["shapes"]),
        "default_selector_workflow_cv_path_shapes": sel_shape_rows(
            "bin_matrix", dsel["wcv_shapes"]),
        **{f"{p}_selector_path_shapes": sel_shape_rows(
            "bin_matrix", v["shapes"]) for p, v in problems.items()},
        **{f"{p}_path_shapes": sel_shape_rows("bin_matrix", v["shapes"])
           for p, v in vectors.items()},
        "families_path_shapes": sel_shape_rows("bin_matrix",
                                               families["shapes"]),
        "serve_path_shapes": serve["k2_shapes"],
        "fused_train_path_shapes": sel_shape_rows("bin_matrix",
                                                  fused["shapes"]),
        "fused_train_existing_launches": fused["existing_launches"][
            "bin_matrix"],
        "at_scale": bins_at_scale,
        "other_shapes": other_bins,
    }]}
    assert file_digest(native_so) == native_before, \
        "native/libtxkernels.so changed during the run"
    print(smi)
    print(json.dumps(kernel_line))
    # the run used one card, whatever the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
