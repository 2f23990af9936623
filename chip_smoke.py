"""Chip smoke test of transmogrifai_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the package from its sources (``nvcc``, one
process per source, all started together), holds each kernel against its
plain torch version on the card, then trains and scores the ported main
paths at the repo's scale on the card and on the CPU, and checks that the
two agree:

* each kernel at the shapes of its routes redesigned for small inputs and
  wide rows (``[redesign]``: K1 at 1M x 538 and 10k x 4 243, K2 at the
  serving batches and the small bucketizer, fold and LOCO shapes), beside
  its yardstick, the empty launch of its own grid (``*_floor``) and its
  time before the redesign; ``--kernels-only`` runs the build, the kernel
  check and this alone;
* the passenger AutoML workflow, transmogrify -> SanityChecker ->
  OpLogisticRegression -> AuROC, on 1M rows (kernel ``fused_moments``);
* the tree slice, transmogrify(label=...) (one decision-tree bucketizer per
  numeric column) -> SanityChecker -> OpGBTClassifier -> AuROC, on the same
  1M rows (kernels ``fused_moments`` and ``bin_matrix``), twice on the card
  (heaps bit-identical), and card against CPU on the first 200k rows;
* the selector, transmogrify(label=...) -> SanityChecker ->
  BinaryClassificationModelSelector (3-fold CV over logistic regression's
  8-point and the GBT's 9-point default grids) -> holdout AuROC -> score(),
  on 200k rows (both kernels); its device rank metrics on the card
  against the CPU;
* the README example (README.md's first code block, the port's imports,
  ``OpWorkflow()`` on the card): a 1M-row CSV written by
  ``examples.synthetic.write_readme_csv`` read through
  ``CSVReader`` on the native scanner -> ``age.fill_missing_with_mean()
  .z_normalize()`` -> transmogrify -> ``survived.sanity_check(...)`` ->
  BinaryClassificationModelSelector.with_cross_validation(num_folds=3) over
  its four default families (logistic regression and the linear SVM at 8
  grid points, the random forest with per-node feature subsets at 18, the
  GBT at 9) -> train(), score(), ``summary_pretty()``, counted, every
  kernel call held against its plain version;
* the serving path (``[serve]``): the README model, and a 50-tree
  depth-12 forest and a 20-tree depth-12 GBT fitted on the README front at
  200k rows, each saved, loaded into its rebuilt workflow with
  ``OpWorkflowModel.load`` and served through ``score_function()`` - one
  torch program on the card per batch, every tree head binning its batch
  with ``bin_matrix`` - over 50k held-out CSV records at batches of 1,
  64, 1 024 and 16 384, row for row against the numpy-fused scorer,
  counted, every kernel call held against its plain version, ``bin_matrix``
  timed at the serving shapes; then ``[deploy]`` in the same temporary
  directory: the saved forest and GBT published as v1 and v2 into a
  ``ModelRegistry``, ``OpWorkflowRunner.run("serve")`` of v1 through the
  ``MicroBatchScheduler`` and ``run("deploy")`` of v1 with v2 as a 20%
  canary over the 50k records (every row against its arm's
  ``score_function()`` rows, the canary's rows the host ``route_key``
  split's), the ``canary.regression`` rollback drill, four hot swaps from
  the registry under a scoring thread (the p99 inside the swap windows
  beside outside them, the device memory after each swap), every
  generation torch-fused and warm, every ``bin_matrix`` launch counted by
  step and arm and held against its plain version; then ``[fleet]``: the
  saved forest published as v1 and v2 into a fresh registry, a
  ``FleetController`` of three replica worker processes on the card
  (``device="cuda"``, each its own CUDA context, each rebuilding the
  workflow through ``chip_smoke:fleet_forest_workflow`` and holding its
  own ``bin_matrix`` launches against the plain version, the counts
  shipped in its obs shard), the 50k records routed in 512-row batches
  from four client threads with ``rolling_deploy("v2")`` mid-traffic,
  then one replica SIGKILLed under traffic: every routed row 0 ULP from
  ``score_function()``, none dropped, rows conserved exactly, each
  worker's spawn-to-ready wall and device memory (``--serve-only`` runs
  the phase and both steps alone);
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
  the linear families through the fused programs);
* multi-GPU on ``torch.distributed`` (``[mesh]``; ``--mesh-only`` runs it
  alone): world 1 over NCCL - ``initialize()`` from the torchrun
  variables, ``fused_moments_sharded`` on ``make_mesh(1)`` at 10M x 39
  bit-equal to ``fused_moments`` (its K1 launch counted) and
  ``all_reduce_stats`` at the same size, then the group destroyed; world
  2 on the one card over gloo - two spawned ranks, both on ``cuda:0``,
  run the SanityChecker at 1M x 39, the LR grid's CV and a forest and a
  GBT grid at 200k rows through the product entry points with the data
  and CV meshes active, held against this process's world-1 answers:
  the same drops (statistics rtol 3e-5), the same winners (CV means
  1e-5), forest heaps bit-equal, GBT predictions within 1e-4, K1 and K2
  launched on every rank and equal to their plain versions, every
  validator trail falling back with reason ``mesh``.  Two ranks on one
  card prove the route and its parity, not scaling: no multi-GPU speed-up
  is claimed;
* the training operations layer (``[ops]``; ``--ops-only`` runs it
  alone): 1M passenger rows written as 8 CSV shards and 1 Avro shard; a
  cold ``OpWorkflowRunner.run("train")`` over a 100k-row cut with
  ``ingest_shards`` (4 workers), ``autotune`` (the report says
  ``cost_model_cold``, the cost model trained from the run's spans and
  saved as ``autotune.json``) and ``fleet_dir`` (the shipped shard read
  back through the aggregator); the cost model warmed by three
  validations on the card; a warm autotuned train at 1M rows through
  the streamed ingest (the imputer's and indexer's partial fits armed,
  the raw columns bit-equal to the serial read by digest), the ladder
  pruning with every rung fit on the card (the trail printed), the
  winner equal to the exhaustive sweep's (CV metric within 1e-9) and its
  AuROC on a separate 200k-row set in [0.70, 0.755]; ``run("serve")`` of
  the saved model with ``serving_autotune`` (the knob decision, p50 and
  p99, every row within ``SERVE_ULP_BUDGETS`` of ``score_function()``);
  ``run("continuous")`` in direct mode (a GBT bootstrapped from 50k rows,
  windows dropped one a cycle with ``weight`` shifted from the second:
  clear, over, trigger - refit, publish, promote - then clear; the idle
  exit), the refit canaried against the bootstrap on the card; every K1
  and K2 launch counted by step and held against its plain version.

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
import inspect
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
#: the tree slice's card-against-CPU comparison runs on this many first
#: rows of the 1M-row slice data (the CPU's 1M-row train took ~39 s)
TREE_CMP_ROWS = 200_000
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


#: the kernels' cold ms before their redesign for Hopper's small inputs and
#: wide rows, at the shapes it targets, as PERF.md's kernel table recorded
#: them (a range where the table gives one for a span of shapes): text for
#: the [kernel] log lines beside this run's times, never a number of the
#: kernels line, which holds only what this run measured (and the bound)
BEFORE_MS = {
    ("fused_moments", (1_000_000, 538)): 2.9315,
    ("fused_moments", (10_000, 4243)): 3.1435,
    ("fused_moments", (10_000_000, 39)): 0.5580,
    ("bin_matrix", (1, 7)): 0.0053,
    ("bin_matrix", (8, 7)): 0.0049,
    ("bin_matrix", (32, 7)): 0.0049,
    ("bin_matrix", (128, 7)): 0.0049,
    ("bin_matrix", (16_384, 7)): 0.0075,
    ("bin_matrix", (8_952, 1)): 0.0069,
    ("bin_matrix", (54_000, 1)): (0.0072, 0.0076),
    ("bin_matrix", (90_000, 1)): (0.0072, 0.0076),
    ("bin_matrix", (180_000, 1)): (0.0073, 0.0076),
    ("bin_matrix", (10_000, 15)): 0.0079,
    ("bin_matrix", (30_000, 9)): 0.0082,
    ("bin_matrix", (60_000, 9)): 0.0086,
    ("bin_matrix", (180_000, 9)): 0.0106,
    ("bin_matrix", (10_000_000, 39)): 0.9123,
}

def before_ms(kname: str, shape):
    """The kernel's recorded cold ms before the redesign at ``shape``, or
    None."""
    return BEFORE_MS.get((kname, tuple(int(v) for v in shape)))


def floor_ms(floor, *args) -> float:
    """Device ms a call of the kernel's empty-launch floor (``*_floor``:
    an empty kernel at the kernel's own grid, threads and dynamic shared
    memory), warm: it reads nothing."""
    return timed(floor, [args])["ms"]


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
              causes: bool = False, plain: bool = True) -> dict:
    """The kernel, its plain version (unless not ``plain``) and the
    library yardstick, each cold and warm (``measure``): torch.searchsorted
    over the sorted edge rows of a pre-transposed NaN-free x (it ranks a
    NaN x at 0, so it is a yardstick, not a substitute).  With ``causes``,
    what tells compares from bytes: the kernel on the same x against the
    edge rows reversed (not sorted, so every element takes the linear
    count) and ``x.to(torch.int8)``, a pass that moves the same bytes and
    compares nothing."""
    n, d = x.shape
    assert not bool(torch.isnan(x).any()) and not bool(torch.isnan(edges).any())
    xt = x.T.contiguous()
    out_bytes = 1 if dtype == torch.int8 else 4
    k = measure(kernels.bin_matrix, x, edges, dtype)
    lib = measure(lambda e, a: torch.searchsorted(e, a, side="left"), edges, xt)
    del xt
    out = {
        "shape": [n, d], "edges": int(edges.shape[1]), **k,
        "library_ms": lib["ms"], "library_ms_warm": lib["ms_warm"],
        "library_host_us": lib["host_us"],
        "bound_ms": bin_bound_ms(n, d, int(edges.shape[1]), out_bytes),
    }
    if plain:
        p = measure(kernels.bin_matrix_plain, x, edges, dtype)
        out.update(plain_ms=p["ms"], plain_ms_warm=p["ms_warm"])
    if causes:
        rev = edges.flip(1).contiguous()
        out["reversed_edges_ms"] = measure(kernels.bin_matrix, x, rev, dtype)["ms"]
        out["cast_ms"] = measure(lambda a: a.to(torch.int8), x)["ms"]
    return out


def before_note(kname: str, t: dict) -> str:
    """The empty-launch floor where the timing has one, and the recorded
    time before the redesign (BEFORE_MS) where there is one for its
    shape."""
    note = ""
    if t.get("floor_ms") is not None:
        note += f"; empty launch {t['floor_ms']:.4f}"
    b = before_ms(kname, t["shape"])
    if b is not None:
        b = f"{b[0]:.4f}-{b[1]:.4f}" if isinstance(b, (list, tuple)) else f"{b:.4f}"
        note += f"; recorded before the redesign {b} cold"
    return note


def log_moments_times(where: str, m: dict) -> None:
    log(f"[kernel] fused_moments {where}: {m['ms']:.4f} ms cold "
        f"({100 * m['bound_ms'] / m['ms']:.0f}% of the {m['bound_ms']:.4f} ms "
        f"bound), {m['ms_warm']:.4f} warm, host {m['host_us']:.1f} us a call; "
        f"x.sum(0) {m['anchor_ms']:.4f} cold, {m['anchor_ms_warm']:.4f} warm; "
        f"plain {m['plain_ms']:.4f} cold{before_note('fused_moments', m)}")


def log_bins_times(where: str, b: dict) -> None:
    causes = (f"; reversed edges (linear count) {b['reversed_edges_ms']:.4f}, "
              f"x.to(int8) {b['cast_ms']:.4f}" if "cast_ms" in b else "")
    plain = f"; plain {b['plain_ms']:.4f} cold" if "plain_ms" in b else ""
    log(f"[kernel] bin_matrix {where}: {b['ms']:.4f} ms cold "
        f"({100 * b['bound_ms'] / b['ms']:.0f}% of the {b['bound_ms']:.4f} ms "
        f"bound), {b['ms_warm']:.4f} warm, host {b['host_us']:.1f} us a call; "
        f"torch.searchsorted {b['library_ms']:.4f} cold, "
        f"{b['library_ms_warm']:.4f} warm, host {b['library_host_us']:.1f} us"
        f"{plain}{causes}{before_note('bin_matrix', b)}")


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
SELECTOR_TYPES = ["OpLogisticRegression", "OpGBTClassifier"]
SELECTOR_AUROC_RANGE = (0.70, 0.755)  # the holdout AuROC gate of PERF.md
#: card against CPU: a mean CV metric within the CPU tests' tolerance for
#: its mode
CMP_METRIC_ATOL = {"approx": 1e-3, "exact": 1e-5}
#: the fits inside a validation (its scoring is the rest; a family's fused
#: training dispatch, ``fused_linear`` or ``fused_tree``, holds its scoring
#: and metrics too)
FIT_PHASES = ("lr_batch", "lr_folds", "svc_batch", "linreg_batch",
              "nb_folds", "gbt_grid", "rf_grid", "dt_grid", "fused_linear",
              "fused_tree")
#: the card's and the CPU's float32 roundings (exp, reduction orders) flip
#: near-tied splits in deep trees: GBT predictions and deep trees' mean
#: metrics are held to CMP_DEEP_TREE_ATOL (a depth-12 GBT candidate
#: differed by 2.7e-5 at 100k rows on an H100)
CMP_DEEP_TREE_ATOL = 1e-4
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
                 model_types=SELECTOR_TYPES) -> dict:
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
    with selector_walls(device == "cuda") as rec:
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
              tmp: str, bin_errs: list, profiled: bool = True) -> dict:
    """Save ``model``, load it into ``rebuild()``, serve ``records`` through
    the loaded model's ``score_function()`` on the card (torch-fused) and
    on the host (numpy-fused) at every SERVE_BATCHES size, counted and
    held, and with ``profiled`` one call of the largest batch under the
    profiler; returns what the result lines need."""
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

    if profiled:
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
    return out


# -- the deployment path: registry, runner serve and deploy, hot swap -----------

#: the serving knobs of [deploy]'s serve run and generations
DEPLOY_BUCKETS = (1, 8, 32, 128)
DEPLOY_MAX_WAIT_US, DEPLOY_WINDOW = 2000, 256
DEPLOY_CANARY_FRACTION, DEPLOY_BATCH_ROWS = 0.2, 128
#: the hot-swap drill's versions, in swap order, and the quiet scoring
#: before the first swap and after the last
DEPLOY_SWAPS = ("v1", "v2", "v1", "v2")
DEPLOY_SWAP_GAP_S = 0.5
#: device memory after the 4th swap against after the 1st: within this
#: share of the 1st (v1's 50 trees and v2's 20 hold different heaps; the
#: pairs with the same version live are held to one generation's heaps)
DEPLOY_MEM_RTOL = 0.10


class ArmTags:
    """Within the block, every K2 call made through a module of the package
    is kept (its arguments cloned, as ``kernel_inputs`` does) under a tag:
    ``warm`` while ``DeploymentController`` builds a generation, ``stable``
    or ``canary`` while it scores an arm, else the thread's ``default``.
    ``calls`` is the list of (tag, args); ``counts()`` the launches by
    tag; ``generations``, with ``keep_generations``, every generation built
    within the block (held alive until it is cleared)."""

    def __init__(self, kernels, default: str, keep_generations=False):
        import threading

        from transmogrifai_tpu_torch.registry import deployment

        self.kernels, self.deployment = kernels, deployment
        self.local = threading.local()
        self.default = default
        self.calls: list = []
        self.keep_generations = keep_generations
        self.generations: list = []
        #: launches by tag, and by row count, of the calls already held
        #: and dropped
        self.held: dict = {}
        self.by_rows: dict = {}
        self.lock = threading.Lock()

    def tag(self) -> str:
        return getattr(self.local, "tag", None) or self.default

    def counts(self) -> dict:
        """Launches by tag, held or still kept."""
        out = dict(self.held)
        with self.lock:
            for t, _ in self.calls:
                out[t] = out.get(t, 0) + 1
        return out

    def __enter__(self):
        ctl = self.deployment.DeploymentController
        self.saved = (ctl._score_arm, ctl._build_generation)
        score_arm, build = self.saved
        me = self

        def tagged(tag, fn):
            def run(*a, **k):
                prev = getattr(me.local, "tag", None)
                me.local.tag = tag(a, k)
                try:
                    return fn(*a, **k)
                finally:
                    me.local.tag = prev
            return run

        ctl._score_arm = tagged(
            lambda a, k: "canary" if k.get("is_canary") else "stable",
            score_arm)
        def build_kept(*a, **k):
            gen, warm_s = build(*a, **k)
            if me.keep_generations:
                me.generations.append(gen)
            return gen, warm_s

        ctl._build_generation = tagged(lambda a, k: "warm", build_kept)
        self.patched = []
        w = self.kernels.bin_matrix
        for mod in list(sys.modules.values()):
            if (mod is not self.kernels and getattr(mod, "__name__", "")
                    .startswith("transmogrifai_tpu_torch.")
                    and getattr(mod, w.__name__, None) is w):
                def shim(*args, _w=w):
                    kept = tuple(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args)
                    with me.lock:
                        me.calls.append((me.tag(), kept))
                    return _w(*args)
                setattr(mod, w.__name__, shim)
                self.patched.append(mod)
        return self

    def __exit__(self, *exc):
        ctl = self.deployment.DeploymentController
        ctl._score_arm, ctl._build_generation = self.saved
        for mod in self.patched:
            setattr(mod, self.kernels.bin_matrix.__name__,
                    self.kernels.bin_matrix)

    def hold(self, bin_errs: list, samples=None) -> int:
        """Hold every kept call against the plain version (``check_bins``),
        then drop the copies, keeping the first call of each row count in
        ``samples`` when it is given; returns how many were held."""
        with self.lock:
            calls, self.calls = self.calls, []
        for t, args in calls:
            self.held[t] = self.held.get(t, 0) + 1
            m = int(args[0].shape[0])
            self.by_rows[m] = self.by_rows.get(m, 0) + 1
            assert args[0].is_cuda
            bin_errs.append(check_bins(self.kernels, *args))
            if samples is not None:
                samples.setdefault(m, args)
        return len(calls)


def split_assigns(records: list, fraction: float, seed: int = 42) -> np.ndarray:
    """The canary split computed here, from ``route_key`` and the port's
    murmur3: True where a record goes to the canary arm."""
    from transmogrifai_tpu_torch.registry import route_key
    from transmogrifai_tpu_torch.utils.hashing import murmur3_32

    cut = int(fraction * 10000)
    return np.array([murmur3_32(route_key(r).encode("utf-8"), seed) % 10000
                     < cut for r in records])


def hold_rows(tag: str, got: np.ndarray, want: np.ndarray, fam: str) -> float:
    """Served rows against the arm's ``score_function()`` rows: equal
    predictions, floats within the family's SERVE_ULP_BUDGETS; returns the
    largest distance in ULPs."""
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got[:, 0], want[:, 0]), f"[deploy] {tag}: predictions differ"
    ulps = max_ulps(got[:, 1:], want[:, 1:])
    assert ulps <= SERVE_ULP_BUDGETS[fam], (
        f"[deploy] {tag}: {ulps:g} ULP from score_function() (budget "
        f"{SERVE_ULP_BUDGETS[fam]})")
    return ulps


def device_heap_bytes(model) -> int:
    """Bytes of the tensors that the device-fused program holds on the card
    for ``model``'s tree head (``trees._walk_params``: packed heaps, leaf
    stats, edges): the least one generation of the model keeps there."""
    from transmogrifai_tpu_torch.models.trees import _walk_params

    wp = _walk_params(model.stages[-1].model_params, torch.device("cpu"))
    ts = [v for v in wp.values() if isinstance(v, torch.Tensor)]
    ts += list(wp.get("heaps", ()))
    return sum(t.numel() * t.element_size() for t in ts)


def read_scores(path: str) -> list:
    with open(os.path.join(path, "scores.json")) as f:
        rows = json.load(f)
    bad = [r for r in rows if "error" in r]
    assert not bad, f"[deploy] {len(bad)} rows failed: {bad[:2]}"
    return rows


def deploy_step(kernels, tmp: str, serve_csv: str, want: dict,
                bin_errs: list) -> dict:
    """``[deploy]``, in [serve]'s temporary directory ``tmp``: [serve]'s
    saved forest and GBT published as v1 and v2 into a ``ModelRegistry``;
    ``OpWorkflowRunner.run("serve")`` of v1 through the
    ``MicroBatchScheduler``; ``run("deploy")`` of v1 with v2 as a canary on
    a 20% split; the ``canary.regression`` rollback drill; four hot swaps
    under a scoring thread, with the device memory after each.  ``want``
    maps v1 and v2 to their loaded model's ``score_function()`` rows over
    the held-out records ([serve]'s 16 384-record batches).  Every K2
    launch is kept under its step and arm and held against its plain
    version.  Returns the result lines' pieces."""
    import gc
    import threading

    from transmogrifai_tpu_torch.faults import injection as faults
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier,
        OpRandomForestClassifier,
    )
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
    from transmogrifai_tpu_torch.registry import (
        DeploymentController,
        ModelRegistry,
    )
    from transmogrifai_tpu_torch.serving import (
        RowScoringError,
        records_from_dataset,
    )
    from transmogrifai_tpu_torch.workflow.params import OpParams
    from transmogrifai_tpu_torch.workflow.runner import OpWorkflowRunner
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

    t_step = time.perf_counter()
    heads = {"v1": lambda: OpRandomForestClassifier(**SERVE_FOREST),
             "v2": lambda: OpGBTClassifier(**SERVE_GBT)}
    fams = {"v1": "rf", "v2": "gbt"}

    def workflow(v):
        return serve_front(serve_csv, heads[v]())

    out: dict = {"launches": {}, "walls": {}, "heap_bytes": {}}
    reg = ModelRegistry(os.path.join(tmp, "registry"))
    t0 = time.perf_counter()
    for v, tag in (("v1", "forest"), ("v2", "gbt")):
        model = OpWorkflowModel.load(os.path.join(tmp, tag), workflow(v))
        out["heap_bytes"][v] = device_heap_bytes(model)
        entry = reg.publish(model, metrics={"model": tag})
        assert entry.version == v, entry.version
        del model
    reg.promote("v1", to="stable")
    out["walls"]["publish"] = time.perf_counter() - t0
    log(f"[deploy] published [serve]'s forest as v1 and GBT as v2 in "
        f"{out['walls']['publish']:.3f} s; registry {reg.describe()['stable']}"
        f" stable, verify ok {reg.verify()['ok']}")

    # -- the serve run type ---------------------------------------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ArmTags(kernels, "serve") as tags:
        res = OpWorkflowRunner(workflow("v1")).run("serve", OpParams(
            model_location=reg.artifact_path("v1"),
            metrics_location=os.path.join(tmp, "serve_metrics"),
            write_location=os.path.join(tmp, "serve_scores"),
            custom_params={"serving_buckets": list(DEPLOY_BUCKETS),
                           "serving_max_wait_us": DEPLOY_MAX_WAIT_US,
                           "serving_window": DEPLOY_WINDOW}))
        assert kernels.bin_matrix.launches == len(tags.calls)
        assert kernels.fused_moments.launches == 0
        out["launches"]["serve"] = tags.counts()
        out["walls"]["serve"] = time.perf_counter() - t0
        held = tags.hold(bin_errs)
    out["k2_launches_by_rows"] = {"serve": tags.by_rows}
    with open(os.path.join(tmp, "serve_metrics", "serving_metrics.json")) as f:
        sm = json.load(f)
    got = serve_rows(read_scores(os.path.join(tmp, "serve_scores")))
    n = len(got)
    assert sm["rows_scored"] == n and sm["rows_failed"] == 0, sm
    assert sm["fused"]["backend"] == "torch", sm["fused"]
    assert sorted(map(int, sm["fused"]["bucket_timings"])) == list(
        DEPLOY_BUCKETS), sm["fused"]["bucket_timings"]
    ulps = hold_rows("serve run", got, want["v1"], "rf")
    # the batcher's compiled batches and one warm-up batch per bucket
    assert held == sm["batches"] + len(DEPLOY_BUCKETS), (held, sm["batches"])
    out["serve"] = {k: sm[k] for k in ("latency_ms", "rows_per_s",
                                       "batches", "mean_batch_size",
                                       "batch_rows_per_s", "queue_depth")}
    out["serve"]["bucket_timings"] = sm["fused"]["bucket_timings"]
    lat = sm["latency_ms"]
    log(f"[deploy] serve run: {n} records through the MicroBatchScheduler "
        f"(max_wait_us {DEPLOY_MAX_WAIT_US}, window {DEPLOY_WINDOW}, buckets "
        f"{DEPLOY_BUCKETS}) in {out['walls']['serve']:.3f} s: p50 "
        f"{lat['p50']} ms, p95 {lat['p95']} ms, p99 {lat['p99']} ms, "
        f"{sm['rows_per_s']} rows/s ({sm['batches']} batches, mean "
        f"{sm['mean_batch_size']} rows, batch path {sm['batch_rows_per_s']} "
        f"rows/s); backend torch, warmed buckets "
        f"{sorted(map(int, sm['fused']['bucket_timings']))}; rows within "
        f"{ulps:g} ULP of score_function(); K2 {out['launches']['serve']}, "
        f"{held} held against plain")

    # -- the deploy run type: v1 stable, v2 canary on a 20% split -------------
    order = iter(("v1", "v2"))  # the runner loads the stable, then the canary
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ArmTags(kernels, "deploy", keep_generations=True) as tags:
        res = OpWorkflowRunner(
            workflow("v1"), workflow_factory=lambda: workflow(next(order)),
        ).run("deploy", OpParams(
            metrics_location=os.path.join(tmp, "deploy_metrics"),
            write_location=os.path.join(tmp, "deploy_scores"),
            custom_params={
                "registry_root": reg.root, "deploy_version": "v1",
                "canary_version": "v2",
                "canary_fraction": DEPLOY_CANARY_FRACTION,
                "deploy_batch_rows": DEPLOY_BATCH_ROWS,
                "serving_buckets": list(DEPLOY_BUCKETS)}))
        assert kernels.bin_matrix.launches == len(tags.calls)
        assert kernels.fused_moments.launches == 0
        out["launches"]["deploy"] = tags.counts()
        out["walls"]["deploy"] = time.perf_counter() - t0
        out["k2_inputs"] = {}
        held = tags.hold(bin_errs, out["k2_inputs"])
    out["k2_launches_by_rows"]["deploy"] = tags.by_rows
    m = res.metrics
    assert m["rows_failed"] == 0, m["rows_failed"]
    raw = workflow("v1").raw_features
    records = records_from_dataset(CSVReader(serve_csv).generate_dataset(raw),
                                   raw)
    assigned = split_assigns(records, DEPLOY_CANARY_FRACTION)
    # the run keeps the controller's default cadence, a canary check every
    # ``check_every`` batches; a check that rolls the canary back mid-run
    # sends every later row to stable, so the rows' arms follow the split
    # up to that check's batch, found from the canary rows it cites
    check_every = inspect.signature(DeploymentController).parameters[
        "check_every_batches"].default
    rollbacks = [e for e in m["events"] if e["event"] == "rollback"]
    cut_rows, mid_run = len(records), None
    if rollbacks:
        cited = rollbacks[0]["evidence"]["canary"]["rows_scored"]
        ks = [k for k in range(check_every, -(-len(records)
                                             // DEPLOY_BATCH_ROWS) + 1,
                               check_every)
              if int(assigned[:k * DEPLOY_BATCH_ROWS].sum()) == cited]
        assert ks, f"[deploy] no check's batch holds {cited} canary rows"
        k = ks[0]
        cut_rows = k * DEPLOY_BATCH_ROWS
        mid_run = {"after_batches": k, "canary_rows": cited,
                   "reasons": rollbacks[0]["reasons"]}
    on_canary = assigned & (np.arange(len(records)) < cut_rows)
    got = serve_rows(read_scores(os.path.join(tmp, "deploy_scores")))
    assert len(got) == len(records) == m["rows_submitted"]
    ulps = {"stable": hold_rows("deploy run, stable arm", got[~on_canary],
                                want["v1"][~on_canary], "rf"),
            "canary": hold_rows("deploy run, canary arm", got[on_canary],
                                want["v2"][on_canary], "gbt")}
    assert [(g.version, g.endpoint.fused_backend, g.endpoint.warm_error)
            for g in tags.generations] == [("v1", "torch", None),
                                           ("v2", "torch", None)], [
        (g.version, g.endpoint.fused_reason, g.endpoint.warm_error)
        for g in tags.generations]
    arms = {}
    for arm, gen in zip(("stable", "canary"), tags.generations):
        snap = gen.endpoint.telemetry.snapshot()
        assert sorted(map(int, snap["fused"]["bucket_timings"])) == list(
            DEPLOY_BUCKETS), (arm, snap["fused"]["bucket_timings"])
        want_rows = int(on_canary.sum()) if arm == "canary" else int(
            (~on_canary).sum())
        assert snap["rows_scored"] == want_rows, (arm, snap["rows_scored"])
        # one K2 launch per compiled batch of the arm (one tree head)
        assert out["launches"]["deploy"].get(arm, 0) == snap["batches"], (
            arm, out["launches"]["deploy"], snap["batches"])
        arms[arm] = {"rows": want_rows, "batches": snap["batches"],
                     "latency_ms": snap["latency_ms"],
                     "rows_per_s": snap["rows_per_s"],
                     "batch_rows_per_s": snap["batch_rows_per_s"],
                     "ulps": ulps[arm]}
    assert out["launches"]["deploy"].get("warm") == 2 * len(DEPLOY_BUCKETS)
    assert reg.canary is None
    assert (m["canary_released"] is None) == bool(rollbacks), (
        m["canary_released"], rollbacks)
    tags.generations.clear()
    out["deploy"] = {"arms": arms, "final_decision": m["final_decision"],
                     "check_every_batches": check_every,
                     "rollback_mid_run": mid_run}
    if mid_run is None:
        ending = (f"no check of the default cadence rolled the canary back; "
                  f"final check rollback "
                  f"{(m['final_decision'] or {}).get('rollback')}, canary "
                  "released undecided")
    else:
        ending = (f"FINDING: a check of the default cadence rolled the "
                  f"healthy canary back after {mid_run['after_batches']} "
                  f"batches ({mid_run['canary_rows']} canary rows) on "
                  + ", ".join(f"{r['signal']}={r['value']} (limit "
                              f"{r['threshold']})" for r in mid_run["reasons"])
                  + "; every later row served on v1")
    log(f"[deploy] deploy run: {len(records)} records in batches of "
        f"{DEPLOY_BATCH_ROWS} in {out['walls']['deploy']:.3f} s, v1 stable "
        f"and v2 canary at {DEPLOY_CANARY_FRACTION}, checked every "
        f"{check_every} batches: no failed row; the canary's "
        f"{arms['canary']['rows']} rows are exactly the host route_key "
        f"split's up to the last batch it served; stable rows within "
        f"{ulps['stable']:g} ULP of v1's score_function(), canary rows within "
        f"{ulps['canary']:g} of v2's; both generations torch-fused and warmed"
        f" on {DEPLOY_BUCKETS}; p50/p99 ms stable "
        f"{arms['stable']['latency_ms']['p50']}/"
        f"{arms['stable']['latency_ms']['p99']}, canary "
        f"{arms['canary']['latency_ms']['p50']}/"
        f"{arms['canary']['latency_ms']['p99']}; {ending}; K2 "
        f"{out['launches']['deploy']}, {held} held against plain")

    # -- the rollback drill -----------------------------------------------------
    models = {v: reg.load(v, workflow(v)) for v in ("v1", "v2")}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ArmTags(kernels, "rollback") as tags:
        ctl = DeploymentController(canary_fraction=DEPLOY_CANARY_FRACTION,
                                   check_every_batches=1,
                                   batch_buckets=DEPLOY_BUCKETS)
        ctl.deploy(models["v1"], version="v1")
        canary = ctl.start_canary(models["v2"], version="v2")
        gens = [ctl.stable_generation, canary]
        faults.configure("canary.regression:every=1")
        batches = 0
        try:
            for lo in range(0, 8 * DEPLOY_BATCH_ROWS, DEPLOY_BATCH_ROWS):
                batch = records[lo:lo + DEPLOY_BATCH_ROWS]
                rows = ctl.score_batch(batch)
                batches += 1
                arm = assigned[lo:lo + DEPLOY_BATCH_ROWS]
                assert not any(isinstance(r, RowScoringError)
                               for r, a in zip(rows, arm) if not a), \
                    "[deploy] a stable row failed in the rollback drill"
                hold_rows("rollback drill, stable arm", serve_rows(
                    [r for r, a in zip(rows, arm) if not a]),
                    want["v1"][lo:lo + DEPLOY_BATCH_ROWS][~arm], "rf")
                if ctl.canary_generation is None:
                    break
        finally:
            faults.reset()
        assert ctl.canary_generation is None, "the canary was not rolled back"
        (event,) = [e for e in ctl.events() if e["event"] == "rollback"]
        signals = sorted(r["signal"] for r in event["reasons"])
        assert "nonfinite_rows" in signals, signals
        after = ctl.score_batch(records[:DEPLOY_BATCH_ROWS])
        hold_rows("after the rollback", serve_rows(after),
                  want["v1"][:DEPLOY_BATCH_ROWS], "rf")
        assert kernels.bin_matrix.launches == len(tags.calls)
        assert kernels.fused_moments.launches == 0
        out["launches"]["rollback"] = tags.counts()
        out["walls"]["rollback"] = time.perf_counter() - t0
        held = tags.hold(bin_errs)
    out["k2_launches_by_rows"]["rollback"] = tags.by_rows
    for g in gens:
        assert g.endpoint.fused_backend == "torch", g.endpoint.fused_reason
        assert g.endpoint.warm_error is None, g.endpoint.warm_error
    nonfinite = event["evidence"]["canary"]["breaker"]["rows_nonfinite"]
    out["rollback"] = {"batches": batches, "signals": signals,
                       "canary_rows_nonfinite": nonfinite}
    log(f"[deploy] rollback drill (canary.regression:every=1, checked every "
        f"batch): the canary rolled back automatically after {batches} "
        f"batch(es) on {signals} ({nonfinite} non-finite canary rows "
        f"refused); every stable row clean and within budget of v1's "
        f"score_function(), and the next batch all on v1; K2 "
        f"{out['launches']['rollback']}, {held} held against plain")
    del ctl, canary, gens, models

    # -- the hot-swap drill -------------------------------------------------------
    ctl = DeploymentController(registry=reg, track_registry=False,
                               batch_buckets=DEPLOY_BUCKETS)
    ctl.deploy_version("v1", workflow("v1"))
    # the main thread takes the gate between two batches to hold the kept
    # K2 calls and read the device memory with no batch in flight; the
    # scoring thread yields while ``want`` is set
    gate, want_gate = threading.Lock(), threading.Event()
    stop = threading.Event()
    failures: list = []
    served: list = []         # (start, end, version, lo, rows)
    streams: dict = {"live": [], "warm": []}

    def pump():
        streams["live"].append(torch.cuda.current_stream().cuda_stream)
        lo = 0
        while not stop.is_set():
            batch = records[lo:lo + DEPLOY_BATCH_ROWS]
            while want_gate.is_set():
                time.sleep(1e-3)
            with gate:
                t_a = time.perf_counter()
                try:
                    rows, info = ctl.score_batch_with_info(batch)
                except Exception as e:  # noqa: BLE001 - the drill's verdict
                    failures.append(f"{type(e).__name__}: {e}")
                    return
                t_b = time.perf_counter()
            if len(rows) != len(batch) or any(
                    isinstance(r, RowScoringError) for r in rows):
                failures.append(f"batch at {lo}: {len(rows)} rows for "
                                f"{len(batch)}, or a failed row")
                return
            served.append((t_a, t_b, info["stable_version"], lo,
                           serve_rows(rows)))
            lo = (lo + DEPLOY_BATCH_ROWS) % (len(records) - DEPLOY_BATCH_ROWS)

    kernels.reset_launches()
    held = counted = 0
    windows, mem = [], []
    t0 = time.perf_counter()
    with ArmTags(kernels, "hot_swap") as tags:
        thread = threading.Thread(target=pump, name="deploy-pump")
        thread.start()
        try:
            for v in DEPLOY_SWAPS:
                time.sleep(DEPLOY_SWAP_GAP_S)
                streams["warm"].append(torch.cuda.current_stream().cuda_stream)
                t_a = time.perf_counter()
                gen = ctl.deploy_version(v, workflow(v))
                windows.append((t_a, time.perf_counter()))
                assert gen.endpoint.fused_backend == "torch"
                assert gen.endpoint.warm_error is None, gen.endpoint.warm_error
                del gen
                want_gate.set()
                with gate:
                    # the launches so far, before check_bins adds its own
                    counted += kernels.bin_matrix.launches
                    assert kernels.fused_moments.launches == 0
                    held += tags.hold(bin_errs)
                    kernels.reset_launches()
                    torch.cuda.synchronize()
                    gc.collect()
                    mem.append(int(torch.cuda.memory_allocated()))
                want_gate.clear()
            time.sleep(DEPLOY_SWAP_GAP_S)
        finally:
            stop.set()
            thread.join(60)
        assert not thread.is_alive(), "the scoring thread did not stop"
        counted += kernels.bin_matrix.launches
        assert kernels.fused_moments.launches == 0
        held += tags.hold(bin_errs)
        out["launches"]["hot_swap"] = tags.counts()
    out["walls"]["hot_swap"] = time.perf_counter() - t0
    out["k2_launches_by_rows"]["hot_swap"] = tags.by_rows
    assert not failures, failures[:3]
    assert counted == held, (counted, held)
    assert out["launches"]["hot_swap"]["warm"] == len(DEPLOY_SWAPS) * len(
        DEPLOY_BUCKETS), out["launches"]["hot_swap"]
    assert out["launches"]["hot_swap"]["stable"] == len(served)
    swaps = [e for e in ctl.events() if e["event"] == "swap"]
    assert [e["version"] for e in swaps] == ["v1", *DEPLOY_SWAPS], swaps
    # every row of every batch equals its generation's score_function() rows
    inside, outside = [], []
    for t_a, t_b, v, lo, rows in served:
        hold_rows(f"hot swap, batch at {lo} on {v}", rows,
                  want[v][lo:lo + DEPLOY_BATCH_ROWS], fams[v])
        wall_ms = 1e3 * (t_b - t_a)
        (inside if any(t_a < w1 and t_b > w0 for w0, w1 in windows)
         else outside).append(wall_ms)
    n_rows = sum(len(s[4]) for s in served)
    assert inside and outside, (len(inside), len(outside))
    p99_in, p99_out = (float(np.percentile(inside, 99)),
                       float(np.percentile(outside, 99)))
    # the same version is live after swaps 1 and 3 (v1) and 2 and 4 (v2):
    # a retired generation that lived on would add at least the smaller
    # generation's heaps to the later reading; half of them splits that
    # from the readings' own spread, which may fall on either side
    leak_bytes = min(out["heap_bytes"].values()) // 2
    for later, first in ((3, 1), (4, 2)):
        assert abs(mem[later - 1] - mem[first - 1]) < leak_bytes, (
            f"[deploy] device memory after swap {later} {mem[later - 1]} B "
            f"against {mem[first - 1]} B after swap {first}, the same version"
            f" live: more than half a generation's heaps ({leak_bytes} B) "
            "apart, a retired generation lives on")
    # and after swap 4 (v2 live) against after swap 1 (v1 live)
    assert abs(mem[3] - mem[0]) <= DEPLOY_MEM_RTOL * mem[0], (
        f"[deploy] device memory after swap 4 {mem[3]} B against {mem[0]} B "
        "after swap 1")
    out["hot_swap"] = {
        "batches": len(served), "rows": n_rows,
        "batches_in_swap_windows": len(inside),
        "p99_ms_in_swap_windows": p99_in, "p99_ms_outside": p99_out,
        "p50_ms_in_swap_windows": float(np.percentile(inside, 50)),
        "p50_ms_outside": float(np.percentile(outside, 50)),
        "swap_walls_s": [w1 - w0 for w0, w1 in windows],
        "warm_s": [e["warm_s"] for e in swaps[1:]],
        "flip_us": [e["flip_us"] for e in swaps[1:]],
        "memory_after_swap_bytes": mem,
        "warm_stream": streams["warm"], "live_stream": streams["live"],
    }
    hs = out["hot_swap"]
    log(f"[deploy] hot swap: a scoring thread served {hs['batches']} batches "
        f"({n_rows} rows, none dropped, every row equal within budget to its "
        f"generation's score_function()) while the main thread hot-swapped "
        f"{DEPLOY_SWAPS} from the registry (each load + build + warm "
        f"{', '.join(f'{s:.3f}' for s in hs['swap_walls_s'])} s, warm "
        f"{hs['warm_s']} s, pointer flip {hs['flip_us']} us); batch p99 "
        f"{p99_in:.3f} ms inside the swap windows ({len(inside)} batches) "
        f"against {p99_out:.3f} ms outside ({len(outside)}), p50 "
        f"{hs['p50_ms_in_swap_windows']:.3f} / {hs['p50_ms_outside']:.3f} ms;"
        f" the new generation warms on CUDA stream {streams['warm']} and live"
        f" traffic scores on {streams['live']} (the same stream: recorded, "
        f"not fixed); device memory after each swap {mem} B (after swap 4 "
        f"within {100 * DEPLOY_MEM_RTOL:.0f}% of after swap 1, and with the "
        f"same version live after swaps 1 and 3, 2 and 4, within "
        f"{leak_bytes} B, half the smaller generation's heaps "
        f"{out['heap_bytes']}: retired generations freed); K2 "
        f"{out['launches']['hot_swap']}, {held} held against plain")
    del ctl
    out["wall_s"] = time.perf_counter() - t_step
    log(f"[deploy] step wall {out['wall_s']:.1f} s")
    return out


# -- [fleet]: the serving fleet core on the card ---------------------------------

#: [fleet]: three replica workers on the one card, [serve]'s held-out
#: records in the runner's default 512-row fleet batches from four client
#: threads, round robin: the rolling deploy starts half way through the
#: first pass and one more pass follows it; then one pass with one
#: replica SIGKILLed
FLEET_REPLICAS, FLEET_BATCH_ROWS, FLEET_CLIENTS = 3, 512, 4
#: the factory every replica worker rebuilds [serve]'s forest workflow
#: with (the controller puts the repo root on the workers' PYTHONPATH),
#: and the environment that names its CSV and arms its K2 hold
FLEET_WORKFLOW = "chip_smoke:fleet_forest_workflow"
FLEET_CSV_ENV, FLEET_HOLD_ENV = "TX_SMOKE_FLEET_CSV", "TX_SMOKE_FLEET_HOLD"
#: the metrics view the hold ships in each worker's obs shard
FLEET_VIEW = "chip_fleet_k2"

_fleet_hold = None


class FleetK2Hold:
    """Inside a replica worker: every K2 call the package makes (through
    ``models.trees`` and ``ops.bucketizers``, which hold the wrapper by
    name) launches the kernel, then is held against ``bin_matrix_plain``
    on the same card tensors.  ``snapshot()`` is a metrics view: the
    worker's ObsShipper ships it in its shard, where the parent reads it
    through ``FleetAggregator``."""

    def __init__(self, kernels):
        import threading

        self.kernels = kernels
        self.lock = threading.Lock()
        self.held = self.mismatches = self.max_abs_err = 0
        self.shapes: dict = {}

    def install(self) -> None:
        import importlib

        w = self.kernels.bin_matrix
        for name in ("models.trees", "ops.bucketizers"):
            mod = importlib.import_module(f"transmogrifai_tpu_torch.{name}")
            assert getattr(mod, w.__name__) is w, name

            def shim(*args, _w=w):
                # the launch and its hold under one lock: a snapshot (the
                # ObsShipper's thread) never falls between the wrapper's
                # launch count and the hold, which a SIGKILL would freeze
                with self.lock:
                    got = _w(*args)
                    want = self.kernels.bin_matrix_plain(*args)
                    err = int((got.int() - want.int()).abs().max()) \
                        if got.numel() else 0
                    x, edges, dtype = args[0], args[1], args[2]
                    key = (f"{x.shape[0]}x{x.shape[1]}x{edges.shape[1]}:"
                           f"{str(dtype).replace('torch.', '')}")
                    self.held += 1
                    self.mismatches += int(err != 0 or got.dtype != dtype)
                    self.max_abs_err = max(self.max_abs_err, err)
                    self.shapes[key] = self.shapes.get(key, 0) + 1
                return got

            setattr(mod, w.__name__, shim)

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "launches": self.kernels.bin_matrix.launches,
                "fused_moments_launches": self.kernels.fused_moments.launches,
                "held": self.held, "mismatches": self.mismatches,
                "max_abs_err": self.max_abs_err, "shapes": dict(self.shapes),
                "device": torch.cuda.get_device_name(0),
                "memory_allocated": torch.cuda.memory_allocated(),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "memory_reserved": torch.cuda.memory_reserved(),
                "pid": os.getpid(),
            }


def fleet_forest_workflow():
    """[serve]'s forest workflow (``serve_front`` with SERVE_FOREST) over
    the CSV that ``TX_SMOKE_FLEET_CSV`` names: the zero-argument factory
    each [fleet] replica worker rebuilds it with.  With
    ``TX_SMOKE_FLEET_HOLD`` set (the workers' environment), the first
    call installs this process's ``FleetK2Hold`` and registers its view."""
    global _fleet_hold
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier

    if os.environ.get(FLEET_HOLD_ENV) and _fleet_hold is None:
        from transmogrifai_tpu_torch.obs.metrics import metrics_registry
        from transmogrifai_tpu_torch.parallel import kernels

        _fleet_hold = FleetK2Hold(kernels)
        _fleet_hold.install()
        metrics_registry().register_view(FLEET_VIEW, _fleet_hold)
    return serve_front(os.environ[FLEET_CSV_ENV],
                       OpRandomForestClassifier(**SERVE_FOREST))


def device_used_bytes() -> int:
    """Bytes in use on card 0 by every process (``cudaMemGetInfo``)."""
    free, total = torch.cuda.mem_get_info(0)
    return int(total - free)


def compute_app_memory() -> dict:
    """pid -> MiB of device memory, as ``nvidia-smi --query-compute-apps``
    gives it ({} when it gives none; a container's processes may all be
    listed under one pid)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30)
    mem = {}
    for line in out.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            try:
                mem[int(parts[0])] = float(parts[1])
            except ValueError:
                continue
    return mem


def fleet_views(fc) -> dict:
    """instance -> the shipped FleetK2Hold view of each live replica."""
    from transmogrifai_tpu_torch.obs import FleetAggregator

    out = {}
    for doc in FleetAggregator(fc.fleet_dir, stale_after_s=60.0).shards():
        views = doc.get("metrics", {}).get("views", {})
        view = views.get(f"{FLEET_VIEW}/0")
        if view is not None:
            out[str(doc.get("instance"))] = view
    return out


def wait_fleet_views(fc, instances, batches_by_instance: dict,
                     timeout_s: float = 30.0) -> dict:
    """The replicas' views once each has shipped at least the K2 holds its
    served batches imply (every batch launches K2 at least once)."""
    deadline = time.monotonic() + timeout_s
    while True:
        views = fleet_views(fc)
        if all(i in views and views[i]["held"] >=
               batches_by_instance.get(i, 0) for i in instances):
            return views
        assert time.monotonic() < deadline, (
            f"[fleet] replicas did not ship their K2 views: {sorted(views)}")
        time.sleep(0.1)


class FleetPump:
    """Routes ``batches`` round robin through the fleet's router from
    ``clients`` threads until ``total`` requests, or until ``finish``
    caps them; keeps each request's (batch index, submit time, done time,
    FleetResult or error)."""

    def __init__(self, fc, batches: list, clients: int,
                 total: "int | None" = None):
        import threading

        self.fc, self.batches = fc, batches
        self.lock = threading.Lock()
        self.next, self.total = 0, total
        self.requests: list = []
        self.threads = [threading.Thread(target=self._client, daemon=True)
                        for _ in range(clients)]

    def _client(self) -> None:
        while True:
            with self.lock:
                i = self.next
                if self.total is not None and i >= self.total:
                    return
                self.next = i + 1
            b = i % len(self.batches)
            t0 = time.perf_counter()
            try:
                res = self.fc.router.submit(
                    records=self.batches[b]).wait(120.0)
            except Exception as e:  # noqa: BLE001 - the step counts it
                res = e
            with self.lock:
                self.requests.append((b, t0, time.perf_counter(), res))

    def done(self) -> int:
        with self.lock:
            return len(self.requests)

    def finish(self, more: int) -> int:
        """Cap the pump at ``more`` requests past those already submitted;
        returns the cap."""
        with self.lock:
            self.total = self.next + more
            return self.total

    def run(self, steer) -> dict:
        """Start the clients, run ``steer(self)`` in this thread (it must
        call ``finish`` unless ``total`` was given), wait for the
        clients."""
        t0 = time.perf_counter()
        for t in self.threads:
            t.start()
        try:
            steer(self)
        finally:
            if self.total is None:
                self.finish(0)
            for t in self.threads:
                t.join(timeout=600.0)
        assert not any(t.is_alive() for t in self.threads), \
            "[fleet] a client hung"
        return {"requests": self.requests, "total": self.total,
                "wall_s": time.perf_counter() - t0}


def fleet_step(kernels, tmp: str, serve_csv: str, records: list,
               want: np.ndarray, deploy_serve: dict, bin_errs: list) -> dict:
    """``[fleet]``, in [serve]'s temporary directory ``tmp``: [serve]'s
    saved forest published as v1 (stable) and again as v2 in a fresh
    registry; ``FleetController(n_replicas=3, device="cuda")`` on AF_UNIX,
    every worker rebuilding the workflow through ``fleet_forest_workflow``
    and holding its own K2 calls against plain; the held-out records
    routed in 512-row batches from four client threads with
    ``rolling_deploy("v2")`` mid-traffic; then one replica SIGKILLed under
    traffic (``max_restarts=0``).  Every routed row is held at 0 ULP
    against ``want`` (the loaded forest's ``score_function()`` rows over
    ``records``).  Returns the result lines' pieces."""
    import signal
    import threading

    from transmogrifai_tpu_torch.fleet import FleetController
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
    from transmogrifai_tpu_torch.registry import ModelRegistry
    from transmogrifai_tpu_torch.serving import compile_endpoint
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

    t_step = time.perf_counter()
    out: dict = {"walls": {}}
    reg = ModelRegistry(os.path.join(tmp, "fleet_registry"))
    model = OpWorkflowModel.load(
        os.path.join(tmp, "forest"),
        serve_front(serve_csv, OpRandomForestClassifier(**SERVE_FOREST)))
    v1 = reg.publish(model, stage="stable").version
    v2 = reg.publish(model).version
    # the workers' K2 shapes, reproduced here: an endpoint at the workers'
    # default buckets warmed, then one fleet batch, its K2 inputs kept
    with kernel_inputs(kernels) as kept:
        endpoint = compile_endpoint(model)
        endpoint.score_batch(records[:FLEET_BATCH_ROWS])
    k2_inputs = {}
    for args in kept["bin_matrix"]:
        k2_inputs.setdefault(int(args[0].shape[0]), args)
    del endpoint, model, kept
    log(f"[fleet] published [serve]'s forest as {v1} (stable) and {v2}; "
        f"K2 per {FLEET_BATCH_ROWS}-row batch at rows {sorted(k2_inputs)}")

    batches = [records[lo:lo + FLEET_BATCH_ROWS]
               for lo in range(0, len(records), FLEET_BATCH_ROWS)]
    starts = list(range(0, len(records), FLEET_BATCH_ROWS))
    work = os.path.join(tmp, "fleet")
    socks = [os.path.join(work, f"replica-{i}.sock")
             for i in range(FLEET_REPLICAS)]
    ready: dict = {}
    watching = threading.Event()

    def watch_sockets() -> None:
        # a worker listens once its load, lowering and warm-up are done:
        # its socket file's appearance is its readiness
        while not watching.is_set() and len(ready) < len(socks):
            for i, s in enumerate(socks):
                if i not in ready and os.path.exists(s):
                    ready[i] = time.time()
            time.sleep(0.005)

    fc = FleetController(
        reg.root, FLEET_WORKFLOW, n_replicas=FLEET_REPLICAS,
        work_dir=work, device="cuda", max_restarts=0,
        worker_env={FLEET_CSV_ENV: serve_csv, FLEET_HOLD_ENV: "1"},
        router_kw={"max_in_flight_per_replica": 2, "max_queue": 256})
    watcher = threading.Thread(target=watch_sockets, daemon=True)
    torch.cuda.synchronize()
    used = {"before": device_used_bytes()}
    t0 = time.perf_counter()
    watcher.start()
    try:
        fc.start()
        out["walls"]["bring_up"] = time.perf_counter() - t0
        used["up"] = device_used_bytes()
        watching.set()
        watcher.join(timeout=5.0)
        spawn = {r.index: r.events[0]["t"] for r in fc._replicas.values()}
        out["spawn_to_ready_s"] = {
            f"replica-{i}": ready[i] - spawn[i] for i in sorted(spawn)}
        pids = {r.instance: r.proc.pid for r in fc._replicas.values()}
        for inst in sorted(pids):
            doc = fc.router.control(inst, "status", timeout_s=60.0)
            assert doc["device"] == "cuda", (inst, doc["device"])
            assert doc["version"] == v1, (inst, doc["version"])
        log(f"[fleet] {FLEET_REPLICAS} replica workers up on the card in "
            f"{out['walls']['bring_up']:.3f} s (spawn to ready "
            + ", ".join(f"{k} {v:.3f} s"
                        for k, v in out["spawn_to_ready_s"].items())
            + "); every worker reports device cuda, serving "
            f"{v1}; pids {pids}")

        # -- warm; half a pass, the rolling deploy under traffic, one more
        # pass after it --------------------------------------------------
        fc.router.score_batch(batches[0], timeout_s=120.0)
        roll: dict = {}

        def deploy_mid_traffic(pump) -> None:
            while pump.done() < len(batches) // 2:
                time.sleep(0.005)
            roll["at"] = pump.done()
            t_r = time.perf_counter()
            roll["report"] = fc.rolling_deploy(v2)
            roll["wall_s"] = time.perf_counter() - t_r
            roll["done_at"] = pump.done()
            pump.finish(len(batches))

        pumped = FleetPump(fc, batches, FLEET_CLIENTS).run(deploy_mid_traffic)
        reqs = pumped["requests"]
        errors = [r for *_, r in reqs if isinstance(r, BaseException)]
        assert not errors, f"[fleet] {len(errors)} requests failed: {errors[:2]}"
        assert len(reqs) == pumped["total"]
        versions = set()
        for b, _ta, _tb, res in reqs:
            assert res.version in (v1, v2) and res.generation is not None, \
                (res.version, res.generation)
            versions.add((res.version, res.generation))
            got = serve_rows(res.results)
            ref = want[starts[b]:starts[b] + len(batches[b])]
            assert got.shape == ref.shape and np.array_equal(got, ref), (
                f"[fleet] batch {b} on {res.version}: rows differ from "
                f"score_function(), up to {max_ulps(got, ref):g} ULP")
        assert {v for v, _ in versions} == {v1, v2}, versions
        snap = fc.router.snapshot()
        n_rows = sum(len(batches[b]) for b, *_ in reqs)
        assert snap["rows_ok"] == n_rows + len(batches[0]), (
            snap["rows_ok"], n_rows)
        assert snap["replica_deaths"] == 0 and snap["retries"] == 0, snap
        assert all(r.restarts == 0 for r in fc._replicas.values())
        walls = np.array([1e3 * (tb - ta) for _b, ta, tb, _r in reqs])
        out["route"] = {
            "requests": len(reqs), "rows": n_rows,
            "wall_s": pumped["wall_s"],
            "rows_per_s": n_rows / pumped["wall_s"],
            "batch_p50_ms": float(np.percentile(walls, 50)),
            "batch_p99_ms": float(np.percentile(walls, 99)),
            "versions": sorted(f"{v}/g{g}" for v, g in versions),
            "rows_by_replica": {k: v["rows_ok"]
                                for k, v in snap["replicas"].items()},
        }
        out["rolling_deploy"] = dict(roll)
        r = out["route"]
        single = deploy_serve["rows_per_s"]
        log(f"[fleet] routed {r['requests']} batches of up to "
            f"{FLEET_BATCH_ROWS} rows ({r['rows']} rows: [serve]'s "
            f"{len(records)} held-out records round robin, one pass after "
            f"the rolling deploy) from "
            f"{FLEET_CLIENTS} client threads in {r['wall_s']:.3f} s: "
            f"{r['rows_per_s']:.0f} rows/s with {FLEET_REPLICAS} replicas "
            f"(against {single} rows/s of [deploy]'s single-process serve "
            f"run), batch p50 {r['batch_p50_ms']:.3f} ms, p99 "
            f"{r['batch_p99_ms']:.3f} ms; rows by replica "
            f"{r['rows_by_replica']}; none dropped, every row 0 ULP from "
            f"score_function(); responses by (version, generation) "
            f"{r['versions']}")
        for s in roll["report"]:
            log(f"[fleet] rolling deploy step: {s['instance']} -> "
                f"{s['version']} generation {s['generation']}, drained and "
                f"swapped in {s['swap_s']:.3f} s")
        log(f"[fleet] rolling deploy to {v2}: {roll['wall_s']:.3f} s, "
            f"started after {roll['at']} and done after {roll['done_at']} "
            f"of {pumped['total']} requests")

        # -- each worker's K2 launches, holds and device memory ------------
        by_inst = {k: v["requests_ok"] for k, v in snap["replicas"].items()}
        views = wait_fleet_views(fc, sorted(pids), by_inst)
        smi = compute_app_memory()
        used["routed"] = device_used_bytes()
        out["workers"] = {}
        for inst in sorted(pids):
            v = views[inst]
            assert v["pid"] == pids[inst], (inst, v["pid"], pids[inst])
            assert v["launches"] >= 1, f"[fleet] {inst}: K2 never launched"
            assert v["held"] == v["launches"], (inst, v)
            assert v["mismatches"] == 0 and v["max_abs_err"] == 0, (inst, v)
            assert v["fused_moments_launches"] == 0, (inst, v)
            bin_errs.append(v["max_abs_err"])
            out["workers"][inst] = {
                "pid": v["pid"], "k2_launches": v["launches"],
                "k2_shapes": v["shapes"],
                "memory_allocated": v["memory_allocated"],
                "max_memory_allocated": v["max_memory_allocated"],
                "memory_reserved": v["memory_reserved"],
                "smi_used_mib": smi.get(pids[inst]),
                "spawn_to_ready_s": out["spawn_to_ready_s"][inst],
                "rows_ok": snap["replicas"][inst]["rows_ok"],
            }
            w = out["workers"][inst]
            log(f"[fleet] {inst} (pid {w['pid']}): K2 launched "
                f"{w['k2_launches']} times, each equal to plain, at "
                f"{w['k2_shapes']}; device memory: nvidia-smi "
                f"{w['smi_used_mib']} MiB, torch allocated "
                f"{w['memory_allocated']} B (peak "
                f"{w['max_memory_allocated']} B, reserved "
                f"{w['memory_reserved']} B)")
        out["parent_smi_used_mib"] = smi.get(os.getpid())
        log(f"[fleet] this process: nvidia-smi {out['parent_smi_used_mib']} "
            f"MiB; all compute apps {smi}; the card's memory in use "
            f"{used['before']} B before the fleet, {used['up']} B with the "
            f"{FLEET_REPLICAS} workers up ({(used['up'] - used['before']) / FLEET_REPLICAS:.0f}"
            f" B a worker), {used['routed']} B after the traffic")

        # -- [bulk] while the three workers are up ------------------------
        out["bulk"] = bulk_step(kernels, tmp, serve_csv, records, want, fc,
                                bin_errs)

        # -- the SIGKILL drill ----------------------------------------------
        victim = fc._replicas["replica-1"]
        kill: dict = {}

        def kill_mid_traffic(pump) -> None:
            # a quarter of the way through the pass: the fleet is busy
            while pump.done() < len(batches) // 4:
                time.sleep(0.001)
            kill["t"] = time.perf_counter()
            kill["at"] = pump.done()
            os.kill(victim.proc.pid, signal.SIGKILL)
            while fc.router.snapshot()["replica_deaths"] < 1:
                time.sleep(0.001)
            kill["detect_s"] = time.perf_counter() - kill["t"]

        before = fc.router.snapshot()["rows_ok"]
        pumped = FleetPump(fc, batches, FLEET_CLIENTS,
                           total=len(batches)).run(kill_mid_traffic)
        reqs = pumped["requests"]
        errors = [r for *_, r in reqs if isinstance(r, BaseException)]
        assert not errors, f"[fleet] kill drill: {len(errors)} failed: {errors[:2]}"
        assert kill["at"] < pumped["total"], "[fleet] traffic ended before the kill"
        for b, _ta, _tb, res in reqs:
            got = serve_rows(res.results)
            ref = want[starts[b]:starts[b] + len(batches[b])]
            assert np.array_equal(got, ref), f"[fleet] kill drill batch {b}"
        snap = fc.router.snapshot()
        n_rows = sum(len(batches[b]) for b, *_ in reqs)
        assert n_rows == len(records) and len(reqs) == len(batches)
        assert snap["rows_ok"] - before == n_rows, (snap["rows_ok"], before)
        assert snap["replica_deaths"] == 1, snap["replica_deaths"]
        live = sorted(h.instance for h in fc.router.live_replicas())
        assert live == ["replica-0", "replica-2"], live
        assert victim.proc.wait(timeout=10) == -signal.SIGKILL
        assert all(r.restarts == 0 for r in fc._replicas.values())
        # recovery: the last answer to a request that was out before the kill
        orphans = [tb for _b, ta, tb, _r in reqs if ta < kill["t"] < tb]
        kill["recover_s"] = (max(orphans) - kill["t"]) if orphans else 0.0
        kill.update(retries=snap["retries"], in_flight=len(orphans),
                    rows=n_rows, wall_s=pumped["wall_s"])
        del kill["t"]
        out["kill"] = kill
        log(f"[fleet] SIGKILL of replica-1 after {kill['at']} of "
            f"{pumped['total']} requests: death seen in "
            f"{kill['detect_s']:.3f} s, the {len(orphans)} requests out at "
            f"the kill answered within {kill['recover_s']:.3f} s "
            f"({snap['retries']} failed over); {n_rows} rows conserved "
            f"exactly on {live}, every row 0 ULP, no restarts")
        # the launches of the kill pass too: the survivors' views once
        # they shipped their batches, replica-1's last view before it died
        by_inst = {k: v["requests_ok"] for k, v in snap["replicas"].items()
                   if k != "replica-1"}
        views = wait_fleet_views(fc, sorted(by_inst), by_inst)
        for inst, w in out["workers"].items():
            v = views.get(inst)
            if v is None:  # the killed worker's shard aged out
                assert inst == "replica-1", sorted(views)
                continue
            assert v["held"] == v["launches"] >= w["k2_launches"], (inst, v)
            assert v["mismatches"] == 0 and v["max_abs_err"] == 0, (inst, v)
            w["k2_launches"], w["k2_shapes"] = v["launches"], v["shapes"]
        log("[fleet] K2 launches a worker after the kill drill (each equal "
            "to plain; replica-1 as of its last shipped view): "
            + ", ".join(f"{k} {w['k2_launches']}"
                        for k, w in out["workers"].items()))

        # -- [autoscale] on the same controller ----------------------------
        out["autoscale"] = autoscale_step(kernels, records, want, batches,
                                          starts, fc, bin_errs)
    finally:
        watching.set()
        fc.stop()
    assert all(r.proc.poll() is not None for r in fc._replicas.values())
    used["stopped"] = device_used_bytes()
    out["device_used_bytes"] = used
    log(f"[fleet] the card's memory in use after the fleet stopped: "
        f"{used['stopped']} B (before it: {used['before']} B)")

    # -- K2 at the workers' shapes, timed here -------------------------------
    out["k2_shapes"] = []
    launches = {}
    for w in out["workers"].values():
        for key, n in w["k2_shapes"].items():
            m = int(key.split("x")[0])
            launches[m] = launches.get(m, 0) + n
    assert set(launches) == set(k2_inputs), (sorted(launches), sorted(k2_inputs))
    for m in sorted(k2_inputs):
        x, edges, dtype = k2_inputs[m]
        bin_errs.append(check_bins(kernels, x, edges, dtype))
        b = time_bins(kernels, x, edges, dtype)
        b["fleet_launches"] = launches[m]
        out["k2_shapes"].append(b)
        log_bins_times(f"[fleet] {tuple(x.shape)} x {edges.shape[1]} edges "
                       f"-> {dtype} ({launches[m]} launches in the workers)",
                       b)
    # the autoscaler's new workers served at the same shapes
    grown: dict = {}
    for w in out["autoscale"]["surge"]["workers"].values():
        for key, n in w["k2_shapes"].items():
            m = int(key.split("x")[0])
            grown[m] = grown.get(m, 0) + n
    assert set(grown) <= set(k2_inputs), (sorted(grown), sorted(k2_inputs))
    for b in out["k2_shapes"]:
        b["autoscale_launches"] = grown.get(b["shape"][0], 0)
    # [bulk]'s local chunks, timed at their shapes
    bulk = out["bulk"]
    bulk["k2_shapes"] = []
    for m, (x, edges, dtype) in sorted(bulk.pop("k2_inputs").items()):
        b = time_bins(kernels, x, edges, dtype)
        b["bulk_launches"] = sum(v.get(m, 0) for v in bulk["k2"].values())
        bulk["k2_shapes"].append(b)
        log_bins_times(f"[bulk] {tuple(x.shape)} x {edges.shape[1]} edges "
                       f"-> {dtype} ({b['bulk_launches']} launches here)", b)
    out["k2_launches"] = sum(w["k2_launches"] for w in out["workers"].values())
    out["wall_s"] = time.perf_counter() - t_step
    log(f"[fleet] step wall {out['wall_s']:.1f} s")
    return out


# -- [bulk]: exactly-once bulk scoring on the card --------------------------------

#: [bulk]: [serve]'s held-out CSV in BULK_SHARDS shard files of
#: consecutive rows, scored with ``chunk_rows`` BULK_CHUNK_ROWS (a CSV
#: shard is read in 16 MB chunks, so each of these shards arrives as one
#: chunk: ``chunk_rows`` sizes record-oriented shards)
BULK_SHARDS, BULK_CHUNK_ROWS = 4, 4096
#: the kill drill: the child dies once the second shard's output is
#: durable, before its journal receipt
BULK_KILL_FAULT = "bulk.output_crash:on=2"


def write_csv_shards(path: str, out_dir: str, n: int) -> list:
    """``path``'s rows in ``n`` CSV files of consecutive rows, each with
    the header; returns their paths in order."""
    with open(path) as f:
        header, *lines = f.read().splitlines(keepends=True)
    os.makedirs(out_dir, exist_ok=True)
    step = -(-len(lines) // n)
    paths = []
    for k in range(n):
        p = os.path.join(out_dir, f"part-{k}.csv")
        with open(p, "w") as f:
            f.write(header)
            f.writelines(lines[k * step:(k + 1) * step])
        paths.append(p)
    return paths


def bulk_rows(blob: bytes, keys: list) -> np.ndarray:
    """A bulk job's output lines (one Prediction each) -> [n, k] float64
    in ``keys`` order (the output's keys are sorted; ``score_function``
    rows are in the prediction's own order)."""
    rows = [next(iter(json.loads(line).values()))
            for line in blob.splitlines()]
    return np.array([[r[k] for k in keys] for r in rows], dtype=np.float64)


def cli_json(argv: list) -> tuple:
    """(exit code, JSON document) of ``cli.main(argv)`` in this process."""
    import io

    from transmogrifai_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, json.loads(buf.getvalue())


def bulk_step(kernels, tmp: str, serve_csv: str, records: list,
              want: np.ndarray, fc, bin_errs: list) -> dict:
    """``[bulk]``, inside ``[fleet]`` while its three workers are up:
    [serve]'s held-out CSV in BULK_SHARDS shards through
    ``BulkScoringJob`` on [serve]'s saved forest (v1), on the card's
    torch-fused route, every K2 launch of this process held against
    plain; a child on the card that loads v1 through
    ``fleet_forest_workflow`` and dies by ``BULK_KILL_FAULT``, and this
    process's resume of its job; the same shards through the fleet
    (``router=fc``); ``cli bulk status`` and ``cli fleet status``.  Every
    output row is held at 0 ULP against ``want`` (``score_function()``'s
    rows over ``records``).  Returns the result lines' pieces."""
    from transmogrifai_tpu_torch.bulk import (
        BulkJournal,
        BulkScoringJob,
        concatenated_output,
    )
    from transmogrifai_tpu_torch.faults import DEFAULT_KILL_EXIT
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
    from transmogrifai_tpu_torch.testkit.drills import (
        BULK_KILL_CHILD_TEMPLATE,
        drill_env,
    )
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

    t_step = time.perf_counter()
    out: dict = {"walls": {}}
    shards = write_csv_shards(serve_csv, os.path.join(tmp, "bulk_in"),
                              BULK_SHARDS)
    forest_dir = os.path.join(tmp, "forest")
    # the output lines name the result feature, and its name carries the
    # stages' uids: load v1 into the workflow a fresh process (the kill
    # child) builds first, so the two write the same bytes
    reset_uids()
    wf = serve_front(serve_csv, OpRandomForestClassifier(**SERVE_FOREST))
    wf.device = fc.device
    model = OpWorkflowModel.load(forest_dir, wf)
    assert model.device == fc.device
    keys = list(next(iter(
        model.score_function().score_batch(records[:1])[0].values())))

    def held(kept) -> dict:
        """Each K2 call of ``kept`` against plain; launches by rows."""
        by_rows: dict = {}
        for args in kept["bin_matrix"]:
            assert args[0].device.type == fc.device, args[0].device
            bin_errs.append(check_bins(kernels, *args))
            m = int(args[0].shape[0])
            by_rows[m] = by_rows.get(m, 0) + 1
        return by_rows

    # -- 1: the uninterrupted job, local, on the card -------------------
    job_dir = os.path.join(tmp, "bulk_job")
    kernels.reset_launches()
    with kernel_inputs(kernels) as kept:
        t0 = time.perf_counter()
        summary = BulkScoringJob(model, job_dir, shards,
                                 chunk_rows=BULK_CHUNK_ROWS,
                                 fused_backend="torch").run()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    assert summary["scorer_backend"] == "torch", summary["scorer_backend"]
    led = summary["ledger"]
    assert led["balanced"] and led["complete"], led
    assert led["rows_in"] == led["rows_out"] + led["rows_quarantined"]
    assert led["rows_out"] == len(records) and led["rows_quarantined"] == 0
    blob = concatenated_output(job_dir)
    got = bulk_rows(blob, keys)
    assert got.shape == want.shape and np.array_equal(got, want), (
        f"[bulk] rows differ from score_function(), up to "
        f"{max_ulps(got, want):g} ULP")
    assert launches["fused_moments"] == 0, launches
    assert launches["bin_matrix"] == len(kept["bin_matrix"]) >= BULK_SHARDS
    k2 = {"local": held(kept)}
    k2_inputs = {int(a[0].shape[0]): a for a in kept["bin_matrix"]}
    del kept
    out["local"] = {"rows": led["rows_out"], "wall_s": wall,
                    "rows_per_s": led["rows_out"] / wall,
                    "job_rows_per_s": summary["rows_per_s"],
                    "launches": launches["bin_matrix"],
                    "bytes": len(blob)}
    log(f"[bulk] {len(records)} held-out rows in {BULK_SHARDS} CSV shards "
        f"through BulkScoringJob on the card ({summary['scorer_backend']}-"
        f"fused, chunk_rows {BULK_CHUNK_ROWS}): {wall:.3f} s, "
        f"{out['local']['rows_per_s']:.0f} rows/s; ledger rows_in "
        f"{led['rows_in']} == rows_out {led['rows_out']} + quarantined "
        f"{led['rows_quarantined']}; every row 0 ULP from score_function(); "
        f"K2 launched {launches['bin_matrix']} times at rows "
        f"{k2['local']}, each equal to plain")

    # -- 2: the kill drill: a child on the card dies, this process resumes
    kill_dir = os.path.join(tmp, "bulk_kill")
    script = os.path.join(tmp, "bulk_kill_child.py")
    with open(script, "w") as f:
        f.write(BULK_KILL_CHILD_TEMPLATE.format(
            repo=os.path.dirname(os.path.abspath(__file__)),
            fault=BULK_KILL_FAULT, n=0, job_dir=kill_dir, shards=shards,
            chunk=BULK_CHUNK_ROWS, device=fc.device, model_dir=forest_dir,
            factory=FLEET_WORKFLOW))
    env = dict(drill_env(), **{FLEET_CSV_ENV: serve_csv})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script], env=env, timeout=600,
                          capture_output=True, text=True)
    child_s = time.perf_counter() - t0
    assert proc.returncode == DEFAULT_KILL_EXIT, (
        f"[bulk] the kill child exited {proc.returncode}: "
        f"{proc.stderr[-3000:]}")
    killed = BulkJournal.load(kill_dir)
    states = killed.states()
    assert states["committed"] == 1 and states["assigned"] == 1, states
    assert os.path.exists(killed.output_path(1))
    kernels.reset_launches()
    with kernel_inputs(kernels) as kept:
        t0 = time.perf_counter()
        resumed = BulkScoringJob(model, kill_dir,
                                 fused_backend="torch").run()
        resume_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    assert resumed["resumed"] is True
    (resume,) = resumed["resumes"]
    assert resume["recovered_states"] == {"1": "assigned"}, resume
    assert resume["rescored_shards"] == [1], resume
    # no shard committed twice: the child's committed shard 0 is never
    # scored again, the resume scores the three it did not commit
    assert resumed["shards_scored_this_run"] == BULK_SHARDS - 1
    assert launches["bin_matrix"] == len(kept["bin_matrix"])
    k2["resume"] = held(kept)
    del kept
    assert concatenated_output(kill_dir) == blob, \
        "[bulk] the resumed output is not byte-equal to the uninterrupted run"
    rled = resumed["ledger"]
    assert rled["balanced"] and rled["rows_out"] == len(records), rled
    done = BulkJournal.load(kill_dir)
    assert done.states()["committed"] == BULK_SHARDS
    assert all(done.verify_output(s) for s in done.shard_ids())
    out["kill"] = {"child_s": child_s, "child_exit": proc.returncode,
                   "states_at_kill": states, "resume_s": resume_s,
                   "rescored_shards": resume["rescored_shards"],
                   "launches": launches["bin_matrix"]}
    log(f"[bulk] kill drill: a child on the card loaded v1 through "
        f"{FLEET_WORKFLOW} and died by {BULK_KILL_FAULT} (exit "
        f"{proc.returncode}, {child_s:.3f} s) with journal states {states}; "
        f"this process resumed in {resume_s:.3f} s, re-scoring shard(s) "
        f"{resume['rescored_shards']} and scoring {BULK_SHARDS - 1} "
        f"uncommitted shards (none committed twice); the output is "
        f"byte-equal to the uninterrupted run; K2 {launches['bin_matrix']} "
        f"launches, each equal to plain")

    # -- 3: the same shards through the fleet ---------------------------
    before = fc.router.snapshot()
    views_before = fleet_views(fc)
    fleet_dir = os.path.join(tmp, "bulk_fleet")
    t0 = time.perf_counter()
    fsum = BulkScoringJob(model, fleet_dir, shards, router=fc,
                          chunk_rows=BULK_CHUNK_ROWS).run()
    fleet_s = time.perf_counter() - t0
    fled = fsum["ledger"]
    assert fled["balanced"] and fled["rows_out"] == len(records), fled
    frows = bulk_rows(concatenated_output(fleet_dir), keys)
    assert np.array_equal(frows, got), (
        f"[bulk] fleet rows differ from the local run's, up to "
        f"{max_ulps(frows, got):g} ULP")
    snap = fc.router.snapshot()
    assert snap["rows_ok"] - before["rows_ok"] == len(records)
    assert snap["requests_failed"] == before["requests_failed"]
    by_inst = {k: v["requests_ok"] for k, v in snap["replicas"].items()}
    views = wait_fleet_views(fc, sorted(by_inst), {
        k: views_before[k]["held"] + n - before["replicas"][k]["requests_ok"]
        for k, n in by_inst.items()})
    worker_k2 = {}
    for inst in sorted(by_inst):
        v = views[inst]
        assert v["held"] == v["launches"], (inst, v)
        assert v["mismatches"] == 0 and v["max_abs_err"] == 0, (inst, v)
        bin_errs.append(v["max_abs_err"])
        worker_k2[inst] = v["launches"] - views_before[inst]["launches"]
    rows_by = {k: v["rows_ok"] - before["replicas"][k]["rows_ok"]
               for k, v in snap["replicas"].items()}
    out["fleet"] = {"wall_s": fleet_s, "rows_per_s": len(records) / fleet_s,
                    "rows_by_replica": rows_by, "k2_launches": worker_k2}
    log(f"[bulk] the same shards through the fleet's {len(by_inst)} "
        f"workers: {fleet_s:.3f} s, {out['fleet']['rows_per_s']:.0f} rows/s; "
        f"rows by replica {rows_by}; every row equal to the local run's; "
        f"K2 launches in the workers {worker_k2}, each equal to plain")

    # -- 4: the operator's view --------------------------------------------
    rc, doc = cli_json(["bulk", "status", job_dir])
    assert rc == 0 and doc["n_shards"] == BULK_SHARDS, (rc, doc)
    assert doc["states"]["committed"] == BULK_SHARDS
    assert doc["ledger"] == led, (doc["ledger"], led)
    rc, kdoc = cli_json(["bulk", "status", kill_dir])
    assert rc == 0 and kdoc["resume_count"] == 1
    assert kdoc["rescored_shards"] == [1]
    # the controller rewrites its status document every monitor tick
    deadline = time.monotonic() + 30.0
    while True:
        rc, fdoc = cli_json(["fleet", "status", "--path", fc.control_dir])
        router = fdoc.get("status", {}).get("router", {})
        if rc == 0 and router.get("rows_ok") == snap["rows_ok"]:
            break
        assert time.monotonic() < deadline, (rc, router, snap["rows_ok"])
        time.sleep(0.1)
    assert set(fdoc["status"]["replicas"]) == set(fc.member_instances())
    log(f"[bulk] cli bulk status: {doc['states']}, ledger rows_in "
        f"{doc['ledger']['rows_in']}, the kill job's resume_count "
        f"{kdoc['resume_count']}; cli fleet status: router rows_ok "
        f"{router['rows_ok']} over replicas "
        f"{sorted(fdoc['status']['replicas'])}, equal to the router's")
    out["k2"] = k2
    out["k2_inputs"] = k2_inputs
    out["wall_s"] = time.perf_counter() - t_step
    log(f"[bulk] step wall {out['wall_s']:.1f} s")
    return out


# -- [autoscale]: the capacity control loop over the card's workers ---------------

#: [autoscale]: the fleet between AUTOSCALE_MIN and AUTOSCALE_MAX serving
#: workers, one decision window every AUTOSCALE_INTERVAL_S driven from the
#: step's own loop; a low target utilization sizes the one scale-up
#: straight to the maximum
AUTOSCALE_MIN, AUTOSCALE_MAX = 2, 4
AUTOSCALE_INTERVAL_S, AUTOSCALE_TARGET_UTIL = 0.1, 0.25
#: the surge's client threads, the live retune's probe records and each
#: stage's deadline
AUTOSCALE_CLIENTS, AUTOSCALE_PROBE_ROWS = 12, 2048
AUTOSCALE_DEADLINE_S = 120.0


def autoscale_step(kernels, records: list, want: np.ndarray, batches: list,
                   starts: list, fc, bin_errs: list) -> dict:
    """``[autoscale]``, on ``[fleet]``'s controller after its SIGKILL drill
    (two workers serving, the killed one a gave-up member):
    ``FleetAutoscaler(min 2, max 4)`` with live probe records and no
    ``measure_fn``, ``step()`` driven here.  Under a FleetPump surge one
    scale-up brings the fleet to four workers on the card, whose rows are
    0 ULP from ``score_function()`` and whose K2 launches are held
    against plain in the workers; with no load, scale-down decisions
    drain it back to two, no request dropped and the row ledger exact;
    then under a tight p99 objective (a real SLO engine over the workers'
    shipped metrics) one A/B retune of the micro-batch knobs, its winner
    applied on every member.  Returns the result lines' pieces."""
    from transmogrifai_tpu_torch.fleet import FleetAutoscaler
    from transmogrifai_tpu_torch.obs.slo import SLObjective, SLOEngine

    t_step = time.perf_counter()
    out: dict = {"decisions": []}
    scaler = FleetAutoscaler(
        fc, min_replicas=AUTOSCALE_MIN, max_replicas=AUTOSCALE_MAX,
        interval_s=AUTOSCALE_INTERVAL_S, up_consecutive=2,
        down_consecutive=2, cooldown_windows=1,
        target_utilization=AUTOSCALE_TARGET_UTIL, retune_enabled=False,
        probe_records=records[:AUTOSCALE_PROBE_ROWS],
        probe_timeout_s=120.0, drain_timeout_s=60.0)

    def window(stage: str):
        t0 = time.perf_counter()
        d = scaler.step()
        if d is not None:
            wall = time.perf_counter() - t0
            row = {"stage": stage, "action": d.action,
                   "outcome": d.outcome, "reason": d.reason,
                   "members_before": d.members_before,
                   "members_after": d.members_after, "target": d.target,
                   "wall_s": wall,
                   "utilization": d.evidence.get("utilization")}
            out["decisions"].append(row)
            log(f"[autoscale] {stage}: {d.action} ({d.outcome}; "
                f"{d.reason}) members {d.members_before} -> "
                f"{d.members_after}, target {d.target}, utilization "
                f"{d.evidence.get('utilization')}, decision wall "
                f"{wall:.3f} s")
        return d

    def live() -> list:
        return sorted(h.instance for h in fc.router.live_replicas())

    start_live = live()
    assert len(start_live) == AUTOSCALE_MIN, start_live
    snap0 = fc.router.snapshot()

    # -- 1: the surge: a pass of the held-out records (at least 8
    # batches a client) from AUTOSCALE_CLIENTS clients, during which one
    # scale-up goes to the
    # maximum (the new workers come up as the pass drains); then one more
    # pass over the grown fleet, its windows held at the maximum -------
    grown: dict = {}

    def surge(pump) -> None:
        while pump.done() < pump.total:
            d = window("surge")
            if d is not None and d.action == "scale_up":
                grown["decision"] = d
                return
            time.sleep(AUTOSCALE_INTERVAL_S)

    def at_max(pump) -> None:
        while pump.done() < pump.total:
            window("surge")
            time.sleep(AUTOSCALE_INTERVAL_S)

    t0 = time.perf_counter()
    pumped = FleetPump(fc, batches, AUTOSCALE_CLIENTS,
                       total=max(len(batches), 8 * AUTOSCALE_CLIENTS)
                       ).run(surge)
    assert "decision" in grown, "[autoscale] the surge never scaled up"
    more = FleetPump(fc, batches, AUTOSCALE_CLIENTS,
                     total=len(batches)).run(at_max)
    surge_s = time.perf_counter() - t0
    up = grown["decision"]
    added = up.evidence["added"]
    assert len(live()) == AUTOSCALE_MAX, live()
    assert len(added) == AUTOSCALE_MAX - len(start_live), up.evidence
    assert [d["action"] for d in out["decisions"]].count("scale_up") == 1
    reqs = pumped["requests"] + more["requests"]
    errors = [r for *_, r in reqs if isinstance(r, BaseException)]
    assert not errors, f"[autoscale] {len(errors)} requests failed"
    rows_by_inst: dict = {}
    for b, _ta, _tb, res in reqs:
        got = serve_rows(res.results)
        ref = want[starts[b]:starts[b] + len(batches[b])]
        assert np.array_equal(got, ref), (
            f"[autoscale] batch {b} on {res.instance}: up to "
            f"{max_ulps(got, ref):g} ULP from score_function()")
        rows_by_inst[res.instance] = (rows_by_inst.get(res.instance, 0)
                                      + len(batches[b]))
    surge_rows = sum(len(batches[b]) for b, *_ in reqs)
    for inst in added:
        doc = fc.router.control(inst, "status", timeout_s=60.0)
        assert doc["device"] == fc.device, (inst, doc["device"])
        assert rows_by_inst.get(inst, 0) > 0, (inst, rows_by_inst)
    snap = fc.router.snapshot()
    by_inst = {k: v["requests_ok"] for k, v in snap["replicas"].items()}
    views = wait_fleet_views(fc, added, by_inst)
    new_workers = {}
    for inst in added:
        v = views[inst]
        assert v["held"] == v["launches"] >= 1, (inst, v)
        assert v["mismatches"] == 0 and v["max_abs_err"] == 0, (inst, v)
        bin_errs.append(v["max_abs_err"])
        new_workers[inst] = {"pid": v["pid"], "k2_launches": v["launches"],
                             "k2_shapes": v["shapes"],
                             "rows": rows_by_inst[inst],
                             "memory_allocated": v["memory_allocated"]}
    out["surge"] = {"wall_s": surge_s, "requests": len(reqs),
                    "rows": surge_rows, "rows_per_s": surge_rows / surge_s,
                    "scale_up_wall_s": next(
                        d["wall_s"] for d in out["decisions"]
                        if d["action"] == "scale_up"),
                    "rows_by_replica": rows_by_inst, "added": added,
                    "workers": new_workers}
    log(f"[autoscale] surge: {len(reqs)} batches ({surge_rows} rows: two "
        f"passes) from {AUTOSCALE_CLIENTS} clients in {surge_s:.3f} s; one "
        f"scale_up "
        f"brought {added} up on the card (each reports device {fc.device}) in "
        f"{out['surge']['scale_up_wall_s']:.3f} s, {len(live())} workers "
        f"serving; rows by replica {rows_by_inst}, every row 0 ULP from "
        f"score_function(); the new workers' K2 launches "
        + ", ".join(f"{k} {w['k2_launches']} at {w['k2_shapes']}"
                    for k, w in new_workers.items())
        + ", each equal to plain")

    # -- 2: no load: scale-down drains back to the minimum ---------------
    t0 = time.perf_counter()
    deadline = time.monotonic() + AUTOSCALE_DEADLINE_S
    while len(live()) > AUTOSCALE_MIN:
        assert time.monotonic() < deadline, (
            f"[autoscale] the idle fleet never shrank: {live()}")
        window("idle")
        time.sleep(AUTOSCALE_INTERVAL_S)
    idle_s = time.perf_counter() - t0
    downs = [d for d in out["decisions"] if d["action"] == "scale_down"]
    assert downs, out["decisions"]
    assert live() == start_live, (live(), start_live)
    snap = fc.router.snapshot()
    assert snap["rows_ok"] - snap0["rows_ok"] == surge_rows, (
        snap["rows_ok"], snap0["rows_ok"], surge_rows)
    assert snap["requests_failed"] == snap0["requests_failed"]
    out["idle"] = {"wall_s": idle_s, "scale_downs": len(downs),
                   "live": live()}
    log(f"[autoscale] no load: {len(downs)} scale_down decision(s) in "
        f"{idle_s:.3f} s drained the fleet back to {live()}; no request "
        f"dropped, the router's rows_ok moved by exactly the surge's "
        f"{surge_rows} rows")

    # -- 3: a tight p99 objective burns: one live A/B retune --------------
    scaler.retune_enabled = True
    engine = fc.slo_engine
    fc.slo_engine = SLOEngine(
        [SLObjective(name="serving-p99-latency", kind="threshold",
                     metric="serving.latency_ms.p99", objective=1e-3,
                     windows_s=(300.0, 60.0))],
        doc_fn=fc.aggregator.merged_metrics_docs, register=False)
    retune: dict = {}

    def burn(pump) -> None:
        deadline = time.monotonic() + AUTOSCALE_DEADLINE_S
        while time.monotonic() < deadline:
            d = window("burn")
            if d is not None and d.action == "retune":
                retune["decision"] = d
                break
            time.sleep(AUTOSCALE_INTERVAL_S)
        pump.finish(0)

    try:
        t0 = time.perf_counter()
        pumped = FleetPump(fc, batches, 2).run(burn)
        retune_s = time.perf_counter() - t0
    finally:
        fc.slo_engine = engine
    assert "decision" in retune, "[autoscale] no retune under the burn"
    d = retune["decision"]
    assert d.outcome in ("tuned", "baseline_held"), d.outcome
    assert not [r for *_, r in pumped["requests"]
                if isinstance(r, BaseException)]
    members = sorted(fc.member_instances())
    assert d.evidence["applied_on"] == live(), (d.evidence["applied_on"],
                                                live())
    kd = d.evidence["knob_decision"]
    cap = (kd["winner"]["max_batch_size"] if d.outcome == "tuned" else None)
    for inst in live():
        knobs = fc.router.control(inst, "status", timeout_s=60.0)["knobs"]
        assert knobs["max_batch_size"] == cap, (inst, knobs, cap)
    out["retune"] = {"outcome": d.outcome, "winner": kd["winner"],
                     "baseline": kd.get("baseline"), "wall_s": retune_s,
                     "decision_wall_s": out["decisions"][-1]["wall_s"],
                     "applied_on": d.evidence["applied_on"],
                     "probes": kd.get("probes")}
    log(f"[autoscale] p99 objective 0.001 ms burning over the workers' "
        f"shipped metrics: one retune, {d.outcome}, winner {kd['winner']} "
        f"(baseline {kd.get('baseline')}) applied on {live()} (members "
        f"{members}) in {out['decisions'][-1]['wall_s']:.3f} s")
    out["scaler"] = scaler.snapshot()
    out["wall_s"] = time.perf_counter() - t_step
    log(f"[autoscale] step wall {out['wall_s']:.1f} s")
    return out


# -- [cli]: the project generator, host only ---------------------------------------

def cli_step(tmp: str, serve_csv: str) -> dict:
    """``[cli]``: ``cli.main(["gen", ...])`` on [serve]'s README CSV, the
    generated ``build_workflow()`` imported and checked to build a port
    workflow on the card, and every generated source AST-checked to
    import no module of the JAX package.  Nothing is trained here."""
    import ast
    import importlib.util

    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

    t0 = time.perf_counter()
    proj = os.path.join(tmp, "gen_project")
    from transmogrifai_tpu_torch import cli

    rc = cli.main(["gen", "--input", serve_csv, "--response", "survived",
                   "--name", "SmokeApp", "--output", proj])
    assert rc == 0
    imported = set()
    for name in sorted(os.listdir(proj)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(proj, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("transmogrifai_tpu", "jax"), (name, m)
                imported.add(m)
    assert any(m.startswith("transmogrifai_tpu_torch") for m in imported)
    spec = importlib.util.spec_from_file_location(
        "smoke_generated_main", os.path.join(proj, "main.py"))
    main_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(main_mod)
    wf, prediction, evaluator = main_mod.build_workflow()
    assert isinstance(wf, OpWorkflow) and wf.device == "cuda", wf.device
    assert type(wf).__module__.startswith("transmogrifai_tpu_torch.")
    wall = time.perf_counter() - t0
    files = sorted(os.listdir(proj))
    log(f"[cli] cli gen on [serve]'s CSV wrote {files}; the generated "
        f"build_workflow() builds a {type(wf).__name__} of "
        f"{type(wf).__module__} on {wf.device} ({type(evaluator).__name__}); "
        f"its sources import {len(imported)} modules, none of the JAX "
        f"package; {wall:.3f} s")
    return {"files": files, "device": wf.device, "wall_s": wall,
            "imports": sorted(imported)}


def serve_phase(kernels, readme_model, bin_errs: list,
                readme_build=None) -> dict:
    """``[serve]``: three models served on the card through save ->
    ``OpWorkflowModel.load`` -> ``score_function()``: the README model,
    a forest and a GBT at the default grids' deepest points fitted on the
    README front at SERVE_FIT_ROWS.  Each scores SERVE_RECORDS held-out
    CSV records at every SERVE_BATCHES size, torch-fused against
    numpy-fused; K2 is launched once per tree-head batch and each launch
    is held against its plain version; K2 is timed at the serving shapes.
    Then ``[deploy]`` (``deploy_step``) in the same temporary directory,
    over the saved forest and GBT artifacts.
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
        # the README model's profiled call was cut to make room for
        # [bulk] and [autoscale] (7.5 s of the profiler's first start and
        # read); the forest's and the GBT's stay
        out["readme"] = serve_one(
            kernels, "readme", readme_model, lambda: build(serve_csv),
            records, data, tmp, bin_errs, profiled=False)
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
        deploy = deploy_step(kernels, tmp, serve_csv,
                             {"v1": out["forest"]["rows"],
                              "v2": out["gbt"]["rows"]}, bin_errs)
        out["fleet"] = fleet_step(kernels, tmp, serve_csv, records,
                                  out["forest"]["rows"], deploy["serve"],
                                  bin_errs)
        cli_out = cli_step(tmp, serve_csv)
    fleet = out.pop("fleet")
    for v in out.values():
        del v["rows"]
    out["fleet"] = fleet
    out["cli"] = cli_out
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
    # and at [deploy]'s shapes, its buckets (the deploy run's own inputs)
    kept = deploy.pop("k2_inputs")
    deploy["k2_shapes"] = []
    for m in sorted(kept):
        x, edges, dtype = kept[m]
        b = time_bins(kernels, x, edges, dtype)
        b["deploy_launches"] = sum(v.get(m, 0) for v in
                                   deploy["k2_launches_by_rows"].values())
        deploy["k2_shapes"].append(b)
        log_bins_times(f"[deploy] {tuple(x.shape)} x {edges.shape[1]} edges "
                       f"-> {dtype} ({b['deploy_launches']} launches)", b)
    del kept
    out["deploy"] = deploy
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


# -- [mesh]: multi-GPU on torch.distributed ----------------------------------
#: the world-2 workloads' sizes: the SanityChecker at 1M x 39, the LR
#: grid's CV at [selector]'s 200k rows, a forest and a GBT fold x grid fit
#: at [selector]'s cut depths (6 and 3; [fused_train]'s tree families)
MESH_SANITY_ROWS = 1_000_000
MESH_CV_ROWS = SELECTOR_ROWS
MESH_TEXT_DIMS = SCALE_SHAPE[1] - 7
MESH_FOREST = dict(num_trees=8, max_depth=6)
MESH_FOREST_GRID = [{"min_info_gain": m} for m in (0.0, 0.01)]
MESH_GBT = dict(num_trees=10, max_depth=3)
MESH_GBT_GRID = [{"step_size": s} for s in (0.1, 0.3)]
MESH_GBT_SCORE_ROWS = 20_000       # GBT predictions compared on these rows
MESH_MOMENT_RTOL = 3e-5            # world 2 against world 1: statistics
MESH_CV_RTOL = 1e-5                # CV means and fold metrics (exact mode)
MESH_RANK_TIMEOUT_S = 600


def mesh_workloads(kernels, train_fused=None,
                   time_shapes: bool = False) -> dict:
    """The [mesh] phase's product entry points, run in one process (world
    1, no process group) or on every rank of a world (the data and CV
    meshes active): a SanityChecker fit at MESH_SANITY_ROWS x 39,
    ``OpCrossValidation.validate`` of the LR grid, a forest and a GBT grid
    at MESH_CV_ROWS (exact rank metrics; ``train_fused`` goes to each
    validator, False for world 1 so that both worlds take the
    kernel-at-a-time path, which a mesh keeps).  Each workload's K1 and K2
    launches are counted; K1's block and every K2 input are held against
    the plain versions.  With ``time_shapes`` (world 1), K1 and K2 are
    also timed at a world-2 rank's shapes: K1 over half the rows, K2
    binning half the CV rows, K2 on a fold's validation rows (every rank
    scores the whole fold)."""
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )
    from transmogrifai_tpu_torch.examples.synthetic import (
        synthetic_design_matrix,
    )
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier,
        OpRandomForestClassifier,
    )
    from transmogrifai_tpu_torch.parallel.mesh import data_mesh_or_none, row_block
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.selector.factories import lr_grid
    from transmogrifai_tpu_torch.selector.validator import OpCrossValidation
    from transmogrifai_tpu_torch.types.columns import NumericColumn, VectorColumn
    from transmogrifai_tpu_torch.types.dataset import Dataset
    from transmogrifai_tpu_torch.types.feature_types import RealNN

    out: dict = {"launches": {}, "walls": {}, "k2_err": 0, "k2_calls": 0}
    X, y, meta = synthetic_design_matrix(MESH_SANITY_ROWS, seed=0,
                                         text_dims=MESH_TEXT_DIMS)
    n = len(y)
    label = NumericColumn(y, np.ones(n, bool), RealNN)
    vec = VectorColumn(X, meta)
    ds = Dataset({"label": label, "features": vec})
    sc = SanityChecker(device="cuda")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc.fit_model([label, vec], ds)
    torch.cuda.synchronize()
    out["walls"]["sanity"] = time.perf_counter() - t0
    out["launches"]["sanity"] = {w.__name__: w.launches
                                 for w in kernels.WRAPPERS}
    summ = sc.metadata["sanity_checker_summary"]
    out["sanity"] = {
        "dropped": list(summ["dropped"]),
        **{k: np.array([c[k] for c in summ["column_stats"]], np.float64)
           for k in ("mean", "variance", "corr_label")}}
    # K1 launched once on this process's rows of the design matrix
    mesh = data_mesh_or_none()
    lo, hi = row_block(n, mesh) if mesh is not None else (0, n)
    from transmogrifai_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    xb = torch.from_numpy(np.ascontiguousarray(X[lo:hi], np.float32)).to(dev)
    yb = torch.from_numpy(np.asarray(y[lo:hi], np.float32)).to(dev)
    out["k1"] = {"rows": [lo, hi], **check_moments(kernels, xb, yb)}
    if time_shapes:
        half = n // 2
        out["timings"] = [{"kernel": "fused_moments", "what": "a rank's block",
                           **time_moments(kernels, xb[:half], yb[:half])}]
    del xb, yb, ds, vec

    Xc, yc = X[:MESH_CV_ROWS].astype(np.float64), y[:MESH_CV_ROWS]
    del X
    ev = OpBinaryClassificationEvaluator()
    os.environ["TX_CV_RANK_METRICS"] = "exact"
    try:
        for name, est, grid in (
                ("cv", OpLogisticRegression(device="cuda"), lr_grid()),
                ("rf", OpRandomForestClassifier(**MESH_FOREST, device="cuda"),
                 MESH_FOREST_GRID),
                ("gbt", OpGBTClassifier(**MESH_GBT, device="cuda"),
                 MESH_GBT_GRID)):
            cv = OpCrossValidation(num_folds=3, evaluator=ev, stratify=True,
                                   device="cuda")
            cv.train_fused = train_fused
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with kernel_inputs(kernels) as kept, \
                    selector_walls(True, keep_grid=True) as rec:
                res = cv.validate([(est, grid)], Xc, yc)
            torch.cuda.synchronize()
            out["walls"][name] = time.perf_counter() - t0
            out["launches"][name] = {w.__name__: w.launches
                                     for w in kernels.WRAPPERS}
            for xk, ek, dt in kept["bin_matrix"]:
                out["k2_err"] = max(out["k2_err"], check_bins(kernels, xk, ek, dt))
                out["k2_calls"] += 1
            if time_shapes and name == "rf":
                (xk, ek, dt), (xv, _, _) = kept["bin_matrix"][:2]
                out["timings"] += [
                    {"kernel": "bin_matrix", "what": "a rank's binning",
                     **time_bins(kernels, xk[:len(xk) // 2].contiguous(),
                                 ek, dt)},
                    {"kernel": "bin_matrix", "what": "a fold's validation rows",
                     **time_bins(kernels, xv, ek, dt)}]
            assert not kept["fused_moments"], "a CV fit launched K1"
            del kept
            row = {"best_params": res.best_params,
                   "best_metric": float(res.best_metric),
                   "fold_metrics": np.array([r["fold_metrics"]
                                             for r in res.all_results]),
                   "trail": cv.last_train_fused}
            if name == "rf":
                row["heaps"] = [[p["heaps"] for p in per_fold]
                                for per_fold in rec["rf_grid"][0]]
            if name == "gbt":
                fits = rec["grid"][0]
                row["prob"] = [[est.with_params(**grid[j]).predict_arrays(
                    p, Xc[:MESH_GBT_SCORE_ROWS])[2] for p in fits[j]]
                    for j in range(len(grid))]
            out[name] = row
    finally:
        del os.environ["TX_CV_RANK_METRICS"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def mesh_rank(rank: int, init_url: str, out_path: str) -> None:
    """One rank of the [mesh] phase's world of 2 on the one card (``spawn``
    target): both ranks drive ``cuda:0`` (``LOCAL_RANK=0``) and join a
    gloo group - NCCL refuses two ranks on one GPU - whose collectives take
    the CUDA tensors; each runs ``mesh_workloads`` through the product
    entry points with the data and CV meshes active, counts its
    collectives and pickles its results to ``out_path``."""
    import pickle

    import torch.distributed as dist

    from transmogrifai_tpu_torch.parallel import distributed as tdist
    from transmogrifai_tpu_torch.parallel import kernels

    os.environ["LOCAL_RANK"] = "0"
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    tdist.initialize(coordinator_address=init_url, num_processes=2,
                     process_id=rank, backend="gloo")
    init_s = time.perf_counter() - t0
    counts = {"all_reduce": 0, "all_gather": 0}
    originals = {k: getattr(dist, k) for k in counts}

    def counted(k):
        def call(*a, **kw):
            counts[k] += 1
            return originals[k](*a, **kw)
        return call

    for k in counts:
        setattr(dist, k, counted(k))
    try:
        torch.cuda.reset_peak_memory_stats()
        out = mesh_workloads(kernels)
    finally:
        for k, fn in originals.items():
            setattr(dist, k, fn)
    out.update(rank=rank, init_s=init_s, collectives=counts,
               world=dist.get_world_size(),
               device=torch.cuda.current_device())
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    tdist.shutdown()


def mesh_phase(kernels, errs: list, bin_errs: list) -> dict:
    """``[mesh]``: the multi-GPU runtime on the one card.  World 1 over
    NCCL: ``initialize()`` from the torchrun variables, then
    ``fused_moments_sharded`` on ``make_mesh(1)`` at SCALE_SHAPE,
    bit-equal to ``fused_moments`` on the same tensors with its one K1
    launch counted, and ``all_reduce_stats`` at the same size; the group
    is destroyed after.  World 2 over gloo: ``mesh_workloads`` in this
    process (world 1) and on two spawned ranks, held against it - the
    SanityChecker's drops equal and statistics within MESH_MOMENT_RTOL,
    the same best params and CV means within MESH_CV_RTOL, forest heaps
    bit-equal, GBT predictions within CMP_DEEP_TREE_ATOL, K1 and K2
    launched on every rank as often as in world 1 and each launch equal
    to its plain version, every family's fused-training trail falling
    back with reason ``mesh``."""
    import pickle
    import socket
    import tempfile

    import torch.multiprocessing as tmp

    from transmogrifai_tpu_torch.examples.synthetic import (
        synthetic_design_matrix_device,
    )
    from transmogrifai_tpu_torch.parallel import distributed as tdist
    from transmogrifai_tpu_torch.parallel.mesh import make_mesh

    tag = "mesh"
    t_phase = time.perf_counter()
    # -- world 1 over NCCL ---------------------------------------------------
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    w1: dict = {}
    try:
        t0 = time.perf_counter()
        tdist.initialize(backend="cuda:nccl")
        w1["init_s"] = time.perf_counter() - t0
        mesh1 = make_mesh(1)
        x, yh, _ = synthetic_design_matrix_device(SCALE_SHAPE[0], seed=5,
                                                  text_dims=MESH_TEXT_DIMS)
        y = torch.from_numpy(yh.astype(np.float32)).to(x.device)
        want = [t.clone() for t in kernels.fused_moments(x, y)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = kernels.fused_moments_sharded(x, y, mesh1)
        torch.cuda.synchronize()
        w1["launches"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
        assert w1["launches"] == {"fused_moments": 1, "bin_matrix": 0}, w1
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            "fused_moments_sharded at world 1 is not bit-equal to fused_moments"
        w1.update(check_moments(kernels, x, y))
        errs.append({k: w1[k] for k in ("max_abs_err", "max_rel_err")})

        def moment_sums(a):
            return a.sum(dim=0), (a * a).sum(dim=0)

        stats = tdist.all_reduce_stats(moment_sums, mesh1, x)
        assert all(torch.equal(a, b) for a, b in zip(stats, moment_sums(x))), \
            "all_reduce_stats at world 1 differs from the local sums"
        w1["sharded"] = timed(lambda: kernels.fused_moments_sharded(
            x, y, mesh1), [()])
        w1["kernel"] = timed(kernels.fused_moments, [(x, y)])
        w1["all_reduce_stats"] = timed(lambda: tdist.all_reduce_stats(
            moment_sums, mesh1, x), [()])
        w1["bound_ms"] = moments_bound_ms(*SCALE_SHAPE)
        log(f"[{tag}] world 1 over NCCL ({torch.distributed.get_backend()}): "
            f"initialize() "
            f"{w1['init_s']:.2f} s; fused_moments_sharded on make_mesh(1) at "
            f"{SCALE_SHAPE} bit-equal to fused_moments (1 K1 launch), "
            f"{w1['sharded']['ms']:.4f} ms against the kernel's "
            f"{w1['kernel']['ms']:.4f} ms (bound {w1['bound_ms']:.4f} ms; the "
            f"difference is the float64 all-reduces); all_reduce_stats "
            f"{w1['all_reduce_stats']['ms']:.4f} ms, equal to the local sums")
        del x, y, want, got, stats
    finally:
        tdist.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert not torch.distributed.is_initialized()

    # -- world 2 on one card over gloo ---------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    single = mesh_workloads(kernels, train_fused=False, time_shapes=True)
    single_s = time.perf_counter() - t0
    log(f"[{tag}] world 1 (no group): {single_s:.1f} s, walls "
        f"{ {k: round(v, 3) for k, v in single['walls'].items()} }, launches "
        f"{single['launches']}, peak {single['peak_gb']:.2f} GB")
    ctx = tmp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmpdir:
        init_url = "file://" + os.path.join(tmpdir, "store")
        paths = [os.path.join(tmpdir, f"rank{r}.pkl") for r in range(2)]
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank, args=(r, init_url, paths[r]))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, MESH_RANK_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        world_s = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        assert codes == [0, 0], f"[mesh] ranks exited {codes}"
        ranks = []
        for path in paths:
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
    for r in ranks:
        assert r["world"] == 2, r["world"]
        sa, sb = r["sanity"], single["sanity"]
        assert sa["dropped"] == sb["dropped"], (sa["dropped"], sb["dropped"])
        for k in ("mean", "variance", "corr_label"):
            np.testing.assert_allclose(sa[k], sb[k], rtol=MESH_MOMENT_RTOL,
                                       atol=1e-7, err_msg=k)
        for name in ("cv", "rf", "gbt"):
            a, b = r[name], single[name]
            assert a["best_params"] == b["best_params"], (name, a, b)
            np.testing.assert_allclose(a["fold_metrics"], b["fold_metrics"],
                                       rtol=MESH_CV_RTOL, atol=1e-7,
                                       err_msg=name)
            fam = next(iter(a["trail"]["families"].values()))
            assert fam == {"backend": "existing", "reason": "mesh"}, (name, fam)
        for ga, gb in zip(r["rf"]["heaps"], single["rf"]["heaps"]):
            for fa, fb in zip(ga, gb):
                assert all(np.array_equal(u, v) for u, v in zip(fa, fb)), \
                    "the sharded forest's heaps differ from world 1's"
        gbt_diff = max(float(np.abs(np.asarray(pa) - np.asarray(pb)).max())
                       for ga, gb in zip(r["gbt"]["prob"], single["gbt"]["prob"])
                       for pa, pb in zip(ga, gb))
        assert gbt_diff <= CMP_DEEP_TREE_ATOL, gbt_diff
        r["gbt_prob_diff"] = gbt_diff
        assert r["launches"] == single["launches"], (r["launches"],
                                                     single["launches"])
        assert r["launches"]["sanity"]["fused_moments"] >= 1
        assert r["launches"]["rf"]["bin_matrix"] >= 1
        assert r["k2_calls"] == sum(v["bin_matrix"]
                                    for v in r["launches"].values())
        errs.append({k: r["k1"][k] for k in ("max_abs_err", "max_rel_err")})
        bin_errs.append(r["k2_err"])
        log(f"[{tag}] rank {r['rank']} of 2 (gloo, cuda:{r['device']}): "
            f"init {r['init_s']:.2f} s, walls "
            f"{ {k: round(v, 3) for k, v in r['walls'].items()} }, launches "
            f"{r['launches']}, collectives {r['collectives']}, peak device "
            f"memory {r['peak_gb']:.2f} GB; K1 on rows {r['k1']['rows']} "
            f"matches plain (max abs err {r['k1']['max_abs_err']:.3g}), "
            f"{r['k2_calls']} K2 calls equal to plain; drops equal, CV "
            f"winners equal, forest heaps bit-equal, GBT max |prob diff| "
            f"{gbt_diff:.3g}")
    wall = time.perf_counter() - t_phase
    launches = {"mesh_world1": w1["launches"],
                **{f"mesh_rank{r['rank']}": {
                    k: sum(v[k] for v in r["launches"].values())
                    for k in ("fused_moments", "bin_matrix")} for r in ranks}}
    for t in single["timings"]:
        where = f"a world-2 rank's {tuple(t['shape'])} ({t['what']})"
        if t["kernel"] == "fused_moments":
            log_moments_times(where, t)
        else:
            log_bins_times(where, t)
    log(f"[{tag}] world 2 spawned and joined in {world_s:.1f} s; the "
        f"validator trails fell back with reason mesh; phase wall {wall:.1f} s "
        "(two ranks on one card prove the route and its parity, not scaling)")
    return {"world1": w1, "single": single, "ranks": ranks,
            "launches": launches, "wall_s": wall, "world_s": world_s,
            "shapes": single["timings"]}


def mesh_only_main() -> int:
    """``--mesh-only``: the kernels' build and the [mesh] phase alone."""
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
    m = mesh_phase(kernels, [], [])
    print(json.dumps({"launches": m["launches"], "wall_s": m["wall_s"],
                      "world_s": m["world_s"],
                      "world1": {k: v for k, v in m["world1"].items()},
                      "shapes": m["shapes"],
                      "ranks": [{k: r[k] for k in ("rank", "walls",
                                                   "collectives", "peak_gb",
                                                   "init_s", "gbt_prob_diff")}
                                for r in m["ranks"]]}, default=str))
    return 0


# -- [ops]: the training operations layer -------------------------------------
#: the phase's data: 1M passenger rows as 8 CSV shards and 1 Avro shard, a
#: 100k-row cut of the same rows as 4 CSV shards for the cold run, and a
#: separate scoring set
OPS_ROWS = 1_000_000
OPS_CSV_SHARDS = 8
OPS_AVRO_ROWS = 50_000
OPS_COLD_ROWS = 100_000
OPS_COLD_SHARDS = 4
OPS_SCORE_ROWS = 200_000
OPS_SCORE_SEED = 43
OPS_WORKERS = 4
#: the selector: 4 LR points whose L1 levels part their metrics, and a
#: 10-tree depth-3 GBT at 3 step sizes (7 candidates, 3 folds)
OPS_LR_GRID = [{"reg_param": 0.001, "elastic_net_param": 0.0}] + [
    {"reg_param": r, "elastic_net_param": 1.0} for r in (0.02, 0.05, 0.1)]
OPS_GBT = dict(num_trees=10, max_depth=3)
OPS_GBT_GRID = [{"step_size": s} for s in (0.05, 0.1, 0.3)]
#: the cold run leaves one observation per family (each family's fold x
#: grid fit is one batched dispatch); these validations of the cold run's
#: design matrix on the card add three more row counts, so the cost model
#: reaches its four observations a key
OPS_WARMUP_ROWS = (12_500, 25_000, 50_000)
OPS_RUNG_ROWS = 250_000
OPS_KEEP_FRACTION = 0.3
#: the pruned winner against the exhaustive sweep's: the same candidate,
#: its CV metric within OPS_WINNER_ATOL.  The JAX package's
#: test_autotune.py::test_pruned_selection_parity_and_floor holds 1e-9 on
#: a CPU, where each candidate of a batched fit sums alone; on the card
#: the two sweeps batch 2 and 4 LR candidates a fold, and cuBLAS picks
#: its batched GEMM by the batch, so the winner's Gram sums in another
#: order (5.8e-9 apart on an H100).  The CPU parity test keeps 1e-9.
OPS_WINNER_ATOL = 1e-6
OPS_SERVE_RECORDS = 10_000
OPS_PROBE_ROWS = 512
#: continuous: the bootstrap's rows, then windows of one shard each, the
#: shifted ones with ``weight`` moved by OPS_SHIFT_KG (past the drift
#: threshold, as [families] moves it past the RawFeatureFilter's)
OPS_CONT_BOOT_ROWS = 50_000
OPS_CONT_WINDOW_ROWS = 20_000
OPS_SHIFT_KG = 30.0
OPS_CONT_REFIT_ROWS = 40_000
OPS_CANARY_RECORDS = 4_096
OPS_PASSENGER_COLS = ("survived", "age", "height", "weight", "gender")


def ops_write_csv(path: str, ds, lo: int, hi: int, shift: float = 0.0) -> str:
    """Rows [lo, hi) of the passenger dataset ``ds`` as a CSV with a header
    (a missing age an empty cell, floats by their shortest round-trip
    repr), ``weight`` moved by ``shift``; written to a temporary name and
    renamed into place, the shard follower's producer contract."""
    # numpy's float-to-str is the shortest round-trip repr, in C
    age = ds["age"]
    vals = {
        "survived": ds["survived"].values[lo:hi].astype(np.int64).astype(str),
        "age": np.where(age.mask[lo:hi], age.values[lo:hi].astype(str), ""),
        "height": ds["height"].values[lo:hi].astype(str),
        "weight": (ds["weight"].values[lo:hi] + shift).astype(str),
        "gender": ds["gender"].values[lo:hi].astype(str),
    }
    rows = map(",".join, zip(*(vals[c].tolist() for c in OPS_PASSENGER_COLS)))
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        f.write(",".join(OPS_PASSENGER_COLS) + "\n" + "\n".join(rows) + "\n")
    os.replace(tmp, path)
    return path


def ops_models(device: str) -> list:
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier

    return [(OpLogisticRegression(device=device), list(OPS_LR_GRID)),
            (OpGBTClassifier(device=device, **OPS_GBT), list(OPS_GBT_GRID))]


def build_ops(device: str):
    """The phase's selector workflow: ``age`` mean-imputed
    (``FillMissingWithMean``) and ``gender`` indexed (``StringIndexer``) -
    both on raw features, so their partial fits arm under streaming
    ingest - then transmogrify -> SanityChecker -> the selector over
    ``ops_models`` with no reserved holdout (a holdout would keep the
    partial fits from arming).  The vectorizers are label-free, so the
    model lowers whole to the torch-fused serving program.  Returns
    (workflow, label, checked, pred)."""
    from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
    from transmogrifai_tpu_torch.ops.categorical import StringIndexer
    from transmogrifai_tpu_torch.ops.scalers import FillMissingWithMean
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.selector.factories import (
        BinaryClassificationModelSelector,
    )
    from transmogrifai_tpu_torch.selector.splitters import DataBalancer

    survived = FeatureBuilder.RealNN("survived").as_response()
    age = FeatureBuilder.Real("age").as_predictor()
    height = FeatureBuilder.Real("height").as_predictor()
    weight = FeatureBuilder.Real("weight").as_predictor()
    gender = FeatureBuilder.PickList("gender").as_predictor()
    age_f = FillMissingWithMean().set_input(age).get_output()
    gender_i = StringIndexer().set_input(gender).get_output()
    vec = transmogrify([age_f, height, weight, gender, gender_i])
    checked = SanityChecker(device=device).set_input(
        survived, vec).get_output()
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, device=device, models_and_parameters=ops_models(device),
        splitter=DataBalancer(reserve_test_fraction=0.0))
    pred = selector.set_input(survived, checked).get_output()
    wf = OpWorkflow(device=device).set_result_features(pred)
    return wf, survived, checked, pred


def build_continuous(device: str, data):
    """The continuous loop's workflow over ``data`` (its input dataset):
    transmogrify -> SanityChecker -> a 10-tree depth-3 GBT, so every refit
    launches K1 and K2, and the model lowers whole to the torch-fused
    program (a label-aware bucketizer does not lower), whose tree head
    bins every served batch with K2."""
    from transmogrifai_tpu_torch import OpWorkflow
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker

    survived, preds = passenger_features()
    vec = transmogrify(preds)
    checked = SanityChecker(device=device).set_input(
        survived, vec).get_output()
    pred = OpGBTClassifier(device=device, **OPS_GBT).set_input(
        survived, checked).get_output()
    return (OpWorkflow(device=device).set_result_features(pred)
            .set_input_dataset(data))


def dataset_digest(ds, names) -> str:
    """SHA-256 of the named raw columns' values and masks: two ingests with
    one digest are bit-equal."""
    import hashlib

    h = hashlib.sha256()
    for name in names:
        col = ds[name]
        vals = np.asarray(col.values)
        h.update(name.encode())
        if vals.dtype == object:
            h.update(repr(vals.tolist()).encode())
        else:
            h.update(np.ascontiguousarray(vals).tobytes())
        mask = getattr(col, "mask", None)
        if mask is not None:
            h.update(np.ascontiguousarray(mask).tobytes())
    return h.hexdigest()


def selector_summary(summary: dict) -> dict:
    return next(s["metadata"]["model_selector_summary"]
                for s in summary["stages"]
                if "model_selector_summary" in s.get("metadata", {}))


def log_autotune_trail(tag: str, rep: dict) -> None:
    log(f"[ops] {tag}: autotune {rep['mode']}"
        f"{' (' + rep['reason'] + ')' if rep.get('reason') else ''}; "
        f"{rep['candidates_total']} candidates, {rep['survivors']} kept, "
        f"rung rows {rep['rung_rows']}, fits {rep['fits']}, predicted "
        f"speedup {rep.get('predicted_speedup')}")
    for c in rep.get("rungs", []):
        log(f"[ops]   rung {c['family']} "
            f"{json.dumps(c['params'], sort_keys=True)}: interim "
            f"{c['interim_metric']}, rung {c['rung_wall_ms']} ms "
            f"(predicted {c['predicted_rung_ms']}), full fit predicted "
            f"{c['predicted_fit_ms']} ms, kept {c['kept']}"
            f"{', error ' + c['rung_error'] if c['rung_error'] else ''}")
    if rep.get("actual_full_ms_by_family"):
        log(f"[ops]   full spend: predicted "
            f"{rep.get('predicted_pruned_ms')} ms pruned, "
            f"{rep.get('predicted_exhaustive_ms')} ms exhaustive; measured "
            f"{rep['actual_full_ms_by_family']} ms by family")


@contextlib.contextmanager
def ops_step(kernels, out: dict, step: str, errs: list, bin_errs: list,
             timings: dict, timed: bool = True):
    """One counted step of ``[ops]``: the launch counts start from zero and
    every kernel call's inputs are kept (``kernel_inputs``); after the
    block the counts land in ``out["launches"][step]`` and every kept call
    is held against its plain version (``hold_path_inputs``; timed once a
    new shape into ``out["shapes"]`` with ``timed``)."""
    kernels.reset_launches()
    with kernel_inputs(kernels) as kept:
        yield
        out["launches"][step] = {w.__name__: w.launches
                                 for w in kernels.WRAPPERS}
    hold_path_inputs(kernels, kept, out["shapes"] if timed else {}, errs,
                     bin_errs, timed=timed, timings=timings)


def ops_phase(kernels, errs: list, bin_errs: list, timings: dict,
              device: str = "cuda") -> dict:
    """``[ops]``, the training operations layer on the card: 1M passenger
    rows as 8 CSV and 1 Avro shards; a cold autotuned ``train`` run over a
    100k-row cut (``ingest_shards``, 4 workers, ``fleet_dir`` shipping read
    back through the aggregator); the cost model warmed and a warm
    autotuned ``train`` at 1M rows (streamed ingest with its partial fits
    armed, the ladder pruning, rungs on the card) held against the serial
    ingest, the exhaustive sweep and a 200k-row scoring set; a ``serve``
    run of its model with the knob tuner; a ``continuous`` run in direct
    mode (bootstrap, drift on shifted shards, refit, publish, promote) and
    the refit canaried against the bootstrap on the card.  Every K1 and K2
    launch is counted by step and held against its plain version."""
    import shutil
    import tempfile
    import threading

    from transmogrifai_tpu_torch.autotune import CostModel
    from transmogrifai_tpu_torch.continuous import STATUS_FILENAME
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )
    from transmogrifai_tpu_torch.examples.synthetic import synthetic_passengers
    from transmogrifai_tpu_torch.obs import (
        FleetAggregator,
        reset_tracer,
        tracer,
    )
    from transmogrifai_tpu_torch.readers.avro_reader import save_dataset_avro
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
    from transmogrifai_tpu_torch.readers.pipeline import PipelinedCSVReader
    from transmogrifai_tpu_torch.registry import (
        DeploymentController,
        ModelRegistry,
    )
    from transmogrifai_tpu_torch.selector import validator as validator_mod
    from transmogrifai_tpu_torch.serving import records_from_dataset
    from transmogrifai_tpu_torch.utils.masked_stats import masked_mean
    from transmogrifai_tpu_torch.utils.uid import reset_uids
    from transmogrifai_tpu_torch.workflow.params import OpParams
    from transmogrifai_tpu_torch.workflow.runner import OpWorkflowRunner
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

    t_phase = time.perf_counter()
    out: dict = {"launches": {}, "walls": {}, "shapes": {}}

    def step(name: str, timed: bool = True):
        return ops_step(kernels, out, name, errs, bin_errs, timings, timed)

    # the cost model trains from this phase's spans alone
    reset_tracer()
    tmp = tempfile.mkdtemp(prefix="tx-ops-")
    try:
        # -- 1. the shards ------------------------------------------------
        t0 = time.perf_counter()
        data = synthetic_passengers(OPS_ROWS, seed=42, with_text=False)
        per = (OPS_ROWS - OPS_AVRO_ROWS) // OPS_CSV_SHARDS
        shards = [ops_write_csv(os.path.join(tmp, f"part-{i}.csv"), data,
                                i * per, (i + 1) * per)
                  for i in range(OPS_CSV_SHARDS)]
        avro = os.path.join(tmp, "part-8.avro")
        save_dataset_avro(data.select(list(OPS_PASSENGER_COLS)).take(
            np.arange(OPS_CSV_SHARDS * per, OPS_ROWS)), avro)
        shards.append(avro)
        cold_per = OPS_COLD_ROWS // OPS_COLD_SHARDS
        cold = [ops_write_csv(os.path.join(tmp, f"cold-{i}.csv"), data,
                              i * cold_per, (i + 1) * cold_per)
                for i in range(OPS_COLD_SHARDS)]
        out["walls"]["write"] = time.perf_counter() - t0
        log(f"[ops] wrote {OPS_ROWS} passenger rows as {OPS_CSV_SHARDS} CSV "
            f"shards of {per} and one Avro shard of {OPS_AVRO_ROWS}, and a "
            f"{OPS_COLD_ROWS}-row cut as {OPS_COLD_SHARDS} CSV shards, in "
            f"{out['walls']['write']:.3f} s")

        # -- 2. a cold autotuned train (100k rows), fleet shipping on ------
        agg_dir = os.path.join(tmp, "agg")
        cold_dir = os.path.join(tmp, "cold")
        reset_uids()
        wf, survived, checked, pred = build_ops(device)
        with step("cold_train"):
            t0 = time.perf_counter()
            res = OpWorkflowRunner(wf).run("train", OpParams(
                model_location=cold_dir, custom_params={
                    "ingest_shards": cold, "ingest_workers": OPS_WORKERS,
                    "autotune": True, "fleet_dir": agg_dir}))
            out["walls"]["cold_train"] = time.perf_counter() - t0
        cold_rep = selector_summary(res.summary)["autotune"]
        log_autotune_trail(f"cold train, {OPS_COLD_ROWS} rows, "
                           f"{out['walls']['cold_train']:.3f} s", cold_rep)
        assert cold_rep["mode"] == "exhaustive", cold_rep
        assert cold_rep["reason"].startswith("cost_model_cold"), cold_rep
        at_path = os.path.join(cold_dir, "autotune.json")
        cm_cold = CostModel.load(at_path)
        assert cm_cold.load_error is None and cm_cold.n_observations() > 0
        assert res.summary["autotune"]["cost_model"]["path"] == at_path
        assert len(res.model._train_data_cache) == OPS_COLD_ROWS
        ln = out["launches"]["cold_train"]
        assert ln["fused_moments"] == 1 and ln["bin_matrix"] >= 1, ln
        agg = FleetAggregator(agg_dir, stale_after_s=600.0)
        shipped = agg.shards()
        assert len(shipped) == 1, agg.last_report
        names = {s["name"] for s in shipped[0]["spans"]}
        assert {"run.train", "workflow.train", "ingest.shard",
                "cv.fit_batch"} <= names, names
        assert "tx_obs_tracer_spans_recorded" in agg.prometheus_text()
        log(f"[ops] cold run: cost model saved at autotune.json with "
            f"{cm_cold.snapshot()['observations_by_key']} observations; K1 "
            f"{ln['fused_moments']}, K2 {ln['bin_matrix']} launches; the "
            f"fleet shard read back ({agg.last_report['shards_live']} live, "
            f"{len(shipped[0]['spans'])} spans)")

        # -- 3. the warm-up: the cold design matrix at three row counts ----
        X_cold = np.asarray(res.model._train_data_cache[checked.name].values,
                            np.float64)
        y_cold = np.asarray(res.model._train_data_cache[survived.name].values,
                            np.float64)
        t0 = time.perf_counter()
        cm = CostModel.load(at_path)
        with step("warmup", timed=False):
            for rows in OPS_WARMUP_ROWS:
                with tracer().span("ops.warmup", rows=rows) as sp:
                    validator_mod.OpCrossValidation(
                        num_folds=3,
                        evaluator=OpBinaryClassificationEvaluator(),
                        seed=42, stratify=True, device=device,
                    ).validate(ops_models(device), X_cold[:rows],
                               y_cold[:rows])
                cm.ingest_spans(tracer().spans(sp.trace_id))
        warm_path = os.path.join(tmp, "autotune-warm.json")
        cm.save(warm_path)
        out["walls"]["warmup"] = time.perf_counter() - t0
        obs = cm.snapshot()["observations_by_key"]
        assert all(cm.can_predict(f"fit:{est.model_type}")
                   for est, _ in ops_models(device)), obs
        log(f"[ops] warm-up: validations at {OPS_WARMUP_ROWS} rows of the "
            f"cold design matrix on the card in "
            f"{out['walls']['warmup']:.3f} s; cost model {obs}")
        del X_cold, y_cold

        # -- 4. the warm autotuned train at 1M rows, streamed ---------------
        warm_dir = os.path.join(tmp, "warm")
        reset_uids()
        wf, survived, checked, pred = build_ops(device)
        captured = {}
        real_validate = validator_mod.OpValidator.validate

        def keep_args(self, models, X, y, weights=None):
            captured.setdefault("args", (X, y, weights))
            return real_validate(self, models, X, y, weights)

        validator_mod.OpValidator.validate = keep_args
        try:
            with step("warm_train"):
                t0 = time.perf_counter()
                res = OpWorkflowRunner(wf).run("train", OpParams(
                    model_location=warm_dir, custom_params={
                        "ingest_shards": shards,
                        "ingest_workers": OPS_WORKERS,
                        "autotune": True, "autotune_model_path": warm_path,
                        "autotune_rung_rows": OPS_RUNG_ROWS,
                        "autotune_keep_fraction": OPS_KEEP_FRACTION}))
                out["walls"]["warm_train"] = time.perf_counter() - t0
        finally:
            validator_mod.OpValidator.validate = real_validate
        model = res.model
        md = selector_summary(res.summary)
        rep = md["autotune"]
        log_autotune_trail(f"warm train, {OPS_ROWS} rows, "
                           f"{out['walls']['warm_train']:.3f} s", rep)
        assert rep["mode"] == "pruned", rep
        assert rep["fits"]["total"] <= rep["fits"]["exhaustive"], rep
        assert all(c["rung_error"] is None for c in rep["rungs"]), rep
        ln = out["launches"]["warm_train"]
        # K1 once; K2 in the 3 GBT rung fits at least
        assert ln["fused_moments"] == 1 and ln["bin_matrix"] >= 3, ln
        armed = {type(s).__name__ for s in model.stages
                 if s.uid in set(wf.last_streamed_fits)}
        assert armed == {"_FillMeanModel", "StringIndexerModel"}, armed
        log(f"[ops] streamed partial fits armed: {sorted(armed)} "
            f"({len(wf.last_streamed_fits)} estimators); K1 "
            f"{ln['fused_moments']}, K2 {ln['bin_matrix']} launches; train_fused "
            f"{res.summary.get('train_fused', {}).get('backend')}")
        # the streamed ingest against the serial read of the same shards
        raw_names = [f.name for f in wf.raw_features]
        cache = model._train_data_cache
        assert len(cache) == OPS_ROWS
        t0 = time.perf_counter()
        serial = PipelinedCSVReader(shards, workers=OPS_WORKERS) \
            .generate_dataset(wf.raw_features)
        out["walls"]["serial_read"] = time.perf_counter() - t0
        d_stream = dataset_digest(cache, raw_names)
        d_serial = dataset_digest(serial, raw_names)
        assert d_stream == d_serial, (d_stream, d_serial)
        fill = [s.fill for s in model.stages
                if type(s).__name__ == "_FillMeanModel"][0]
        want_fill = masked_mean(serial["age"].values, serial["age"].mask)
        labels = [s.labels for s in model.stages
                  if type(s).__name__ == "StringIndexerModel"][0]
        want_labels = sorted(
            set(v for v in serial["gender"].values if v is not None),
            key=lambda v: (-int((serial["gender"].values == v).sum()), v))
        assert abs(fill - want_fill) <= 1e-12 * abs(want_fill), (fill,
                                                                 want_fill)
        assert labels == want_labels, (labels, want_labels)
        log(f"[ops] streamed ingest digest {d_stream[:16]} == serial "
            f"{d_serial[:16]} ({OPS_ROWS} rows, {len(raw_names)} columns; "
            f"serial read {out['walls']['serial_read']:.3f} s); streamed "
            f"age mean {fill!r} against serial {want_fill!r}, indexer "
            f"labels {labels}")
        del serial
        # the pruned winner against the exhaustive sweep on the same X, y
        X, y, w = captured["args"]
        t0 = time.perf_counter()
        with step("exhaustive"):
            ex = validator_mod.OpCrossValidation(
                num_folds=3, evaluator=OpBinaryClassificationEvaluator(),
                seed=42, stratify=True, device=device,
            ).validate(ops_models(device), X, y, w)
        out["walls"]["exhaustive"] = time.perf_counter() - t0
        del X, y, w, captured
        win = [md["best_model_type"], md["best_params"]]
        ex_win = [ex.best_estimator.model_type, ex.best_params]
        best_metric = md["validation_metric"]["value"]
        metric_diff = abs(best_metric - ex.best_metric)
        assert win == ex_win, (win, ex_win)
        assert metric_diff <= OPS_WINNER_ATOL, metric_diff
        # the held-out AuROC on a separate scoring set
        sdata = synthetic_passengers(OPS_SCORE_ROWS, seed=OPS_SCORE_SEED,
                                     with_text=False)
        t0 = time.perf_counter()
        with step("warm_score"):
            scored = model.score(sdata.select(list(OPS_PASSENGER_COLS)))
        out["walls"]["warm_score"] = time.perf_counter() - t0
        auroc = float(OpBinaryClassificationEvaluator().evaluate(
            scored, label_col=survived.name, pred_col=pred.name).AuROC)
        assert SELECTOR_AUROC_RANGE[0] <= auroc <= SELECTOR_AUROC_RANGE[1], \
            auroc
        out["auroc"] = auroc
        log(f"[ops] pruned winner {win} (CV {best_metric:.6f})"
            f" == exhaustive {ex_win} (CV {ex.best_metric:.6f}), |diff| "
            f"{metric_diff:.3g}; exhaustive sweep {out['walls']['exhaustive']:.3f}"
            f" s, K2 {out['launches']['exhaustive']['bin_matrix']}; held-out "
            f"AuROC {auroc:.6f} over {OPS_SCORE_ROWS} rows (range "
            f"{SELECTOR_AUROC_RANGE}), score {out['walls']['warm_score']:.3f} s")
        del scored, sdata, ex

        # -- 5. a serve run of the warm model with the knob tuner ------------
        serve_csv = ops_write_csv(os.path.join(tmp, "serve.csv"), data,
                                  OPS_ROWS - OPS_SERVE_RECORDS, OPS_ROWS)
        reset_uids()
        wf, survived, checked, pred = build_ops(device)
        loaded = OpWorkflowModel.load(warm_dir, wf)
        fam = head_family(loaded)
        records = records_from_dataset(
            CSVReader(serve_csv).generate_dataset(wf.raw_features),
            wf.raw_features)
        with step("serve_reference", timed=False):
            want = serve_rows(loaded.score_function(
                fused_backend="torch").score_batch(records))
        reset_uids()
        wf, survived, checked, pred = build_ops(device)
        with step("serve", timed=False):
            t0 = time.perf_counter()
            res = OpWorkflowRunner(wf, score_reader=CSVReader(serve_csv)).run(
                "serve", OpParams(
                    model_location=warm_dir,
                    metrics_location=os.path.join(tmp, "serve_metrics"),
                    write_location=os.path.join(tmp, "serve_scores"),
                    custom_params={"serving_autotune": True,
                                   "serving_fused_backend": "torch",
                                   "autotune_probe_rows": OPS_PROBE_ROWS}))
            out["walls"]["serve"] = time.perf_counter() - t0
        sm = res.metrics
        got = serve_rows(read_scores(os.path.join(tmp, "serve_scores")))
        ulps = max_ulps(got[:, 1:], want[:, 1:])
        assert np.array_equal(got[:, 0], want[:, 0])
        assert ulps <= SERVE_ULP_BUDGETS[fam], (ulps, fam)
        assert sm["fused"]["backend"] == "torch", sm["fused"]
        dec = sm["autotune"]
        lat = sm["latency_ms"]
        base_v = next(p["value"] for p in dec["probes"] if p["is_baseline"])
        win_v = next(p["value"] for p in dec["probes"] if p["is_winner"])
        margin = win_v / base_v - 1.0 if base_v else 0.0
        out["serve"] = {"latency_ms": lat, "rows_per_s": sm["rows_per_s"],
                        "decision": dec, "head": fam, "ulps": ulps}
        log(f"[ops] serve run: {len(got)} records ({fam} head, "
            f"{sm['fused']['backend']}) in {out['walls']['serve']:.3f} s: "
            f"p50 {lat['p50']} ms, p99 {lat['p99']} ms, {sm['rows_per_s']} "
            f"rows/s; knob tuner {'chose ' + json.dumps(dec['winner']) if dec['tuned'] else 'kept the baseline ' + json.dumps(dec['baseline'])}"
            f" (winner {margin:+.3%} against the baseline, margin "
            f"{dec['margin']}, {len(dec['probes'])} arms); rows within "
            f"{ulps:g} ULP of score_function(); K2 "
            f"{out['launches']['serve']['bin_matrix']} launches")
        for p in dec["probes"]:
            log(f"[ops]   probe {json.dumps(p['knobs'])}: {p['value']} rows/s"
                f"{' (baseline)' if p['is_baseline'] else ''}"
                f"{' (winner)' if p['is_winner'] else ''}")
        del loaded, records, want, got

        # -- 6. continuous, direct mode ----------------------------------------
        watch = os.path.join(tmp, "watch")
        stage = os.path.join(tmp, "stage")
        os.makedirs(watch)
        os.makedirs(stage)
        cont_dir = os.path.join(tmp, "cont")
        boot = data.take(np.arange(OPS_CONT_BOOT_ROWS))
        lo = OPS_CONT_BOOT_ROWS
        windows = []  # (shifted, staged path)
        for i, shifted in enumerate((False, True, True, True)):
            windows.append((shifted, ops_write_csv(
                os.path.join(stage, f"w{i}.csv"), data, lo,
                lo + OPS_CONT_WINDOW_ROWS, OPS_SHIFT_KG if shifted else 0.0)))
            lo += OPS_CONT_WINDOW_ROWS
        os.replace(windows[0][1], os.path.join(watch, "w0.csv"))
        status = os.path.join(tmp, "cont_metrics", STATUS_FILENAME)
        stop = threading.Event()

        def producer():
            # drop window i once the loop has finished cycle i: each cycle
            # then judges exactly one shard
            for i in range(1, len(windows)):
                while not stop.is_set():
                    try:
                        with open(status) as f:
                            cycles = json.load(f)["counters"]["cycles"]
                    except (OSError, ValueError, KeyError):
                        cycles = -1
                    if cycles >= i:
                        break
                    time.sleep(0.01)
                if stop.is_set():
                    return
                os.replace(windows[i][1],
                           os.path.join(watch, f"w{i}.csv"))

        def factory():
            reset_uids()
            return build_continuous(device, boot)

        feeder = threading.Thread(target=producer, daemon=True)
        feeder.start()
        with step("continuous"):
            t0 = time.perf_counter()
            try:
                res = OpWorkflowRunner(factory(), workflow_factory=factory).run(
                    "continuous", OpParams(
                        model_location=cont_dir,
                        metrics_location=os.path.join(tmp, "cont_metrics"),
                        custom_params={
                            "watch_dir": watch,
                            "drift_consecutive": 2, "drift_cooldown": 1,
                            "continuous_window_rows": 1_000,
                            "continuous_refit_rows": OPS_CONT_REFIT_ROWS,
                            "continuous_max_cycles": 12,
                            "continuous_idle_exit": 3,
                            "continuous_poll_s": 0.2}))
            finally:
                stop.set()
                feeder.join(timeout=30)
            out["walls"]["continuous"] = time.perf_counter() - t0
        m = res.metrics
        spans = tracer().spans(m["last_trace"])
        cycles = [s for s in spans if s["name"] == "continuous.cycle"]
        detect = {s["parent"]: s["attrs"] for s in spans
                  if s["name"] == "continuous.detect"}
        verdicts = [detect[c["span"]]["verdict"] for c in cycles
                    if c["span"] in detect]
        judged = [v for v in verdicts if v != "idle"]
        assert judged == ["clear", "over", "trigger", "clear"], verdicts
        assert m["counters"]["refits"] == 1 and m["counters"]["promotes"] == 1
        reg = ModelRegistry(os.path.join(cont_dir, "registry"), create=False)
        v1, v2 = [v.version for v in reg.versions()]
        assert reg.stable == v2 == m["stable_version"] and reg.verify()["ok"]
        ln = out["launches"]["continuous"]
        # the bootstrap and the refit: K1 once each, K2 in each GBT fit and
        # its transform of the training rows
        assert ln["fused_moments"] == 2 and ln["bin_matrix"] >= 2 * 2, ln
        refit = [s for s in spans if s["name"] == "continuous.refit"][0]
        log(f"[ops] continuous run in {out['walls']['continuous']:.3f} s: "
            f"bootstrap {v1} from {OPS_CONT_BOOT_ROWS} rows, windows of "
            f"{OPS_CONT_WINDOW_ROWS} rows (weight +{OPS_SHIFT_KG} kg from the "
            f"second), verdicts {verdicts}, drift scores "
            f"{[round(detect[c['span']].get('max_js', 0.0), 4) for c in cycles if c['span'] in detect]}, "
            f"refit {refit['attrs'].get('rows')} rows in "
            f"{refit['wall_ms']:.1f} ms -> {v2} published and promoted; "
            f"cycle walls {[round(c['wall_ms'], 1) for c in cycles]} ms; "
            f"idle exit after {m['counters']['cycles']} cycles; K1 "
            f"{ln['fused_moments']}, K2 {ln['bin_matrix']} launches")
        out["continuous"] = {"verdicts": verdicts,
                             "cycle_ms": [c["wall_ms"] for c in cycles],
                             "refit_ms": refit["wall_ms"]}

        # the refit canaried against the bootstrap on the card
        models = {v: reg.load(v, factory()) for v in (v1, v2)}
        raw = factory().raw_features
        shifted = records_from_dataset(
            CSVReader(os.path.join(watch, f"w{len(windows) - 1}.csv"))
            .generate_dataset(raw), raw)[:OPS_CANARY_RECORDS]
        with step("canary_reference", timed=False):
            arm_want = {v: serve_rows(models[v].score_function(
                fused_backend="torch").score_batch(shifted)) for v in models}
        ctl = DeploymentController(batch_buckets=DEPLOY_BUCKETS,
                                   canary_fraction=0.5,
                                   check_every_batches=1_000_000,
                                   fused_backend="torch")
        with step("canary", timed=False):
            t0 = time.perf_counter()
            ctl.deploy(models[v1], version=v1)
            ctl.start_canary(models[v2], version=v2)
            rows = []
            for i in range(0, len(shifted), 128):
                rows += ctl.score_batch(shifted[i:i + 128])
            decision = ctl.check_canary()
            ctl.promote_canary()
            out["walls"]["canary"] = time.perf_counter() - t0
        assert decision is None or not decision.rollback, decision
        assigned = split_assigns(shifted, 0.5)
        got = serve_rows(rows)
        n_canary = int(assigned.sum())
        for v, mask in ((v1, ~assigned), (v2, assigned)):
            hold_rows(f"canary {v}", got[mask], arm_want[v][mask], "gbt")
        assert ctl.stable_generation.version == v2
        assert out["launches"]["canary"]["bin_matrix"] >= 2, out["launches"]
        log(f"[ops] canary: {v2} (the refit) against {v1} on "
            f"{len(shifted)} shifted records, {n_canary} to the canary, "
            f"each row within the GBT budget of its arm's score_function(); "
            f"no rollback, promoted; {out['walls']['canary']:.3f} s, K2 "
            f"{out['launches']['canary']['bin_matrix']} launches")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log_path_shapes("the [ops] phase's", out["shapes"])
    log(f"[ops] launches by step {out['launches']}; phase wall "
        f"{out['wall_s']:.1f} s")
    return out


def ops_only_main() -> int:
    """``--ops-only``: the kernels' build and the [ops] phase alone."""
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
    ops = ops_phase(kernels, [], [], {})
    print(json.dumps({"launches": ops["launches"], "walls": ops["walls"],
                      "wall_s": ops["wall_s"], "auroc": ops["auroc"],
                      "serve": ops["serve"],
                      "continuous": ops["continuous"],
                      "shapes": [[k, list(shape), t["ms"], t["bound_ms"],
                                  t["plain_ms"], t["path_calls"]]
                                 for (k, shape), t in ops["shapes"].items()]},
                     default=str))
    return 0


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
    # [deploy]: each step's launches by arm (``warm``: a generation's
    # warm-up, one batch per bucket); K1 is not on the serving path
    out.update({f"deploy_{step}_{arm}": n if k == "bin_matrix" else 0
                for step, arms in serve["deploy"]["launches"].items()
                for arm, n in arms.items()})
    # [fleet]: the launches in each replica worker, read from its shipped
    # view (each worker's counts start at 0 with the process; K1 was held
    # to none there)
    out.update({f"fleet_{inst}": w["k2_launches"] if k == "bin_matrix"
                else 0 for inst, w in serve["fleet"]["workers"].items()})
    # [bulk]: this process's uninterrupted job and its resume of the
    # killed job (the fleet path's launches are in the fleet workers'
    # counts above); [autoscale]: the workers it added
    bulk = serve["fleet"]["bulk"]
    out.update({f"bulk_{what}": sum(bulk["k2"][what].values())
                if k == "bin_matrix" else 0 for what in ("local", "resume")})
    out.update({f"autoscale_{inst}": w["k2_launches"]
                if k == "bin_matrix" else 0 for inst, w in
                serve["fleet"]["autoscale"]["surge"]["workers"].items()})
    return out


def serve_only_main() -> int:
    """``--serve-only``: the kernels' build and the [serve] phase (with its
    [deploy] step) alone, with a logistic regression on the README front in the README model's
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


def kernel_header(kernels) -> tuple:
    """Builds the kernels and logs the card, the versions and each
    kernel's registers and shared memory.  Returns (the card's name and
    power limit as nvidia-smi gives them, ptxas rows by kernel)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
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
    return smi, ptxas


def kernel_check(kernels, dev, errs: list, bin_errs: list) -> tuple:
    """Each kernel against its plain version at the check's shapes (small
    and wide ones, row-offset views, the repo's 10M x 39 scale), K1
    bit-identical from run to run, and both timed at the scale.  Appends
    the errors to ``errs`` and ``bin_errs``; returns (K1's, K2's timing at
    the scale)."""
    from transmogrifai_tpu_torch.examples.synthetic import synthetic_design_matrix
    from transmogrifai_tpu_torch.models.trees import _sampled_bin_edges

    rng = np.random.RandomState(0)
    cases = []
    for n, d in ((1, 1), (513, 129), (1000, 37), (1500, 1100), (2049, 513),
                 (33, 4244)):
        x = (rng.randn(n, d) * 3.0 + 1.0).astype(np.float32)
        if d == 37:
            x[::7, 5] = np.nan
        cases.append((x, rng.rand(n).astype(np.float32)))
    for n, text_dims in (((1 << 22) + 3, 4), (SCALE_SHAPE[0], 32)):
        x, yv, _ = synthetic_design_matrix(n, seed=1, text_dims=text_dims)
        cases.append((x, yv.astype(np.float32)))
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
    return at_scale, bins_at_scale


#: the shapes of the routes redesigned for small inputs and wide rows
#: (PERF.md's kernel table): K1 at the full schema's and the type
#: lattice's widths; K2 at the serving and fleet batches, a bulk chunk,
#: the small bucketizers, LOCO's passes and the folds, and the tree
#: slice's first depth-group shape
REDESIGN_MOMENTS = ((1_000_000, 538), (10_000, 4243))
REDESIGN_BINS = ((1, 7), (8, 7), (32, 7), (128, 7), (16_384, 7), (8_952, 1),
                 (54_000, 1), (90_000, 1), (180_000, 1), (10_000, 15),
                 (30_000, 9), (60_000, 9), (180_000, 9))


def redesign_phase(kernels, dev, errs: list, bin_errs: list) -> dict:
    """K1 and K2 at REDESIGN_MOMENTS and REDESIGN_BINS (seeded normal data;
    K2 with the tree learner's edges, int8 bins): each held against its
    plain version, then timed beside its yardstick, its empty-launch floor
    and its time before the redesign.  K1's plain version is timed here
    too (its target is to beat it); K2's is timed at these shapes by the
    paths that give them.  Returns kernel name -> rows."""
    from transmogrifai_tpu_torch.models.trees import _sampled_bin_edges

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    out = {"fused_moments": [], "bin_matrix": []}
    for n, d in REDESIGN_MOMENTS:
        x = torch.randn((n, d), generator=gen, device=dev)
        y = torch.rand(n, generator=gen, device=dev)
        err = check_moments(kernels, x, y)
        errs.append(err)
        out["fused_moments"].append({
            **time_moments(kernels, x, y), **err,
            "floor_ms": floor_ms(kernels.fused_moments_floor, x, y)})
        log_moments_times(f"[redesign] at {(n, d)} (matches plain, max abs "
                          f"err {err['max_abs_err']:.3g})",
                          out["fused_moments"][-1])
        del x, y
    rng = np.random.RandomState(18)
    for n, d in REDESIGN_BINS:
        x_np = rng.randn(n, d).astype(np.float32)
        edges = torch.from_numpy(np.ascontiguousarray(
            _sampled_bin_edges(x_np, BIN_MAX_BINS, 42))).to(dev)
        x = torch.from_numpy(x_np).to(dev)
        bin_errs.append(check_bins(kernels, x, edges, torch.int8))
        out["bin_matrix"].append({
            **time_bins(kernels, x, edges, torch.int8, plain=False),
            "max_abs_err": bin_errs[-1],
            "floor_ms": floor_ms(kernels.bin_matrix_floor, x, edges,
                                 torch.int8)})
        log_bins_times(f"[redesign] at {(n, d)} x {edges.shape[1]} edges -> "
                       "int8 (equal to plain, bit-identical twice)",
                       out["bin_matrix"][-1])
    return out


def kernels_only_main() -> int:
    """``--kernels-only``: the kernels' build, the kernel check and the
    redesigned routes' shapes alone: a quick check of both kernels while
    they change.  Prints the card and one JSON object of the timings."""
    from transmogrifai_tpu_torch.parallel import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi, ptxas = kernel_header(kernels)
    errs, bin_errs = [], []
    at_scale, bins_at_scale = kernel_check(kernels, dev, errs, bin_errs)
    redesign = redesign_phase(kernels, dev, errs, bin_errs)
    print(smi)
    print(json.dumps({"ptxas": ptxas, "fused_moments_at_scale": at_scale,
                      "bin_matrix_at_scale": bins_at_scale,
                      "redesign": redesign}))
    return 0


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--kernels-only":
        return kernels_only_main()
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
    if len(sys.argv) == 2 and sys.argv[1] == "--mesh-only":
        return mesh_only_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--ops-only":
        return ops_only_main()
    if len(sys.argv) == 3 and sys.argv[1] == "--families-cpu":
        return families_cpu_main(int(sys.argv[2]))
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
    children = [start_problem_cpu("multiclass"),
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


def card_main(multiclass_cpu_child: subprocess.Popen,
              regression_cpu_child: subprocess.Popen,
              schema_cpu_child: subprocess.Popen,
              families_cpu_child: subprocess.Popen) -> int:
    from transmogrifai_tpu_torch.examples.synthetic import (
        BAYES_AUROC_OBSERVED,
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

    # -- 1. header and build ------------------------------------------------
    smi, ptxas = kernel_header(kernels)
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
    log(f"[header] the CSV scanner's host library "
        f"{os.path.relpath(native_bridge.lib_path())} built and loaded in "
        f"{native_s:.1f} s")

    # -- 2. kernel check, and the redesigned routes' shapes -------------------
    errs, bin_errs = [], []
    at_scale, bins_at_scale = kernel_check(kernels, dev, errs, bin_errs)
    redesign = redesign_phase(kernels, dev, errs, bin_errs)

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

    # -- 6. the same tree slice on the CPU agrees, on a shared prefix ------------
    # the card against the CPU at TREE_CMP_ROWS rows, both sides on the
    # same first rows (the card-against-card run above holds the heaps at
    # SLICE_ROWS)
    cmp_data = data.take(np.arange(TREE_CMP_ROWS))
    tgc = run_tree_slice("cuda", cmp_data, kernels)
    tc = run_tree_slice("cpu", cmp_data, kernels)
    del cmp_data
    log(f"[trees] {TREE_CMP_ROWS}-row prefix: cuda train "
        f"{tgc['train_s']:.3f} s, score {tgc['score_s']:.3f} s; cpu train "
        f"{tc['train_s']:.3f} s, score {tc['score_s']:.3f} s, AuROC "
        f"{tc['auroc']:.6f} (card {tgc['auroc']:.6f}); the comparison took "
        f"{tgc['train_s'] + tgc['score_s'] + tc['train_s'] + tc['score_s']:.3f}"
        f" s of train and score")
    assert tc["splits"] == tgc["splits"], (tc["splits"], tgc["splits"])
    assert tc["keep"] == tgc["keep"], (tc["keep"], tgc["keep"])
    tprob_diff = float(np.abs(tgc["prob"] - tc["prob"]).max())
    assert tprob_diff <= TREE_PROB_ATOL, tprob_diff
    assert abs(tgc["auroc"] - tc["auroc"]) <= 1e-4
    nodes_differ = int(sum((a != b).sum() for a, b in
                           zip(tgc["heaps"][:3], tc["heaps"][:3])))
    log(f"[trees] cuda vs cpu on the prefix: same splits and kept columns, "
        f"max |prob diff| {tprob_diff:.3g}, AuROC diff "
        f"{abs(tgc['auroc'] - tc['auroc']):.3g}, heap entries (feature, bin, "
        f"leaf) that differ: {nodes_differ} of {3 * tgc['heaps'][0].size}")
    del tgc

    # -- 7. the selector on the card, counted ---------------------------------
    from transmogrifai_tpu_torch.evaluators.binary import masked_rank_metrics
    from transmogrifai_tpu_torch.selector import validator as validator_mod

    sdata = synthetic_passengers(SELECTOR_ROWS, seed=42, with_text=False)
    wdata = synthetic_passengers(WCV_ROWS, seed=42, with_text=False)
    rank_inputs = []

    def keep_rank_inputs(scores, y, vmask):
        rank_inputs.append((scores.clone(), y.clone(), vmask.clone()))
        return masked_rank_metrics(scores, y, vmask)

    # one run, counted (its profiled window was cut to make room for the
    # [mesh] phase: 25 s of the profiler's stop and read)
    validator_mod.masked_rank_metrics = keep_rank_inputs
    try:
        with kernel_inputs(kernels) as sel_inputs:
            sp = run_selector("cuda", sdata, kernels)
    finally:
        validator_mod.masked_rank_metrics = masked_rank_metrics
    log_selector("selector", sp)
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
    # (its run under workflow CV was cut to keep the whole run in its
    # limit: [default_selector] drives the same route at WCV_ROWS)
    assert_counted(sp, sel_inputs)
    # each kernel on every input the selector run gave it, timed once a
    # shape
    sel_shapes: dict = {}
    hold_path_inputs(kernels, sel_inputs, sel_shapes, errs, bin_errs)
    del sel_inputs
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

    # -- 10e. multi-GPU on torch.distributed: world 1 over NCCL, world 2 ----
    mesh = mesh_phase(kernels, errs, bin_errs)

    # -- 10f. the training operations layer: sharded ingest, autotune,
    # serving knobs, continuous refit
    ops = ops_phase(kernels, errs, bin_errs, timings)

    # -- 11. result lines ---------------------------------------------------
    def sel_by_path(k):
        return {"selector_train": spl["train"][k],
                "selector_score": spl["score"][k],
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
                **{path: v[k] for path, v in mesh["launches"].items()},
                **{f"ops_{step}": v[k] for step, v in ops["launches"].items()},
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
        "mesh_path_shapes": [
            {"what": "world 1 over NCCL, fused_moments_sharded",
             "shape": list(SCALE_SHAPE), "ms": mesh["world1"]["sharded"]["ms"],
             "kernel_ms": mesh["world1"]["kernel"]["ms"],
             "bound_ms": mesh["world1"]["bound_ms"]},
            *[t for t in mesh["shapes"] if t["kernel"] == "fused_moments"]],
        "ops_path_shapes": sel_shape_rows("fused_moments", ops["shapes"]),
        "at_scale": at_scale,
        "other_shapes": other_moments,
        "redesign_shapes": redesign["fused_moments"],
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
        "deploy_path_shapes": serve["deploy"]["k2_shapes"],
        "fleet_path_shapes": serve["fleet"]["k2_shapes"],
        "bulk_path_shapes": serve["fleet"]["bulk"]["k2_shapes"],
        "fused_train_path_shapes": sel_shape_rows("bin_matrix",
                                                  fused["shapes"]),
        "fused_train_existing_launches": fused["existing_launches"][
            "bin_matrix"],
        "mesh_path_shapes": [t for t in mesh["shapes"]
                             if t["kernel"] == "bin_matrix"],
        "ops_path_shapes": sel_shape_rows("bin_matrix", ops["shapes"]),
        "at_scale": bins_at_scale,
        "other_shapes": other_bins,
        "redesign_shapes": redesign["bin_matrix"],
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
