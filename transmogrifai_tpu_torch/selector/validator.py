"""Cross-validation / train-validation split over array-level candidates.

Counterpart of ``transmogrifai_tpu/selector/validator.py`` (OpValidator /
OpCrossValidation / OpTrainValidationSplit; reference: core/.../impl/
tuning/OpValidator.scala:275-322, OpCrossValidation.scala:71-167,
OpTrainValidationSplit.scala).  Where the reference fans fold x
model-type training out on a JVM thread pool, here the fan-out is
ARRAY-BATCHED on the validator's ``device``: folds and grid points are a
leading axis of weight vectors.  Three routes, as in the JAX package:

* binary logistic-regression-style grids train the whole fold x grid
  batch as ONE batched Newton fit over the design matrix uploaded once
  (``fit_arrays_batched``), and score it either on the device with the
  1024-bin ``masked_rank_metrics`` (the approx mode) or on the host with
  the exact evaluator;
* estimators with ``fit_arrays_folds`` (the GBT) fit every grid point and
  fold over one shared binning (``fit_arrays_folds_grid``), scored on the
  host;
* anything else fits candidate by candidate.

The approx mode runs where the validator's device is CUDA and n >= 100 000
(the JAX package's rule is its TPU backend and the same n);
``TX_CV_RANK_METRICS=approx|exact`` overrides either way.

The fused training programs (``local/fused_train.py``) take the batched
linear and the tree families' dispatches when their gate opens: one fold
x grid fit, scoring and metric matrix on the device, bit-equal betas and
metrics within 1e-9 of the kernel-at-a-time path.  ``train_fused=None``
(the default) engages them from ``TX_TRAIN_FUSED_MIN_ROWS`` rows (200 000)
up; ``True`` forces them at any size, ``False`` turns them off, and
``TX_TRAIN_FUSED=1|0`` forces or disables them for every validator.  A
family they cannot take, or a failure inside them, falls back to the
kernel-at-a-time path with its reason in the trail
(``last_train_fused``, ``ValidationResult.train_fused``).

``checkpoint_path`` checkpoints the CV state: each completed (model, grid
point) row of fold metrics is written to a JSON file (atomically) and
restored instead of refitted on a restart, and ``<checkpoint>.heartbeat``
is touched at the start and after every save, the liveness signal of
``workflow/supervisor.py``.  The keys are the JAX package's
(``"<model type>:<sorted params json>:<exact|approx>"``, un-suffixed
legacy keys read as exact), so each package restores the other's file.
The fits are traced as the JAX package's ``cv.fit_batch``, ``cv.fit_folds``
and ``cv.fit`` spans (``obs/trace.py``).

With a process group of two or more ranks (``parallel/mesh.py``) the
batched linear route takes the CV mesh, ``cv_mesh_or_none(k * g)``: the
fold x grid candidates split over its ``replica`` axis and the rows of
the replicated host matrix over its ``data`` axis
(``packed_newton.fit_batched_sharded``), the fit runs under the
collective watchdog (``guarded_collective("validator.fit_arrays_batched",
...)``, whose shrink refits on this rank's host copies alone), and every
rank scores the gathered betas over the whole matrix, so the validation
metrics and the selection are the same on every rank.  The tree fold fits
shard their rows over the ``data`` mesh themselves (``models/trees.py``).
A mesh keeps the fused training programs off, with reason ``mesh``, as
in the JAX package.  Only rank 0 writes the CV checkpoint.

``autotune`` (an ``autotune.AutotuneConfig``) runs the successive-halving
ladder before the fold x grid spend: the cost model's go/no-go
(``autotune/pruning.py``), then every candidate fits once on a seeded
row subsample - gathered on the device from the validate-wide float32
buffer (``index_select``), so X itself never crosses to the host for
it - and only the survivors take the full cross-validation; the trail
is ``last_autotune_report`` / ``ValidationResult.autotune``.
``validate_stream`` builds the fold masks from design-matrix chunks as
the input pipeline lands them (``StreamingFoldBuilder``), bit-equal to
the batch masks whatever the arrival order.  The catch-alls of the rung
fits and of the fused dispatch re-raise a device fault
(``parallel.kernels.is_device_fault``): only an ordinary error ranks a
rung last or degrades a family to the kernel-at-a-time path.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..autotune.cost_model import params_hash as _params_hash
from ..evaluators.base import OpEvaluatorBase
from ..evaluators.binary import masked_rank_metrics
from ..models.base import PredictorEstimator
from ..obs import trace as _obs_trace
from ..parallel.kernels import is_device_fault
from ..parallel.mesh import cv_mesh_or_none, data_mesh_or_none, is_writer
from ..types.columns import PredictionColumn
from ..utils.device import resolve_device

#: rows from which a CUDA validator scores LR-style grids by the device
#: rank metrics
APPROX_RANK_MIN_ROWS = 100_000


def _numeric_params(pmap: dict) -> dict:
    """The numeric hyperparameters of one grid point, flattened for span
    attrs: exactly the features the cost model trains on."""
    return {
        k: float(v) for k, v in pmap.items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    }


def _rung_train_mask(ys: np.ndarray, train_fraction: float,
                     seed: int) -> np.ndarray:
    """Deterministic train mask over the rung subsample: stratified per
    label class when the label is discrete (<=32 classes), else a plain
    shuffled split - regression rungs must not np.unique-explode.
    Bit-equal to the JAX package's."""
    n = len(ys)
    rng = np.random.RandomState(seed + 1)
    mask = np.zeros(n, dtype=bool)
    classes = np.unique(ys)
    if len(classes) <= 32:
        for c in classes:
            idx = np.nonzero(ys == c)[0]
            perm = rng.permutation(idx)
            mask[perm[: int(np.ceil(len(idx) * train_fraction))]] = True
    else:
        perm = rng.permutation(n)
        mask[perm[: int(np.ceil(n * train_fraction))]] = True
    return mask


def _ckpt_key(est, pmap: dict, mode: str) -> str:
    """A checkpoint row's key; the metric mode is part of it, so rows of
    the approximate device metrics never mix with exact host ones."""
    return f"{est.model_type}:{json.dumps(pmap, sort_keys=True)}:{mode}"


def _margins_kernel(X: torch.Tensor, betas: torch.Tensor, b0s: torch.Tensor):
    """[n, d] @ [B, d]^T + [B] -> [n, B] decision margins for all
    candidates in one matmul (stays on the device)."""
    return X @ betas.T + b0s[None, :]


@dataclass
class ValidationResult:
    best_estimator: PredictorEstimator
    best_params: dict
    best_metric: float
    metric_name: str
    larger_better: bool
    all_results: list = field(default_factory=list)  # per (model, grid) dicts
    #: the successive-halving decision trail: rungs, prunes,
    #: predicted-vs-actual times; None when autotune was off
    autotune: Optional[dict] = None
    #: the fused-training trail: per family the backend (fused, or
    #: existing with its reason) and, for a fused one, its walls, mode and
    #: shape bucket; None when no family reached the fused gate
    train_fused: Optional[dict] = None


def stratified_kfold_masks(
    y: np.ndarray, k: int, seed: int, stratify: bool
) -> np.ndarray:
    """[k, n] bool masks, True = row in the fold's TRAIN split.  Stratified
    per label class when requested (reference: OpCrossValidation.scala:161-167
    label-stratified kFold).  Bit-equal to the JAX package's."""
    n = len(y)
    if stratify:
        classes = np.unique(y)
        class_indices = {c: np.nonzero(y == c)[0] for c in classes}
        return _kfold_masks_from_indices(class_indices, n, k, seed)
    rng = np.random.RandomState(seed)
    fold_of = np.empty(n, dtype=np.int64)
    fold_of[rng.permutation(n)] = np.arange(n) % k
    return np.stack([fold_of != f for f in range(k)], axis=0)


def _kfold_masks_from_indices(
    class_indices: dict, n: int, k: int, seed: int
) -> np.ndarray:
    """Stratified fold masks from precomputed per-class row indices, the
    RNG consumed class by class in ascending order."""
    rng = np.random.RandomState(seed)
    fold_of = np.empty(n, dtype=np.int64)
    for c in sorted(class_indices):
        idx = np.asarray(class_indices[c])
        perm = rng.permutation(len(idx))
        fold_of[idx[perm]] = np.arange(len(idx)) % k
    return np.stack([fold_of != f for f in range(k)], axis=0)


class StreamingFoldBuilder:
    """CV fold construction that consumes design-matrix chunks AS THEY
    LAND from the sharded input pipeline (readers/pipeline.py), instead
    of waiting for the full matrix.

    ``observe`` runs the per-chunk work - per-class row scans for the
    stratified split plus block retention - while worker threads are
    still parsing later shards; ``finalize`` orders chunks by their
    (shard_id, chunk_id) key, assembles X/y with one copy pass, and
    computes fold masks bit-identical to the batch
    :func:`stratified_kfold_masks` on the assembled y (same RNG
    consumption), regardless of chunk ARRIVAL order.
    """

    def __init__(self, k: int, seed: int = 42,
                 stratify: bool = False) -> None:
        self.k = int(k)
        self.seed = int(seed)
        self.stratify = bool(stratify)
        self._chunks: list[tuple] = []  # (order_key, X, y, local_idx)
        self.rows = 0

    def observe(self, order_key, X_block, y_block) -> None:
        Xb = np.asarray(X_block)
        yb = np.asarray(y_block)
        local: dict = {}
        if self.stratify:
            for c in np.unique(yb):
                local[float(c)] = np.nonzero(yb == c)[0]
        self._chunks.append((tuple(order_key), Xb, yb, local))
        self.rows += len(yb)

    def finalize(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (X [n, d] float32, y [n], train_masks [k, n])."""
        if not self._chunks:
            raise ValueError("no chunks observed")
        self._chunks.sort(key=lambda t: t[0])
        n = self.rows
        d = self._chunks[0][1].shape[1]
        X = np.empty((n, d), np.float32)
        y = np.empty(n, self._chunks[0][2].dtype)
        class_indices: dict = {}
        at = 0
        for _, Xb, yb, local in self._chunks:
            m = len(yb)
            X[at:at + m] = Xb
            y[at:at + m] = yb
            for c, idx in local.items():
                class_indices.setdefault(c, []).append(idx + at)
            at += m
        if self.stratify:
            merged = {
                c: np.concatenate(parts)
                for c, parts in class_indices.items()
            }
            masks = _kfold_masks_from_indices(merged, n, self.k,
                                              self.seed)
        else:
            masks = stratified_kfold_masks(y, self.k, self.seed, False)
        return X, y, masks


def _lr_style_grid(grid: Sequence[dict]) -> bool:
    """Batched path applies when every grid key is a batched-fit scalar."""
    ok = {"reg_param", "elastic_net_param"}
    return all(set(p) <= ok for p in grid)


def _binary_labels(y) -> bool:
    """The batched LR kernel assumes y in {0,1}; multiclass labels must
    take the generic per-candidate path (a 3-class label through the
    binary batched kernel would silently fit sigmoid-on-{0,1,2})."""
    return len(np.unique(np.asarray(y))) <= 2


def lr_grid_scalars(est, grid: Sequence[dict]) -> tuple[np.ndarray, np.ndarray]:
    """Per-grid-point (regs, ens) for fit_arrays_batched, defaulting from
    the estimator's params - the single source of the batched-LR grid
    contract (shared by validate() and workflow-CV's per-fold path)."""
    regs = np.array(
        [p.get("reg_param", est.params.get("reg_param", 0.0)) for p in grid]
    )
    ens = np.array(
        [p.get("elastic_net_param", est.params.get("elastic_net_param", 0.0))
         for p in grid]
    )
    return regs, ens


class OpValidator:
    """Base validator.  ``device`` is where the batched fits and the device
    rank metrics run (``"cuda"`` by default); the model selector sets it,
    and its candidates', to its own."""

    def __init__(
        self,
        evaluator: OpEvaluatorBase,
        seed: int = 42,
        stratify: bool = False,
        checkpoint_path: Optional[str] = None,
        autotune=None,
        device: str = "cuda",
    ) -> None:
        self.evaluator = evaluator
        self.seed = seed
        self.stratify = stratify
        self.checkpoint_path = checkpoint_path
        self.device = str(device)
        #: successive-halving config (autotune.AutotuneConfig); None runs
        #: the exhaustive sweep
        self.autotune = autotune
        #: decision trail of the LAST validate() call (also on
        #: ValidationResult.autotune); None when autotune was off
        self.last_autotune_report: Optional[dict] = None
        #: the fused training programs: None = auto (TX_TRAIN_FUSED and
        #: the row floor), True / False force them on or off
        self.train_fused: Optional[bool] = None
        #: accepted for the JAX package's interface and unused: the torch
        #: programs have no compile cache to keep
        self.train_cache_dir: Optional[str] = None
        #: the per-family fused-training trail of the LAST validate() call
        #: (also on ValidationResult.train_fused)
        self.last_train_fused: Optional[dict] = None

    # -- CV checkpoint ------------------------------------------------------
    def _ckpt_load(self) -> dict:
        if not self.checkpoint_path or not os.path.exists(self.checkpoint_path):
            return {}
        try:
            with open(self.checkpoint_path) as f:
                done = json.load(f)
        except (OSError, ValueError):
            return {}
        # un-suffixed keys come from the exact host metrics of older files:
        # a restart after an upgrade must not refit every candidate
        return {
            (k if k.endswith((":exact", ":approx")) else k + ":exact"): v
            for k, v in done.items()
        }

    def _ckpt_save(self, done: dict) -> None:
        if not self.checkpoint_path or not is_writer():
            return
        tmp = self.checkpoint_path + ".tmp"
        os.makedirs(os.path.dirname(self.checkpoint_path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(done, f)
        os.replace(tmp, self.checkpoint_path)
        self._beat()

    def _beat(self) -> None:
        """Progress heartbeat for the supervisor (workflow/supervisor.py):
        liveness is CV progress, so a wedged launch or a killed host stops
        the beat."""
        if not self.checkpoint_path:
            return
        from ..workflow.supervisor import beat

        beat(self.checkpoint_path + ".heartbeat")

    def train_masks(self, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    #: one-shot mask override installed by validate_stream (fold masks
    #: already built chunk by chunk during ingest)
    _streamed_masks: Optional[np.ndarray] = None

    def validate_stream(
        self,
        models: Sequence[tuple[PredictorEstimator, Sequence[dict]]],
        chunks,
        weights: Optional[np.ndarray] = None,
    ) -> ValidationResult:
        """:meth:`validate` fed by a chunk stream: ``chunks`` yields
        (order_key, X_block, y_block) as the input pipeline lands them
        (readers/pipeline.py).  Fold construction - the stratified
        per-class row scans and the design-matrix assembly - runs per
        chunk DURING parsing; the candidate fits start the moment the
        last chunk lands.  Selection is the batch path's on the same data
        (same masks, same RNG)."""
        is_cv = isinstance(self, OpCrossValidation)
        k = getattr(self, "num_folds", 1)
        # per-chunk stratified scans pay off only when the masks are
        # used: a train/validation split computes its own in validate()
        builder = StreamingFoldBuilder(
            k, self.seed, self.stratify and is_cv)
        for order_key, Xb, yb in chunks:
            builder.observe(order_key, Xb, yb)
        X, y, masks = builder.finalize()
        if is_cv:
            self._streamed_masks = masks
        try:
            return self.validate(models, X, y, weights=weights)
        finally:
            self._streamed_masks = None

    def _metric_of(self, y: np.ndarray, pred, raw, prob) -> float:
        m = self.evaluator.evaluate_arrays(
            y, PredictionColumn(pred, raw, prob)
        )
        return self.evaluator.default_metric(m)

    # -- fused training programs -------------------------------------------
    def _train_fused_gate(self, n: int, mesh_present: bool) -> Optional[str]:
        """None when a family's fused fold x grid dispatch may engage, else
        the fallback reason recorded.  Auto mode engages only at scale
        (``TX_TRAIN_FUSED_MIN_ROWS``, default 200 000), the JAX package's
        rule; ``train_fused=True`` or ``TX_TRAIN_FUSED=1`` force the path
        at any size.  A mesh (``mesh_present``: the CV mesh of a linear
        family, the data mesh of a tree family) always falls back, with
        reason ``mesh``: the guarded mesh route owns multi-rank fits."""
        if self.train_fused is False:
            return "disabled"
        env = os.environ.get("TX_TRAIN_FUSED", "").strip().lower()
        if env in ("0", "false", "off"):
            return "disabled_env"
        forced = self.train_fused is True or env in ("1", "true", "on")
        if not forced:
            min_rows = int(os.environ.get("TX_TRAIN_FUSED_MIN_ROWS", 200_000))
            if n < min_rows:
                return "below_min_rows"
        if mesh_present:
            return "mesh"
        return None

    def _record_train_fused(self, family: str, entry: dict) -> None:
        rep = self.last_train_fused
        if rep is None:
            rep = self.last_train_fused = {
                "backend": "existing",
                "families": {},
                "cache": {"hits": 0, "misses": 0, "stale": 0},
            }
        rep["families"][family] = entry
        backends = {e.get("backend") for e in rep["families"].values()}
        rep["backend"] = (
            "fused" if backends == {"fused"}
            else "existing" if backends == {"existing"} else "mixed"
        )

    def _try_train_fused(self, kind: str, est, mode: str, **kw):
        """The fused dispatch of this family, or None (the reason recorded
        in the trail) to take the kernel-at-a-time path.  A failure here
        degrades, loudly, and never ends a selection."""
        from ..local import fused_train as _ft

        reason = self._train_fused_gate(kw.pop("n"), kw.pop("mesh_present"))
        if reason is not None:
            self._record_train_fused(
                est.model_type, {"backend": "existing", "reason": reason})
            return None
        try:
            with _obs_trace.span(
                "cv.fit_batch", family=est.model_type,
                candidates=int(kw["candidates"]), folds=int(kw["folds"]),
                n_rows=int(kw["n_rows"]), n_features=int(kw["n_features"]),
                fused=1,
            ):
                if kind == "linear":
                    res = _ft.run_linear(
                        est, kw["xdev"](), kw["y"], kw["masks"], kw["w"],
                        kw["weights_given"], kw["regs"], kw["ens"],
                        kw["g"], self.evaluator, mode,
                        cache_dir=self.train_cache_dir,
                        x_source=kw["x_source"],
                    )
                else:
                    res = _ft.run_tree(
                        est, kw["X"], kw["y"], kw["masks"], kw["W"],
                        kw["grid"], self.evaluator,
                        cache_dir=self.train_cache_dir,
                    )
        except _ft.FusedTrainError as e:
            self._record_train_fused(
                est.model_type, {"backend": "existing", "reason": e.reason})
            return None
        except Exception as e:  # noqa: BLE001 - a fused-path fault must
            # degrade to the kernel-at-a-time path, never end the
            # selection; a device fault is not a fused-path fault
            if is_device_fault(e):
                raise
            import logging

            logging.getLogger("transmogrifai_tpu_torch.selector").warning(
                "fused training dispatch for %s failed (%s: %s); falling "
                "back to the kernel-at-a-time path",
                est.model_type, type(e).__name__, e, exc_info=True,
            )
            self._record_train_fused(
                est.model_type,
                {"backend": "existing", "reason": f"error:{type(e).__name__}"})
            return None
        self._record_train_fused(est.model_type, res.report)
        return res

    @staticmethod
    def _fit_batched_on_mesh(est, mesh, Xj, y_fit, Wj, regs, ens, dev,
                             xhost, y, masks, w, weighted: bool, g: int):
        """The fold x grid fit over the CV mesh - THE mesh collective of
        the batched route - under the collective watchdog, so a hung or
        dead peer degrades (straggler retry, then a survivor recompute)
        instead of wedging the selection.  The shrink refits every
        candidate from this rank's host copies with no mesh, on a fresh
        CUDA stream."""
        from ..parallel import resilience

        def shrink():
            train = masks.astype(np.float32)
            if weighted:
                train = train * np.asarray(w, np.float32)[None, :]
            with resilience.survivor_stream(dev):
                return est.fit_arrays_batched(
                    xhost(), y, np.repeat(train, g, axis=0), regs, ens)

        return resilience.guarded_collective(
            "validator.fit_arrays_batched",
            lambda: est.fit_arrays_batched(Xj, y_fit, Wj, regs, ens,
                                           mesh=mesh),
            shrink_fn=shrink,
        )

    def _approx_rank(self, n: int, dev: torch.device) -> bool:
        """Whether LR-style grids may use the 1024-bin device rank metrics:
        only where they save host-device transfers of the per-fold
        validation slices, on the card with enough rows; on the CPU - or
        small data, where near-tied candidates could flip on quantization -
        the exact host metrics.  TX_CV_RANK_METRICS=approx|exact
        overrides."""
        env = os.environ.get("TX_CV_RANK_METRICS", "").strip().lower()
        if env == "approx":
            return True
        if env == "exact":
            return False
        return dev.type == "cuda" and n >= APPROX_RANK_MIN_ROWS

    # -- successive-halving pre-pass ------------------------------------------
    def _autotune_prune(self, models, y, w, masks, larger, xdev, n_features):
        """Budget-ladder rung 0: every candidate fits ONCE on a
        deterministic row subsample, the cost model plus interim eval
        scores pick survivors, and only survivors proceed to the full
        fold x grid spend.  Decision logic lives in autotune/pruning.py
        (go/no-go BEFORE any rung fit, so a degraded run costs exactly the
        exhaustive budget); this method owns execution.  The rung rows are
        gathered from the validate-wide device buffer ``xdev()`` with a
        device index.  Returns (models-to-run, decision report,
        all_results entries for the pruned candidates)."""
        from ..autotune import pruning as _at
        from ..autotune.cost_model import candidate_features, key_for_fit

        cfg = self.autotune
        k = masks.shape[0]
        n = len(y)
        d = int(n_features)
        models = [(est, list(grid) or [{}]) for est, grid in models]
        infos = []
        gi = 0
        for ei, (est, grid) in enumerate(models):
            for j, pmap in enumerate(grid):
                infos.append(_at.CandidateInfo(
                    index=gi, est_index=ei, grid_index=j,
                    family=est.model_type, params=dict(pmap),
                    params_hash=_params_hash(pmap),
                ))
                gi += 1
        classes, counts = np.unique(y, return_counts=True)
        balance = float(counts.min() / counts.sum()) \
            if len(classes) > 1 else 1.0
        plan = _at.plan_pruning(cfg, infos, n, d, k, class_balance=balance)
        if not plan.pruning:
            report = plan.report()
            self._record_autotune(report)
            return models, report, []
        # rung subsample + split: seeded by the validator seed, so the
        # ladder is the same run to run
        rng = np.random.RandomState(self.seed)
        sub = np.sort(rng.permutation(n)[: plan.rung_rows])
        Xd = xdev()
        Xs = Xd.index_select(
            0, torch.as_tensor(sub, device=Xd.device)).cpu().numpy()
        ys, ws = y[sub], w[sub]
        rtr = _rung_train_mask(ys, cfg.rung_train_fraction, self.seed)
        n_rtr = int(rtr.sum())
        cm = cfg.cost_model
        with _obs_trace.span("autotune.rung", rows=int(plan.rung_rows),
                             candidates=len(infos)):
            for c in infos:
                est, _grid = models[c.est_index]
                cand = est.with_params(**c.params)
                t0 = time.perf_counter()
                try:
                    with _obs_trace.span(
                        "autotune.rung_fit", family=c.family,
                        params_hash=c.params_hash, n_rows=n_rtr,
                        n_features=d, **_numeric_params(c.params),
                    ):
                        params = cand.fit_arrays(Xs[rtr], ys[rtr], ws[rtr])
                    pred, raw, prob = cand.predict_arrays(params, Xs[~rtr])
                    c.interim_metric = self._metric_of(
                        ys[~rtr], pred, raw, prob)
                except Exception as e:  # noqa: BLE001 - a failed rung
                    # fit ranks the candidate last (recorded in the trail)
                    # but never ends the selection; a device fault is not
                    # a failed rung, and re-raises
                    if is_device_fault(e):
                        raise
                    c.rung_error = f"{type(e).__name__}: {e}"
                c.rung_wall_ms = (time.perf_counter() - t0) * 1e3
                if c.rung_error is None:
                    # a failed fit's time-to-exception is NOT a cost
                    # observation
                    cm.observe(
                        key_for_fit(c.family),
                        candidate_features(n_rtr, d, c.params, balance),
                        c.rung_wall_ms,
                    )
        _at.select_survivors(plan, larger)
        pruned_models = []
        for ei, (est, grid) in enumerate(models):
            keep = sorted(
                c.grid_index for c in infos
                if c.est_index == ei and c.kept
            )
            if keep:
                # survivors keep their ORIGINAL grid order, so the main
                # loop's evaluation order - and winner tie-breaks - match
                # the exhaustive sweep's
                pruned_models.append((est, [grid[j] for j in keep]))
        pruned_results = [
            {
                "model_type": c.family,
                "model_uid": models[c.est_index][0].uid,
                "params": dict(c.params),
                "metric": float("nan") if c.interim_metric is None
                else float(c.interim_metric),
                "fold_metrics": [],
                "pruned": True,
                "metric_kind": "rung",
                "rung_rows": int(plan.rung_rows),
            }
            for c in infos if not c.kept
        ]
        report = plan.report()
        self._record_autotune(report)
        return pruned_models, report, pruned_results

    def _record_autotune(self, report: dict) -> None:
        """Every pruning decision is visible in the obs plane: counters
        and gauges in the metrics registry (scraped as tx_autotune_*) plus
        a decision event on the ambient trace."""
        from ..obs.metrics import metrics_registry

        reg = metrics_registry()
        reg.counter(
            "autotune.selections",
            help="validate() calls that consulted the autotune ladder",
        ).inc()
        if report["mode"] == "pruned":
            reg.counter(
                "autotune.candidates_pruned",
                help="grid candidates pruned at the rung",
            ).inc(report["candidates_pruned"])
            if report.get("predicted_speedup"):
                reg.gauge(
                    "autotune.predicted_speedup",
                    help="cost-model predicted exhaustive/pruned "
                         "selection speedup",
                ).set(float(report["predicted_speedup"]))
        else:
            reg.counter(
                "autotune.exhaustive_runs",
                help="autotune-enabled selections that degraded to the "
                     "exhaustive sweep (reason in the report)",
            ).inc()
        _obs_trace.tracer().event(
            "autotune.decision", mode=report["mode"],
            reason=report.get("reason") or "",
            pruned=int(report["candidates_pruned"]),
            survivors=int(report["survivors"]),
        )

    def validate(
        self,
        models: Sequence[tuple[PredictorEstimator, Sequence[dict]]],
        X,
        y: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ) -> ValidationResult:
        """Pick the best (estimator, param-map) by mean validation metric
        across folds (reference: OpValidator.validate:129 +
        OpCrossValidation fold aggregation :60,118-124).  ``X`` is a host
        array or a tensor; a float32 tensor on the validator's device
        (``examples.synthetic.synthetic_design_matrix_device``) is fitted
        where it lies."""
        dev = resolve_device(self.device)
        self.last_train_fused = None
        n = len(y)
        w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
        if self._streamed_masks is not None:
            # fold masks already built chunk by chunk during ingest
            # (validate_stream); bit-identical to train_masks(y)
            masks = self._streamed_masks
        else:
            masks = self.train_masks(y)  # [k, n] True=train
        k = masks.shape[0]
        larger = self.evaluator.larger_better
        metric_name = getattr(self.evaluator, "metric_name", "")
        approx_rank = self._approx_rank(n, dev)
        # ONE float32 upload of the design matrix per validate call, shared
        # by every batched family; lazy, so host-only families never pay
        # it, and a float32 tensor already on the device is used as it is
        _xdev: list = []

        def xdev() -> torch.Tensor:
            if not _xdev:
                if isinstance(X, torch.Tensor):
                    _xdev.append(X.to(device=dev, dtype=torch.float32))
                else:
                    _xdev.append(torch.tensor(
                        np.ascontiguousarray(X, dtype=np.float32),
                        device=dev))
            return _xdev[0]

        # the host copy, made at most once and only for a family or metric
        # mode that runs on the host: a card-resident X on the batched
        # LR's device rank metrics never crosses the bus
        _xh: list = []

        def xhost() -> np.ndarray:
            if not _xh:
                _xh.append(X.cpu().numpy() if isinstance(X, torch.Tensor)
                           else np.asarray(X))
            return _xh[0]

        # one np.unique scan per validate() at most, and only if some
        # classifier asks
        _ybin: list = []

        def labels_ok(est) -> bool:
            if not getattr(est, "batched_needs_binary_y", True):
                return True
            if not _ybin:
                _ybin.append(_binary_labels(y))
            return _ybin[0]

        n_features = int(X.shape[1])
        at_report = None
        pruned_results: list = []
        if self.autotune is not None:
            models, at_report, pruned_results = self._autotune_prune(
                models, y, w, masks, larger, xdev, n_features)
        self.last_autotune_report = at_report
        ckpt = self._ckpt_load()
        self._beat()  # validation started: open the liveness window
        all_results = []
        best = None  # (metric, estimator, params)
        for est, grid in models:
            grid = list(grid) or [{}]
            g = len(grid)
            t_est0 = time.perf_counter()
            batched = (hasattr(est, "fit_arrays_batched")
                       and _lr_style_grid(grid) and labels_ok(est))
            # only the batched-LR branch can use the device approximation;
            # tree and generic paths are exact on every device
            mode = ("approx" if approx_rank and batched
                    and metric_name in ("AuROC", "AuPR") else "exact")
            metrics = np.zeros((g, k))
            done_mask = [_ckpt_key(est, pmap, mode) in ckpt for pmap in grid]
            for j, pmap in enumerate(grid):
                if done_mask[j]:
                    metrics[j] = ckpt[_ckpt_key(est, pmap, mode)]
            fold_batched = not batched and hasattr(est, "fit_arrays_folds")
            mesh = None
            if batched:
                # the fold x grid batch's per-candidate scalars, fold-major
                regs_g, ens_g = lr_grid_scalars(est, grid)
                regs = np.tile(regs_g, k)
                ens = np.tile(ens_g, k)
                mesh = cv_mesh_or_none(k * g)
            # the fused training program of the family (fit, scores and the
            # metric matrix in one dispatch), or None: the trail says why
            fused_res = None
            if batched and not any(done_mask):
                fused_res = self._try_train_fused(
                    "linear", est, mode, n=n, mesh_present=mesh is not None,
                    xdev=xdev, x_source=X, y=y,
                    masks=masks, w=w, weights_given=weights is not None,
                    regs=regs, ens=ens, g=g, candidates=k * g, folds=k,
                    n_rows=n, n_features=n_features,
                )
            elif (fold_batched and not any(done_mask)
                    and hasattr(est, "fused_tree_plan")):
                fused_res = self._try_train_fused(
                    "tree", est, mode, n=n,
                    mesh_present=data_mesh_or_none() is not None,
                    X=xhost(), y=y, masks=masks,
                    W=masks.astype(np.float64) * w[None, :], grid=grid,
                    candidates=g * k, folds=k, n_rows=n,
                    n_features=n_features,
                )
            if all(done_mask):
                pass  # every row restored from the checkpoint
            elif fused_res is not None:
                # the shared tail below checkpoints and reports the fused
                # metric matrix as it does the kernel-at-a-time path's
                metrics[:, :] = fused_res.metrics.T
            elif batched:
                # ONE batched fit for the whole fold x grid batch: the
                # [B, n] per-candidate weights are tiled on the device
                # from the [k, n] fold masks, fold-major like the regs
                Xj = xdev()
                trainj = torch.as_tensor(masks, device=dev).to(torch.float32)
                if weights is None:
                    Wj = trainj.repeat_interleave(g, dim=0)
                else:
                    wj = torch.as_tensor(w, device=dev).to(torch.float32)
                    Wj = (trainj * wj[None, :]).repeat_interleave(g, dim=0)
                y_fit = torch.as_tensor(np.asarray(y), device=dev).to(torch.float32)
                # one span for the one-launch-sequence batch: per-candidate
                # walls do not exist here
                with _obs_trace.span(
                    "cv.fit_batch", family=est.model_type,
                    candidates=int(k * g), folds=int(k), n_rows=int(n),
                    n_features=n_features,
                ):
                    if mesh is None:
                        betas, b0s = est.fit_arrays_batched(Xj, y_fit, Wj,
                                                            regs, ens)
                    else:
                        betas, b0s = self._fit_batched_on_mesh(
                            est, mesh, Xj, y_fit, Wj, regs, ens, dev,
                            xhost, y, masks, w, weights is not None, g)
                if mode == "approx":
                    # rank metrics on the device against the resident X: no
                    # per-fold validation slice leaves the card
                    scores = _margins_kernel(
                        Xj, torch.as_tensor(betas, device=dev),
                        torch.as_tensor(b0s, device=dev),
                    ).T  # [B, n]
                    vmask = (1.0 - trainj).repeat_interleave(g, dim=0)
                    auroc_b, aupr_b = masked_rank_metrics(scores, y_fit, vmask)
                    vals = auroc_b if metric_name == "AuROC" else aupr_b
                    metrics[:, :] = vals.reshape(k, g).T
                else:
                    for f in range(k):
                        val = ~masks[f]
                        yv = y[val]
                        for j in range(g):
                            b = f * g + j
                            pred, raw, prob = est.predict_arrays(
                                {"beta": betas[b], "intercept": b0s[b]},
                                xhost()[val],
                            )
                            metrics[j, f] = self._metric_of(yv, pred, raw, prob)
            elif fold_batched:
                # fold-batched path (trees): grid x folds over one shared
                # binning when the estimator batches whole grids, else one
                # fold fan-out per grid point
                W = masks.astype(np.float64) * w[None, :]
                todo = [j for j in range(g) if not done_mask[j]]
                grid_fold_params = None
                if hasattr(est, "fit_arrays_folds_grid"):
                    with _obs_trace.span(
                        "cv.fit_batch", family=est.model_type,
                        candidates=int(len(todo) * k), folds=int(k),
                        n_rows=int(n), n_features=n_features,
                    ):
                        grid_fold_params = est.fit_arrays_folds_grid(
                            xhost(), y, W, [grid[j] for j in todo])
                for pos, j in enumerate(todo):
                    pmap = grid[j]
                    cand = est.with_params(**pmap)
                    if grid_fold_params is not None:
                        fold_params = grid_fold_params[pos]
                    else:
                        with _obs_trace.span(
                            "cv.fit_folds", family=est.model_type,
                            params_hash=_params_hash(pmap), folds=int(k),
                            n_rows=int(n), n_features=n_features,
                            **_numeric_params(pmap),
                        ):
                            fold_params = cand.fit_arrays_folds(xhost(), y, W)
                    for f in range(k):
                        val = ~masks[f]
                        pred, raw, prob = cand.predict_arrays(
                            fold_params[f], xhost()[val]
                        )
                        metrics[j, f] = self._metric_of(y[val], pred, raw, prob)
                    ckpt[_ckpt_key(est, pmap, mode)] = metrics[j].tolist()
                    self._ckpt_save(ckpt)
            else:
                for j, pmap in enumerate(grid):
                    if done_mask[j]:
                        continue
                    cand = est.with_params(**pmap)
                    for f in range(k):
                        tr, val = masks[f], ~masks[f]
                        with _obs_trace.span(
                            "cv.fit", family=est.model_type,
                            params_hash=_params_hash(pmap), fold=int(f),
                            n_rows=int(tr.sum()), n_features=n_features,
                            **_numeric_params(pmap),
                        ):
                            params = cand.fit_arrays(xhost()[tr], y[tr], w[tr])
                        pred, raw, prob = cand.predict_arrays(params, xhost()[val])
                        metrics[j, f] = self._metric_of(y[val], pred, raw, prob)
                    ckpt[_ckpt_key(est, pmap, mode)] = metrics[j].tolist()
                    self._ckpt_save(ckpt)
            if not all(done_mask):
                for j, pmap in enumerate(grid):
                    ckpt[_ckpt_key(est, pmap, mode)] = metrics[j].tolist()
                self._ckpt_save(ckpt)
            mean_metrics = metrics.mean(axis=1)
            for j, pmap in enumerate(grid):
                all_results.append(
                    {
                        "model_type": est.model_type,
                        "model_uid": est.uid,
                        "params": dict(pmap),
                        "metric": float(mean_metrics[j]),
                        "fold_metrics": metrics[j].tolist(),
                        # which evaluator produced these numbers: "approx" =
                        # the 1024-bin device rank metrics, "exact" = host
                        "rank_metric_mode": mode,
                    }
                )
            j_best = int(np.argmax(mean_metrics) if larger else np.argmin(mean_metrics))
            cand_metric = float(mean_metrics[j_best])
            if best is None or (
                cand_metric > best[0] if larger else cand_metric < best[0]
            ):
                best = (cand_metric, est, dict(grid[j_best]))
            if at_report is not None:
                # predicted-vs-actual trail: the measured full-spend wall
                # per family next to the cost model's predictions
                walls = at_report.setdefault("actual_full_ms_by_family", {})
                walls[est.model_type] = round(
                    walls.get(est.model_type, 0.0)
                    + (time.perf_counter() - t_est0) * 1e3, 3)

        assert best is not None, "no models to validate"
        if pruned_results:
            # pruned candidates stay visible in the selection metadata
            # (flagged, rung-scored) but can never win: the best scan saw
            # only survivors' full-CV means
            all_results.extend(pruned_results)
        return ValidationResult(
            best_estimator=best[1].with_params(**best[2]),
            best_params=best[2],
            best_metric=best[0],
            metric_name=self.evaluator.metric_name,
            larger_better=larger,
            all_results=all_results,
            autotune=at_report,
            train_fused=self.last_train_fused,
        )


class OpCrossValidation(OpValidator):
    """(reference: OpCrossValidation.scala - numFolds default 3)"""

    def __init__(
        self,
        num_folds: int = 3,
        evaluator: Optional[OpEvaluatorBase] = None,
        seed: int = 42,
        stratify: bool = False,
        checkpoint_path: Optional[str] = None,
        autotune=None,
        device: str = "cuda",
    ) -> None:
        super().__init__(evaluator, seed, stratify, checkpoint_path,
                         autotune=autotune, device=device)
        self.num_folds = num_folds

    def train_masks(self, y: np.ndarray) -> np.ndarray:
        return stratified_kfold_masks(y, self.num_folds, self.seed, self.stratify)


class OpTrainValidationSplit(OpValidator):
    """(reference: OpTrainValidationSplit.scala - trainRatio default 0.75)"""

    def __init__(
        self,
        train_ratio: float = 0.75,
        evaluator: Optional[OpEvaluatorBase] = None,
        seed: int = 42,
        stratify: bool = False,
        checkpoint_path: Optional[str] = None,
        autotune=None,
        device: str = "cuda",
    ) -> None:
        super().__init__(evaluator, seed, stratify, checkpoint_path,
                         autotune=autotune, device=device)
        self.train_ratio = train_ratio

    def train_masks(self, y: np.ndarray) -> np.ndarray:
        n = len(y)
        rng = np.random.RandomState(self.seed)
        if self.stratify:
            mask = np.zeros(n, dtype=bool)
            for c in np.unique(y):
                idx = np.nonzero(y == c)[0]
                perm = rng.permutation(idx)
                mask[perm[: int(np.ceil(len(idx) * self.train_ratio))]] = True
        else:
            perm = rng.permutation(n)
            mask = np.zeros(n, dtype=bool)
            mask[perm[: int(np.ceil(n * self.train_ratio))]] = True
        return mask[None, :]
