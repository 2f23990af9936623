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

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
queue 1 item when asked for: successive-halving ``autotune`` (item 12)
and ``validate_stream`` (item 12).
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..evaluators.base import OpEvaluatorBase
from ..evaluators.binary import masked_rank_metrics
from ..models.base import PredictorEstimator
from ..obs import trace as _obs_trace
from ..parallel.mesh import cv_mesh_or_none, data_mesh_or_none, is_writer
from ..types.columns import PredictionColumn
from ..utils.device import resolve_device

#: rows from which a CUDA validator scores LR-style grids by the device
#: rank metrics
APPROX_RANK_MIN_ROWS = 100_000


def _not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet "
        f"(ROADMAP.md queue 1, item {item})"
    )


def _params_hash(params: dict) -> str:
    """Stable 12-hex identity of a hyperparameter map (the JAX package's
    ``autotune.cost_model.params_hash``: sha256 of the sorted JSON)."""
    blob = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _numeric_params(pmap: dict) -> dict:
    """The numeric hyperparameters of one grid point, as span attrs."""
    return {
        k: float(v) for k, v in pmap.items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    }


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
        if autotune is not None:
            raise _not_ported("successive-halving autotune", 12)
        self.evaluator = evaluator
        self.seed = seed
        self.stratify = stratify
        self.checkpoint_path = checkpoint_path
        self.device = str(device)
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

    def validate_stream(self, models, chunks, weights=None):
        raise _not_ported("validate_stream (chunk-streamed CV)", 12)

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
            # degrade to the kernel-at-a-time path, never end the selection
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

        ckpt = self._ckpt_load()
        self._beat()  # validation started: open the liveness window
        n_features = int(X.shape[1])
        all_results = []
        best = None  # (metric, estimator, params)
        for est, grid in models:
            grid = list(grid) or [{}]
            g = len(grid)
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

        assert best is not None, "no models to validate"
        return ValidationResult(
            best_estimator=best[1].with_params(**best[2]),
            best_params=best[2],
            best_metric=best[0],
            metric_name=self.evaluator.metric_name,
            larger_better=larger,
            all_results=all_results,
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
