"""Engine-free local scoring of a fitted workflow.

Counterpart of ``transmogrifai_tpu/local/scorer.py`` and of the reference's
``local`` module (reference: local/.../
OpWorkflowModelLocal.scala:30-120, OpWorkflowRunnerLocal) which compiles a
fitted Spark pipeline into a plain ``Map[String, Any] => Map[String, Any]``
function: OP stages score through the row-level ``transformKeyValue``
interface and Spark-wrapped models run through MLeap's local runtime.

Every stage transforms host-side numpy columns, and every predictor
exposes a pure-numpy ``predict_arrays_np`` path (models/base.py), so
"local" means:

* the scoring DAG is resolved ONCE at construction;
* when every fitted stage lowers, batches score through ONE fused
  program: the torch device program (``local/fused_torch.py``) on the
  model's device, or the numpy-fused program (``local/fused.py``);
* otherwise predictor stages are swapped to their numpy predict path and
  the DAG is interpreted stage by stage;
* records score one dict at a time (``__call__``) or as micro-batches
  (``score_batch``) - the same row-level contract as the reference's
  scoreFunction, usable for request/response serving or streaming loops.

The backend: ``"auto"`` takes ``"torch"`` when the model's device is CUDA
(``OpWorkflow()``'s default) and ``"numpy"`` for a CPU model; it never
probes for a card and never picks the CPU by itself.  ``"torch"`` on a
CUDA model that CUDA cannot serve raises.  ``TX_FUSED_BACKEND`` overrides
the default choice.
"""
from __future__ import annotations

import copy
import logging
import os
from typing import Any, Iterable, Mapping, Optional, Sequence

from ..models.base import PredictorModel
from ..obs import trace as _obs_trace
from ..parallel.kernels import is_device_fault
# module-level: the row path validates EVERY scored batch - importing
# inside _validate put one import-machinery hit on every call
from ..schema.contract import apply_drift_policy, collect_violations
from ..stages.base import Transformer
from ..types.columns import column_from_list
from ..types.dataset import Dataset
from ..utils.device import resolve_device
from ..workflow.workflow import OpWorkflowModel
from .fused import DECODABLE_KINDS, FusionError, RecordDecoder, \
    compile_pipeline
from .fused_torch import compile_torch_pipeline

log = logging.getLogger("transmogrifai_tpu_torch.local")

FUSED_BACKENDS = ("auto", "numpy", "torch")


def _auto_backend(device: str) -> str:
    """The model's own device decides: ``"torch"`` for a CUDA model,
    ``"numpy"`` for a CPU one."""
    return "torch" if str(device).startswith("cuda") else "numpy"


class LocalScorer:
    """Compiled dict->dict scorer over a fitted OpWorkflowModel.

    ``drift_policy`` wires the model's schema contract (schema/
    contract.py) into the row path: ``"warn"`` (default) logs each
    distinct violation once, ``"raise"`` raises SchemaDriftError naming
    the offending feature, ``None``/``"off"`` disables validation (the
    serving endpoint sets this - it owns validation itself, validating
    twice per batch would be pure overhead).
    """

    def __init__(self, model: OpWorkflowModel,
                 contract=None,
                 drift_policy: Optional[str] = "warn",
                 fused: bool = True,
                 fused_backend: Optional[str] = None) -> None:
        self.raw_features = tuple(
            f for f in model.raw_features
            if not any(f.name == b.name for b in model.blacklisted_features)
        )
        self.result_features = tuple(model.result_features)
        self.contract = (
            contract if contract is not None
            else getattr(model, "schema_contract", None)
        )
        self.drift_policy = (
            None if drift_policy in (None, "off") else drift_policy
        )
        if self.drift_policy not in (None, "warn", "raise"):
            raise ValueError(
                "LocalScorer drift_policy must be 'warn', 'raise', or "
                f"'off', got {drift_policy!r}"
            )
        self._warned_violations: set = set()
        # shallow-copy the DAG so flipping prefer_numpy never mutates the
        # model object the caller still holds
        dag = model._dag()
        self._dag = []
        for layer in dag:
            new_layer = []
            for stage in layer:
                if isinstance(stage, PredictorModel):
                    stage = copy.copy(stage)
                    stage.prefer_numpy = True
                new_layer.append(stage)
            self._dag.append(new_layer)
        # the per-request hot loop is precompiled: stage order flattened,
        # input/output names resolved once (output_name walks get_output()
        # per call), transformer-ness validated here instead of per row
        self._steps = []
        for layer in self._dag:
            for stage in layer:
                if not isinstance(stage, Transformer):
                    raise ValueError(
                        f"cannot score with unfitted estimator {stage.uid}; "
                        "train first"
                    )
                self._steps.append(
                    (stage, [f.name for f in stage.input_features],
                     stage.output_name)
                )
        # ONE decoder for both serve paths: raw record dicts -> dense
        # arrays (fused) or Columns (interpreted), no per-element
        # column_from_list loop on the hot path.  Features the decoder
        # cannot handle fall back to column_from_list per batch.
        self._decoder = RecordDecoder(
            [f for f in self.raw_features
             if f.ftype.kind in DECODABLE_KINDS]
        )
        self._slow_features = tuple(
            f for f in self.raw_features
            if f.ftype.kind not in DECODABLE_KINDS
        )
        # whole-pipeline fused compilation (local/fused.py +
        # local/fused_torch.py): when every fitted stage lowers, batches
        # score through ONE array program - the torch device program on
        # the model's device when requested/auto-selected, else the
        # numpy-fused program.  Every degradation is per-PIPELINE, never
        # per-batch: torch falls back to numpy-fused, numpy-fused to
        # interpreted, each step recorded in fused_reason.  A device
        # fault (a kernel that does not build or launch, a CUDA error)
        # is never a degradation: it raises out of the lowering here and
        # out of score_batch, so a CUDA model is never served from the
        # host after one.
        backend = (
            fused_backend
            or os.environ.get("TX_FUSED_BACKEND", "").strip()
            or "auto"
        )
        if backend not in FUSED_BACKENDS:
            raise ValueError(
                f"fused_backend must be one of {FUSED_BACKENDS}, "
                f"got {backend!r}"
            )
        self.device = str(getattr(model, "device", "cuda"))
        if backend == "auto":
            backend = _auto_backend(self.device)
        self.fused = None
        self.fused_backend: Optional[str] = None
        self.fused_reason: Optional[str] = (
            None if fused else "disabled by caller"
        )
        reasons: list[str] = []
        if fused and backend == "torch":
            # outside the degrade net: a CUDA model on a host without
            # CUDA raises here rather than serving from the CPU
            dev = resolve_device(self.device)
            try:
                self.fused = compile_torch_pipeline(
                    self._steps, self.raw_features, self.result_features,
                    device=dev,
                )
                self.fused_backend = "torch"
            except FusionError as e:
                reasons.append(f"torch backend unavailable: {e}")
                log.info(
                    "pipeline not torch-fusable, degrading to numpy-fused:"
                    " %s", e,
                )
            except Exception as e:  # noqa: BLE001 - degrade, don't die
                if is_device_fault(e):
                    raise
                reasons.append(
                    f"torch lowering raised {type(e).__name__}: {e}"
                )
                log.warning(
                    "torch fusion failed, degrading to numpy-fused: %s",
                    reasons[-1],
                )
        if fused and self.fused is None:
            try:
                self.fused = compile_pipeline(
                    self._steps, self.raw_features, self.result_features
                )
                self.fused_backend = "numpy"
                # fused, but not on the requested backend: keep the
                # degradation visible in telemetry
                self.fused_reason = "; ".join(reasons) or None
            except FusionError as e:
                reasons.append(str(e))
                self.fused_reason = "; ".join(reasons)
                log.info("pipeline not fusable, serving interpreted: %s", e)
            except Exception as e:  # noqa: BLE001 - degrade, don't die
                # lower() is an open extension seam: a buggy third-party
                # lowering must cost the fused path, not the endpoint
                reasons.append(f"lowering raised {type(e).__name__}: {e}")
                self.fused_reason = "; ".join(reasons)
                log.warning(
                    "pipeline fusion failed, serving interpreted: %s",
                    self.fused_reason,
                )

    # -- contract validation -------------------------------------------------
    def _validate(self, records: Sequence[Mapping[str, Any]]) -> None:
        if self.drift_policy is None or self.contract is None:
            return
        # the validate + policy dispatch shared with the serving endpoint
        # (schema/contract.py): one implementation, so a registry-driven
        # swap cannot behave differently across the two serve surfaces
        violations = collect_violations(self.contract, records)
        apply_drift_policy(violations, self.drift_policy,
                           self._warned_violations, log,
                           "local scorer serving anyway")

    # -- scoring ------------------------------------------------------------
    def score_batch(
        self, records: Sequence[Mapping[str, Any]]
    ) -> list[dict[str, Any]]:
        """Score a micro-batch of record dicts -> list of result dicts.
        An empty batch (e.g. every row quarantined upstream) returns an
        empty list - pinned to the serving endpoint's behavior, never an
        exception from a zero-row stage."""
        if not records:
            return []
        self._validate(records)
        if self.fused is not None:
            # the whole-pipeline compiled path: decode -> one fused
            # array program per shape bucket -> result dicts (one span
            # per batch, fused-tagged, riding the ambient trace)
            with _obs_trace.span("score.batch", n=len(records),
                                 fused=True):
                return self.fused.score_batch(records)
        with _obs_trace.span("score.batch", n=len(records), fused=False):
            cols = self._decoder.decode_columns(records)
            cols.update({
                f.name: column_from_list(
                    [r.get(f.name) for r in records], f.ftype
                )
                for f in self._slow_features
            })
            # mutate the scorer-owned Dataset in place: the functional
            # with_column path re-validates and copies the whole column
            # dict per stage (~16 Dataset builds per scored row), half
            # the serving latency at profile
            out = Dataset(cols)
            for stage, in_names, out_name in self._steps:
                out.set_column(
                    out_name,
                    stage.transform_columns(
                        [out[n] for n in in_names], out),
                    validate=False,
                )
            names = [
                f.name for f in self.result_features if f.name in out
            ]
            n = len(records)
            lists = []
            for name in names:
                vals = out[name].to_list()
                if len(vals) != n:  # validate=False escape hatch guard
                    raise ValueError(
                        f"result column {name!r} has {len(vals)} rows "
                        f"for {n} scored records"
                    )
                lists.append(vals)
            if not names:
                return [{} for _ in records]
            # one columnar pass: zip the result columns into row dicts
            # instead of the per-row x per-name double comprehension
            return [dict(zip(names, row)) for row in zip(*lists)]

    def __call__(self, record: Mapping[str, Any]) -> dict[str, Any]:
        return self.score_batch([record])[0]

    def score_stream(
        self, records: Iterable[Mapping[str, Any]], batch_size: int = 256
    ) -> Iterable[dict[str, Any]]:
        """Micro-batched streaming scoring (the analog of the reference's
        StreamingScore run type scoring each DStream batch with the local
        scoreFn, OpWorkflowRunner.scala:313-332)."""
        batch: list[Mapping[str, Any]] = []
        for r in records:
            batch.append(r)
            if len(batch) >= batch_size:
                yield from self.score_batch(batch)
                batch = []
        if batch:
            yield from self.score_batch(batch)


def score_function(model: OpWorkflowModel, **kw) -> LocalScorer:
    """Compile a fitted model into a reusable dict->dict scorer (reference:
    OpWorkflowModelLocal.scoreFunction:67); ``kw`` goes to
    :class:`LocalScorer`."""
    return LocalScorer(model, **kw)
