"""Stage abstractions: Transformer / Estimator with typed feature IO.

Counterpart of ``transmogrifai_tpu/stages/base.py`` (reference:
features/.../stages/OpPipelineStages.scala:176-616 and
features/.../stages/base/*):

* ``transform`` is *columnar*: it receives the whole Dataset and returns one
  Column - the analog of the reference's row-level ``OpTransformer.
  transformRow`` (OpPipelineStages.scala:592-616) but vectorized.
* Estimators fit on columnar data (the heavy ones on a torch device) and
  return a fitted Transformer (the "Model"), carrying summary metadata.
* Every stage owns a ``params`` dict (reference Spark ``Param``s) and a
  ``metadata`` dict - the summary-metadata channel consumed by
  ModelInsights (reference: SanityChecker.scala:677, ModelSelector.scala:189).

The compile-to-kernel seams: a fitted stage returns a numpy
:class:`Lowering` from ``lower()`` (the numpy-fused scoring program,
``local/fused.py``) and a :class:`TorchLowering` from ``lower_torch()``
(the device program of ``local/fused_torch.py``; the JAX package's
``XlaLowering``).  Estimators whose fit statistics merge across row
chunks (``streaming_fittable``) take them from the workflow's streaming
ingest (``partial_fit_chunk``, ``accept_partial_fits``), as in the JAX
package.
"""
from __future__ import annotations

import copy as _copy
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Type

from ..features.feature import Feature
from ..types.columns import Column
from ..types.dataset import Dataset
from ..types.feature_types import FeatureType
from ..utils.uid import make_uid

#: env-key suffix for a numeric feature's validity mask in the lowered
#: (fused) array representation - see :class:`Lowering`
MASK_SUFFIX = "@mask"
#: env-key suffixes for a Prediction output's auxiliary arrays
RAW_SUFFIX = "@raw"
PROB_SUFFIX = "@prob"


@dataclass(frozen=True)
class Lowering:
    """A fitted stage compiled down to a pure array function.

    The compile-to-kernel seam: a fitted Transformer that can express its
    transform as a closed-over function over named numpy arrays returns
    one of these from :meth:`Transformer.lower`, and the PipelineCompiler
    (local/fused.py) fuses every lowered stage of a fitted plan into ONE
    program per shape bucket - no Column/Dataset boxing between stages.

    The environment is a flat ``dict[str, np.ndarray]`` keyed by
    feature name, with auxiliary arrays under suffixed keys:

    * numeric feature ``f``  -> ``f``: float64 [n] (masked slots hold
      0.0, matching NumericColumn's canonical form), ``f@mask``:
      bool [n]
    * text feature ``f``     -> ``f``: object [n] host list or array
      (None = missing; consumers iterate element-wise either way)
    * list-ish feature ``f`` -> ``f``: object [n] of tuples/frozensets
    * vector feature ``f``   -> ``f``: float32 [n, d]
    * prediction output ``f``-> ``f``: float64 [n], plus optional
      ``f@raw`` / ``f@prob``: float64 [n, k]

    ``fn`` receives the env and returns the new entries to merge into
    it; it must be pure (no mutation of its inputs) so a fused program
    can be replayed per shape bucket.  ``signature`` documents the
    dtype/shape contract per produced key for telemetry and debugging.
    """

    fn: Callable[[dict], dict]
    inputs: tuple  # env keys read
    outputs: tuple  # env keys written
    signature: dict = field(default_factory=dict)  # key -> "dtype[shape]"


@dataclass(frozen=True)
class TorchLowering:
    """A fitted stage compiled to a torch array function on one device.

    The device half of the compile-to-kernel seam (the JAX package's
    ``XlaLowering``): where :class:`Lowering` closes over numpy, a
    ``TorchLowering.fn`` runs pure torch ops over a flat dict of tensors
    that all lie on one device, and the torch pipeline compiler
    (local/fused_torch.py) chains every device-lowered stage into one
    program on the scorer's device.

    The env contract narrows to what a tensor can hold: float64 [n]
    values + bool [n] ``@mask`` companions for numerics, float32 [n, d]
    vectors, float64 [n(, k)] prediction arrays.  Text and list features
    never enter the device program: stages consuming them (one-hot
    pivots) keep their numpy :class:`Lowering` and run as HOST PRE-STEPS
    whose numeric outputs are copied to the device as inputs.

    ``fn`` must mirror the numpy lowering's arithmetic closely enough
    that parity stays within the per-family ULP budgets the tests pin.
    """

    fn: Callable[[dict], dict]
    inputs: tuple  # env keys read
    outputs: tuple  # env keys written
    signature: dict = field(default_factory=dict)  # key -> "dtype[shape]"


class PipelineStage:
    """Base of all stages: uid, typed inputs, single typed output feature."""

    # subclasses declare expected input types; None disables checking
    input_types: Optional[Sequence[Type[FeatureType]]] = None
    output_type: Type[FeatureType] = FeatureType

    def __init__(
        self,
        operation_name: Optional[str] = None,
        uid: Optional[str] = None,
        **params: Any,
    ) -> None:
        cls = type(self).__name__
        self.operation_name = operation_name or cls
        self.uid = uid or make_uid(cls)
        self.params: dict[str, Any] = dict(params)
        self.metadata: dict[str, Any] = {}
        self.input_features: tuple[Feature, ...] = ()
        self._output: Optional[Feature] = None

    # -- params -------------------------------------------------------------
    def set(self, **params: Any) -> "PipelineStage":
        self.params.update(params)
        return self

    def get(self, name: str, default: Any = None) -> Any:
        return self.params.get(name, default)

    # -- wiring -------------------------------------------------------------
    def check_input_types(self, features: Sequence[Feature]) -> None:
        if self.input_types is None:
            return
        expected = list(self.input_types)
        if len(expected) and expected[-1] is Ellipsis:  # variadic tail
            tail_t = expected[-2]
            expected = expected[:-2] + [tail_t] * max(
                0, len(features) - len(expected) + 2
            )
        if len(expected) != len(features):
            raise TypeError(
                f"{self.operation_name} expects {len(expected)} inputs, "
                f"got {len(features)}"
            )
        for f, t in zip(features, expected):
            if not issubclass(f.ftype, t):
                raise TypeError(
                    f"{self.operation_name} input {f.name!r} has type "
                    f"{f.ftype.__name__}, expected {t.__name__}"
                )

    def set_input(self, *features: Feature) -> "PipelineStage":
        self.check_input_types(features)
        self.input_features = tuple(features)
        self._output = None
        return self

    def make_output_name(self) -> str:
        ins = "-".join(f.name for f in self.input_features)[:80]
        return f"{ins}_{self.operation_name}_{self.uid}"

    def get_output(self) -> Feature:
        if self._output is None:
            if not self.input_features:
                raise ValueError(f"stage {self.uid} has no inputs set")
            self._output = Feature(
                name=self.make_output_name(),
                ftype=self.output_type,
                is_response=any(f.is_response for f in self.input_features),
                origin_stage=self,
                parents=self.input_features,
            )
        return self._output

    @property
    def output_name(self) -> str:
        return self.get_output().name

    def input_columns(self, ds: Dataset) -> list[Column]:
        return [ds[f.name] for f in self.input_features]

    def copy(self) -> "PipelineStage":
        # Spark's defaultCopy copies the param map: mutating a copy's params
        # or metadata must never leak into the original stage
        new = _copy.copy(self)
        new.params = _copy.deepcopy(self.params)
        new.metadata = _copy.deepcopy(self.metadata)
        return new

    def __repr__(self) -> str:
        ins = ", ".join(f.name for f in self.input_features)
        return f"{type(self).__name__}(uid={self.uid}, in=[{ins}])"


class Transformer(PipelineStage):
    """A stage with a pure columnar transform."""

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        raise NotImplementedError

    def transform(self, ds: Dataset) -> Dataset:
        col = self.transform_columns(self.input_columns(ds), ds)
        return ds.with_column(self.output_name, col)

    def lower(self) -> Optional[Lowering]:
        """Compile this FITTED stage to a pure numpy array function, or
        None when it cannot be lowered (the pipeline then serves through
        the interpreted stage-by-stage path).  Implementations must
        produce bit-identical arrays to ``transform_columns``."""
        return None

    def lower_torch(self) -> Optional[TorchLowering]:
        """Compile this FITTED stage to a torch array function, or None
        when it has no device lowering.  A None is NOT a pipeline-wide
        failure: when the stage's numpy :meth:`lower` consumes only
        host-available keys (raw decodes or other host outputs), the
        torch compiler runs it as a host pre-step feeding the device
        program - the route every text/one-hot stage takes."""
        return None


class Estimator(PipelineStage):
    """A stage that must observe data to produce a fitted Transformer.

    Estimators with device work keep a ``device`` attribute (a string such
    as ``"cuda"`` or ``"cpu"``); ``OpWorkflow`` sets it to the workflow's
    device before it fits them."""

    #: estimators whose fit-time statistics are mergeable across row
    #: chunks flip this True and implement :meth:`partial_fit_chunk`:
    #: the workflow's streaming ingest (readers/pipeline.py) then
    #: accumulates their statistics WHILE shards parse, and the next
    #: fit() consumes the merged stats instead of re-scanning the
    #: materialized columns
    streaming_fittable = False

    #: merged streaming statistics, set by :meth:`accept_partial_fits`
    #: and consumed EXACTLY ONCE by the next fit (one-shot, so a later
    #: refit - a CV fold refit on a subset - never reuses full-data
    #: statistics)
    _streamed_stats = None

    def partial_fit_chunk(self, cols: Sequence[Column], ds: Dataset):
        """Pure per-chunk fit statistics (no state mutation): whatever
        :meth:`accept_partial_fits` can merge deterministically."""
        raise NotImplementedError(
            f"{type(self).__name__} is not streaming-fittable"
        )

    def accept_partial_fits(self, stats: Sequence) -> None:
        """Install chunk statistics (in deterministic source order) for
        the next fit; stages override ``_merge_partial_fits`` for their
        stat shape."""
        self._streamed_stats = self._merge_partial_fits(list(stats))

    def _merge_partial_fits(self, stats: list):
        return stats

    def _take_streamed(self):
        """Pop the installed streaming statistics (None when absent)."""
        s = self._streamed_stats
        self._streamed_stats = None
        return s

    def fit_model(self, cols: Sequence[Column], ds: Dataset) -> "Transformer":
        raise NotImplementedError

    def fit(self, ds: Dataset) -> "Transformer":
        return self.adopt(self.fit_model(self.input_columns(ds), ds))

    def adopt(self, model: "Transformer") -> "Transformer":
        """Put a fitted model in this estimator's place in the DAG: same
        inputs, output feature and uid (reference: fitted stages replace
        estimators in OpWorkflowModel.setStages)."""
        model.input_features = self.input_features
        model._output = self.get_output()
        model.uid = self.uid  # fitted model keeps the stage's uid in the DAG
        model.operation_name = self.operation_name
        if not model.metadata:
            model.metadata = dict(self.metadata)
        return model


class LambdaTransformer(Transformer):
    """Arity-agnostic transformer from a columnar function.  The function
    receives the input Columns and must return a Column."""

    def __init__(
        self,
        fn,
        output_type: Type[FeatureType],
        operation_name: str = "lambda",
        input_types: Optional[Sequence[Type[FeatureType]]] = None,
        uid: Optional[str] = None,
        **params: Any,
    ) -> None:
        super().__init__(operation_name=operation_name, uid=uid, **params)
        self.fn = fn
        self.output_type = output_type
        if input_types is not None:
            self.input_types = input_types

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        return self.fn(*cols)
