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

The compile-to-kernel seams of the JAX package (``Lowering``,
``XlaLowering``) and its streaming partial-fit hooks are not part of this
package yet (ROADMAP queue 1, items 1 and 7).
"""
from __future__ import annotations

import copy as _copy
from typing import Any, Optional, Sequence, Type

from ..features.feature import Feature
from ..types.columns import Column
from ..types.dataset import Dataset
from ..types.feature_types import FeatureType
from ..utils.uid import make_uid


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


class Estimator(PipelineStage):
    """A stage that must observe data to produce a fitted Transformer.

    Estimators with device work keep a ``device`` attribute (a string such
    as ``"cuda"`` or ``"cpu"``); ``OpWorkflow`` sets it to the workflow's
    device before it fits them."""

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
