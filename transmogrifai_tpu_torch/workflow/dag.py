"""DAG computation: layer stages by distance-to-sink.

Semantics of the reference's FitStagesUtil.computeDAG / cutDAG
(reference: core/.../utils/stages/FitStagesUtil.scala:173-198, 305-358):

* walk ``parent_stages`` from every result feature, keeping each stage's
  MAX distance to any sink,
* group stages by distance, sort layers descending (farthest first), so
  executing layers in order satisfies all data dependencies.

The JAX package's ``cut_dag`` (workflow-level cross-validation) comes with
the model-selector slice (ROADMAP.md queue 1, item 5).

Stages are deduped by uid; each layer is name-sorted for determinism
(the reference sorts everything for reproducibility - OpWorkflow.scala:88).
"""
from __future__ import annotations

from typing import Sequence

from ..features.feature import Feature
from ..stages.base import PipelineStage
from ..stages.feature_generator import FeatureGeneratorStage

Layer = list[PipelineStage]


def compute_dag(result_features: Sequence[Feature]) -> list[Layer]:
    """Layered DAG of stages needed to materialize ``result_features``.

    Returns layers in execution order (dependencies first).  Raw feature
    generators are excluded - they run at ingest (reader) time.
    """
    dist: dict[PipelineStage, int] = {}
    for f in sorted(result_features, key=lambda f: f.name):
        for stage, d in f.parent_stages().items():
            if isinstance(stage, FeatureGeneratorStage):
                continue
            if dist.get(stage, -1) < d:
                dist[stage] = d
    if not dist:
        return []
    layers: dict[int, Layer] = {}
    for stage, d in dist.items():
        layers.setdefault(d, []).append(stage)
    ordered = []
    for d in sorted(layers, reverse=True):  # farthest from sink = first
        ordered.append(sorted(layers[d], key=lambda s: s.uid))
    return ordered


def flatten(dag: Sequence[Layer]) -> list[PipelineStage]:
    return [s for layer in dag for s in layer]


def validate_dag(dag: Sequence[Layer]) -> None:
    """Uid uniqueness + output name uniqueness + stage serializability
    (reference: OpWorkflow.scala:265-323 - validateStages plus the
    ClosureUtils.checkSerializable gate run on every stage before
    training, so save/warm-start failures surface at train() time with
    the offending stage named, not at save() time)."""
    from ..serialization.model_io import _encode, stage_state

    uids: set[str] = set()
    outs: set[str] = set()
    for stage in flatten(dag):
        if stage.uid in uids:
            raise ValueError(f"duplicate stage uid: {stage.uid}")
        uids.add(stage.uid)
        name = stage.output_name
        if name in outs:
            raise ValueError(f"duplicate output feature name: {name}")
        outs.add(name)
        try:  # dry-run the model writer's encoder on everything save_model
            # will encode: fitted state, ctor params, and metadata (a stage
            # holding an unserializable value in params must fail HERE, at
            # train() time, not at save() time)
            _encode(stage_state(stage), {}, stage.uid)
            _encode(stage.params, {}, stage.uid)
            _encode(stage.metadata, {}, stage.uid)
        except TypeError as e:
            raise ValueError(
                f"stage {stage.uid} ({type(stage).__name__}) holds "
                f"state the model writer cannot serialize: {e}"
            ) from e
