"""DAG computation: layer stages by distance-to-sink.

Semantics of the reference's FitStagesUtil.computeDAG / cutDAG
(reference: core/.../utils/stages/FitStagesUtil.scala:173-198, 305-358):

* walk ``parent_stages`` from every result feature, keeping each stage's
  MAX distance to any sink,
* group stages by distance, sort layers descending (farthest first), so
  executing layers in order satisfies all data dependencies.

``cut_dag_during`` / ``cut_dag`` split the DAG around model selectors for
workflow-level cross-validation (reference: FitStagesUtil.cutDAG:305-358).

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


def _label_touching(stage: PipelineStage) -> bool:
    """Reference CVTS trigger (FitStagesUtil.scala:334-337): a stage whose
    inputs mix a response with a non-response feature sees label-dependent
    state and must be refit inside every CV fold."""
    ins = stage.input_features
    return any(f.is_response for f in ins) and any(
        not f.is_response for f in ins
    )


def cut_dag_during(
    dag: Sequence[Layer], model_selectors: Sequence[PipelineStage]
) -> dict[str, list[PipelineStage]]:
    """Per-selector 'during' sets for workflow-level CV, with the
    reference's exact semantics (FitStagesUtil.cutDAG:305-358): walk the
    selector's upstream cone farthest-first and cut at the FIRST layer
    containing a label-touching stage; every cone stage from that layer
    down to the selector - transformers included - refits inside each fold.
    Returns {selector_uid: [during stages in execution order] + [selector]}
    (empty stage list when no label-touching upstream exists, meaning the
    selector's own plain CV is already leakage-free).

    Extension over the reference, which errors on >1 selector
    (FitStagesUtil.scala:311-317): PARALLEL selectors each get their own
    independent cut; a selector nested in another's upstream cone is still
    an error.
    """
    selector_set = set(model_selectors)
    out: dict[str, list[PipelineStage]] = {}
    for sel in model_selectors:
        cone: dict[PipelineStage, int] = {}
        for st, d in sel.get_output().parent_stages().items():
            if st is sel or isinstance(st, FeatureGeneratorStage):
                continue
            if cone.get(st, -1) < d:
                cone[st] = d
        nested = [s for s in cone if s in selector_set]
        if nested:
            raise ValueError(
                f"model selector {sel.uid} has other model selectors in its "
                f"upstream cone ({[s.uid for s in nested]}); nested "
                "selectors are not supported (reference: at most one "
                "selector, FitStagesUtil.scala:311-317)"
            )
        by_dist: dict[int, list[PipelineStage]] = {}
        for st, d in cone.items():
            by_dist.setdefault(d, []).append(st)
        # farthest-first = execution order within the cone
        dists = sorted(by_dist, reverse=True)
        first_idx = next(
            (i for i, d in enumerate(dists)
             if any(_label_touching(s) for s in by_dist[d])),
            None,
        )
        during: list[PipelineStage] = []
        if first_idx is not None:
            for d in dists[first_idx:]:
                during.extend(sorted(by_dist[d], key=lambda s: s.uid))
        out[sel.uid] = during + [sel]
    return out


def cut_dag(
    dag: Sequence[Layer], model_selectors: Sequence[PipelineStage]
) -> tuple[list[Layer], list[PipelineStage], list[Layer]]:
    """Split into (before, during, after) around the given model selectors
    (reference: FitStagesUtil.cutDAG:305-358).  'during' is the union of
    the per-selector cuts from :func:`cut_dag_during`; 'after' is every
    stage transitively downstream of a selector; 'before' is the rest."""
    if not model_selectors:
        return list(dag), [], []
    selector_set = set(model_selectors)
    downstream: set[PipelineStage] = set()
    produced = {s.get_output().uid for s in selector_set}
    all_stages = flatten(dag)
    changed = True
    while changed:
        changed = False
        for s in all_stages:
            if s in selector_set or s in downstream:
                continue
            if any(p.uid in produced for p in s.input_features):
                downstream.add(s)
                produced.add(s.get_output().uid)
                changed = True

    during_map = cut_dag_during(dag, model_selectors)
    during_set = {s for lst in during_map.values() for s in lst}
    during: list[PipelineStage] = []
    seen: set[str] = set()
    for layer in dag:  # union in execution order, deduped
        for s in layer:
            if s in during_set and s.uid not in seen:
                during.append(s)
                seen.add(s.uid)
    before = [
        [s for s in layer
         if s not in selector_set and s not in downstream
         and s not in during_set]
        for layer in dag
    ]
    before = [l for l in before if l]
    after = [[s for s in layer if s in downstream] for layer in dag]
    after = [l for l in after if l]
    return before, during, after
