"""Symbolic feature DAG nodes.

Counterpart of FeatureLike/Feature (reference: features/src/main/
scala/com/salesforce/op/features/FeatureLike.scala:48,338,363 and
Feature.scala).  A Feature is an immutable symbolic handle - no data - with a
name, a static type tag, the stage that produces it, and parent features.
The workflow recovers the full DAG by walking ``origin_stage``/``parents``
from requested result features, exactly as the reference does; materialization
happens only at ``train()``/``score()`` time.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence, Type

from ..types.feature_types import FeatureType
from ..utils.uid import make_uid

if TYPE_CHECKING:  # pragma: no cover
    from ..stages.base import PipelineStage


class Feature:
    """Immutable symbolic handle to a (future) column of typed data."""

    def __init__(
        self,
        name: str,
        ftype: Type[FeatureType],
        is_response: bool = False,
        origin_stage: Optional["PipelineStage"] = None,
        parents: Sequence["Feature"] = (),
        uid: Optional[str] = None,
    ) -> None:
        self.name = name
        self.ftype = ftype
        self.is_response = bool(is_response)
        self.origin_stage = origin_stage
        self.parents: tuple[Feature, ...] = tuple(parents)
        self.uid = uid or make_uid("Feature")

    # -- graph traversal ----------------------------------------------------
    def is_raw(self) -> bool:
        """True when produced by a FeatureGeneratorStage / no origin (raw data)."""
        return not self.parents

    def _current_parents(self) -> tuple:
        """The feature's parents per the CURRENT stage graph: blacklist
        surgery rewires origin_stage.input_features in place, so every
        traversal (raw_features, parent_stages, history) must read the
        stage's inputs, not the construction-time ``parents`` tuple."""
        st = self.origin_stage
        parents = getattr(st, "input_features", None) if st is not None else None
        return tuple(parents) if parents else self.parents

    def raw_features(self) -> list["Feature"]:
        """All raw ancestors (reference: FeatureLike.scala:338), name-sorted."""
        seen: dict[str, Feature] = {}
        stack: list[Feature] = [self]
        visited: set[str] = set()
        while stack:
            f = stack.pop()
            if f.uid in visited:
                continue
            visited.add(f.uid)
            if f.is_raw():
                seen[f.uid] = f
            stack.extend(f._current_parents())
        return sorted(seen.values(), key=lambda f: f.name)

    def parent_stages(self) -> dict["PipelineStage", int]:
        """Map of every ancestor stage to its distance from this feature,
        with cycle detection (reference: FeatureLike.scala:363).  Distance is
        the max path length from this (sink) feature to the stage."""
        dist: dict[PipelineStage, int] = {}
        # iterative BFS over (feature, depth); cycle check via path-length cap
        frontier: list[tuple[Feature, int]] = [(self, 0)]
        n_guard = 0
        while frontier:
            n_guard += 1
            if n_guard > 1_000_000:
                raise ValueError(f"Feature {self.name} has too many ancestors or a cycle")
            nxt: list[tuple[Feature, int]] = []
            for f, d in frontier:
                st = f.origin_stage
                if st is not None:
                    if dist.get(st, -1) < d:
                        dist[st] = d
                    # traverse the CURRENT stage graph (see
                    # _current_parents): blacklist surgery rewires
                    # stage.input_features in place, and the DAG must
                    # follow the rewired graph or cascaded-away stages
                    # keep riding in via stale parent links
                    for p in f._current_parents():
                        nxt.append((p, d + 1))
            frontier = nxt
        return dist

    def history(self) -> dict:
        """Lineage summary (reference: FeatureHistory)."""
        raws = [f.name for f in self.raw_features()]
        stages = sorted(
            (s.uid for s in self.parent_stages()), key=str
        )
        return {"originFeatures": raws, "stages": stages}

    # -- manual op application (reference: FeatureLike.transformWith) -------
    def transform_with(self, stage: "PipelineStage", *others: "Feature") -> "Feature":
        return stage.set_input(self, *others).get_output()

    def copy(self, is_response: Optional[bool] = None) -> "Feature":
        return Feature(
            name=self.name,
            ftype=self.ftype,
            is_response=self.is_response if is_response is None else is_response,
            origin_stage=self.origin_stage,
            parents=self.parents,
            uid=self.uid,
        )

    def as_response(self) -> "Feature":
        return self.copy(is_response=True)

    def as_predictor(self) -> "Feature":
        return self.copy(is_response=False)

    def __repr__(self) -> str:
        kind = "response" if self.is_response else "predictor"
        return f"Feature({self.name}: {self.ftype.__name__}, {kind}, uid={self.uid})"

    def __hash__(self) -> int:
        return hash(self.uid)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Feature) and other.uid == self.uid
