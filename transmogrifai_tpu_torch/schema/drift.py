"""Serve-time distribution-drift scoring against the training contract.

Host copy of ``transmogrifai_tpu/schema/drift.py``.  The score-vs-train half of the reference's RawFeatureFilter (reference:
core/.../filters/RawFeatureFilter.scala jsDivergence check between
training and scoring FeatureDistributions) relocated to where this
engine actually sees scoring traffic: the serving endpoint.  A
:class:`DriftMonitor` accumulates a running FeatureDistribution per
contracted feature from every scored batch (distributions are monoid-
mergeable — the same reduce the reference runs over Spark partitions,
here over serve batches) with numeric bin edges PINNED to the training
value_range, so the JS divergence against the fit-time histogram is
meaningful from the first batch.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Mapping, Optional, Sequence

from ..filters.feature_distribution import (
    FeatureDistribution,
    compute_distribution,
)
# columnar extraction shared with the fused-serving decoder (one
# single-pass comprehension per feature instead of the per-element
# column_from_list loop - drift observation was the top line of the
# fused-endpoint profile at ~46us/row); the helpers live in
# types/columns.py so this import stays within the base layer
from ..types.columns import (
    NumericColumn,
    TextColumn,
    column_from_list,
    decode_numeric,
    decode_text,
)
from .contract import SchemaContract

log = logging.getLogger("transmogrifai_tpu_torch.schema")

#: JS divergence above this logs a drift WARNING (once per feature per
#: monitor); scores are always surfaced in telemetry regardless
DEFAULT_WARN_THRESHOLD = 0.1

#: the WARNING (not the score) waits for this many observed rows: a
#: 4-row batch legitimately has JS ~0.6 against a 32-bin training
#: histogram from pure sampling noise, and a latched false alarm is
#: worse than a slightly later true one
DEFAULT_MIN_WARN_ROWS = 256


class DriftMonitor:
    """Running serve-side distributions + JS drift scores per feature."""

    def __init__(
        self,
        contract: SchemaContract,
        warn_threshold: float = DEFAULT_WARN_THRESHOLD,
        min_warn_rows: int = DEFAULT_MIN_WARN_ROWS,
    ) -> None:
        self.contract = contract
        self.warn_threshold = float(warn_threshold)
        self.min_warn_rows = int(min_warn_rows)
        self._accum: dict[str, FeatureDistribution] = {}
        self._warned: set[str] = set()
        self._lock = threading.Lock()
        self.batches_observed = 0
        # only features with a captured training distribution can drift-
        # score; numeric bins reuse the training value_range so the two
        # histograms share edges (Summary.scala's train->score hand-off)
        self._watch: list[tuple[str, Any, Optional[tuple], int]] = []
        for name, train_dist in contract.distributions.items():
            spec = contract.feature(name)
            if spec is None or spec.is_response:
                continue
            if spec.kind not in ("numeric", "text"):
                continue
            ftype = contract.ftype_of(name)
            n_bins = (
                max(len(train_dist.histogram) - 2, 1)
                if spec.kind == "numeric" else 0
            )
            self._watch.append(
                (name, ftype, train_dist.value_range, n_bins)
            )

    def observe(self, records: Sequence[Mapping[str, Any]]) -> None:
        """Fold one serve batch into the running distributions.  Never
        raises: drift monitoring must not be able to take serving down
        (a mis-typed batch is the schema validator's job, not ours)."""
        if not records:
            return
        for name, ftype, value_range, n_bins in self._watch:
            try:
                if ftype.kind == "numeric":
                    vals, mask = decode_numeric(records, name)
                    col = NumericColumn(vals, mask, ftype)
                elif ftype.kind == "text":
                    col = TextColumn(decode_text(records, name), ftype)
                else:  # pragma: no cover - _watch filters to these kinds
                    col = column_from_list(
                        [r.get(name) for r in records], ftype
                    )
                dist = compute_distribution(
                    name, col,
                    n_bins=n_bins or 100,
                    value_range=value_range,
                )
            except Exception as e:  # noqa: BLE001 - monitoring only
                log.debug("drift observe skipped for %s: %s", name, e)
                continue
            with self._lock:
                prev = self._accum.get(name)
                self._accum[name] = (
                    dist if prev is None else prev.merge(dist)
                )
        with self._lock:
            self.batches_observed += 1

    def scores(self) -> dict[str, float]:
        """Per-feature JS divergence of the accumulated serve
        distribution vs the training one (0 = identical, log2 base so
        1.0 = disjoint support)."""
        out: dict[str, float] = {}
        with self._lock:
            accum = dict(self._accum)
        for name, serve_dist in accum.items():
            train = self.contract.distributions.get(name)
            if train is None:
                continue
            if len(train.histogram) != len(serve_dist.histogram):
                log.warning(
                    "drift score skipped for %s: train/serve histogram "
                    "widths differ (%d vs %d)", name,
                    len(train.histogram), len(serve_dist.histogram),
                )
                continue
            score = train.js_divergence(serve_dist)
            out[name] = round(float(score), 6)
            if (score > self.warn_threshold
                    and serve_dist.count >= self.min_warn_rows
                    and name not in self._warned):
                self._warned.add(name)
                log.warning(
                    "op_data_metrics feature %r drifted: JS divergence "
                    "%.4f vs training distribution (threshold %.2f)",
                    name, score, self.warn_threshold,
                )
        return out

    def rows_observed(self, name: str) -> int:
        with self._lock:
            d = self._accum.get(name)
            return 0 if d is None else d.count

    def reset(self) -> "DriftMonitor":
        """Drop the accumulated serve distributions: the windowed-merge
        seam.  The cumulative monoid merge above is the right
        default for a serving endpoint (one long-lived score-vs-train
        comparison), but it DILUTES late shifts: after a million
        baseline rows, a thousand drifted rows move the accumulated
        histogram - and therefore the JS score - almost nothing, so a
        continuous trainer watching the cumulative score would detect a
        mid-stream distribution change hours late or never.  A drift-triggered
        refit loop instead calls ``reset()`` at each window boundary and
        scores every window against the training contract on its own
        rows.  The warned-once latch clears too: a fresh window is a
        fresh alarm."""
        with self._lock:
            self._accum.clear()
            self._warned.clear()
            self.batches_observed = 0
        return self
