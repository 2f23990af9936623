"""Signal-driven canary rollback policy.

The closed-loop half of the registry (reference frame: TF-Serving
advances servable versions only while health checks hold; this engine
already EMITS every needed health signal — breaker transitions and
NaN-guard hits from serving/admission.py + endpoint.py, per-feature JS
drift from schema/drift.py, latency percentiles from
serving/telemetry.py — and the policy here is what finally reads them):
a :class:`RollbackPolicy` compares the canary generation's live
``ServingTelemetry`` snapshot against the stable generation's and
returns a :class:`RollbackDecision` naming every breached signal with
its value, threshold, and the evidence snapshots.

Signal classes:

* **hard** — breaker opens and NaN/Inf-guard refusals on the canary.
  These indicate a broken model/kernel, not statistical noise, so they
  trip IMMEDIATELY regardless of sample size.
* **soft** — p99 latency ratio vs stable, per-feature JS drift, and the
  failed-row ratio.  These are distributions, so they only trip after
  ``min_canary_rows`` rows have scored on the canary (a 4-row sample
  "drifts" from pure noise; a latched false rollback is worse than a
  slightly later true one — the DriftMonitor warn gate's reasoning).

Host copy of ``transmogrifai_tpu/registry/rollback.py``.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Optional

log = logging.getLogger("transmogrifai_tpu_torch.registry")


@dataclass
class RollbackDecision:
    """One policy evaluation: breached signals + the evidence behind
    them (recorded verbatim in the registry lineage and the controller's
    ``summary_json()`` when the rollback fires)."""

    rollback: bool
    reasons: list = field(default_factory=list)
    evidence: dict = field(default_factory=dict)
    checked_at: float = field(default_factory=time.time)

    def to_json(self) -> dict:
        return {
            "rollback": self.rollback,
            "reasons": [dict(r) for r in self.reasons],
            "evidence": dict(self.evidence),
            "checked_at": self.checked_at,
        }


def _evidence_subset(snap: dict) -> dict:
    """The slice of a ServingTelemetry snapshot a rollback decision
    cites (full snapshots are big; evidence must stay readable in the
    lineage log)."""
    return {
        "rows_scored": snap.get("rows_scored"),
        "rows_failed": snap.get("rows_failed"),
        "latency_ms": snap.get("latency_ms"),
        "breaker": snap.get("breaker"),
        "drift_js_max": snap.get("data_contract", {}).get("drift_js_max"),
        "model_version": snap.get("model_version"),
        "generation": snap.get("generation"),
    }


@dataclass
class RollbackPolicy:
    """SLO thresholds for automatic canary demotion.

    ``max_breaker_opens`` / ``max_nonfinite_rows`` are hard limits (a
    single excess trips regardless of traffic volume); the latency
    ratio, drift, and failure-ratio limits wait for ``min_canary_rows``
    canary rows.  Any limit set to ``None`` disables that signal.

    ``slo_engine`` plugs the declarative obs-plane SLOs in as a third
    signal class: an :class:`~transmogrifai_tpu_torch.obs.slo.SLOEngine`
    attached here is re-observed at every evaluation and any
    FIRING burn-rate alert becomes a hard rollback reason
    (``slo:<name>``) - a fleet-level objective breach demotes the
    canary even when the canary's own telemetry looks clean (e.g. the
    aggregate error budget is burning because of the traffic the canary
    sheds onto stable).  The runner's ``slo_path`` knob wires this.
    """

    min_canary_rows: int = 64
    max_breaker_opens: Optional[int] = 0
    max_nonfinite_rows: Optional[int] = 0
    max_latency_ratio: Optional[float] = 3.0
    max_drift_js: Optional[float] = 0.25
    max_failed_ratio: Optional[float] = 0.2
    slo_engine: Optional[Any] = None

    def _slo_reasons(self) -> list[dict]:
        """Firing SLO alerts as hard signals; a broken engine is
        logged, never allowed to block (or force) a rollback check."""
        if self.slo_engine is None:
            return []
        try:
            self.slo_engine.observe()
            alerts = self.slo_engine.firing()
        except Exception as e:  # noqa: BLE001 - visible, non-fatal
            log.warning("rollback policy: SLO engine failed: %s", e)
            return []
        return [
            {
                "signal": "slo:" + str(a.get("name")),
                "value": a.get("burn_short"),
                "threshold": a.get("burn_threshold"),
            }
            for a in alerts
        ]

    def evaluate(self, stable_snap: dict,
                 canary_snap: dict) -> RollbackDecision:
        """Compare live canary signals against stable; breaches become
        ``reasons`` entries of ``{signal, value, threshold}``."""
        reasons: list[dict] = list(self._slo_reasons())
        c_breaker = canary_snap.get("breaker", {})
        if (self.max_breaker_opens is not None
                and c_breaker.get("opens", 0) > self.max_breaker_opens):
            reasons.append({
                "signal": "breaker_opens",
                "value": c_breaker.get("opens", 0),
                "threshold": self.max_breaker_opens,
            })
        if (self.max_nonfinite_rows is not None
                and c_breaker.get("rows_nonfinite", 0)
                > self.max_nonfinite_rows):
            reasons.append({
                "signal": "nonfinite_rows",
                "value": c_breaker.get("rows_nonfinite", 0),
                "threshold": self.max_nonfinite_rows,
            })
        c_rows = (canary_snap.get("rows_scored", 0)
                  + canary_snap.get("rows_failed", 0))
        if c_rows >= self.min_canary_rows:
            s_p99 = (stable_snap.get("latency_ms") or {}).get("p99")
            c_p99 = (canary_snap.get("latency_ms") or {}).get("p99")
            if (self.max_latency_ratio is not None
                    and s_p99 and c_p99 and s_p99 > 0
                    and c_p99 / s_p99 > self.max_latency_ratio):
                reasons.append({
                    "signal": "p99_latency_ratio",
                    "value": round(c_p99 / s_p99, 3),
                    "threshold": self.max_latency_ratio,
                })
            drift = canary_snap.get(
                "data_contract", {}).get("drift_js_max", 0.0)
            if (self.max_drift_js is not None and drift is not None
                    and drift > self.max_drift_js):
                reasons.append({
                    "signal": "drift_js_max",
                    "value": drift,
                    "threshold": self.max_drift_js,
                })
            if (self.max_failed_ratio is not None
                    and canary_snap.get("rows_failed", 0) / c_rows
                    > self.max_failed_ratio):
                reasons.append({
                    "signal": "failed_ratio",
                    "value": round(
                        canary_snap.get("rows_failed", 0) / c_rows, 4),
                    "threshold": self.max_failed_ratio,
                })
        evidence = {
            "stable": _evidence_subset(stable_snap),
            "canary": _evidence_subset(canary_snap),
        }
        if self.slo_engine is not None:
            try:
                slo_rep = self.slo_engine.report()
                evidence["slo"] = {
                    "firing": slo_rep.get("firing"),
                    "objectives": slo_rep.get("objectives"),
                }
            except Exception as e:  # noqa: BLE001 - evidence only
                log.warning(
                    "rollback policy: SLO report failed: %s", e)
        return RollbackDecision(
            rollback=bool(reasons),
            reasons=reasons,
            evidence=evidence,
        )
