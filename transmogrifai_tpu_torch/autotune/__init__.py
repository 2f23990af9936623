"""transmogrifai_tpu_torch.autotune: cost-model-driven autotuning.

Host copy of ``transmogrifai_tpu/autotune/``: the system learning its own
configuration, in three coupled pieces:

* :mod:`~transmogrifai_tpu_torch.autotune.cost_model` - a small featurized
  regressor (family one-hot by workload key, data shape, hyperparam
  and knob values -> predicted wall time) trained ONLINE from the
  obs plane (tagged ``cv.fit*`` spans, ``serve.batch`` spans,
  probe measurements) and persisted as a versioned JSON artifact next
  to the model (``autotune.json``).
* :mod:`~transmogrifai_tpu_torch.autotune.pruning` - successive-halving
  decisions for the model-selector grid: the go/no-go call (cost-model
  predicted savings, cold-start degrade-to-exhaustive), survivor
  selection from rung interim scores with original-index tie-breaks,
  and the decision-trail report.  Execution stays in
  ``selector/validator.py``; this module only decides.
* :mod:`~transmogrifai_tpu_torch.autotune.knobs` - serving/pipeline knob
  proposals from obs snapshots plus measured A/B probes that only
  dethrone a hand-set default when the candidate beats it by a margin.

Style gate (tests/test_torch_style.py): this package reads observations only
through public obs registry / profiler / tracer APIs - no private
attribute of any telemetry object is touched.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .cost_model import (
    COST_MODEL_VERSION,
    CostModel,
    candidate_features,
    key_for_fit,
    params_hash,
)
from .knobs import (
    KnobDecision,
    KnobTuner,
    microbatch_candidates,
    propose_bucket_edges,
    propose_pipeline_knobs,
)
from .pruning import (
    AutotuneConfig,
    CandidateInfo,
    PruningPlan,
    fit_budget,
    plan_pruning,
    select_survivors,
)

__all__ = [
    "AutotuneConfig",
    "COST_MODEL_VERSION",
    "CandidateInfo",
    "CostModel",
    "KnobDecision",
    "KnobTuner",
    "PruningPlan",
    "candidate_features",
    "fit_budget",
    "key_for_fit",
    "microbatch_candidates",
    "params_hash",
    "plan_pruning",
    "propose_bucket_edges",
    "propose_pipeline_knobs",
    "report_from_path",
    "select_survivors",
]

COST_MODEL_FILENAME = "autotune.json"


def report_from_path(path: str) -> dict:
    """The ``tx autotune report`` document for ``path``, which may be

    * a MODEL directory (``summary.json`` + ``autotune.json`` written
      by a ``train`` run with the ``autotune`` knob) - reports the
      selection decision trail and the persisted cost model; or
    * an OBS EXPORT directory (the runner's ``metrics_path`` knob:
      ``metrics.json`` + ``spans.jsonl``) - reports the autotune
      series scraped from the metrics document and the tagged
      ``cv.fit*`` / ``autotune.*`` spans; or
    * a fleet AGGREGATION directory (per-process ``*.obsshard.json``
      from the obs shippers) - reports every live
      replica's autotune series and tuner-owned serving knobs in one
      document, the fleet-wide view of who tuned what.

    Raises ``ValueError`` when the path holds neither shape."""
    out: dict = {"path": path}
    agg_report = _report_from_agg_dir(path)
    if agg_report is not None:
        out.update(agg_report)
        return out
    summary_p = os.path.join(path, "summary.json")
    model_p = os.path.join(path, COST_MODEL_FILENAME)
    metrics_p = os.path.join(path, "metrics.json")
    found = False
    if os.path.exists(summary_p):
        with open(summary_p) as f:
            summary = json.load(f)
        selections = []
        for st in summary.get("stages", []):
            md = (st.get("metadata") or {}).get(
                "model_selector_summary") or {}
            if (md.get("autotune") is not None
                    or md.get("train_fused") is not None):
                selections.append({
                    "stage_uid": st.get("uid"),
                    "best_model_type": md.get("best_model_type"),
                    "best_params": md.get("best_params"),
                    "autotune": md.get("autotune"),
                    # whether each family dispatch
                    # ran fused / AOT-loaded / retraced
                    "train_fused": md.get("train_fused"),
                })
        out["selection"] = selections
        if summary.get("autotune") is not None:
            out["run"] = summary["autotune"]
        if summary.get("train_fused") is not None:
            out["train_fused"] = summary["train_fused"]
        found = True
    if os.path.exists(model_p):
        out["cost_model"] = CostModel.load(model_p).snapshot()
        found = True
    if os.path.exists(metrics_p) and not found:
        with open(metrics_p) as f:
            doc = json.load(f)
        series = {
            name: s for name, s in (doc.get("series") or {}).items()
            if name.startswith("autotune.")
        }
        out["series"] = series
        spans_p = os.path.join(path, "spans.jsonl")
        if os.path.exists(spans_p):
            from ..obs import read_jsonl_tolerant

            records, skipped = read_jsonl_tolerant(spans_p)
            fit_spans = [
                r for r in records
                if str(r.get("name", "")).startswith(
                    ("cv.fit", "autotune."))
            ]
            out["spans"] = {
                "fit_spans": len(fit_spans),
                "lines_skipped": skipped,
                "by_name": _count_by(fit_spans, "name"),
            }
        found = True
    if not found:
        raise ValueError(
            f"{path!r} holds neither a model directory (summary.json/"
            f"{COST_MODEL_FILENAME}) nor an obs export (metrics.json)"
        )
    return out


def _report_from_agg_dir(path: str) -> Optional[dict]:
    """Fleet-aggregation-dir half of :func:`report_from_path`: None when ``path`` is not an aggregation dir, else
    per-live-replica autotune series (``autotune.*`` native series),
    tuner-owned serving knobs (``tuned_knobs``/``knob_source`` from
    every serving view), and the shard membership report.  Reads ride
    the torn-safe aggregator - a replica SIGKILLed mid-ship costs its
    freshness, never this report."""
    from ..obs.fleet import SHARD_SUFFIX, FleetAggregator, serving_views

    if not os.path.isdir(path):
        return None
    try:
        has_shards = any(n.endswith(SHARD_SUFFIX)
                         for n in os.listdir(path))
    except OSError:
        return None
    if not has_shards:
        return None
    agg = FleetAggregator(path)
    replicas: dict = {}
    for shard in agg.shards():
        inst = str(shard.get("instance"))
        metrics = shard.get("metrics") or {}
        series = {
            name: s for name, s in (metrics.get("series") or {}).items()
            if str(name).startswith("autotune.")
        }
        knobs: dict = {}
        for key, snap in serving_views(metrics):
            tk = snap.get("tuned_knobs")
            if tk:
                knobs[key] = {
                    "knob_source": snap.get("knob_source"),
                    "tuned_knobs": dict(tk),
                    "model_version": snap.get("model_version"),
                }
        replicas[inst] = {"series": series, "serving_knobs": knobs}
    return {"fleet": dict(agg.last_report), "replicas": replicas}


def _count_by(records: list, key: str) -> dict:
    out: dict = {}
    for r in records:
        k = str(r.get(key))
        out[k] = out.get(k, 0) + 1
    return out
