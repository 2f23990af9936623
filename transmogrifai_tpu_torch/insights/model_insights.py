"""ModelInsights: aggregate post-train knowledge into one report.

Counterpart of ``transmogrifai_tpu/insights/model_insights.py`` and of the
reference ModelInsights (reference: core/.../
ModelInsights.scala:72-99,435-525 + prettyPrint): walks the fitted stages
for the last SanityChecker and ModelSelector, joins their summary metadata
with vector-column provenance, and renders the README-style tables
(selected model params, metrics, top positive/negative correlations).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


def _fmt_table(rows: list[tuple], headers: tuple) -> str:
    """ASCII table in the reference's summaryPretty style (reference:
    utils/.../text/Table.scala)."""
    cols = [headers] + [tuple(str(c) for c in r) for r in rows]
    widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]

    def line() -> str:
        return "|" + "|".join("-" * (w + 2) for w in widths) + "|"

    def row(r) -> str:
        return "| " + " | ".join(str(c).rjust(w) for c, w in zip(r, widths)) + " |"

    out = [line(), row(headers), line()]
    out += [row(r) for r in rows]
    out.append(line())
    return "\n".join(out)


@dataclass
class FeatureInsight:
    name: str
    pretty_name: str
    parent: str
    corr_label: Optional[float]
    cramers_v: Optional[float]
    variance: Optional[float]
    mean: Optional[float]
    contribution: Optional[float]
    dropped_reasons: list = field(default_factory=list)

    def to_json(self) -> dict:
        return dict(self.__dict__)


@dataclass
class ModelInsights:
    selected_model_type: Optional[str]
    best_params: dict
    validation_metric: dict
    validation_results: list
    train_metrics: dict
    holdout_metrics: dict
    feature_insights: list[FeatureInsight]
    splitter_summary: dict
    n_rows: int
    # reference parity (ModelInsights.scala:72-79): the label's own
    # summary + every stage's settings keyed by uid
    label_summary: dict = field(default_factory=dict)
    stage_info: dict = field(default_factory=dict)

    @staticmethod
    def _label_summary(model) -> dict:
        """Label name, lineage, sample size and distribution (reference
        LabelSummary + Continuous/Discrete, ModelInsights.scala:291-323).
        Distribution is computed from the model's stored input dataset by
        replaying the fitted DAG up to the prediction - a one-off cost at
        insights time, not retained training state."""
        import numpy as np

        label_f = None
        for f in getattr(model, "result_features", ()):
            st = f.origin_stage
            ins = getattr(st, "input_features", ()) if st else ()
            if len(ins) >= 2 and ins[0].is_response:
                label_f = ins[0]
                break
        if label_f is None:
            return {}
        hist = label_f.history()
        out = {
            "label_name": label_f.name,
            "raw_feature_names": hist["originFeatures"],
            "stages_applied": hist["stages"],
        }
        # the training cache holds the fully-transformed columns - the
        # label included.  A model restored via load_model has no cache
        # (and no data to replay), so the distribution is honestly
        # unavailable there rather than recomputed from nothing.
        ds = getattr(model, "_train_data_cache", None)
        if ds is None:
            out["distribution_unavailable"] = (
                "no training cache (loaded model): label stats are "
                "computed from the fit-time data"
            )
            return out
        try:
            col = ds.columns().get(label_f.name)
            vals = np.asarray(
                [v for v in col.to_list() if v is not None], dtype=float
            )
            out["sample_size"] = int(len(vals))
            uniq, cnts = np.unique(vals, return_counts=True)
            if len(uniq) <= 30:
                out["distribution"] = {
                    "type": "discrete",
                    "domain": [str(u) for u in uniq],
                    "prob": (cnts / max(len(vals), 1)).tolist(),
                }
            else:
                out["distribution"] = {
                    "type": "continuous",
                    "min": float(vals.min()),
                    "max": float(vals.max()),
                    "mean": float(vals.mean()),
                    "variance": float(vals.var(ddof=1)),
                }
        except Exception as e:
            out["distribution_error"] = f"{type(e).__name__}: {e}"
        return out

    @staticmethod
    def _stage_info(model) -> dict:
        """Every fitted stage's settings keyed by uid (reference
        ModelInsights stageInfo map); params scrub to JSON-safe strings
        so exotic values never break the report."""
        def safe(v):
            if isinstance(v, (bool, int, float, str, type(None))):
                return v
            if isinstance(v, (list, tuple)) and len(v) <= 32:
                return [safe(x) for x in v]
            if (
                isinstance(v, dict)
                and len(v) <= 32
                and all(isinstance(k, str) for k in v)
            ):
                return {k: safe(x) for k, x in v.items()}
            return str(v)[:200]

        info = {}
        for s in getattr(model, "stages", ()):
            # fitted predictor wrappers report their estimator's type
            # (PredictorModel alone says nothing about WHICH model)
            cls = (
                getattr(s, "model_type", None)
                or getattr(
                    getattr(s, "estimator_ref", None), "model_type", None
                )
                or type(s).__name__
            )
            params = getattr(s, "params", None) or getattr(
                getattr(s, "estimator_ref", None), "params", None
            ) or {}
            info[s.uid] = {
                "class": cls,
                "inputs": [f.name for f in getattr(s, "input_features", ())],
                "params": {k: safe(v) for k, v in params.items()},
            }
        return info

    @staticmethod
    def from_model(model, feature=None) -> "ModelInsights":
        """Walk fitted stages (reference: ModelInsights.scala:435-525)."""
        sc_summary = None
        ms_summary = None
        contributions = None
        for s in model.stages:
            if "sanity_checker_summary" in s.metadata:
                sc_summary = s.metadata["sanity_checker_summary"]
            if "model_selector_summary" in s.metadata:
                ms_summary = s.metadata["model_selector_summary"]
                if hasattr(s, "feature_contributions"):
                    contributions = s.feature_contributions()
            elif hasattr(s, "feature_contributions") and contributions is None:
                contributions = s.feature_contributions()

        insights: list[FeatureInsight] = []
        if sc_summary is not None:
            kept_i = 0
            for c in sc_summary["column_stats"]:
                contrib = None
                if contributions is not None and not c["dropped_reasons"]:
                    if kept_i < len(contributions):
                        contrib = float(contributions[kept_i])
                    kept_i += 1
                insights.append(
                    FeatureInsight(
                        name=c["name"],
                        pretty_name=c["pretty_name"],
                        parent=c["parent"],
                        corr_label=c["corr_label"],
                        cramers_v=c["cramers_v"],
                        variance=c["variance"],
                        mean=c["mean"],
                        contribution=contrib,
                        dropped_reasons=c["dropped_reasons"],
                    )
                )

        ms = ms_summary or {}
        return ModelInsights(
            selected_model_type=ms.get("best_model_type"),
            best_params=ms.get("best_params", {}),
            validation_metric=ms.get("validation_metric", {}),
            validation_results=ms.get("validation_results", []),
            train_metrics=ms.get("train_metrics", {}),
            holdout_metrics=ms.get("holdout_metrics", {}),
            feature_insights=insights,
            splitter_summary=ms.get("splitter_summary", {}),
            n_rows=ms.get("n_rows", 0),
            label_summary=ModelInsights._label_summary(model),
            stage_info=ModelInsights._stage_info(model),
        )

    def to_json(self) -> dict:
        return {
            "selected_model_type": self.selected_model_type,
            "best_params": self.best_params,
            "validation_metric": self.validation_metric,
            "validation_results": self.validation_results,
            "train_metrics": self.train_metrics,
            "holdout_metrics": self.holdout_metrics,
            "feature_insights": [f.to_json() for f in self.feature_insights],
            "splitter_summary": self.splitter_summary,
            "n_rows": self.n_rows,
            "label_summary": self.label_summary,
            "stage_info": self.stage_info,
        }

    def json(self) -> str:
        return json.dumps(self.to_json(), indent=2, default=str)

    def pretty(self, top_k: int = 15) -> str:
        """README-style summary (reference: ModelInsights.prettyPrint +
        README.md:59-107)."""
        out = []
        if self.validation_results:
            by_type: dict[str, list[float]] = {}
            for r in self.validation_results:
                by_type.setdefault(r["model_type"], []).append(r["metric"])
            name = self.validation_metric.get("name", "metric")
            counts = ", ".join(f"{len(v)} {k}" for k, v in by_type.items())
            out.append(f"Evaluated {counts} models with {name} metric.")
            for k, v in by_type.items():
                out.append(
                    f"Evaluated {len(v)} {k} models with {name} between "
                    f"[{min(v):.6g}, {max(v):.6g}]"
                )
            out.append("")
        if self.selected_model_type:
            rows = [("modelType", self.selected_model_type)] + sorted(
                (k, v) for k, v in self.best_params.items()
            )
            out.append(f"Selected model {self.selected_model_type} with parameters:")
            out.append(_fmt_table(rows, ("Model Param", "Value")))
            out.append("")
        if self.train_metrics or self.holdout_metrics:
            tm = next(iter(self.train_metrics.values()), {})
            hm = next(iter(self.holdout_metrics.values()), {})
            keys = [k for k in tm if isinstance(tm.get(k), (int, float))]
            rows = [
                (k, f"{hm.get(k, float('nan')):.6g}" if k in hm else "-",
                 f"{tm[k]:.6g}")
                for k in keys
            ]
            out.append("Model evaluation metrics:")
            out.append(
                _fmt_table(
                    rows, ("Metric Name", "Hold Out Set Value", "Training Set Value")
                )
            )
            out.append("")
        corr_feats = [
            f for f in self.feature_insights
            if f.corr_label is not None and not f.dropped_reasons
            and np.isfinite(f.corr_label)
        ]
        if corr_feats:
            pos = sorted(corr_feats, key=lambda f: -f.corr_label)[:3]
            neg = sorted(corr_feats, key=lambda f: f.corr_label)[:3]
            out.append("Top model insights computed using correlation:")
            out.append(
                _fmt_table(
                    [(f.pretty_name, f"{f.corr_label:.6g}") for f in pos],
                    ("Top Positive Insights", "Correlation"),
                )
            )
            out.append(
                _fmt_table(
                    [(f.pretty_name, f"{f.corr_label:.6g}") for f in neg],
                    ("Top Negative Insights", "Correlation"),
                )
            )
        return "\n".join(out)
