"""RecordInsightsLOCO: per-row leave-one-column-out explanations.

Counterpart of ``transmogrifai_tpu/insights/loco.py`` (reference: core/.../
impl/insights/RecordInsightsLOCO.scala:55-105, RecordInsightsCorr.scala,
RecordInsightsParser.scala): score each row with each feature column
zeroed and report the top-K score deltas.  The d zero-out passes each
rescore the whole batch through the fitted model's own ``predict_arrays``
on its device (a tree model bins every pass with kernel K2); the ranking
is the JAX package's numpy ``argsort`` on the host, so ties among equal
deltas break as numpy breaks them.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..models.base import PredictorModel
from ..stages.base import Transformer
from ..types.columns import Column, MapColumn, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import OPVector, TextMap


class RecordInsightsCorr(Transformer):
    """Correlation-based record insights (reference: core/.../impl/insights/
    RecordInsightsCorr.scala): per-row contribution of column j approximated
    as corr(feature_j, score) * standardized deviation of x_ij - one pass
    of columnar moments, no rescoring."""

    input_types = [OPVector]
    output_type = TextMap

    def __init__(self, model: PredictorModel, top_k: int = 20, **kw) -> None:
        super().__init__(**kw)
        self.model = model
        self.top_k = top_k

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (vec,) = cols
        assert isinstance(vec, VectorColumn)
        X = np.asarray(vec.values, dtype=np.float64)
        n, d = X.shape
        est, params = self.model.estimator_ref, self.model.model_params
        pred, raw, prob = est.predict_arrays(params, X)
        score = (
            prob[:, 1]
            if prob is not None and prob.shape[1] == 2
            else pred
        )
        mu = X.mean(axis=0)
        sd = X.std(axis=0) + 1e-12
        s_mu, s_sd = score.mean(), score.std() + 1e-12
        corr = ((X - mu) * (score - s_mu)[:, None]).mean(axis=0) / (sd * s_sd)
        contrib = corr[None, :] * (X - mu) / sd  # [n, d]
        names = vec.metadata.column_names() if vec.metadata.size == d else [
            str(j) for j in range(d)
        ]
        k = min(self.top_k, d)
        top_idx = np.argsort(-np.abs(contrib), axis=1)[:, :k]
        return MapColumn(
            [
                {names[j]: float(contrib[i, j]) for j in top_idx[i]}
                for i in range(n)
            ],
            TextMap,
        )


class RecordInsightsLOCO(Transformer):
    """Input: the feature vector; carries a fitted predictor model.  Output:
    per-row {column_name: delta} map of the top-K largest prediction moves.
    With ``detailed=True`` the map uses the reference's serialized format
    instead: {column-history-json: [[prediction_index, delta]] json}
    (RecordInsightsLOCO.scala + RecordInsightsParser.scala), parseable
    back to structure with :func:`parse_insights`."""

    input_types = [OPVector]
    output_type = TextMap

    def __init__(self, model: PredictorModel, top_k: int = 20,
                 detailed: bool = False, **kw) -> None:
        super().__init__(**kw)
        self.model = model
        self.top_k = top_k
        self.detailed = detailed

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (vec,) = cols
        assert isinstance(vec, VectorColumn)
        X = np.asarray(vec.values, dtype=np.float64)
        n, d = X.shape
        est, params = self.model.estimator_ref, self.model.model_params

        def score_all(Xm: np.ndarray) -> np.ndarray:
            """Full score vector per row [n, C] (class probabilities, or
            the prediction itself for regressors) - the reference's LOCO
            diffs EVERY prediction index (RecordInsightsLOCO.scala:94)."""
            pred, raw, prob = est.predict_arrays(params, Xm)
            if prob is not None and prob.shape[1] > 1:
                return np.asarray(prob)
            return np.asarray(pred)[:, None]

        base = score_all(X)                      # [n, C]
        C = base.shape[1]
        deltas = np.zeros((n, d, C))
        for j in range(d):  # d zero-out passes, each a full batched rescore
            Xj = X.copy()
            Xj[:, j] = 0.0
            deltas[:, j, :] = base - score_all(Xj)

        # scalar ranking value per (row, column): binary keeps the positive
        # class' delta (prob sums to 1, so |delta| matches class 0);
        # multiclass/regression takes the largest-|.| class diff
        if C == 2:
            scalar = deltas[:, :, 1]
        elif C == 1:
            scalar = deltas[:, :, 0]
        else:
            amax = np.argmax(np.abs(deltas), axis=2)  # [n, d]
            scalar = np.take_along_axis(
                deltas, amax[:, :, None], axis=2
            )[:, :, 0]

        names = vec.metadata.column_names() if vec.metadata.size == d else [
            str(j) for j in range(d)
        ]
        k = min(self.top_k, d)
        out = []
        # top-k by |delta| per row (the reference's bounded priority queue)
        top_idx = np.argsort(-np.abs(scalar), axis=1)[:, :k]
        if self.detailed:
            import json

            histories = (
                vec.metadata.column_history()
                if vec.metadata.size == d
                else [{"columnName": nm} for nm in names]
            )
            # serialize each column's history ONCE, not once per (row, k)
            keys = [json.dumps(h, sort_keys=True) for h in histories]
            for i in range(n):
                out.append({
                    keys[j]: json.dumps(
                        [[c, float(deltas[i, j, c])] for c in range(C)]
                    )
                    for j in top_idx[i]
                })
            return MapColumn(out, TextMap)
        for i in range(n):
            out.append(
                {names[j]: float(scalar[i, j]) for j in top_idx[i]}
            )
        return MapColumn(out, TextMap)


# -- RecordInsightsParser -----------------------------------------------------
# (reference: core/.../impl/insights/RecordInsightsParser.scala - converts
# the record-insight TextMap {column-history-json: [[idx, score]...]} to and
# from structured form so downstream consumers can parse per-column
# provenance together with the score deltas)
def insights_to_text_map(
    insights: Sequence[tuple[dict, Sequence[tuple[int, float]]]],
) -> dict:
    """[(column_history, [(prediction_index, delta), ...]), ...] -> the
    serialized {history_json: scores_json} map of one record's insights."""
    import json

    out = {}
    for history, scores in insights:
        key = json.dumps(history, sort_keys=True)
        out[key] = json.dumps([[int(i), float(s)] for i, s in scores])
    return out


def parse_insights(
    text_map: dict,
) -> list[tuple[dict, list[tuple[int, float]]]]:
    """Inverse of insights_to_text_map: the record-insight TextMap back to
    [(column_history, [(prediction_index, delta), ...])]."""
    import json

    out = []
    for key, val in text_map.items():
        history = json.loads(key)
        scores = [(int(i), float(s)) for i, s in json.loads(val)]
        out.append((history, scores))
    return out
