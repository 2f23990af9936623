"""SanityChecker: automated feature validation.

Counterpart of the reference SanityChecker (reference: core/.../impl/
preparators/SanityChecker.scala:59-225 params, :535-709 fit; stats via
OpStatistics, utils/.../stats/OpStatistics.scala:384).  A binary estimator
(label RealNN, features OPVector) -> OPVector that:

1. computes per-column stats (mean/var/min/max) and Pearson (or Spearman)
   correlation of every feature column with the label - on the stage's
   ``device`` as one moment sweep (``parallel.kernels.fused_moments``, the
   hand-written CUDA kernel on the card; the analog of the reference's
   Statistics.colStats/corr treeAggregate, SanityChecker.scala:575,633-637);
2. builds label-vs-category contingency tables for every categorical group
   found in the vector metadata - one one-hot matmul per fit on the device -
   and derives Cramer's V / PMI / association-rule max confidence+support
   (reference: SanityChecker.scala:440,495-496);
3. drops feature columns violating minVariance / minCorrelation /
   maxCorrelation / maxCramersV / maxRuleConfidence;
4. emits a SanityCheckerSummary into stage metadata, and the fitted model
   slices kept indices at transform time (reference: SanityChecker.scala:694-709).

With a ``data`` mesh (``parallel.mesh.data_mesh_or_none``: a process
group of two or more ranks) every moment pass takes the sharded route,
``fused_moments_sharded``: each rank sweeps its own row block of the
replicated host matrix with K1 and the ranks all-reduce the partials, so
every rank reaches the same drops.  The fitted model's column gather
lowers to numpy (``lower``) and to torch (``lower_torch``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..parallel.kernels import fused_moments, fused_moments_sharded
from ..parallel.mesh import data_mesh_or_none
from ..stages.base import Estimator, Lowering, TorchLowering, Transformer
from ..types.columns import Column, NumericColumn, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import OPVector, RealNN
from ..utils.device import resolve_device
from ..utils.stats import (
    average_ranks,
    cramers_v,
    max_rule_confidences,
    pearson_correlation,
)
from .metadata import ColumnStatistics, SanityCheckerSummary


def _f32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> contiguous float32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


class SanityCheckerModel(Transformer):
    input_types = [RealNN, OPVector]
    output_type = OPVector

    def __init__(self, indices_to_keep: Sequence[int], **kw) -> None:
        super().__init__(**kw)
        self.indices_to_keep = list(indices_to_keep)

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        vec = cols[1]
        assert isinstance(vec, VectorColumn)
        # memoize the metadata selection by input identity (see
        # VectorsCombiner: upstream metadata objects are cached, so
        # per-row serving reuses one selected metadata)
        cache = getattr(self, "_select_cache", None)
        if cache is not None and cache[0] == id(vec.metadata):
            meta = cache[1]
        else:
            meta = vec.metadata.select(self.indices_to_keep)
            self._select_cache = (id(vec.metadata), meta, vec.metadata)
        return VectorColumn(vec.values[:, self.indices_to_keep], meta)

    def lower(self):
        # input 0 is the label, consumed only at fit time: the lowered
        # transform reads the feature vector alone, so a fused program
        # never needs the label decoded at serve time
        vec_name = self.input_features[1].name
        out = self.output_name
        keep = np.asarray(self.indices_to_keep, dtype=np.intp)

        def fn(env: dict) -> dict:
            return {out: env[vec_name][:, keep]}

        return Lowering(
            fn=fn, inputs=(vec_name,), outputs=(out,),
            signature={out: f"float32[n,{len(keep)}]"},
        )

    def lower_torch(self):
        vec_name = self.input_features[1].name
        out = self.output_name
        keep = np.asarray(self.indices_to_keep, dtype=np.int64)
        on_device: dict = {}  # device -> the kept indices there

        def fn(env: dict) -> dict:
            vec = env[vec_name]
            idx = on_device.get(vec.device)
            if idx is None:
                idx = on_device[vec.device] = torch.as_tensor(
                    keep, device=vec.device)
            # column-major, as numpy's ``[:, keep]`` lays its result out:
            # a float64 head's matmul then takes the same BLAS route on
            # the CPU as the numpy program's (a row-major X sums each row
            # in another order, 16 ULP apart on a cancelling margin)
            return {out: vec.t().index_select(0, idx).t()}

        return TorchLowering(
            fn=fn, inputs=(vec_name,), outputs=(out,),
            signature={out: f"float32[n,{len(keep)}]"},
        )


class SanityChecker(Estimator):
    """Defaults mirror the reference (SanityChecker.scala:59-225)."""

    input_types = [RealNN, OPVector]
    output_type = OPVector

    def __init__(
        self,
        check_sample: float = 1.0,
        sample_upper_limit: int = 1_000_000,
        min_variance: float = 1e-5,
        min_correlation: float = 0.0,
        max_correlation: float = 0.95,
        max_cramers_v: float = 0.95,
        max_rule_confidence: float = 1.0,
        min_required_rule_support: float = 0.3,
        remove_bad_features: bool = True,
        remove_feature_group: bool = True,
        max_label_classes: int = 100,
        seed: int = 42,
        correlation_type: str = "pearson",
        correlation_exclusion: str = "none",
        device: str = "cuda",
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.device = str(device)
        if correlation_type not in ("pearson", "spearman"):
            raise ValueError(
                f"correlation_type must be 'pearson' or 'spearman', "
                f"got {correlation_type!r}"
            )
        if correlation_exclusion not in ("none", "hashed_text"):
            raise ValueError(
                f"correlation_exclusion must be 'none' or 'hashed_text', "
                f"got {correlation_exclusion!r}"
            )
        self.correlation_type = correlation_type
        self.correlation_exclusion = correlation_exclusion
        self.check_sample = check_sample
        self.sample_upper_limit = sample_upper_limit
        self.min_variance = min_variance
        self.min_correlation = min_correlation
        self.max_correlation = max_correlation
        self.max_cramers_v = max_cramers_v
        self.max_rule_confidence = max_rule_confidence
        self.min_required_rule_support = min_required_rule_support
        self.remove_bad_features = remove_bad_features
        self.remove_feature_group = remove_feature_group
        self.max_label_classes = max_label_classes
        self.seed = seed

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        label_col, vec_col = cols
        assert isinstance(label_col, NumericColumn)
        assert isinstance(vec_col, VectorColumn)
        y = np.asarray(label_col.values, dtype=np.float64)
        # the design matrix stays in its stored float32: every consumer
        # below works on float32 copies or ranks (the JAX package's
        # float64 host copy casts back to float32 all the same)
        x = np.asarray(vec_col.values)
        n, d = x.shape
        meta = vec_col.metadata
        dev = resolve_device(self.device)

        # sampling (reference: SanityChecker.scala:68-100 sample bounds)
        if self.check_sample < 1.0 or n > self.sample_upper_limit:
            rng = np.random.RandomState(self.seed)
            target = min(
                int(np.ceil(n * self.check_sample)), self.sample_upper_limit
            )
            idx = rng.choice(n, size=max(target, 1), replace=False)
            x, y = x[idx], y[idx]
            n = len(y)

        # with more than one rank the row axis splits over the 'data'
        # mesh and the partial moments all-reduce (the treeAggregate
        # analog, SanityChecker.scala:575)
        mesh = data_mesh_or_none()

        def moments_f64(a, b):
            """One dispatch policy for every moment pass of this fit:
            sharded over the data mesh when there is one, else one
            fused_moments sweep of float32 copies on the stage's device;
            f64 on the way out."""
            if mesh is not None:
                mom = fused_moments_sharded(a, b, mesh, device=dev)
            else:
                mom = fused_moments(_f32(a, dev), _f32(b, dev))
            return tuple(v.cpu().numpy().astype(np.float64) for v in mom)

        xs, xss, xys, ys, yss, xmin, xmax = moments_f64(x, y)
        mean = xs / n
        var = np.maximum(xss / n - mean**2, 0.0) * (n / max(n - 1, 1))
        if self.correlation_type == "spearman":
            # Spearman = Pearson on average ranks (reference:
            # SanityChecker.scala:633-637 CorrelationType.Spearman ->
            # Statistics.corr(..., "spearman")).  Ranks transform on host
            # under the sample cap (<= 1M rows), then the SAME moment ->
            # correlation pipeline runs on the ranked matrix.
            # Ranking is global (needs a total order over all rows), so it
            # runs on host over the SAMPLED matrix - the sample cap bounds
            # the work.
            # center/scale ranks to ~[-0.5, 0.5] before the f32 device
            # pass: correlation is affine-invariant, and raw ranks up to
            # the 1M sample cap would overflow f32 moment precision
            # (sum of squared ranks ~ n^3/3)
            xr = (average_ranks(x) - (n + 1) / 2.0) / n
            yr = (average_ranks(y) - (n + 1) / 2.0) / n
            rxs, rxss, rxys, rys, ryss, _, _ = moments_f64(xr, yr)
            corr = pearson_correlation(
                rxs, rxss, rxys, float(rys), float(ryss), float(n)
            )
        else:
            corr = pearson_correlation(
                xs, xss, xys, float(ys), float(yss), float(n)
            )

        if self.correlation_exclusion == "hashed_text":
            # hashed text dims (Text/TextArea + their maps, no grouping or
            # indicator - i.e. not pivoted by SmartTextVectorizer) carry no
            # per-column meaning: exclude them from label correlation so
            # min/max-corr dropping never fires on them (reference:
            # SanityChecker.scala:595 CorrelationExclusion.HashedText)
            _hashed_types = {"Text", "TextArea", "TextMap", "TextAreaMap"}
            excluded = [
                i for i, c in enumerate(meta.columns)
                if c.grouping is None and c.indicator_value is None
                and c.parent_feature_type in _hashed_types
            ]
            corr[excluded] = np.nan
            n_corr_excluded = len(excluded)
        else:
            n_corr_excluded = 0

        # contingency tables per categorical group
        classes = np.unique(y)
        groups = meta.grouping_indices()
        cramers: dict[tuple[str, str], float] = {}
        confidences: dict[int, tuple[float, float]] = {}
        group_of: dict[int, tuple[str, str]] = {}
        if len(classes) <= self.max_label_classes and groups:
            onehot = (y[:, None] == classes[None, :]).astype(np.float64)
            all_idx = sorted({i for idxs in groups.values() for i in idxs})
            sub = x[:, all_idx]
            # [n, L]^T @ [n, D] -> [L, D] counts for all categorical
            # indicator columns at once (the reference builds these via
            # reduceByKey shuffles, SanityChecker.scala:440)
            counts = (_f32(onehot, dev).T @ _f32(sub, dev)).cpu().numpy()
            pos = {col_i: j for j, col_i in enumerate(all_idx)}
            for gkey, idxs in groups.items():
                table = counts[:, [pos[i] for i in idxs]]
                cramers[gkey] = cramers_v(table)
                conf, support = max_rule_confidences(table)
                for i, c, s in zip(idxs, conf, support):
                    confidences[i] = (float(c), float(s))
                    group_of[i] = gkey

        # drop decisions (reference: SanityChecker.scala:640-690)
        reasons: dict[int, list[str]] = {}

        def flag(i: int, why: str) -> None:
            reasons.setdefault(i, []).append(why)

        abs_corr = np.abs(corr)
        for i in range(d):
            if var[i] < self.min_variance:
                flag(i, f"variance {var[i]:.3g} < {self.min_variance}")
            if np.isfinite(corr[i]):
                if abs_corr[i] > self.max_correlation:
                    flag(i, f"|corr| {abs_corr[i]:.3f} > {self.max_correlation}")
                elif abs_corr[i] < self.min_correlation:
                    flag(i, f"|corr| {abs_corr[i]:.3f} < {self.min_correlation}")
            cv = cramers.get(group_of.get(i)) if i in group_of else None
            if cv is not None and cv > self.max_cramers_v:
                flag(i, f"group Cramer's V {cv:.3f} > {self.max_cramers_v}")
            if i in confidences:
                conf, support = confidences[i]
                if (
                    conf > self.max_rule_confidence
                    and support > self.min_required_rule_support
                ):
                    flag(i, f"rule confidence {conf:.3f} support {support:.3f}")

        # remove whole groups when one member is flagged for group reasons
        if self.remove_feature_group:
            flagged_groups = {
                group_of[i]
                for i in reasons
                if i in group_of
                and any("Cramer" in r or "rule" in r for r in reasons[i])
            }
            for gkey, idxs in groups.items():
                if gkey in flagged_groups:
                    for i in idxs:
                        if i not in reasons:
                            flag(i, "categorical group removed")

        if self.remove_bad_features:
            keep = [i for i in range(d) if i not in reasons]
        else:
            keep = list(range(d))
        if not keep:
            raise ValueError(
                "SanityChecker dropped all features "
                "(reference guard: SanityChecker.scala:682)"
            )

        null_groups = {
            i for i, c in enumerate(meta.columns) if c.is_null_indicator
        }
        col_stats = [
            ColumnStatistics(
                name=meta.columns[i].column_name() if i < meta.size else str(i),
                pretty_name=meta.columns[i].pretty_name() if i < meta.size else str(i),
                parent=meta.columns[i].parent_feature_name if i < meta.size else "",
                mean=float(mean[i]),
                variance=float(var[i]),
                min=float(xmin[i]),
                max=float(xmax[i]),
                corr_label=float(corr[i]) if np.isfinite(corr[i]) else None,
                cramers_v=cramers.get(group_of.get(i)) if i in group_of else None,
                max_rule_confidence=confidences.get(i, (None, None))[0],
                support=confidences.get(i, (None, None))[1],
                is_null_indicator=i in null_groups,
                dropped_reasons=reasons.get(i, []),
            )
            for i in range(d)
        ]
        summary = SanityCheckerSummary(
            n_rows=int(n),
            n_features=int(d),
            n_kept=len(keep),
            column_stats=col_stats,
            dropped=[col_stats[i].name for i in sorted(reasons)],
            cramers_v_by_group={f"{p}/{g}": v for (p, g), v in cramers.items()},
        )
        model = SanityCheckerModel(keep)
        summary_json = summary.to_json()
        summary_json["correlation_excluded_columns"] = n_corr_excluded
        model.metadata = {"sanity_checker_summary": summary_json}
        self.metadata = model.metadata
        return model
