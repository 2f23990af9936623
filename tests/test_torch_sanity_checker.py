"""SanityChecker in the torch package against the JAX package's.

The same design matrix, with a constant column, a label-leaking column
and two categorical groups (one of them a label proxy), goes through both
packages' SanityChecker.  The kept indices must be identical.  Means,
variances and label correlations agree within rtol 1e-5, atol 1e-6: both
sum in float32, but in different orders (the JAX package's test runs
shard the sweep over the 8-device CPU mesh).  Min/max are exact.
"""
import numpy as np
import pytest

from torch_parity import PORT, REF, mod, reset_uids

N = 2000


def _inputs(seed: int = 11):
    rng = np.random.RandomState(seed)
    y = (rng.rand(N) < 0.4).astype(np.float64)
    cont = rng.randn(N, 4) * 3.0 + 1.0
    cont[:, 1] += 0.8 * y  # informative, kept
    const = np.full((N, 1), 2.5)  # variance 0: dropped
    leak = (y + 0.05 * rng.randn(N))[:, None]  # |corr| > 0.95: dropped
    cat = np.eye(3)[rng.randint(0, 3, N)]  # unrelated group: kept
    proxy = np.stack([y, 1.0 - y], axis=1)  # Cramer's V = 1: dropped
    x = np.concatenate([cont, const, leak, cat, proxy], axis=1)
    return x.astype(np.float32), y


def _metas(pkg: str):
    vm = mod(pkg, "types.vector_metadata")
    metas = [vm.VectorColumnMeta(f"c{j}", "Real") for j in range(4)]
    metas += [vm.VectorColumnMeta("const", "Real"),
              vm.VectorColumnMeta("leak", "Real")]
    metas += [vm.VectorColumnMeta("cat", "PickList", grouping="cat",
                                  indicator_value=v) for v in "abc"]
    metas += [vm.VectorColumnMeta("proxy", "PickList", grouping="proxy",
                                  indicator_value=v) for v in ("yes", "no")]
    return vm.VectorMetadata("features", tuple(metas)).reindexed()


def _fit(pkg: str, correlation_type: str):
    reset_uids(pkg)
    x, y = _inputs()
    cols = mod(pkg, "types.columns")
    ft = mod(pkg, "types.feature_types")
    label = cols.NumericColumn(y, np.ones(N, bool), ft.RealNN)
    vec = cols.VectorColumn(x, _metas(pkg))
    kw = {"device": "cpu"} if pkg == PORT else {}
    checker = mod(pkg, "preparators.sanity_checker").SanityChecker(
        correlation_type=correlation_type, **kw
    )
    model = checker.fit_model([label, vec], None)
    return model.indices_to_keep, model.metadata["sanity_checker_summary"]


@pytest.mark.parametrize("correlation_type", ["pearson", "spearman"])
def test_sanity_checker_matches_reference(correlation_type):
    keep_ref, sum_ref = _fit(REF, correlation_type)
    keep_port, sum_port = _fit(PORT, correlation_type)
    assert keep_port == keep_ref
    # the planted drops fire: const (4), the proxy group (9, 10) and, by
    # Pearson, leak (5) - the rank correlation of any column with a binary
    # label stays below 0.95, so Spearman keeps it
    leak = [] if correlation_type == "pearson" else [5]
    assert keep_port == [0, 1, 2, 3] + leak + [6, 7, 8]
    assert sum_port["dropped"] == sum_ref["dropped"]
    for a, b in zip(sum_port["column_stats"], sum_ref["column_stats"]):
        assert a["name"] == b["name"]
        assert a["dropped_reasons"] == b["dropped_reasons"]
        for k in ("mean", "variance"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)
        assert a["min"] == b["min"] and a["max"] == b["max"]
        if b["corr_label"] is None:
            assert a["corr_label"] is None
        else:
            np.testing.assert_allclose(
                a["corr_label"], b["corr_label"], rtol=1e-5, atol=1e-6
            )
        for k in ("cramers_v", "max_rule_confidence", "support"):
            if b[k] is None:
                assert a[k] is None
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-12)


def test_sanity_checker_sampling_matches_reference():
    """Above sample_upper_limit both packages draw the same numpy sample."""
    x, y = _inputs(seed=3)
    outs = []
    for pkg in (REF, PORT):
        reset_uids(pkg)
        cols = mod(pkg, "types.columns")
        ft = mod(pkg, "types.feature_types")
        kw = {"device": "cpu"} if pkg == PORT else {}
        checker = mod(pkg, "preparators.sanity_checker").SanityChecker(
            sample_upper_limit=500, **kw
        )
        model = checker.fit_model(
            [cols.NumericColumn(y, np.ones(N, bool), ft.RealNN),
             cols.VectorColumn(x, _metas(pkg))], None,
        )
        summary = model.metadata["sanity_checker_summary"]
        outs.append((model.indices_to_keep, summary["n_rows"],
                     [c["mean"] for c in summary["column_stats"]]))
    (k_ref, n_ref, m_ref), (k_port, n_port, m_port) = outs
    assert k_port == k_ref and n_port == n_ref == 500
    np.testing.assert_allclose(m_port, m_ref, rtol=1e-5, atol=1e-6)
