"""Random forests with per-node feature subsets: the torch package against
the JAX package's (``backend="jax"``, single device).

* ``fit_tree`` with a node subset mask against the reference's
  ``fit_tree(rng_key=..., feature_subset_p=...)``;
* ``OpRandomForestClassifier()`` at its defaults (``"auto"``: sqrt(d)/d of
  the features) and ``OpRandomForestRegressor()`` (``"auto"``: 1/3), and
  the other strategies: the same edges, node masks bit-equal to
  ``jax.random.bernoulli(fold_in(PRNGKey(seed), level), float32(p),
  (2^l, d))`` of the reference's seeds;
* ``fit_arrays_folds`` and ``fit_arrays_folds_grid``, each fold also equal
  to a one-fold fit of the port, exactly.

Tolerances: heaps compared by ``torch_parity.compare_trees`` (structure
node by node but for exact ties, ROADMAP.md queue 3; gini counts exact,
variance channels within rtol 1e-4, atol 1e-5); probabilities and
predictions within 1e-5 on every row that no tie touches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, compare_trees, mod

N, D = 1000, 9


def _data(classification: bool, seed: int = 0):
    """Nine columns of the selector's width: six continuous, two of a few
    values and one binary (no complementary pair, whose splits always tie)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    X[:, 6] = np.round(rng.rand(N) * 4)
    X[:, 7] = np.round(rng.rand(N) * 2)
    X[:, 8] = rng.rand(N) < 0.3
    z = (X[:, 0] - 0.7 * X[:, 1] + 0.8 * X[:, 8] + 0.3 * X[:, 6] * X[:, 2]
         + 0.4 * X[:, 7])
    if classification:
        return X, (z + 0.5 * rng.randn(N) > 0.2).astype(np.float64)
    return X, z + 0.3 * rng.randn(N)


def _pair(cls_name: str, **kw):
    trees = [mod(pkg, "models.trees") for pkg in (REF, PORT)]
    return (getattr(trees[0], cls_name)(backend="jax", **kw),
            getattr(trees[1], cls_name)(device="cpu", **kw))


def _ref_masks(seed_ints, p: float, depth: int, d: int) -> np.ndarray:
    """The reference's per-node masks, drawn by jax.random as its fit_tree
    draws them: [T, 2^depth - 1, d]."""
    out = []
    for s in seed_ints:
        key = jax.random.PRNGKey(int(s))
        out.append(np.concatenate([
            np.asarray(jax.random.bernoulli(
                jax.random.fold_in(key, level), jnp.float32(p), (2**level, d)))
            for level in range(depth)]))
    return np.stack(out)


def _compare_forest(got, want, X, classification: bool):
    """Heaps tree by tree (compare_trees); returns (tie count, the rows a
    tie touches)."""
    np.testing.assert_array_equal(got["edges"], want["edges"])
    assert got["max_depth"] == want["max_depth"]
    if classification:
        np.testing.assert_array_equal(got["classes"], want["classes"])
    assert [h.dtype for h in got["heaps"]] == \
        [np.asarray(h).dtype for h in want["heaps"]]
    bins = mod(REF, "models.tree_kernel").bin_data(
        X.astype(np.float32), want["edges"])
    tol = dict(rtol=0, atol=0) if classification else dict(rtol=1e-4, atol=1e-5)
    ties, rows = 0, np.zeros(len(X), bool)
    for t in range(np.asarray(want["heaps"][0]).shape[0]):
        tie_nodes, tie_rows = compare_trees(
            [h[t] for h in got["heaps"]],
            [np.asarray(h[t]) for h in want["heaps"]],
            bins, want["max_depth"], **tol)
        ties += len(tie_nodes)
        rows |= tie_rows
    return ties, rows


def _compare_predictions(ref, port, got, want, X, rows, classification):
    k = 2 if classification else 0
    out_w = np.asarray(ref.predict_arrays(want, X)[k])
    out_g = port.predict_arrays(got, X)[k]
    ok = ~rows
    np.testing.assert_allclose(out_g[ok], out_w[ok], rtol=0, atol=1e-5)
    return ok.mean()


def test_fit_tree_with_node_masks_matches_reference():
    """One tree grown by each package's fit_tree on the same bins, stats
    and weights, the reference drawing its masks from ``rng_key``."""
    ref_tk, port_tk = mod(REF, "models.tree_kernel"), mod(PORT, "models.tree_kernel")
    X, y = _data(True, seed=1)
    edges = ref_tk.quantile_bin_edges(X.astype(np.float32), 32)
    bins = ref_tk.bin_data(X.astype(np.float32), edges)
    stats = np.stack([np.ones(N), 1.0 - y, y], axis=1).astype(np.float32)
    w = np.random.RandomState(2).poisson(1.0, N).astype(np.float32)
    depth, p, seed = 6, np.float32(np.sqrt(D) / D), 987654321
    want = ref_tk.fit_tree(
        jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(w),
        jnp.ones(D, bool), max_depth=depth, max_bins=32,
        impurity_kind="gini", n_stats=3, min_instances_per_node=5.0,
        min_info_gain=0.001, rng_key=jax.random.PRNGKey(seed),
        feature_subset_p=float(p))
    masks = port_tk.node_subset_masks([seed], p, depth, D)
    np.testing.assert_array_equal(masks, _ref_masks([seed], p, depth, D))
    got = port_tk.fit_tree(
        torch.as_tensor(bins), torch.as_tensor(stats), torch.as_tensor(w),
        torch.ones(D, dtype=torch.bool), depth, 32, "gini", 3, 5.0, 0.001,
        node_mask=torch.as_tensor(masks[0]))
    ties, rows = compare_trees([h.numpy() for h in got],
                               [np.asarray(h) for h in want], bins, depth)
    assert rows.mean() < 0.1, ties
    # the masks bind: the root may split only on a feature its row keeps
    root = int(got[0][0])
    assert masks[0, 0, root] and not masks[0, 0].all()


def test_no_masks_when_every_feature_is_kept():
    tk = mod(PORT, "models.tree_kernel")
    assert tk.node_subset_masks([1, 2], 1.0, 4, D) is None
    assert tk.node_subset_masks([1, 2], 0.5, 4, D).shape == (2, 15, D)


@pytest.mark.parametrize("cls_name,classification,kw", [
    ("OpRandomForestClassifier", True, {}),
    ("OpRandomForestRegressor", False, {}),
    ("OpRandomForestClassifier", True,
     dict(num_trees=8, max_depth=6, feature_subset_strategy="onethird",
          min_instances_per_node=5)),
    ("OpRandomForestRegressor", False,
     dict(num_trees=8, max_depth=6, feature_subset_strategy="sqrt",
          subsampling_rate=0.8)),
    ("OpRandomForestClassifier", True,
     dict(num_trees=6, feature_subset_strategy="all")),
    ("OpDecisionTreeClassifier", True, dict(max_depth=6)),
], ids=["clf_defaults_auto", "reg_defaults_auto", "clf_onethird",
        "reg_sqrt", "clf_all", "tree_clf"])
def test_forest_matches_reference(cls_name, classification, kw):
    X, y = _data(classification, seed=len(cls_name) + len(kw))
    ref, port = _pair(cls_name, **kw)
    assert dict(port.params, backend="jax") == ref.params
    want, got = ref.fit_arrays(X, y), port.fit_arrays(X, y)
    # the masks come from the reference's own draws: its seed_ints follow
    # the Poisson bootstrap in the same RandomState
    ref_in = ref._forest_inputs(X, y)
    seed_ints, subset_p, depth = ref_in[8], ref_in[9], ref_in[10]
    port_masks = port._forest_inputs(X, y)[7]
    if subset_p < 1.0:
        np.testing.assert_array_equal(
            port_masks, _ref_masks(seed_ints, np.float32(subset_p), depth, D))
    else:
        assert port_masks is None
    ties, rows = _compare_forest(got, want, X, classification)
    compared = _compare_predictions(ref, port, got, want, X, rows,
                                    classification)
    assert compared > 0.5, (ties, compared)
    # the host serving route agrees with the device route
    k = 2 if classification else 0
    np.testing.assert_allclose(port.predict_arrays_np(got, X)[k],
                               port.predict_arrays(got, X)[k],
                               rtol=0, atol=1e-5)


def _folds(y):
    return mod(REF, "selector.validator").stratified_kfold_masks(
        (y > np.median(y)).astype(float), 3, 42, True).astype(np.float64)


@pytest.mark.parametrize("classification", [True, False], ids=["clf", "reg"])
def test_fit_arrays_folds_matches_reference(classification, monkeypatch):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    X, y = _data(classification, seed=5)
    W = _folds(y)
    kw = dict(num_trees=5, max_depth=4, min_info_gain=0.001)
    cls_name = ("OpRandomForestClassifier" if classification
                else "OpRandomForestRegressor")
    ref, port = _pair(cls_name, **kw)
    want, got = ref.fit_arrays_folds(X, y, W), port.fit_arrays_folds(X, y, W)
    assert len(got) == len(want) == 3
    for f in range(3):
        _, rows = _compare_forest(got[f], want[f], X, classification)
        assert _compare_predictions(ref, port, got[f], want[f], X, rows,
                                    classification) > 0.5
        # a fold of the fan-out is a one-fold fit, exactly
        one = port.fit_arrays(X, y, W[f])
        for a, b in zip(one["heaps"], got[f]["heaps"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("classification", [True, False], ids=["clf", "reg"])
def test_fit_arrays_folds_grid_matches_reference(classification, monkeypatch):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    X, y = _data(classification, seed=6)
    W = _folds(y)
    grid = [
        {"min_info_gain": 0.001, "min_instances_per_node": 10},
        {"min_info_gain": 0.01, "min_instances_per_node": 1},
        {"max_depth": 2, "min_info_gain": 0.001},
        {"max_depth": 2, "num_trees": 3},
    ]
    kw = dict(num_trees=4, max_depth=4)
    cls_name = ("OpRandomForestClassifier" if classification
                else "OpRandomForestRegressor")
    ref, port = _pair(cls_name, **kw)
    want = ref.fit_arrays_folds_grid(X, y, W, grid)
    got = port.fit_arrays_folds_grid(X, y, W, grid)
    assert len(got) == len(want) == len(grid)
    for j, pmap in enumerate(grid):
        cand = port.with_params(**pmap)
        for f in range(3):
            _, rows = _compare_forest(got[j][f], want[j][f], X, classification)
            assert _compare_predictions(
                ref.with_params(**pmap), cand, got[j][f], want[j][f], X, rows,
                classification) > 0.5
        # each fold equals the one-fold fit of its grid point, exactly
        one = cand.fit_arrays(X, y, W[j % 3])
        for a, b in zip(one["heaps"], got[j][j % 3]["heaps"]):
            np.testing.assert_array_equal(a, b)


def test_rows_with_the_same_leaves_score_the_same_bits():
    """A forest whose trees never split (no gain reaches min_info_gain)
    scores every row alike, bit for bit, at a row count off any vector
    width: the trees add in tree order (``tree_kernel.seq_sum``), the
    numpy walk's order (``predict_forest_np``).  A stacked mean added some
    rows' trees in another order, and the CV metric of such a candidate
    left 0.5.  The host serving route (``predict_arrays_np``, the C++ walk
    where the native library is built) scores every row alike too."""
    X, y = _data(True, seed=3)
    X, y = np.tile(X, (6, 1))[:6001], np.tile(y, 6)[:6001]
    tk_mod = mod(PORT, "models.tree_kernel")
    port = mod(PORT, "models.trees").OpRandomForestClassifier(
        device="cpu", num_trees=50, max_depth=3, min_info_gain=0.5)
    params = port.fit_arrays(X, y)
    assert params["heaps"][2].all()
    prob = port.predict_arrays(params, X)[2]
    assert np.unique(prob[:, 1]).size == 1
    bins = tk_mod.bin_data(np.asarray(X, np.float32), params["edges"])
    np.testing.assert_array_equal(prob, tk_mod.predict_forest_np(
        bins, params["heaps"], params["max_depth"]))
    assert np.unique(port.predict_arrays_np(params, X)[2][:, 1]).size == 1


@pytest.mark.parametrize("classification", [True, False])
@pytest.mark.parametrize("num_trees", [3, 20, 50])
def test_score_route_and_served_head_agree_bit_for_bit(num_trees,
                                                       classification):
    """``predict_arrays`` (``score()`` and the validator's predictions, on
    ``tree_kernel.predict_forest``) and ``predict_arrays_torch`` (the
    served head) scale the tree-order sum by the same float32 1/T, so they
    give the same bits at tree counts whose 1/T is not exact in float32.
    Before, ``predict_forest`` divided by T and the two routes were one
    float32 ULP apart on a fifth to a quarter of the values."""
    X, y = _data(classification, seed=5)
    name = ("OpRandomForestClassifier" if classification
            else "OpRandomForestRegressor")
    est = getattr(mod(PORT, "models.trees"), name)(
        device="cpu", num_trees=num_trees, max_depth=6)
    params = est.fit_arrays(X, y)
    want = est.predict_arrays(params, X)
    got = est.predict_arrays_torch(
        est.torch_params(params, torch.device("cpu")),
        torch.from_numpy(np.asarray(X, np.float32)))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
