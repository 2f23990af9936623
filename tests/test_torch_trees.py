"""models/trees.py of the torch package against the JAX package's.

``fit_arrays`` + ``predict_arrays`` of each ported tree estimator on the
same seeded data, the reference always with ``backend="jax"`` (its
``"auto"`` takes the host C++ learner on a CPU).  Tolerances: the GBT
initial margin within 1e-7; heap structure identical node by node, except
at an exact tie (``torch_parity.compare_trees``; ROADMAP.md queue 3); node
stats: gini counts exact, variance and gradient channels as Newton leaf
values within rtol 1e-4, atol 1e-5 (float32 sums in another order);
probabilities and predictions within 1e-5 on every row that no tie
touches; ``predict_arrays_np`` equal to ``predict_arrays`` within 1e-5.
"""
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, compare_trees, mod, tree_fits_agree

N, D = 1200, 8


def _data(classification: bool, seed: int = 0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    X[:, 5] = rng.randint(0, 2, N)      # a one-hot pair: complementary
    X[:, 6] = 1.0 - X[:, 5]             # columns, each split ties the other
    X[:, 7] = np.round(rng.rand(N) * 4)  # few distinct values
    z = X[:, 0] - 0.7 * X[:, 1] + 0.8 * X[:, 5] + 0.3 * X[:, 7] * X[:, 2]
    if classification:
        y = (z + 0.5 * rng.randn(N) > 0.2).astype(np.float64)
    else:
        y = z + 0.3 * rng.randn(N)
    return X, y


def _pair(cls_name: str, **kw):
    ref = getattr(mod(REF, "models.trees"), cls_name)(backend="jax", **kw)
    port = getattr(mod(PORT, "models.trees"), cls_name)(device="cpu", **kw)
    return ref, port


ESTIMATORS = [
    ("OpGBTClassifier", True, dict(num_trees=6, max_depth=4)),
    ("OpGBTRegressor", False, dict(num_trees=6, max_depth=4)),
    ("OpXGBoostClassifier", True, dict(num_round=4, max_depth=3,
                                       min_child_weight=20.0)),
    ("OpDecisionTreeClassifier", True, dict(max_depth=5)),
    ("OpDecisionTreeRegressor", False, dict(max_depth=5,
                                            min_instances_per_node=10)),
    ("OpRandomForestClassifier", True, dict(num_trees=5, max_depth=4,
                                            feature_subset_strategy="all")),
]


@pytest.mark.parametrize("cls_name,classification,kw", ESTIMATORS,
                         ids=[e[0] for e in ESTIMATORS])
def test_fit_and_predict_match_reference(cls_name, classification, kw):
    X, y = _data(classification, seed=len(cls_name))
    ref, port = _pair(cls_name, **kw)
    want, got = ref.fit_arrays(X, y), port.fit_arrays(X, y)
    gbt = "f0" in want
    if gbt:
        assert abs(got["f0"] - want["f0"]) <= 1e-7
        assert got["step_size"] == want["step_size"]
    else:
        np.testing.assert_array_equal(got["classes"], want["classes"])
    tied = tree_fits_agree(want, got, X, classification, gbt)
    assert tied.mean() < 0.2

    pred_w, raw_w, prob_w = ref.predict_arrays(want, X)
    pred_g, raw_g, prob_g = port.predict_arrays(got, X)
    ok = ~tied
    np.testing.assert_allclose(pred_g[ok], np.asarray(pred_w)[ok], atol=1e-5)
    if classification:
        np.testing.assert_allclose(prob_g[ok], np.asarray(prob_w)[ok],
                                   rtol=0, atol=1e-5)
    # the host serving route agrees with the device route
    pred_n, _, prob_n = port.predict_arrays_np(got, X)
    np.testing.assert_allclose(pred_n, pred_g, atol=1e-5)
    if classification:
        np.testing.assert_allclose(prob_n, prob_g, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        port.contributions(got), ref.contributions(want), atol=0.05)


def test_one_hot_pair_tie_is_logged():
    """The complementary columns 5 and 6 route every row alike, so a
    split on either is an exact tie; where the packages pick different
    ones, the rows fall into the same leaves and every prediction agrees
    (ROADMAP.md queue 3)."""
    X, _ = _data(True, seed=3)
    rng = np.random.RandomState(5)
    y = (X[:, 5] + 0.8 * rng.rand(N) > 0.6).astype(np.float64)
    ref, port = _pair("OpDecisionTreeClassifier", max_depth=2)
    want, got = ref.fit_arrays(X, y), port.fit_arrays(X, y)
    assert {int(want["heaps"][0][0, 0]), int(got["heaps"][0][0, 0])} <= {5, 6}
    bins = mod(REF, "models.tree_kernel").bin_data(
        X.astype(np.float32), want["edges"])
    compare_trees([h[0] for h in got["heaps"]],
                  [np.asarray(h[0]) for h in want["heaps"]], bins, 2)
    np.testing.assert_allclose(port.predict_arrays(got, X)[2],
                               np.asarray(ref.predict_arrays(want, X)[2]),
                               atol=1e-6)


def test_unported_routes_raise():
    """The fused plan is ported: built where the reference's is, with its
    signature and array names, its bins the reference's; the host C++ learner
    (``backend="native"``) gives the JAX package's native heaps bit for
    bit; the forests' per-node subsets (item 6a) no longer raise: a default forest
    fits, folds and predicts.  The scoring mirror of the device-fused
    program is ported (``predict_arrays_torch``, within an ULP of the
    numpy route here)."""
    X, y = _data(True)
    trees = mod(PORT, "models.trees")
    rf = trees.OpRandomForestClassifier(device="cpu", num_trees=3)
    params = rf.fit_arrays(X, y)
    assert params["heaps"][0].shape == (3, 2 ** (params["max_depth"] + 1) - 1)
    assert rf.predict_arrays(params, X)[2].shape == (N, 2)
    folds = rf.fit_arrays_folds(X, y, np.ones((2, N)))
    for a, b in zip(folds[1]["heaps"], params["heaps"]):
        np.testing.assert_array_equal(a, b)
    # the host C++ learner (backend="native"): heaps bit-equal to the
    # JAX package's native learner on the same inputs
    ref_trees = mod(REF, "models.trees")
    got = trees.OpGBTClassifier(device="cpu", backend="native").fit_arrays(X, y)
    want = ref_trees.OpGBTClassifier(backend="native").fit_arrays(X, y)
    for a, b in zip(got["heaps"], want["heaps"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got["f0"] == want["f0"] and got["max_depth"] == want["max_depth"]
    W = (np.arange(N)[None, :] % 3 != np.arange(3)[:, None]).astype(float)
    got = trees.OpRandomForestClassifier(device="cpu", backend="native") \
        .fit_arrays_folds(X, y, W)
    want = ref_trees.OpRandomForestClassifier(backend="native") \
        .fit_arrays_folds(X, y, W)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["edges"], w["edges"])
        for a, b in zip(g["heaps"], w["heaps"]):
            np.testing.assert_array_equal(a, np.asarray(b))
    gbt = trees.OpGBTClassifier(device="cpu")
    W = np.ones((3, N))
    try:
        want = ref_trees.OpGBTClassifier(backend="jax").fused_tree_plan(
            X, y, W, [{}])
    except ValueError as e:  # single_class or dispatch_chunked
        with pytest.raises(ValueError, match=f"^{e}$"):
            gbt.fused_tree_plan(X, y, W, [{}])
    else:
        plan = gbt.fused_tree_plan(X, y, W, [{}])
        assert plan["sig"] == want["sig"]
        assert sorted(plan["arrays"]) == sorted(want["arrays"])
        for k in ("step_g", "minipn_g", "minig_g"):
            np.testing.assert_array_equal(  # the reference's float32 copy
                plan["arrays"][k].astype(np.float32), want["arrays"][k])
        assert plan["donate"] == want["donate"]
        np.testing.assert_array_equal(plan["arrays"]["bins"].numpy(),
                                      want["arrays"]["bins"])
        state = plan["fit"](plan["arrays"])
        assert len(state) == plan["n_state"] == want["n_state"]
    assert not hasattr(gbt, "predict_arrays_xla")
    # the forest's float32 mean: 1 float32 ULP (the C++ walk multiplies
    # by 1/T, the mirror divides by T); the GBT's float64 head: 64 ULP
    for est, p, rtol in ((rf, params, 2.0 ** -23),
                         (gbt, gbt.fit_arrays(X, y), 64 * 2.0 ** -52)):
        got = est.predict_arrays_torch(
            est.torch_params(p, torch.device("cpu")),
            torch.from_numpy(np.asarray(X, np.float32)))
        want = est.predict_arrays_np(p, np.asarray(X, np.float32))
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=rtol,
                                   atol=0)
    with pytest.raises(ValueError, match="binary"):
        gbt.fit_arrays(X, np.arange(N) % 3)


def test_defaults_match_reference():
    for name in ("OpGBTClassifier", "OpRandomForestRegressor",
                 "OpXGBoostRegressor", "OpDecisionTreeClassifier"):
        ref = getattr(mod(REF, "models.trees"), name)()
        port = getattr(mod(PORT, "models.trees"), name)()
        assert port.params == ref.params
        assert port.device == "cuda"


def test_large_input_edges_come_from_the_seeded_sample(monkeypatch):
    """Above the sample cap both packages draw the same RandomState rows."""
    monkeypatch.setattr(mod(PORT, "models.trees"), "_EDGE_SAMPLE_CAP", 257)
    monkeypatch.setattr(mod(REF, "models.trees"), "_EDGE_SAMPLE_CAP", 257)
    X, _ = _data(False)
    np.testing.assert_array_equal(
        mod(PORT, "models.trees")._sampled_bin_edges(X, 32, 7),
        mod(REF, "models.trees")._sampled_bin_edges(X, 32, 7))
    bins = mod(PORT, "models.trees")._bin_for_backend(
        torch.from_numpy(X.astype(np.float32)),
        mod(PORT, "models.trees")._sampled_bin_edges(X, 32, 7), 32)
    assert bins.dtype == torch.int8


def test_device_inputs_are_contiguous():
    """The kernel takes contiguous tensors: a column-major design matrix
    (as a column selection can leave it) is laid out row-major on the way
    up."""
    X = np.asfortranarray(_data(True)[0])
    t = mod(PORT, "models.trees")._f32(X, torch.device("cpu"))
    assert t.is_contiguous() and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), X.astype(np.float32))
