"""The batched CV fits against the JAX package and against their own
one-candidate fits.

Batched binary LR (3 folds x the 8-point default grid): within rtol 1e-4,
atol 1e-5 of the reference's ``_lr_fit_batched`` (the grid's
``reg_param >= 0.001`` identifies the betas), and within rtol 1e-5, atol
1e-6 of the port's own per-candidate ``fit_arrays``.  The guards are per
candidate: a converged candidate takes zero steps while another still
moves, and one candidate's failed Cholesky leaves the others finite.

GBT (and forest) ``fit_arrays_folds`` and ``fit_arrays_folds_grid``: each fold's heaps
against the reference's (``backend="jax"``, single device) through
``compare_trees`` and its tie rules, leaf stats within rtol 1e-4, atol
1e-5, probabilities within 1e-5; and each fold equal to a one-fold fit of
the port, exactly.
"""
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, compare_trees, mod

IDS = ["X_plain", "X_offset"]


def _data(n=500, d=7, seed=0, offset=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d) * np.linspace(0.5, 4.0, d)
    if offset:  # |mean| >> std columns: the pre-centering path
        X = X + np.linspace(0.0, 30.0, d)
    z = (X - X.mean(0)) @ np.linspace(0.8, -0.5, d) / 2.0 + rng.randn(n)
    return X, (z > 0).astype(np.float64)


def _fold_masks(y, k=3):
    return mod(REF, "selector.validator").stratified_kfold_masks(
        y, k, 42, True).astype(np.float64)


def _fold_grid(y, k=3, grid=None):
    """Fold-major W [k*g, n] and regs/ens [k*g] of the default LR grid."""
    masks = _fold_masks(y, k)
    grid = grid or mod(REF, "selector.factories").lr_grid()
    g = len(grid)
    regs = np.tile([p["reg_param"] for p in grid], k)
    ens = np.tile([p["elastic_net_param"] for p in grid], k)
    return np.repeat(masks, g, axis=0), regs, ens


def _ref_batched(X, y, W, regs, ens, iters=25):
    import jax.numpy as jnp

    from transmogrifai_tpu.models.logistic_regression import _lr_fit_batched

    b, b0 = _lr_fit_batched(
        jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(W, jnp.float32), jnp.asarray(regs, jnp.float32),
        jnp.asarray(ens, jnp.float32), iters=iters,
    )
    return np.asarray(b), np.asarray(b0)


def _port_lr(**kw):
    return mod(PORT, "models.logistic_regression").OpLogisticRegression(
        device="cpu", **kw)


@pytest.mark.parametrize("offset", [False, True], ids=IDS)
def test_batched_lr_matches_reference(offset):
    X, y = _data(offset=offset)
    W, regs, ens = _fold_grid(y)
    want_b, want_b0 = _ref_batched(X, y, W, regs, ens)
    got_b, got_b0 = _port_lr().fit_arrays_batched(X, y, W, regs, ens)
    assert got_b.shape == (24, X.shape[1]) and got_b0.shape == (24,)
    np.testing.assert_allclose(got_b, want_b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_b0, want_b0, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("offset", [False, True], ids=IDS)
def test_batched_lr_matches_one_candidate_fits(offset):
    X, y = _data(offset=offset, seed=1)
    W, regs, ens = _fold_grid(y)
    got_b, got_b0 = _port_lr().fit_arrays_batched(X, y, W, regs, ens)
    # every third candidate: each of the 8 grid points, in all 3 folds
    for b in range(0, len(W), 3):
        one = _port_lr(reg_param=regs[b], elastic_net_param=ens[b]) \
            .fit_arrays(X, y, W[b])
        np.testing.assert_allclose(got_b[b], one["beta"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_b0[b], one["intercept"], rtol=1e-5,
                                   atol=1e-6)


def test_batched_lr_accepts_device_tensors():
    X, y = _data(n=200)
    W, regs, ens = _fold_grid(y)
    est = _port_lr()
    host = est.fit_arrays_batched(X, y, W, regs, ens)
    dev = est.fit_arrays_batched(
        torch.tensor(X, dtype=torch.float32), torch.tensor(y, dtype=torch.float32),
        torch.tensor(W, dtype=torch.float32), regs, ens)
    for h, t in zip(host, dev):
        np.testing.assert_array_equal(h, t)


def test_batched_lr_guard_is_per_candidate():
    """A candidate on separable data (reg 0: its betas grow at every step,
    never converged) beside heavily regularized ones that converge within
    a few steps: each equals its one-candidate fit, so a converged
    candidate's zero steps and a moving one's steps do not leak across."""
    X, y = _data(n=300, d=4, seed=2)
    Xs = X.copy()
    ys = (X[:, 0] > 0).astype(np.float64)  # separable through column 0
    W = np.ones((3, len(y)))
    regs = np.array([0.0, 5.0, 0.5])
    ens = np.array([0.0, 0.0, 0.5])
    for iters in (4, 12):
        est = _port_lr(max_iter=iters)
        got_b, got_b0 = est.fit_arrays_batched(Xs, ys, W, regs, ens)
        for b in range(3):
            one = _port_lr(max_iter=iters, reg_param=regs[b],
                           elastic_net_param=ens[b]).fit_arrays(Xs, ys, W[b])
            np.testing.assert_allclose(got_b[b], one["beta"], rtol=1e-5, atol=1e-6)
        want_b, _ = _ref_batched(Xs, ys, W, regs, ens, iters=iters)
        np.testing.assert_allclose(got_b[1:], want_b[1:], rtol=1e-4, atol=1e-5)
    assert np.abs(got_b[0]).max() > 10 * np.abs(got_b[1]).max()


def test_guarded_step_reduces_per_candidate():
    """|g| is reduced per candidate (axis=1), as the JAX package's: a
    converged row takes a zero step whatever the others do, and only
    non-finite entries are zeroed in a moving row."""
    import jax.numpy as jnp

    from transmogrifai_tpu.models.packed_newton import guarded_step as ref_step

    pn = mod(PORT, "models.packed_newton")
    g = np.array([[1e-9, -5e-8, 0.0], [0.3, -1e-9, 2.0], [1e-6, 0.0, 0.0]],
                 np.float32)
    delta = np.array([[0.5, 0.5, 0.5], [1.0, np.nan, -np.inf], [2.0, 3.0, 4.0]],
                     np.float32)
    got = pn.guarded_step(torch.from_numpy(delta), torch.from_numpy(g), axis=1)
    want = np.asarray(ref_step(jnp.asarray(delta), jnp.asarray(g), axis=1))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), [[0, 0, 0], [1.0, 0, 0], [2.0, 3.0, 4.0]])
    # unbatched: the one fit's reduction over all of g
    one = pn.guarded_step(torch.from_numpy(delta[0]), torch.from_numpy(g[0]))
    np.testing.assert_array_equal(one.numpy(), [0, 0, 0])


def test_solve_pos_nan_is_per_candidate():
    pn = mod(PORT, "models.packed_newton")
    H = torch.tensor([[[4.0, 1.0], [1.0, 3.0]],
                      [[1.0, 2.0], [2.0, 1.0]],   # indefinite
                      [[2.0, 0.0], [0.0, 5.0]]])
    g = torch.tensor([[1.0, 2.0], [1.0, 1.0], [4.0, 5.0]])
    x = pn.solve_pos(H, g)
    assert torch.isnan(x[1]).all() and torch.isfinite(x[[0, 2]]).all()
    np.testing.assert_allclose(
        x[[0, 2]].numpy(),
        np.linalg.solve(H[[0, 2]].numpy(), g[[0, 2], :, None].numpy())[..., 0],
        rtol=1e-6)
    np.testing.assert_array_equal(pn._batched_diag(g)[2].numpy(),
                                  np.diag(g[2].numpy()))


def test_lr_fit_arrays_folds_matches_batched():
    X, y = _data(n=240, seed=3)
    W, _, _ = _fold_grid(y, grid=[{"reg_param": 0.01,
                                   "elastic_net_param": 0.1}])
    est = _port_lr(reg_param=0.01, elastic_net_param=0.1)
    folds = est.fit_arrays_folds(X, y, W)
    betas, b0s = est.fit_arrays_batched(X, y, W, np.full(3, 0.01),
                                        np.full(3, 0.1))
    want_b, want_b0 = _ref_batched(X, y, W, np.full(3, 0.01), np.full(3, 0.1))
    for f in range(3):
        np.testing.assert_array_equal(folds[f]["beta"], betas[f])
        assert folds[f]["intercept"] == float(b0s[f])
        np.testing.assert_allclose(folds[f]["beta"], want_b[f], rtol=1e-4,
                                   atol=1e-5)
    # a 3-class label takes the multinomial fold batch: the reference's
    # per-fold betas within rtol 1e-4, atol 1e-5
    y3 = np.arange(len(y)) % 3.0
    got = est.fit_arrays_folds(X, y3, W)
    want = mod(REF, "models.logistic_regression").OpLogisticRegression(
        reg_param=0.01, elastic_net_param=0.1).fit_arrays_folds(X, y3, W)
    for g, w in zip(got, want):
        assert g["family"] == w["family"] == "multinomial"
        np.testing.assert_allclose(g["betas"], w["betas"], rtol=1e-4,
                                   atol=1e-5)


# -- GBT fold and grid fan-outs -----------------------------------------------

def _tree_data(regression=False):
    X, y = _data(n=360, d=6, seed=4)
    if regression:
        return X, X @ np.linspace(1.0, -1.0, 6) * 0.3 + y
    return X, y


def _gbt(pkg, regression=False, **kw):
    trees = mod(pkg, "models.trees")
    cls = trees.OpGBTRegressor if regression else trees.OpGBTClassifier
    return cls(**kw, **({"device": "cpu"} if pkg == PORT else {"backend": "jax"}))


def _port_bins(X, params):
    tk = mod(PORT, "models.tree_kernel")
    return tk.bin_data(np.asarray(X, np.float32), params["edges"])


def _compare_fold(got, want, X, regression):
    np.testing.assert_array_equal(got["edges"], want["edges"])
    assert got["max_depth"] == want["max_depth"]
    assert got["step_size"] == pytest.approx(want["step_size"])
    np.testing.assert_allclose(got["f0"], want["f0"], rtol=1e-6)
    bins = _port_bins(X, got)
    tie_rows = np.zeros(len(X), bool)
    for t in range(got["heaps"][0].shape[0]):
        _, rows = compare_trees([h[t] for h in got["heaps"]],
                                [h[t] for h in want["heaps"]],
                                bins, got["max_depth"], rtol=1e-4, atol=1e-5)
        tie_rows |= rows
    return tie_rows


@pytest.mark.parametrize("regression", [False, True], ids=["clf", "reg"])
def test_gbt_fit_arrays_folds_matches_reference(regression, monkeypatch):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    X, y = _tree_data(regression)
    W = _fold_masks((X[:, 0] > 0).astype(float))
    # min_info_gain above float32 noise, as in every selector grid: at 0 a
    # pure node (one gradient on all its rows) splits anywhere on a gain of
    # +-1e-8, a tie the heap comparison cannot see
    kw = {"num_trees": 4, "max_depth": 3, "min_info_gain": 1e-4}
    want = _gbt(REF, regression, **kw).fit_arrays_folds(X, y, W)
    port = _gbt(PORT, regression, **kw)
    got = port.fit_arrays_folds(X, y, W)
    assert len(got) == len(want) == 3
    for f in range(3):
        ties = _compare_fold(got[f], want[f], X, regression)
        out_g = port.predict_arrays(got[f], X)
        out_w = _gbt(REF, regression, **kw).predict_arrays(want[f], X)
        k = 2 if not regression else 0
        np.testing.assert_allclose(out_g[k][~ties], out_w[k][~ties], atol=1e-5)
        # a fold of the fan-out is a one-fold fit, exactly
        one = port.fit_arrays(X, y, W[f])
        for a, b in zip(one["heaps"], got[f]["heaps"]):
            np.testing.assert_array_equal(a, b)
        assert one["f0"] == got[f]["f0"]


@pytest.mark.parametrize("regression", [False, True], ids=["clf", "reg"])
def test_gbt_fit_arrays_folds_grid_matches_reference(regression, monkeypatch):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    X, y = _tree_data(regression)
    W = _fold_masks((X[:, 1] > 0).astype(float))
    grid = [
        {"min_info_gain": 0.001, "step_size": 0.1},
        {"min_info_gain": 0.05, "step_size": 0.1},
        {"min_info_gain": 0.001, "step_size": 0.3, "min_instances_per_node": 20},
        {"max_depth": 2, "min_info_gain": 0.01},
    ]
    kw = {"num_trees": 4, "max_depth": 3}
    want = _gbt(REF, regression, **kw).fit_arrays_folds_grid(X, y, W, grid)
    port = _gbt(PORT, regression, **kw)
    got = port.fit_arrays_folds_grid(X, y, W, grid)
    assert len(got) == len(want) == len(grid)
    for j, pmap in enumerate(grid):
        cand = port.with_params(**pmap)
        per_fold = cand.fit_arrays_folds(X, y, W)
        for f in range(3):
            _compare_fold(got[j][f], want[j][f], X, regression)
            for a, b in zip(got[j][f]["heaps"], per_fold[f]["heaps"]):
                np.testing.assert_array_equal(a, b)
            assert got[j][f]["f0"] == per_fold[f]["f0"]


def test_forest_fold_fan_outs_raise():
    """The forest fold and grid fan-outs, which raised until the per-node
    subsets were ported: the default forest's folds against the reference's
    (``compare_trees``, gini counts exact; probabilities within 1e-5 off tie
    rows), each fold equal to a one-fold fit, and the grid's first point
    equal to the plain fan-out."""
    X, y = _tree_data()
    W = _fold_masks(y)
    kw = {"num_trees": 4, "max_depth": 3}
    ref = mod(REF, "models.trees").OpRandomForestClassifier(backend="jax", **kw)
    rf = mod(PORT, "models.trees").OpRandomForestClassifier(device="cpu", **kw)
    want, got = ref.fit_arrays_folds(X, y, W), rf.fit_arrays_folds(X, y, W)
    by_grid = rf.fit_arrays_folds_grid(X, y, W, [{}, {"min_info_gain": 0.01}])
    bins = _port_bins(X, got[0])
    for f in range(3):
        ties = np.zeros(len(y), bool)
        for t in range(4):
            ties |= compare_trees([h[t] for h in got[f]["heaps"]],
                                  [h[t] for h in want[f]["heaps"]],
                                  bins, got[f]["max_depth"])[1]
        assert ties.mean() < 0.5
        np.testing.assert_allclose(
            rf.predict_arrays(got[f], X)[2][~ties],
            np.asarray(ref.predict_arrays(want[f], X)[2])[~ties], atol=1e-5)
        one = rf.fit_arrays(X, y, W[f])
        for a, b, c in zip(one["heaps"], got[f]["heaps"], by_grid[0][f]["heaps"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)
