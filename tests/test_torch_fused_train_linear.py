"""The fused training programs of the linear families against the
kernel-at-a-time path and against the JAX package's fused path.

``local/fused_train.py``: port fused against port existing - betas
bit-equal, fold metrics within 1e-9, the same winner - for logistic
regression (exact and approx rank metrics), the linear SVM and linear
regression at the reference tests' 12 000 rows; port fused against the
reference's fused path (run through ``torch_parity.reference_fused_x64``)
- the same trail backend and mode, CV means within 1e-5 (approx 1e-3),
the same winner.  The exact device metrics (``exact_rank_metrics``,
``regression_metrics``, ``val_gather_plan``) against the reference's
functions and the host evaluator (1e-12); the bitwise fixed-point Newton
exit; the gate's reasons against the reference's; the design matrix read
back unchanged after a dispatch; the trail's keys.  The reference runs
its single-device route (``TX_PRODUCT_MESH=0``).
"""
import numpy as np
import pytest
import torch

from torch_parity import (
    PORT,
    REF,
    fold_metric_diffs,
    fused_cv_data,
    fused_validate,
    mod,
    reference_fused_x64,
)

N = 12_000


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    reference_fused_x64(monkeypatch)


def _family(pkg: str, name: str):
    kw = {"device": "cpu"} if pkg == PORT else {}
    if name.startswith("lr"):
        est = mod(pkg, "models.logistic_regression").OpLogisticRegression(
            max_iter=12, **kw)
        return est, mod(pkg, "selector.factories").lr_grid()
    if name == "svc":
        est = mod(pkg, "models.linear_svc").OpLinearSVC(max_iter=8, **kw)
        return est, [{"reg_param": r} for r in (0.01, 0.1, 0.5)]
    est = mod(pkg, "models.linear_regression").OpLinearRegression(**kw)
    return est, mod(pkg, "selector.factories").lr_grid()


CASES = {  # family -> (regression, rank mode, tolerance against the reference)
    "lr": (False, "exact", 1e-5),
    "lr_approx": (False, "approx", 1e-3),
    "svc": (False, "exact", 1e-5),
    "linreg": (True, "exact", 1e-5),
}


@pytest.mark.parametrize("family", list(CASES))
def test_linear_fused_matches_existing_and_reference(monkeypatch, family):
    regression, mode, ref_tol = CASES[family]
    monkeypatch.setenv("TX_CV_RANK_METRICS", mode)
    X, y = fused_cv_data(N, regression)
    ev = "OpRegressionEvaluator" if regression else \
        "OpBinaryClassificationEvaluator"
    est, grid = _family(PORT, family)
    existing = fused_validate(PORT, est, grid, X, y, ev, False,
                              stratify=not regression)
    fused = fused_validate(PORT, est, grid, X, y, ev, True,
                           stratify=not regression)
    fam = fused.train_fused["families"][est.model_type]
    assert fam["backend"] == "fused" and fam["mode"] == mode
    assert existing.train_fused["families"][est.model_type] == {
        "backend": "existing", "reason": "disabled"}
    assert fused.best_params == existing.best_params
    assert fold_metric_diffs(existing, fused).max() <= 1e-9
    if mode == "approx":  # the same kernels on the same betas
        assert fold_metric_diffs(existing, fused).max() == 0.0
    # the fixed-point betas are the fixed-length loop's, bit for bit
    val = mod(PORT, "selector.validator")
    masks = val.stratified_kfold_masks(y, 3, 42, not regression)
    regs_g, ens_g = val.lr_grid_scalars(est, grid)
    regs, ens = np.tile(regs_g, 3), np.tile(ens_g, 3)
    Xd = torch.tensor(X, dtype=torch.float32)
    res = mod(PORT, "local.fused_train").run_linear(
        est, Xd, y, masks, np.ones(len(y)), False, regs, ens, len(grid),
        getattr(mod(PORT, "evaluators." + ("regression" if regression
                                           else "binary")), ev)(), mode)
    W = torch.as_tensor(masks).to(torch.float32).repeat_interleave(
        len(grid), dim=0)
    betas, b0s = est.fit_arrays_batched(Xd, torch.tensor(y, dtype=torch.float32),
                                        W, regs, ens)
    np.testing.assert_array_equal(res.betas, betas)
    np.testing.assert_array_equal(res.b0s, b0s)
    # the reference's own fused path
    ref_est, ref_grid = _family(REF, family)
    want = fused_validate(REF, ref_est, ref_grid, X, y, ev, True,
                          stratify=not regression)
    want_fam = want.train_fused["families"][est.model_type]
    assert (want_fam["backend"], want_fam["mode"]) == (fam["backend"], mode)
    assert want.train_fused["backend"] == fused.train_fused["backend"]
    assert fused.best_params == want.best_params
    assert fold_metric_diffs(want, fused, "metric").max() <= ref_tol


# -- the exact device metrics ---------------------------------------------------

def _rank_case(kind: str, rng):
    """(scores [B, m], labels [B, m], ok [B, m]) of one case."""
    B, m = 3, 4000
    y = (rng.rand(B, m) > 0.6).astype(np.float64)
    ok = rng.rand(B, m) > 0.1
    if kind == "ties":  # a saturated block and a coarse grid of values
        s = np.where(rng.rand(B, m) < 0.2, 1.0,
                     np.round(rng.rand(B, m) * 50) / 50)
    elif kind == "negative":
        s = rng.randn(B, m) * 3.0
    elif kind == "signed_zero":  # -0.0 and 0.0 are one tie group
        s = rng.choice([-0.0, 0.0, -1.0, 0.5], size=(B, m))
    elif kind == "one_class":  # a fold of one class scores 0
        s = rng.rand(B, m)
        y[1] = 1.0
        y[2] = 0.0
    else:  # "padding": a short fold padded to the widest
        s = rng.rand(B, m)
        ok[0, m // 3:] = False
    return s, y, ok


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["ties", "negative", "signed_zero",
                                  "one_class", "padding"])
def test_exact_rank_metrics_match_reference_and_host(kind, dtype):
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(7)
    s, y, ok = _rank_case(kind, rng)
    s = s.astype(dtype)
    ft = mod(PORT, "local.fused_train")
    got = ft.exact_rank_metrics(torch.from_numpy(s), torch.from_numpy(y),
                                torch.from_numpy(ok))
    # the reference's keys split -0.0 from 0.0 (their bit patterns), its
    # host evaluator ties them, and so does the port: held against the
    # reference on the scores with the zeros' sign dropped
    with jax.enable_x64(True):
        want = mod(REF, "local.fused_train").exact_rank_metrics(
            jnp.asarray(s + 0.0), jnp.asarray(y), jnp.asarray(ok))
        want = [np.asarray(w) for w in want]
    host = mod(PORT, "evaluators.binary")._roc_pr_areas
    for b in range(s.shape[0]):
        h = host(y[b][ok[b]], s[b][ok[b]].astype(np.float64))
        for i in range(2):
            assert abs(float(got[i][b]) - float(want[i][b])) <= 1e-12
            assert abs(float(got[i][b]) - h[i]) <= 1e-12
    if kind == "one_class":
        assert float(got[0][1]) == float(got[0][2]) == 0.0
    if kind == "signed_zero":
        assert (np.signbit(s) & (s == 0)).any() and (s == 0).any()


@pytest.mark.parametrize("metric", ["RootMeanSquaredError", "MeanSquaredError",
                                    "MeanAbsoluteError", "R2"])
def test_regression_metrics_match_reference(metric):
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    pred = rng.randn(4, 500).astype(np.float32)
    y = rng.randn(4, 500)
    ok = rng.rand(4, 500) > 0.2
    y[3] = 1.5  # a constant target: R2 is 0
    got = mod(PORT, "local.fused_train").regression_metrics(
        torch.from_numpy(pred), torch.from_numpy(y), torch.from_numpy(ok),
        metric)
    with jax.enable_x64(True):
        want = np.asarray(mod(REF, "local.fused_train").regression_metrics(
            jnp.asarray(pred), jnp.asarray(y), jnp.asarray(ok), metric))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    ev = mod(PORT, "evaluators.regression").OpRegressionEvaluator()
    ev.metric_name = metric
    pc = mod(PORT, "types.columns").PredictionColumn
    for b in range(3):
        host = ev.evaluate_arrays(y[b][ok[b]], pc(
            pred[b][ok[b]].astype(np.float64), None, None))
        assert abs(float(got[b]) - getattr(host, metric)) <= 1e-12


def test_val_gather_plan_and_metric_kind_match_reference():
    rng = np.random.RandomState(5)
    val = mod(PORT, "selector.validator")
    for y in ((rng.rand(301) > 0.5).astype(float), np.zeros(10)):
        masks = val.stratified_kfold_masks(y, 3, 42, True)
        got = mod(PORT, "local.fused_train").val_gather_plan(masks)
        want = mod(REF, "local.fused_train").val_gather_plan(masks)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    ft = {p: mod(p, "local.fused_train") for p in (REF, PORT)}
    with pytest.raises(ft[PORT].FusedTrainError) as e:
        ft[PORT].val_gather_plan(np.ones((3, 5), bool))
    assert e.value.reason == "no_validation_rows"
    for where, cls in (("binary", "OpBinaryClassificationEvaluator"),
                       ("binary", "OpBinScoreEvaluator"),
                       ("regression", "OpRegressionEvaluator"),
                       ("multiclass", "OpMultiClassificationEvaluator")):
        kinds = [ft[p].metric_kind(getattr(mod(p, f"evaluators.{where}"),
                                           cls)()) for p in (REF, PORT)]
        assert kinds[0] == kinds[1], (cls, kinds)


# -- the fixed-point Newton exit --------------------------------------------------

def test_newton_fixed_point_equals_the_full_length_loop():
    pn = mod(PORT, "models.packed_newton")
    X, y = fused_cv_data(3000)
    Xd = torch.tensor(X, dtype=torch.float32)
    yd = torch.tensor(y, dtype=torch.float32)
    W = (torch.rand(6, 3000, generator=torch.Generator().manual_seed(1))
         > 0.3).to(torch.float32)
    regs = torch.tensor([0.0, 0.01, 0.1, 0.0, 0.01, 0.1])
    ens = torch.tensor([0.0, 0.0, 0.0, 0.5, 0.5, 0.5])
    lr = mod(PORT, "models.logistic_regression")
    full = lr.lr_fit_batched_core(Xd, yd, W, regs, ens, 25)
    fixed = lr.lr_fit_batched_core(Xd, yd, W, regs, ens, 25, fixed_point=True)
    for a, b in zip(full, fixed):
        assert torch.equal(a, b)
    calls = []

    def halving(c):  # reaches the fixed point 0.0 after ~150 steps
        calls.append(1)
        return (c[0] * 0.5, c[1])

    pn.newton_fixed_point(halving, (torch.ones(3), torch.zeros(())), 400)
    assert 100 < len(calls) < 400
    # a NaN never ends the loop: the whole budget runs, as the scan's
    calls.clear()
    nan = torch.tensor([float("nan"), 1.0])
    out = pn.run_newton(lambda c: (calls.append(1) or c), nan, 17,
                        fixed_point=True)
    assert len(calls) == 17 and torch.isnan(out[0])
    calls.clear()
    pn.run_newton(lambda c: (calls.append(1) or c), torch.ones(2), 17,
                  fixed_point=True)
    assert len(calls) == 1


# -- the gate, the trail and the shared design matrix ----------------------------

@pytest.mark.parametrize("case", ["disabled", "disabled_env", "below_min_rows",
                                  "evaluator_unsupported", "forced_env"])
def test_gate_reasons_match_reference(monkeypatch, case):
    X, y = fused_cv_data(4000)
    fused = {"disabled": False, "evaluator_unsupported": True}.get(case)
    if case == "disabled_env":
        monkeypatch.setenv("TX_TRAIN_FUSED", "0")
        fused = True
    if case == "forced_env":
        monkeypatch.setenv("TX_TRAIN_FUSED", "1")
    ev = ("OpBinScoreEvaluator" if case == "evaluator_unsupported"
          else "OpBinaryClassificationEvaluator")
    fams = []
    for pkg in (REF, PORT):
        est, grid = _family(pkg, "lr")
        est.params["max_iter"] = 6
        r = fused_validate(pkg, est, grid[:2], X, y, ev, fused)
        fams.append(r.train_fused["families"][est.model_type])
    if case == "forced_env":
        assert fams[0]["backend"] == fams[1]["backend"] == "fused"
    else:
        assert fams[1] == fams[0] == {"backend": "existing", "reason": case}
    # the auto gate opens at TX_TRAIN_FUSED_MIN_ROWS rows
    if case == "below_min_rows":
        monkeypatch.setenv("TX_TRAIN_FUSED_MIN_ROWS", "4000")
        est, grid = _family(PORT, "lr")
        r = fused_validate(PORT, est, grid[:2], X, y, ev, None)
        assert r.train_fused["families"][est.model_type]["backend"] == "fused"


def test_dispatch_leaves_the_design_matrix_and_keeps_the_trail_shape():
    """The fold-weight block is the dispatch's own; the shared design
    matrix is read, never written: X reads back bit-equal, and a second
    dispatch over it gives the same metrics and betas.  The trail has the
    reference's keys (its cache fields with the port's values: no compile
    cache)."""
    X, y = fused_cv_data(6000)
    est, grid = _family(PORT, "lr")
    val = mod(PORT, "selector.validator")
    masks = val.stratified_kfold_masks(y, 3, 42, True)
    regs_g, ens_g = val.lr_grid_scalars(est, grid)
    regs, ens = np.tile(regs_g, 3), np.tile(ens_g, 3)
    Xd = torch.tensor(X, dtype=torch.float32)
    before = Xd.clone()
    ft = mod(PORT, "local.fused_train")
    ev = mod(PORT, "evaluators.binary").OpBinaryClassificationEvaluator()
    registry = mod(PORT, "obs.metrics").metrics_registry()
    count = registry.counter("train_fused.dispatches")
    n0 = count.value
    r1 = ft.run_linear(est, Xd, y, masks, np.ones(len(y)), False, regs, ens,
                       len(grid), ev, "exact")
    assert torch.equal(Xd, before)
    r2 = ft.run_linear(est, Xd, y, masks, np.ones(len(y)), False, regs, ens,
                       len(grid), ev, "exact")
    assert count.value == n0 + 2
    np.testing.assert_array_equal(r1.metrics, r2.metrics)
    np.testing.assert_array_equal(r1.betas, r2.betas)
    r = fused_validate(PORT, est, grid[:2], X, y,
                       "OpBinaryClassificationEvaluator", True)
    tf = r.train_fused
    assert tf["backend"] == "fused"
    assert tf["cache"] == {"hits": 0, "misses": 0, "stale": 0}
    fam = tf["families"][est.model_type]
    for key in ("backend", "cache", "trace_ms", "compile_ms", "load_ms",
                "exec_ms", "bucket", "mode"):
        assert key in fam, key
    assert fam["cache"] == "none"
    assert fam["trace_ms"] == fam["compile_ms"] == fam["load_ms"] == 0.0
    assert fam["bucket"] == "n=6000,d=39,k=3,g=2"
