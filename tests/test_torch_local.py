"""Local scoring of the torch package against the JAX package's.

The workflow is the JAX package's ``_mixed_pipeline`` (fill-mean ->
z-normalize, real and integral vectorizers, a one-hot picklist, the
combiner, the SanityChecker and a head), built in both packages.  The JAX
package trains it and saves it; ``interop.load_reference_artifact`` loads
the artifact into the torch package's workflow, so both sides score with
the same weights.  Then, per family:

* the torch package's numpy-fused rows are bit-equal to the JAX package's
  numpy-fused rows;
* its torch-fused rows (the device program on CPU tensors, with
  ``bin_matrix_plain`` in place of kernel K2) are within the family's ULP
  budget of them (``torch_parity.ULP_BUDGETS``, copied from the JAX
  package's tests/test_fused_xla.py; its XLA backend cannot run on this
  host, so the reference is its numpy-fused backend);
* its interpreted rows are within 1 ULP of the JAX package's interpreted
  rows.

Also: batch of 1 and odd lengths (pad-to-bucket), the empty batch, a
poison row, the NaN guard, NaN features in the tree heads, a
``lower_torch()`` that raises, and the ``"auto"`` backend rule.
"""
import numpy as np
import pytest
import torch

from torch_parity import (
    PORT,
    REF,
    SERVE_FAMILIES,
    ULP_BUDGETS,
    assert_rows_close,
    mixed_pipeline,
    mod,
    reset_uids,
)

from transmogrifai_tpu_torch.interop import load_reference_artifact
from transmogrifai_tpu_torch.local import LocalScorer, score_function
from transmogrifai_tpu_torch.local.fused_torch import _exec_bucket
from transmogrifai_tpu_torch.models.base import PredictorModel
from transmogrifai_tpu_torch.parallel import kernels as tk

FAMILIES = list(SERVE_FAMILIES)
TREES = ("rf", "gbt", "rf_reg", "gbt_reg")

_cache: dict = {}


def _pair(family: str, tmp_path_factory):
    """(reference model, torch model carrying its weights, records)."""
    if family not in _cache:
        reset_uids(REF)
        ref_wf, records, _ = mixed_pipeline(REF, family)
        ref_model = ref_wf.train()
        path = str(tmp_path_factory.mktemp(f"ref_{family}") / "model")
        ref_model.save(path)
        reset_uids(PORT)
        port_wf, _, _ = mixed_pipeline(PORT, family)
        port_model = load_reference_artifact(path, port_wf)
        _cache[family] = (ref_model, port_model, records)
    return _cache[family]


def _ref_scorer(model, **kw):
    from transmogrifai_tpu.local import LocalScorer as RefScorer

    return RefScorer(model, drift_policy=None, **kw)


def _port(model, **kw):
    return LocalScorer(model, drift_policy=None, **kw)


@pytest.mark.parametrize("family", FAMILIES)
def test_numpy_fused_rows_bit_equal_to_reference(family, tmp_path_factory):
    ref, port, records = _pair(family, tmp_path_factory)
    want = _ref_scorer(ref, fused_backend="numpy")
    got = _port(port, fused_backend="numpy")
    assert want.fused_backend == got.fused_backend == "numpy"
    assert got.score_batch(records) == want.score_batch(records)
    assert [got(r) for r in records[:5]] == [want(r) for r in records[:5]]


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_fused_rows_within_ulp_budget(family, tmp_path_factory):
    torch.set_float32_matmul_precision("highest")
    ref, port, records = _pair(family, tmp_path_factory)
    want = _ref_scorer(ref, fused_backend="numpy")
    got = _port(port, fused_backend="torch")
    assert got.fused_backend == "torch" and got.fused_reason is None
    assert got.fused.device == torch.device("cpu")
    assert got.fused.cache == "none"
    ulps, atol = ULP_BUDGETS[family]
    # 160 rows pad to the 256 bucket; then batch of 1 and odd lengths
    assert_rows_close(got.score_batch(records),
                      want.score_batch(records), ulps, atol)
    for lo, hi in ((0, 1), (1, 4), (4, 21), (21, 121)):
        assert_rows_close(got.score_batch(records[lo:hi]),
                          want.score_batch(records[lo:hi]), ulps, atol)
    assert sorted(got.fused.bucket_stats) == [1, 4, 32, 128, 256]
    for st in got.fused.bucket_stats.values():
        assert st["compile_ms"] >= st["first_exec_ms"] > 0
    routes = [entry[-1]["route"] for entry in got.fused.plan]
    assert routes.count("host") == 1  # the one-hot pivot


@pytest.mark.parametrize("family", FAMILIES)
def test_interpreted_rows_match_reference(family, tmp_path_factory):
    ref, port, records = _pair(family, tmp_path_factory)
    want = _ref_scorer(ref, fused=False).score_batch(records)
    got = _port(port, fused=False)
    assert got.fused is None and got.fused_reason == "disabled by caller"
    assert_rows_close(got.score_batch(records), want, 1)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_empty_batch_is_empty_list(backend, tmp_path_factory):
    _, port, _ = _pair("lr", tmp_path_factory)
    scorer = _port(port, fused_backend=backend)
    assert scorer.score_batch([]) == []
    assert scorer.fused.last_nonfinite_rows == ()


def test_poison_row_raises_and_good_rows_still_score(tmp_path_factory):
    _, port, records = _pair("lr", tmp_path_factory)
    scorer = _port(port, fused_backend="torch")
    batch = [dict(r) for r in records[:6]]
    batch[2]["b"] = "not-a-number"  # poisons the numeric decode
    with pytest.raises(ValueError):
        scorer.score_batch(batch)
    good = [r for i, r in enumerate(batch) if i != 2]
    npf = _port(port, fused_backend="numpy")
    assert_rows_close(scorer.score_batch(good), npf.score_batch(good), 4)


def test_nan_guard_flags_nonfinite_scores(tmp_path_factory):
    _, port, records = _pair("lr", tmp_path_factory)
    (head,) = [s for s in port.stages if isinstance(s, PredictorModel)]
    saved = head.model_params
    head.model_params = dict(saved, beta=np.full_like(saved["beta"], np.nan))
    try:
        for backend in ("torch", "numpy"):
            scorer = _port(port, fused_backend=backend)
            scorer.score_batch(records[:5])
            assert scorer.fused.last_nonfinite_rows == (0, 1, 2, 3, 4)
    finally:
        head.model_params = saved
    scorer = _port(port, fused_backend="torch")
    scorer.score_batch(records[:5])
    assert scorer.fused.last_nonfinite_rows == ()


@pytest.mark.parametrize("family", TREES)
def test_tree_heads_bin_nan_features_like_numpy(family, tmp_path_factory):
    """A present NaN (the string "nan") reaches the tree head's binning:
    K2's plain version and the numpy route both put it after every
    non-NaN edge, so torch-fused rows stay within budget of numpy-fused."""
    _, port, records = _pair(family, tmp_path_factory)
    batch = [dict(r) for r in records[:9]]
    for i in (0, 4, 8):
        batch[i]["b"] = "nan"
    got = _port(port, fused_backend="torch")
    want = _port(port, fused_backend="numpy")
    before = tk.bin_matrix.launches
    rows = got.score_batch(batch)
    assert tk.bin_matrix.launches == before  # CPU tensors: plain version
    assert_rows_close(rows, want.score_batch(batch), *ULP_BUDGETS[family])
    assert got.fused.last_nonfinite_rows == ()


def test_lower_torch_raise_degrades_whole_pipeline(monkeypatch,
                                                   tmp_path_factory):
    from transmogrifai_tpu_torch.ops.combiner import VectorsCombiner

    _, port, records = _pair("lr", tmp_path_factory)

    def boom(self):
        raise RuntimeError("drill: torch lowering exploded")

    monkeypatch.setattr(VectorsCombiner, "lower_torch", boom)
    scorer = _port(port, fused_backend="torch")
    assert scorer.fused_backend == "numpy"
    assert "torch" in scorer.fused_reason and "drill" in scorer.fused_reason
    npf = _port(port, fused_backend="numpy")
    for _ in range(3):  # every batch stays numpy-fused
        assert scorer.score_batch(records[:8]) == \
            npf.score_batch(records[:8])


def test_auto_backend_follows_the_model_device(monkeypatch, tmp_path_factory):
    _, port, _ = _pair("lr", tmp_path_factory)
    assert port.device == "cpu"
    monkeypatch.delenv("TX_FUSED_BACKEND", raising=False)
    assert _port(port).fused_backend == "numpy"
    assert score_function(port, drift_policy=None).fused_backend == "numpy"
    monkeypatch.setenv("TX_FUSED_BACKEND", "torch")
    assert _port(port).fused_backend == "torch"
    monkeypatch.delenv("TX_FUSED_BACKEND")
    monkeypatch.setattr(port, "device", "cuda")
    if torch.cuda.is_available():
        assert _port(port).fused_backend == "torch"
    else:
        # a CUDA model never falls back to the CPU by itself
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port(port)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.score_function()
    with pytest.raises(ValueError, match="fused_backend"):
        _port(port, fused_backend="xla")


def test_exec_bucket_is_next_power_of_two():
    assert [_exec_bucket(n) for n in (1, 2, 3, 4, 5, 160, 1024, 1025)] == \
        [1, 2, 4, 4, 8, 256, 1024, 2048]


@pytest.mark.parametrize("family", ["lr", "gbt"])
def test_torch_lowerings_match_numpy_lowerings(family, tmp_path_factory):
    """Stage by stage, each device lowering's outputs equal its numpy
    lowering's on the same env (the head within its ULP budget)."""
    _, port, records = _pair(family, tmp_path_factory)
    npf = _port(port, fused_backend="numpy").fused
    env = npf._decoder.decode_env(records)
    for stage in [s for layer in port._dag() for s in layer]:
        lw, tl = stage.lower(), stage.lower_torch()
        if lw is None:
            continue
        new_np = lw.fn(env)
        if tl is not None:
            tenv = {k: torch.from_numpy(np.asarray(env[k]))
                    for k in tl.inputs}
            new_t = tl.fn(tenv)
            for key, arr in new_np.items():
                got = new_t[key].numpy()
                if isinstance(stage, PredictorModel):
                    np.testing.assert_allclose(got, arr, rtol=1e-13)
                else:
                    np.testing.assert_array_equal(got, arr)
        env.update(new_np)


@pytest.mark.parametrize("native", [True, False])
def test_forest_mean_follows_the_host_route(native, monkeypatch):
    """At 50 trees (1/T not exact in float32) the device forest's mean is
    one program whatever the host has built: times float32 1/T, bit-equal
    to the C++ walk's host route and to the numpy walk that serves when
    the native library does not."""
    from transmogrifai_tpu_torch.models import native_trees, trees

    if not native:
        monkeypatch.setattr(native_trees, "predict_forest",
                            lambda *a, **k: None)
    elif not native_trees.available():
        pytest.skip("the native library did not build on this host")
    rng = np.random.RandomState(8)
    X = rng.randn(300, 5).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.randn(300) > 0).astype(np.float64)
    est = trees.OpRandomForestClassifier(num_trees=50, max_depth=5,
                                         device="cpu")
    params = est.fit_arrays(X, y)
    want = est.predict_arrays_np(params, X)
    got = est.predict_arrays_torch(est.torch_params(params,
                                                    torch.device("cpu")),
                                   torch.from_numpy(X))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_kernel_failure_propagates_out_of_score_batch(monkeypatch,
                                                      tmp_path_factory):
    """A K2 build or launch failure inside the device program is not
    rerouted to the plain binning or to numpy-fused: it raises out of
    score_batch, batch after batch, and the scorer stays on torch."""
    from transmogrifai_tpu_torch.models import trees

    _, port, records = _pair("gbt", tmp_path_factory)
    scorer = _port(port, fused_backend="torch")

    def broken(*args, **kw):
        raise RuntimeError("nvcc failed for bin_matrix.cu")

    monkeypatch.setattr(trees, "bin_matrix", broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            scorer.score_batch(records[:4])
    assert scorer.fused_backend == "torch"
