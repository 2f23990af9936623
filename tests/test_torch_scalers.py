"""The torch package's scalers (``ops/scalers.py``) against the JAX
package's: ``FillMissingWithMean``, ``OpScalarStandardScaler`` and
``PercentileCalibrator`` fit the same models and give bit-equal columns,
also on an all-missing and on a constant column; the partial-fit merge
equals the one-shot fit."""
import numpy as np
import pytest

from torch_parity import PORT, REF, mod

N = 2000


def _column(pkg: str, values: np.ndarray, mask: np.ndarray):
    cols, ft = mod(pkg, "types.columns"), mod(pkg, "types.feature_types")
    return cols.NumericColumn(np.where(mask, values, 0.0), mask.copy(), ft.Real)


def _cases():
    rng = np.random.RandomState(7)
    vals = rng.normal(40.0, 13.0, N)
    return {
        "some_missing": (vals, rng.rand(N) > 0.1),
        "all_missing": (vals, np.zeros(N, bool)),
        "constant": (np.full(N, 3.25), np.ones(N, bool)),
        "ties": (np.round(vals / 5.0) * 5.0, rng.rand(N) > 0.3),
    }


def _fit(pkg: str, stage_name: str, values, mask, **kw):
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ds_mod = mod(pkg, "types.dataset")
    x = fb.Real("x").as_predictor()
    stage = getattr(mod(pkg, "ops.scalers"), stage_name)(**kw)
    out = stage.set_input(x).get_output()
    ds = ds_mod.Dataset({"x": _column(pkg, values, mask)})
    model = stage.fit(ds)
    return stage, model, model.transform(ds)[out.name]


STAGES = [("FillMissingWithMean", {}), ("FillMissingWithMean", {"default": 2.5}),
          ("OpScalarStandardScaler", {}),
          ("OpScalarStandardScaler", {"with_mean": False, "with_std": False}),
          ("PercentileCalibrator", {}), ("PercentileCalibrator", {"buckets": 7})]


@pytest.mark.parametrize("case", list(_cases()))
@pytest.mark.parametrize("stage_name,kw", STAGES,
                         ids=[f"{s}-{i}" for i, (s, _) in enumerate(STAGES)])
def test_scaler_models_and_columns_bit_equal(stage_name, kw, case):
    values, mask = _cases()[case]
    _, m_ref, c_ref = _fit(REF, stage_name, values, mask, **kw)
    _, m_port, c_port = _fit(PORT, stage_name, values, mask, **kw)
    assert type(m_port).__name__ == type(m_ref).__name__
    for attr in ("fill", "mean", "std", "buckets"):
        if hasattr(m_ref, attr):
            assert getattr(m_port, attr) == getattr(m_ref, attr), attr
    if hasattr(m_ref, "splits"):
        np.testing.assert_array_equal(m_port.splits, m_ref.splits)
    np.testing.assert_array_equal(c_port.values, c_ref.values)
    np.testing.assert_array_equal(c_port.mask, c_ref.mask)
    assert c_port.feature_type.__name__ == c_ref.feature_type.__name__ \
        == "RealNN"


@pytest.mark.parametrize("stage_name", ["FillMissingWithMean",
                                        "OpScalarStandardScaler"])
@pytest.mark.parametrize("case", ["some_missing", "constant", "all_missing"])
def test_partial_fit_merge_equals_one_shot_fit(stage_name, case):
    """Chunk statistics merged in order are the JAX package's bit for bit,
    and the JAX package's streamed fit from them gives the model the
    port's one-shot fit gives (up to the rounding of a different
    summation order)."""
    values, mask = _cases()[case]
    merged = {}
    for pkg in (REF, PORT):
        stage = getattr(mod(pkg, "ops.scalers"), stage_name)()
        ds_mod = mod(pkg, "types.dataset")
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        stage.set_input(fb.Real("x").as_predictor())
        stats = []
        for lo in range(0, N, 300):
            chunk = ds_mod.Dataset({"x": _column(
                pkg, values[lo:lo + 300], mask[lo:lo + 300])})
            stats.append(stage.partial_fit_chunk(stage.input_columns(chunk),
                                                 chunk))
        merged[pkg] = stage._merge_partial_fits(stats)
    assert merged[PORT] == merged[REF]
    ref_stage, _, _ = _fit(REF, stage_name, values, mask)
    ref_stage.accept_partial_fits([merged[PORT]])
    empty = mod(REF, "types.dataset").Dataset(
        {"x": _column(REF, values[:0], mask[:0])})
    streamed = ref_stage.fit(empty)
    _, one_shot, _ = _fit(PORT, stage_name, values, mask)
    for attr in ("fill", "mean", "std"):
        if hasattr(one_shot, attr):
            np.testing.assert_allclose(getattr(streamed, attr),
                                       getattr(one_shot, attr),
                                       rtol=1e-12, atol=1e-12)
