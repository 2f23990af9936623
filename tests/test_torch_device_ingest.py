"""The ingestion layer's device paths: the torch package against the JAX
package's, on the CPU.

* ``readers.fast_csv.DeviceCSVIngest(..., device="cpu")`` against the
  reference's ``to_device()`` on the same CSVs: many chunks, a missing
  cell and a literal ``nan``, a header-only and an empty file, unicode
  digits, the quarantine and strict modes; X, mask and rows bit-equal.
  The pump itself: a producer's exception re-raised, a consumer failure
  that drains the producer, the card as the default device.
* ``readers.arrow_ingest.DeviceParquetIngest`` likewise on Parquet files
  (pyarrow on this host).
* ``examples.synthetic.synthetic_design_matrix_device``: torch's draws,
  so held on distribution, not bits, against the reference's generator
  at 200k rows (per column: 0.02 absolute on the 0/1 columns and the
  label, 1% relative on age, height and weight, 0.01 absolute on the
  Poisson counts; mean and standard deviation each), the same metadata,
  and the planted-truth gate of ``tests/test_planted_truth.py`` on an LR
  fit of the port's matrix at 150k rows.
* ``selector.validator.OpCrossValidation.validate`` on a tensor and on its
  numpy twin: the same winner, parameters and fold metrics, exactly.
"""
import csv as _csv
import io
import threading

import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, mod

ft_ref = mod(REF, "types.feature_types")
ft_port = mod(PORT, "types.feature_types")


@pytest.fixture(scope="module")
def native_csv():
    for pkg in (REF, PORT):
        if not mod(pkg, "readers.fast_csv").fast_path_available():
            pytest.skip(f"{pkg}'s native CSV scanner is not available")


def _write(tmp_path, text: str, name: str = "t.csv") -> str:
    p = tmp_path / name
    p.write_bytes(text.encode("utf-8"))
    return str(p)


def _csv_text(header, rows) -> str:
    buf = io.StringIO()
    w = _csv.writer(buf)
    if header is not None:
        w.writerow(header)
    w.writerows(rows)
    return buf.getvalue()


def _ingest_both(path, columns, kinds, **kw):
    """(reference, port) results of DeviceCSVIngest(...).to_device() and
    the ingests; ``kinds`` names each column's feature type."""
    out = []
    for pkg, ftm in ((REF, ft_ref), (PORT, ft_port)):
        schema = {c: getattr(ftm, kinds[c]) for c in columns}
        extra = {"device": "cpu"} if pkg == PORT else {}
        ing = mod(pkg, "readers.fast_csv").DeviceCSVIngest(
            path, columns, schema, **kw, **extra)
        out.append((ing.to_device(), ing))
    return out


def _assert_bit_equal(ref_out, port_out):
    (Xr, Mr, nr), (Xp, Mp, np_) = ref_out, port_out
    assert isinstance(Xp, torch.Tensor) and isinstance(Mp, torch.Tensor)
    assert Xp.dtype == torch.float32 and Mp.dtype == torch.bool
    assert np_ == nr
    Xr, Mr = np.asarray(Xr), np.asarray(Mr)
    assert Xp.shape == Xr.shape and Mp.shape == Mr.shape
    np.testing.assert_array_equal(Xp.numpy(), Xr)
    np.testing.assert_array_equal(Mp.numpy(), Mr)


def test_many_chunks_and_missing_cells_equal_the_reference(native_csv,
                                                           tmp_path):
    """2 000 rows through 4 KB chunks (dozens of blocks in the double
    buffer), an empty cell, a literal ``nan`` cell and a skipped text
    column: bit-equal, and a missing cell is 0 with mask False."""
    rng = np.random.RandomState(0)
    n = 2000
    M = rng.randn(n, 3)
    rows = []
    for i in range(n):
        rows.append([f"{M[i, 0]:.6f}", "" if i == 17 else f"{M[i, 1]:.6f}",
                     "text", "nan" if i == 1999 else f"{M[i, 2]:.6f}"])
    path = _write(tmp_path, _csv_text(["x1", "x2", "skip", "x3"], rows))
    (ref, _), (port, _) = _ingest_both(
        path, ["x1", "x2", "x3"], dict.fromkeys(["x1", "x2", "x3"], "Real"),
        chunk_bytes=4096)
    _assert_bit_equal(ref, port)
    X, mask, rows_read = port
    assert rows_read == n and X.shape == (n, 3)
    assert not bool(mask[17, 1]) and float(X[17, 1]) == 0.0
    assert not bool(mask[1999, 2]) and float(X[1999, 2]) == 0.0
    assert int(mask.sum()) == 3 * n - 2


@pytest.mark.parametrize("has_header", [True, False])
@pytest.mark.parametrize("text", ["a,b\n", ""], ids=["header-only", "empty"])
def test_header_only_and_empty_files(native_csv, tmp_path, text, has_header):
    """A header-only file gives zero-row tensors of the right width; a
    file without the columns (empty, or a header read as data) raises the
    reference's KeyError."""
    path = _write(tmp_path, text)
    kinds = {"a": "Real", "b": "Real"}
    if text and has_header:
        (ref, _), (port, _) = _ingest_both(path, ["a", "b"], kinds,
                                           has_header=has_header)
        _assert_bit_equal(ref, port)
        assert port[0].shape == (0, 2) and port[2] == 0
        return
    for pkg, ftm in ((REF, ft_ref), (PORT, ft_port)):
        extra = {"device": "cpu"} if pkg == PORT else {}
        ing = mod(pkg, "readers.fast_csv").DeviceCSVIngest(
            path, ["a", "b"], {"a": ftm.Real, "b": ftm.Real},
            has_header=has_header, **extra)
        with pytest.raises(KeyError, match="not in CSV"):
            ing.to_device()


@pytest.mark.parametrize("chunk_bytes", [64, 1 << 20])
def test_unicode_digit_cells(native_csv, tmp_path, chunk_bytes):
    """Unicode decimal digits parse as python's float() does (the masked
    cell retry), ASCII junk and the Arabic decimal separator stay masked,
    through small and large chunks (reference tests/test_fast_csv.py
    ``test_unicode_digit_cells_match_python_float`` and
    ``test_device_ingest_unicode_digit_parity``)."""
    rows = [["1", "١٢٣", "x"], ["2", "4.5", "Ünïcødé"], ["3", "junk", "y"],
            ["4", "٢٫٥", "z"], ["5", "", "w"]]
    path = _write(tmp_path, _csv_text(["id", "v", "t"], rows))
    (ref, _), (port, _) = _ingest_both(
        path, ["id", "v"], {"id": "Integral", "v": "Real"},
        chunk_bytes=chunk_bytes)
    _assert_bit_equal(ref, port)
    X, mask, _ = port
    assert X[:, 1].tolist() == [123.0, 4.5, 0.0, 0.0, 0.0]
    assert mask[:, 1].tolist() == [True, True, False, False, False]


def test_quarantine_and_strict_modes(native_csv, tmp_path):
    """``errors="quarantine"`` drops the type-flipped rows from the blocks
    and records them; ``"strict"`` raises MalformedRowError in the
    consumer and counts it in the caller's telemetry (reference
    tests/test_data_plane.py ``test_device_csv_ingest_quarantine``)."""
    path = str(tmp_path / "d.csv")
    truth = mod(PORT, "testkit.random_data").write_corrupted_csv(
        path, n_rows=200, n_type_flips=4, n_truncated=0, seed=5)
    kinds = {"y": "Real", "a": "Real"}
    (ref, ing_ref), (port, ing_port) = _ingest_both(
        path, ["y", "a"], kinds, errors="quarantine", chunk_bytes=1024)
    _assert_bit_equal(ref, port)
    assert port[2] == truth["good_rows"]
    assert ing_port.quarantine.total == ing_ref.quarantine.total \
        == len(truth["type_flip_rows"])
    assert sorted(q.row_index for q in ing_port.quarantine.rows) \
        == sorted(q.row_index for q in ing_ref.quarantine.rows) \
        == truth["type_flip_rows"]
    quarantine = mod(PORT, "schema.quarantine")
    tel = quarantine.DataTelemetry()
    ing = mod(PORT, "readers.fast_csv").DeviceCSVIngest(
        path, ["y", "a"], {"y": ft_port.Real, "a": ft_port.Real},
        errors="strict", telemetry=tel, device="cpu")
    with pytest.raises(quarantine.MalformedRowError) as exc:
        ing.to_device()
    assert exc.value.row_index == truth["type_flip_rows"][0]
    assert tel.snapshot()["strict_errors"] == 1


def test_the_pump_reraises_and_drains():
    """A producer's exception is re-raised by the consumer after the
    blocks before it; a failure in the consumer lets the producer run to
    its end (no thread left blocked on the full queue)."""
    pump = mod(PORT, "readers.fast_csv").double_buffered_to_device
    block = (np.ones((3, 2), np.float32), np.ones((3, 2), bool))

    def failing(q):
        q.put(block)
        q.put(ValueError("bad chunk"))

    with pytest.raises(ValueError, match="bad chunk"):
        pump(failing, 2, device="cpu")

    finished = threading.Event()

    def chatty(q):
        # the consumer fails on this one: torch has no object dtype
        q.put((np.ones((3, 2), object), np.ones((3, 2), bool)))
        for _ in range(8):              # more than the queue holds
            q.put(block)
        q.put(None)
        finished.set()

    with pytest.raises(TypeError):
        pump(chatty, 2, device="cpu")
    assert finished.wait(timeout=10)

    X, mask, rows = pump(lambda q: q.put(None), 5, device="cpu")
    assert X.shape == mask.shape == (0, 5) and rows == 0
    assert X.dtype == torch.float32 and mask.dtype == torch.bool


def test_the_card_is_the_default_device(tmp_path):
    """Every entry point of the layer defaults to CUDA and raises without
    it, before any thread starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    path = _write(tmp_path, "a\n1\n")
    fast_csv = mod(PORT, "readers.fast_csv")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fast_csv.DeviceCSVIngest(path, ["a"], {"a": ft_port.Real})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fast_csv.double_buffered_to_device(lambda q: q.put(None), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod(PORT, "readers.arrow_ingest").DeviceParquetIngest(path, ["a"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod(PORT, "examples.synthetic").synthetic_design_matrix_device(10)


# -- Parquet -------------------------------------------------------------------

def _parquet_both(path, columns, **kw):
    out = []
    for pkg in (REF, PORT):
        extra = {"device": "cpu"} if pkg == PORT else {}
        ing = mod(pkg, "readers.arrow_ingest").DeviceParquetIngest(
            path, columns, **kw, **extra)
        out.append((ing.to_device(), ing))
    return out


def test_parquet_ingest_equals_the_reference(tmp_path):
    """Nulls and NaNs masked and zeroed, an integer column cast, many
    batches: bit-equal."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    rng = np.random.RandomState(1)
    n = 1000
    x0 = rng.randn(n)
    x0[[3, 500]] = np.nan
    x1 = [None if i % 13 == 0 else float(v)
          for i, v in enumerate(rng.rand(n))]
    x2 = rng.randint(0, 9, n)
    path = str(tmp_path / "p.parquet")
    pq.write_table(pa.table({"x0": x0, "x1": x1, "x2": x2, "s": ["u"] * n}),
                   path, row_group_size=300)
    (ref, _), (port, _) = _parquet_both(path, ["x0", "x1", "x2"],
                                        batch_rows=128)
    _assert_bit_equal(ref, port)
    X, mask, rows = port
    assert rows == n
    assert not mask[3, 0] and not mask[13, 1] and float(X[13, 1]) == 0.0


def test_parquet_quarantine_and_strict(tmp_path):
    """A string-typed numeric column: the junk cell's row is quarantined
    (bit-equal to the reference), strict raises (reference
    tests/test_data_plane.py ``test_arrow_device_ingest_quarantine``)."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"x0": [1.0, 2.0, 3.0, 4.0],
                             "x1": ["0.5", "nope", "1.5", "2.5"]}), path)
    (ref, ing_ref), (port, ing_port) = _parquet_both(
        path, ["x0", "x1"], errors="quarantine")
    _assert_bit_equal(ref, port)
    assert port[2] == 3
    assert ing_port.quarantine.total == 1
    assert ing_port.quarantine.rows[0].column == "x1"
    assert ing_port.quarantine.rows[0].row_index \
        == ing_ref.quarantine.rows[0].row_index == 1
    ingest = mod(PORT, "readers.arrow_ingest")
    with pytest.raises(mod(PORT, "schema.quarantine").MalformedRowError):
        ingest.DeviceParquetIngest(path, ["x0", "x1"], errors="strict",
                                   device="cpu").to_device()


# -- the on-device design matrix ----------------------------------------------

def _column_stats(X) -> tuple:
    X = np.asarray(X, np.float64)
    return X.mean(axis=0), X.std(axis=0)


def test_device_matrix_matches_the_reference_in_distribution():
    n, dims = 200_000, 32
    Xp, yp, meta_p = mod(PORT, "examples.synthetic") \
        .synthetic_design_matrix_device(n, text_dims=dims, device="cpu")
    Xr, yr, meta_r = mod(REF, "examples.synthetic") \
        .synthetic_design_matrix_device(n, text_dims=dims)
    assert isinstance(Xp, torch.Tensor) and Xp.dtype == torch.float32
    assert Xp.device.type == "cpu" and tuple(Xp.shape) == (n, 7 + dims)
    assert isinstance(yp, np.ndarray) and yp.dtype == np.float64
    assert yp.shape == (n,) and set(np.unique(yp)) <= {0.0, 1.0}
    # the same metadata as the host generator's (and the reference's)
    meta_host = mod(PORT, "examples.synthetic").synthetic_design_matrix(
        100, text_dims=dims)[2]
    names = [c.column_name() for c in meta_p.columns]
    assert names == [c.column_name() for c in meta_host.columns] \
        == [c.column_name() for c in meta_r.columns]
    (mp, sp), (mr, sr) = _column_stats(Xp.numpy()), _column_stats(Xr)
    binary = [1, 4, 5, 6]            # the null indicator, the three genders
    real = [0, 2, 3]                 # age (imputed), height, weight
    counts = list(range(7, 7 + dims))
    np.testing.assert_allclose(mp[binary], mr[binary], rtol=0, atol=0.02)
    np.testing.assert_allclose(sp[binary], sr[binary], rtol=0, atol=0.02)
    np.testing.assert_allclose(mp[real], mr[real], rtol=0.01, atol=0)
    np.testing.assert_allclose(sp[real], sr[real], rtol=0.01, atol=0)
    np.testing.assert_allclose(mp[counts], mr[counts], rtol=0, atol=0.01)
    np.testing.assert_allclose(sp[counts], sr[counts], rtol=0, atol=0.01)
    assert abs(yp.mean() - yr.mean()) <= 0.02
    # the structure: one gender a row, the indicator where age was imputed
    Xn = Xp.numpy()
    np.testing.assert_array_equal(Xn[:, 4:7].sum(axis=1), 1.0)
    imputed = Xn[:, 1] == 1.0
    assert np.unique(Xn[imputed, 0]).size == 1
    assert np.array_equal(Xn[:, 7:], np.round(Xn[:, 7:]))
    # seeded: the same seed gives the same draws, another seed others
    X2, y2, _ = mod(PORT, "examples.synthetic") \
        .synthetic_design_matrix_device(1000, text_dims=4, device="cpu")
    X3, y3, _ = mod(PORT, "examples.synthetic") \
        .synthetic_design_matrix_device(1000, text_dims=4, device="cpu")
    X4, _, _ = mod(PORT, "examples.synthetic") \
        .synthetic_design_matrix_device(1000, seed=7, text_dims=4,
                                        device="cpu")
    assert torch.equal(X2, X3) and np.array_equal(y2, y3)
    assert not torch.equal(X2, X4)


def _lr_report(X, y, meta, reg_param: float):
    """(planted_truth_report, AuROC) of the port's LR fitted on (X, y) and
    scored on the same rows, as the reference's gate does it."""
    est = mod(PORT, "models.logistic_regression").OpLogisticRegression(
        reg_param=reg_param, max_iter=25, device="cpu")
    params = est.fit_arrays(X, y)
    pred, raw, prob = est.predict_arrays(params, X)
    m = mod(PORT, "evaluators.binary").OpBinaryClassificationEvaluator() \
        .evaluate_arrays(y, mod(PORT, "types.columns").PredictionColumn(
            pred, raw, prob))
    return (mod(PORT, "examples.synthetic").planted_truth_report(
        params["beta"], meta, float(m.AuROC)), float(m.AuROC))


def test_device_matrix_recovers_the_planted_truth():
    """The gate of the reference's tests/test_planted_truth.py on the
    port's device matrix (150k rows on the CPU): an LR fit recovers the
    planted coefficients within their windows and lands within 0.012 of
    the observable Bayes AuROC, never above it by more than 0.008."""
    synth = mod(PORT, "examples.synthetic")
    X, y, meta = synth.synthetic_design_matrix_device(
        150_000, text_dims=8, device="cpu")
    report, auroc = _lr_report(X, y, meta, 1e-3)
    assert report["ok"], report
    assert 0.025 <= report["age_coef"] <= 0.032
    assert -0.022 <= report["height_coef"] <= -0.016
    assert 1.40 <= report["female_vs_male"] <= 1.60
    assert abs(report["weight_coef"]) < 0.005
    assert abs(report["other_vs_male"]) < 0.05
    assert abs(report["auroc_gap"]) < 0.012
    assert auroc <= synth.BAYES_AUROC_OBSERVED + 0.008


def test_planted_truth_report_is_the_reference_s():
    """The copied constants and report: equal to the reference's on the
    same coefficients, and a wrong coefficient vector fails the gate."""
    synth_p, synth_r = (mod(pkg, "examples.synthetic") for pkg in (PORT, REF))
    assert synth_p.PLANTED == synth_r.PLANTED
    assert synth_p.BAYES_AUROC_OBSERVED == synth_r.BAYES_AUROC_OBSERVED
    meta_p = synth_p.synthetic_design_matrix(100, text_dims=4)[2]
    meta_r = synth_r.synthetic_design_matrix(100, text_dims=4)[2]
    rng = np.random.RandomState(3)
    for beta, auroc in ((np.zeros(meta_p.size), 0.5),
                        (np.array([0.03, 0.1, -0.02, 0.001, -0.4, 1.2, -0.4,
                                   0.0, 0.0, 0.0, 0.0]), 0.745),
                        (rng.randn(meta_p.size) * 0.01, 0.74)):
        assert synth_p.planted_truth_report(beta, meta_p, auroc) \
            == synth_r.planted_truth_report(beta, meta_r, auroc)
    assert not synth_p.planted_truth_report(
        np.zeros(meta_p.size), meta_p, 0.5)["ok"]


# -- validate on a tensor ------------------------------------------------------

@pytest.mark.parametrize("rank_metrics", ["exact", "approx"])
def test_validate_on_a_tensor_equals_its_numpy_twin(monkeypatch,
                                                    rank_metrics):
    """OpCrossValidation.validate over LR (the batched fold x grid fit)
    and a GBT grid (a host family): a float32 tensor and its numpy twin
    give the same winner, parameters and fold metrics, exactly, under
    either rank-metric mode."""
    monkeypatch.setenv("TX_CV_RANK_METRICS", rank_metrics)
    X, y, _ = mod(PORT, "examples.synthetic").synthetic_design_matrix_device(
        6_000, text_dims=4, device="cpu")
    lr = mod(PORT, "models.logistic_regression").OpLogisticRegression(
        device="cpu")
    gbt = mod(PORT, "models.trees").OpGBTClassifier(device="cpu")
    grid_lr = mod(PORT, "selector.factories").lr_grid()
    grid_gbt = [{"max_depth": 2, "num_trees": 3}]
    results = []
    for Xin in (X, X.numpy().copy()):
        cv = mod(PORT, "selector.validator").OpCrossValidation(
            num_folds=3, stratify=True, device="cpu",
            evaluator=mod(PORT, "evaluators.binary")
            .OpBinaryClassificationEvaluator())
        results.append(cv.validate([(lr, grid_lr), (gbt, grid_gbt)], Xin, y))
    got, want = results
    assert got.best_estimator.model_type == want.best_estimator.model_type
    assert got.best_params == want.best_params
    assert got.best_metric == want.best_metric
    assert len(got.all_results) == len(grid_lr) + len(grid_gbt)
    for g, w in zip(got.all_results, want.all_results):
        assert (g["model_type"], g["params"], g["rank_metric_mode"]) \
            == (w["model_type"], w["params"], w["rank_metric_mode"])
        assert g["fold_metrics"] == w["fold_metrics"]
    modes = {r["model_type"]: r["rank_metric_mode"] for r in got.all_results}
    assert modes["OpLogisticRegression"] == rank_metrics
