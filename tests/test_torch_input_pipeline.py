"""The sharded input pipeline and streaming ingest, port against reference.

Ports the contracts of ``tests/test_input_pipeline.py`` and the pipeline
case of ``tests/test_avro_streaming.py`` onto ``transmogrifai_tpu_torch.
readers.pipeline``, each on the same shards written from a seed with
numpy and read by both packages:

* pipelined columns, chunk ids, order keys, quarantine counts and the
  stacked design matrix: bit-equal to the reference's;
* streamed fold masks (``StreamingFoldBuilder``): bit-equal to the
  reference's and to the batch masks under shuffled arrival;
* ``OpLinearRegression.fit_from_stats``: betas within rtol 1e-12 of the
  reference's (both float64 numpy);
* a streamed ``train()``: the streamed scaler, imputer and indexer
  statistics and the design matrix bit-equal to the reference's streamed
  train, betas within rtol 1e-4 (centred, ``torch_parity.identified``);
* ``validate_stream``: the same selection as the reference's, CV means
  within 1e-5;
* a device fault raised in a worker reaches the consumer as itself.

The reference's 4-worker throughput floor is left out: walls belong to
the card phase (``chip_smoke.py`` ``[ops]``).
"""
import csv
import io
import time

import numpy as np
import pytest

from torch_parity import (
    DEVICE_FAULTS,
    PORT,
    REF,
    identified,
    mod,
    reset_uids,
)

N_FOLDS = 3


@pytest.fixture(autouse=True)
def _disarm_faults():
    for pkg in (REF, PORT):
        mod(pkg, "faults.injection").reset()
    yield
    for pkg in (REF, PORT):
        mod(pkg, "faults.injection").reset()


def _pl(pkg):
    return mod(pkg, "readers.pipeline")


def _ft(pkg):
    return mod(pkg, "types.feature_types")


def _write_shards(tmp_path, nshards=4, rows=2_000, d=3, seed=0,
                  prefix="s"):
    r = np.random.RandomState(seed)
    paths = []
    for s in range(nshards):
        M = r.randn(rows, d)
        buf = io.StringIO()
        np.savetxt(buf, M, delimiter=",", fmt="%.6f")
        p = str(tmp_path / f"{prefix}{s}.csv")
        with open(p, "w") as f:
            f.write(",".join(f"x{i}" for i in range(d)) + "\n")
            f.write(buf.getvalue())
        paths.append(p)
    return paths


def _schema(pkg, d=3):
    return {f"x{i}": _ft(pkg).Real for i in range(d)}


def _columns_state(cols):
    return {n: (np.asarray(c.values), np.asarray(c.mask))
            for n, c in cols.items()}


# -- determinism seam --------------------------------------------------------

def test_pipelined_columns_bit_equal_to_reference_and_serial(tmp_path):
    paths = _write_shards(tmp_path)
    got = {}
    for pkg in (REF, PORT):
        pl = _pl(pkg)
        pipe = pl.InputPipeline(pl.shard(paths), _schema(pkg), workers=4,
                                chunk_bytes=1 << 15)
        got[pkg] = _columns_state(pl.pipelined_columns(pipe))
    serial = [mod(PORT, "readers.fast_csv").read_csv_columnar(
        p, _schema(PORT)) for p in paths]
    for name in _schema(PORT):
        for pkg in (REF, PORT):
            v, m = got[pkg][name]
            assert np.array_equal(
                v, np.concatenate([c[name].values for c in serial]))
            assert np.array_equal(
                m, np.concatenate([c[name].mask for c in serial]))
        assert got[PORT][name][0].dtype == got[REF][name][0].dtype


def test_chunk_ids_and_ordered_mode_match_reference(tmp_path):
    paths = _write_shards(tmp_path, nshards=5)
    # an empty shard (header only) must not wedge ordered reassembly
    empty = str(tmp_path / "empty.csv")
    with open(empty, "w") as f:
        f.write("x0,x1,x2\n")
    paths.insert(2, empty)
    seen = {}
    for pkg in (REF, PORT):
        pl = _pl(pkg)
        pipe = pl.InputPipeline(pl.shard(paths), _schema(pkg), workers=3,
                                chunk_bytes=1 << 14, ordered=True)
        seen[pkg] = [(pc.order_key, pc.n_rows) for pc in pipe.chunks()]
    keys = [k for k, _ in seen[PORT]]
    assert keys == sorted(keys)
    assert len({k[0] for k in keys}) == 5  # every non-empty shard
    assert all(k[0] != 2 for k in keys)  # the empty shard has no chunks
    assert seen[PORT] == seen[REF]


def test_design_matrix_bit_equal_any_arrival_order(tmp_path):
    paths = _write_shards(tmp_path, nshards=6, rows=1_500)
    cols = list(_schema(PORT))
    mats = []
    for pkg in (REF, PORT):
        pl = _pl(pkg)
        for workers in (1, 4):
            pipe = pl.InputPipeline(pl.shard(paths), _schema(pkg),
                                    workers=workers, chunk_bytes=1 << 14)
            X, M, n = pl.pipelined_design_matrix(pipe, cols)
            assert n == 9_000
            mats.append((X, M))
    for X, M in mats[1:]:
        assert X.dtype == np.float32
        assert np.array_equal(X, mats[0][0]) and np.array_equal(M, mats[0][1])


def test_stack_chunk_columns_bit_equal(tmp_path):
    paths = _write_shards(tmp_path, nshards=1, rows=500)
    cols = list(_schema(PORT))
    blocks = {}
    for pkg in (REF, PORT):
        pl = _pl(pkg)
        pipe = pl.InputPipeline(pl.shard(paths), _schema(pkg), workers=1)
        blocks[pkg] = [pl.stack_chunk_columns(pc.payload, cols)
                       for pc in pipe.chunks()]
    assert len(blocks[PORT]) == len(blocks[REF]) >= 1
    for a, b in zip(blocks[PORT], blocks[REF]):
        assert np.array_equal(a, b)
    block, _ = mod(PORT, "readers.fast_csv").chunk_to_block(
        next(_pl(PORT).InputPipeline(
            _pl(PORT).shard(paths), _schema(PORT)).chunks()).payload, cols)
    assert np.allclose(blocks[PORT][0].T, block, atol=1e-6)


def test_streamed_fold_masks_bit_equal_shuffled_arrival():
    y = (np.random.RandomState(5).rand(10_000) > 0.6).astype(float)
    X = np.random.RandomState(6).randn(10_000, 3).astype(np.float32)
    want = mod(REF, "selector.validator").stratified_kfold_masks(
        y, 4, seed=11, stratify=True)
    step = 1_000
    order = list(range(0, 10_000, step))
    np.random.RandomState(7).shuffle(order)  # arrival != source order
    for pkg in (REF, PORT):
        for stratify in (True, False):
            fb = mod(pkg, "selector.validator").StreamingFoldBuilder(
                4, seed=11, stratify=stratify)
            for at in order:
                fb.observe((0, at // step), X[at:at + step], y[at:at + step])
            Xf, yf, masks = fb.finalize()
            batch = mod(pkg, "selector.validator").stratified_kfold_masks(
                y, 4, seed=11, stratify=stratify)
            assert np.array_equal(masks, batch)
            if stratify:
                assert np.array_equal(masks, want)
            assert np.array_equal(yf, y) and np.array_equal(Xf, X)


# -- quarantine under concurrency --------------------------------------------

def _quarantine_doc(buf):
    return (buf.total, dict(buf.by_reason),
            [r.to_json() for r in buf.rows])


def test_quarantine_counts_match_reference_multi_shard(tmp_path):
    nshards, rows, flips = 5, 400, 17
    paths, truths = [], []
    for s in range(nshards):
        p = str(tmp_path / f"bad{s}.csv")
        truths.append(mod(PORT, "testkit.random_data").write_corrupted_csv(
            p, n_rows=rows, n_type_flips=flips, n_truncated=0, seed=50 + s))
        paths.append(p)
    docs = {}
    for pkg in (REF, PORT):
        pl, ft = _pl(pkg), _ft(pkg)
        schema = {"y": ft.Real, "a": ft.Real, "c": ft.Text}
        pipe = pl.InputPipeline(pl.shard(paths), schema, workers=4,
                                errors="quarantine", chunk_bytes=1 << 13,
                                quarantine_max_rows=1 << 16)
        kept = sum(pc.n_rows for pc in pipe.chunks())
        docs[pkg] = (kept, _quarantine_doc(pipe.merged_quarantine()))
    kept, (total, by_reason, rows_) = docs[PORT]
    assert total == nshards * flips and kept == nshards * (rows - flips)
    assert by_reason == {"type_flip": nshards * flips}
    assert sorted(r["row_index"] for r in rows_) == sorted(
        s * rows + r for s, t in enumerate(truths)
        for r in t["type_flip_rows"])
    assert docs[PORT] == docs[REF]


def test_quarantine_python_path_ragged_rows_match_reference(tmp_path):
    """The python fallback shard reader owns ragged-row detection the
    native scanner cannot do: counts stay exact through the pipeline."""
    nshards, rows = 3, 300
    paths = []
    for s in range(nshards):
        p = str(tmp_path / f"rag{s}.csv")
        mod(PORT, "testkit.random_data").write_corrupted_csv(
            p, n_rows=rows, n_type_flips=4, n_truncated=6, seed=70 + s)
        paths.append(p)
    docs = {}
    for pkg in (REF, PORT):
        pl, ft = _pl(pkg), _ft(pkg)
        schema = {"y": ft.Real, "a": ft.Real, "c": ft.Text}
        pipe = pl.InputPipeline(pl.shard(paths), schema, workers=3,
                                errors="quarantine", chunk_rows=64,
                                use_native=False,
                                quarantine_max_rows=1 << 16)
        kept = sum(pc.n_rows for pc in pipe.chunks())
        docs[pkg] = (kept, _quarantine_doc(pipe.merged_quarantine()))
    kept, (total, by_reason, _) = docs[PORT]
    assert total == nshards * 10 and kept == nshards * (rows - 10)
    assert by_reason == {"type_flip": nshards * 4,
                         "truncated_row": nshards * 6}
    assert docs[PORT] == docs[REF]


def test_fault_points_fire_inside_worker_shards(tmp_path):
    """reader.malformed_row / reader.type_flip armed while 4 workers parse
    concurrently: times=K bounds the fires across ALL workers, no hang,
    clean drain."""
    paths = _write_shards(tmp_path, nshards=4, rows=500)
    pl = _pl(PORT)
    mod(PORT, "faults.injection").configure(
        "reader.type_flip:every=1:times=3 "
        "reader.malformed_row:every=1:times=2"
    )
    pipe = pl.InputPipeline(pl.shard(paths), _schema(PORT), workers=4,
                            errors="quarantine", chunk_bytes=1 << 13,
                            quarantine_max_rows=1 << 16)
    t0 = time.perf_counter()
    kept = sum(pc.n_rows for pc in pipe.chunks())
    assert time.perf_counter() - t0 < 60
    merged = pipe.merged_quarantine()
    # the two points can co-fire on the same chunk's row 0 (one row, one
    # reason recorded): the injected rows are between the max and the sum
    assert 3 <= merged.total <= 5
    assert kept == 2_000 - merged.total
    assert set(merged.by_reason) <= {"type_flip", "malformed_row"}


def test_strict_mode_error_names_shard_and_file(tmp_path):
    paths = _write_shards(tmp_path, nshards=3, rows=200)
    bad = str(tmp_path / "s1.csv")  # corrupt the middle shard
    with open(bad, "a") as f:
        f.write("junk_cell,1.0,2.0\n")
    pl = _pl(PORT)
    pipe = pl.InputPipeline(pl.shard(paths), _schema(PORT), workers=3,
                            errors="strict", chunk_bytes=1 << 13)
    with pytest.raises(pl.ShardIngestError) as exc:
        for _ in pipe.chunks():
            pass
    assert exc.value.shard_id == 1 and exc.value.path == bad
    assert isinstance(exc.value.cause,
                      mod(PORT, "schema.quarantine").MalformedRowError)
    assert all(not t.is_alive() for t in pipe._threads)


def test_producer_crash_drains_cleanly_no_hang(tmp_path):
    """A worker crash (unreadable shard) surfaces as ShardIngestError
    naming the shard and file; the bounded queue drains and every worker
    joins."""
    paths = _write_shards(tmp_path, nshards=4, rows=800)
    paths[2] = str(tmp_path / "missing.csv")  # ENOENT mid-fleet
    pl = _pl(PORT)
    pipe = pl.InputPipeline(pl.shard(paths), _schema(PORT), workers=2,
                            buffer_chunks=1, chunk_bytes=1 << 12)
    t0 = time.perf_counter()
    with pytest.raises(pl.ShardIngestError) as exc:
        for _ in pipe.chunks():
            pass
    assert time.perf_counter() - t0 < 60
    assert exc.value.shard_id == 2 and "missing.csv" in str(exc.value)
    assert all(not t.is_alive() for t in pipe._threads)
    assert pipe._queue.qsize() == 0  # drained


@pytest.mark.parametrize("make_fault", DEVICE_FAULTS)
def test_device_fault_in_a_worker_reaches_the_consumer_as_itself(
        tmp_path, make_fault):
    """A device fault raised by a worker-side ``transform=`` is forwarded
    unwrapped (every caller's is_device_fault rule must see it), and the
    workers still drain and join; an ordinary error stays wrapped."""
    paths = _write_shards(tmp_path, nshards=3, rows=400)
    pl = _pl(PORT)
    fault = make_fault()

    def transform(chunk):
        raise fault

    pipe = pl.InputPipeline(pl.shard(paths), _schema(PORT), workers=2,
                            chunk_bytes=1 << 12, transform=transform)
    with pytest.raises(type(fault)) as exc:
        for _ in pipe.chunks():
            pass
    assert exc.value is fault
    assert all(not t.is_alive() for t in pipe._threads)

    def broken(chunk):
        raise ValueError("not a device fault")

    pipe = pl.InputPipeline(pl.shard(paths), _schema(PORT), workers=2,
                            transform=broken)
    with pytest.raises(pl.ShardIngestError):
        for _ in pipe.chunks():
            pass


def test_consumer_abandonment_stops_workers(tmp_path):
    paths = _write_shards(tmp_path, nshards=4, rows=2_000)
    pl = _pl(PORT)
    pipe = pl.InputPipeline(pl.shard(paths), _schema(PORT), workers=4,
                            buffer_chunks=1, chunk_bytes=1 << 12)
    it = pipe.chunks()
    next(it)
    it.close()  # GeneratorExit mid-stream
    assert all(not t.is_alive() for t in pipe._threads)
    with pytest.raises(RuntimeError, match="single-use"):
        next(pipe.chunks())


def test_parquet_and_avro_shards_interleave_like_reference(tmp_path):
    """A mixed CSV + Parquet + Avro shard list lands one column set,
    bit-equal to the reference's (pyarrow is on this host only: the card
    phase reads CSV and Avro shards)."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    r = np.random.RandomState(21)
    vals = {s: r.randn(500, 2) for s in range(3)}
    csv_p = str(tmp_path / "m0.csv")
    with open(csv_p, "w") as f:
        f.write("x0,x1\n")
        np.savetxt(f, vals[0], delimiter=",", fmt="%.6f")
    pq_p = str(tmp_path / "m1.parquet")
    pq.write_table(pa.table({"x0": vals[1][:, 0], "x1": vals[1][:, 1]}),
                   pq_p)
    av_p = str(tmp_path / "m2.avro")
    cfl = mod(PORT, "types.columns").column_from_list
    mod(PORT, "readers.avro_reader").save_dataset_avro(
        mod(PORT, "types.dataset").Dataset({
            "x0": cfl(vals[2][:, 0], _ft(PORT).Real),
            "x1": cfl(vals[2][:, 1], _ft(PORT).Real),
        }), av_p)
    got = {}
    for pkg in (REF, PORT):
        pl = _pl(pkg)
        schema = {"x0": _ft(pkg).Real, "x1": _ft(pkg).Real}
        pipe = pl.InputPipeline(pl.shard([csv_p, pq_p, av_p]), schema,
                                workers=3, chunk_rows=200)
        got[pkg] = _columns_state(pl.pipelined_columns(pipe))
    want = np.concatenate([vals[s][:, 0] for s in range(3)])
    assert len(got[PORT]["x0"][0]) == 1_500
    assert np.allclose(got[PORT]["x0"][0], want, atol=1e-5)
    for name in ("x0", "x1"):
        for a, b in zip(got[PORT][name], got[REF][name]):
            assert np.array_equal(a, b)


def test_avro_shard_checked_modes_match_reference(tmp_path):
    """Avro shards count type flips exactly like the reference's pipeline
    and its serial avro route: strict raises, quarantine drops."""
    av = str(tmp_path / "flip.avro")
    mod(PORT, "readers.avro_reader").save_dataset_avro(
        mod(PORT, "types.dataset").Dataset({
            "x0": mod(PORT, "types.columns").column_from_list(
                ["1.5", "junk", "2.5", "alsojunk", "3.5"], _ft(PORT).Text),
        }), av)
    docs = {}
    for pkg in (REF, PORT):
        pl = _pl(pkg)
        schema = {"x0": _ft(pkg).Real}
        pipe = pl.InputPipeline(pl.shard([av]), schema, workers=1,
                                errors="quarantine")
        kept = sum(pc.n_rows for pc in pipe.chunks())
        docs[pkg] = (kept, _quarantine_doc(pipe.merged_quarantine()))
        pipe2 = pl.InputPipeline(pl.shard([av]), schema, workers=1,
                                 errors="strict")
        with pytest.raises(pl.ShardIngestError) as exc:
            for _ in pipe2.chunks():
                pass
        assert isinstance(exc.value.cause,
                          mod(pkg, "schema.quarantine").MalformedRowError)
        assert exc.value.cause.row_index == 1
    kept, (total, by_reason, rows_) = docs[PORT]
    assert kept == 3 and total == 2 and by_reason == {"type_flip": 2}
    assert sorted(r["row_index"] for r in rows_) == [1, 3]
    assert docs[PORT] == docs[REF]


def test_pipeline_avro_shard_streams_with_damage_like_reference(tmp_path):
    """A damaged Avro shard (the reference's ``test_avro_streaming``
    pipeline case): exact quarantine counts and the same kept rows, bit
    for bit, in both packages."""
    from test_avro_streaming import (
        PIPE_SCHEMA,
        WANTED,
        _flip_byte,
        _records,
        _sync_positions,
        _write,
    )

    recs = _records(180, seed=9)
    p = _write(tmp_path / "pipe.avro", recs, block_records=30)
    syncs, _ = _sync_positions(p)
    _flip_byte(p, syncs[3])  # blocks 3+4 (records 60..119) roll back
    got = {}
    for pkg in (REF, PORT):
        pl = _pl(pkg)
        schema = {k: getattr(_ft(pkg), v.__name__)
                  for k, v in PIPE_SCHEMA.items()}
        pipe = pl.InputPipeline(pl.shard([p]), schema, wanted=WANTED,
                                workers=1, chunk_rows=16,
                                errors="quarantine")
        chunks = [(pc.order_key, pc.payload.n_rows) for pc in pipe.chunks()]
        got[pkg] = (chunks, _quarantine_doc(pipe.merged_quarantine()))
    chunks, (total, by_reason, _) = got[PORT]
    assert sum(n for _, n in chunks) == 120
    assert total == 1 and by_reason == {"corrupt_block": 1}
    assert got[PORT] == got[REF]


# -- workflow streaming ingest ----------------------------------------------

def _csv_workflow_shards(tmp_path, nshards=3, rows=400):
    r = np.random.RandomState(9)
    paths = []
    for s in range(nshards):
        p = str(tmp_path / f"wf{s}.csv")
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["y", "a", "cat"])
            for i in range(rows):
                a = r.randn()
                y = float(a + 0.3 * r.randn() > 0)
                w.writerow([
                    y, "" if i % 13 == 0 else f"{a:.6f}",
                    ("u", "v", "w")[int(r.randint(3))],
                ])
        paths.append(p)
    return paths


def _wf(pkg, reader):
    """The reference test's streaming workflow: FillMissingWithMean and
    StringIndexer on raw features (their partial fits arm), a standard
    scaler on the imputed column (it does not), transmogrify -> LR."""
    reset_uids(pkg)
    kw = {"device": "cpu"} if pkg == PORT else {}
    ft = _ft(pkg)
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    scalers = mod(pkg, "ops.scalers")
    y = fb(ft.RealNN, "y").as_response()
    a = fb(ft.Real, "a").as_predictor()
    cat = fb(ft.Text, "cat").as_predictor()
    am = scalers.FillMissingWithMean().set_input(a).get_output()
    asc = scalers.OpScalarStandardScaler().set_input(am).get_output()
    ci = mod(pkg, "ops.categorical").StringIndexer().set_input(
        cat).get_output()
    vec = mod(pkg, "ops.transmogrifier").transmogrify([asc, ci])
    pred = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        reg_param=0.1, **kw).set_input(y, vec).get_output()
    wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw) \
        .set_result_features(pred).set_reader(reader)
    return wf, pred, vec


def _stage_stats(model):
    by_type = {type(s).__name__: s for s in model.stages}
    return (by_type["_FillMeanModel"].fill, by_type["_ScaleModel"].mean,
            by_type["_ScaleModel"].std,
            tuple(by_type["StringIndexerModel"].labels))


def _pipelined_reader(pkg, paths, **kw):
    return _pl(pkg).PipelinedCSVReader(paths, **kw)


def test_streamed_train_matches_reference_and_serial(tmp_path):
    """A streamed train (the imputer's and indexer's statistics
    accumulated while shards parse) in both packages: the fitted
    statistics and the design matrix bit-equal to the reference's
    streamed train, betas within rtol 1e-4 (centred), and the port's
    streamed fit equal to its serial fit over the concatenated file."""
    paths = _csv_workflow_shards(tmp_path)
    concat = str(tmp_path / "all.csv")
    with open(concat, "w") as out:
        out.write("y,a,cat\n")
        for p in paths:
            with open(p) as f:
                next(f)
                out.write(f.read())
    models = {}
    for pkg in (REF, PORT):
        wf, pred, vec = _wf(pkg, _pipelined_reader(
            pkg, paths, workers=3, chunk_rows=128, chunk_bytes=1 << 12))
        model = wf.train()
        models[pkg] = (model, wf, vec, model.score())
    m_p, wf_p, vec_p, sc_p = models[PORT]
    m_r, _, vec_r, sc_r = models[REF]
    assert _stage_stats(m_p) == _stage_stats(m_r)
    # the streamed fits armed on the two raw-input stages, not the scaler
    armed = {type(s).__name__ for s in m_p.stages
             if s.uid in set(wf_p.last_streamed_fits)}
    assert armed == {"_FillMeanModel", "StringIndexerModel"}
    X_p = np.asarray(sc_p[vec_p.name].values)
    X_r = np.asarray(sc_r[vec_r.name].values)
    assert np.array_equal(X_p, X_r)
    b_p, c_p = identified(m_p, sc_p, vec_p.name)
    b_r, c_r = identified(m_r, sc_r, vec_r.name)
    np.testing.assert_allclose(b_p, b_r, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c_p, c_r, rtol=1e-4, atol=1e-5)
    # the port's serial reader over the concatenated data fits the same
    # statistics (to the float64 rounding of a different summation order)
    ft = _ft(PORT)
    wf_s, _, _ = _wf(PORT, mod(PORT, "readers.csv_reader").CSVReader(
        concat, schema={"y": ft.RealNN, "a": ft.Real, "cat": ft.Text}))
    s = _stage_stats(wf_s.train())
    got = _stage_stats(m_p)
    assert s[0] == pytest.approx(got[0], rel=1e-12)
    assert s[1] == pytest.approx(got[1], rel=1e-12)
    assert s[2] == pytest.approx(got[2], rel=1e-9)
    assert s[3] == got[3]


def test_streaming_is_leakage_gated_by_the_holdout(tmp_path):
    """With a reserved holdout the stream still feeds the train, but no
    partial fit arms: every estimator fits from the materialized split."""
    paths = _csv_workflow_shards(tmp_path, nshards=2, rows=200)
    wf, _, _ = _wf(PORT, _pipelined_reader(PORT, paths, workers=2))
    wf.set_parameters(reserve_test_fraction=0.2)
    model = wf.train()
    assert wf.last_streamed_fits == []
    assert len(model._train_data_cache) == 320
    wf, _, _ = _wf(PORT, _pipelined_reader(PORT, paths, workers=2))
    wf.set_parameters(streaming_ingest=False)
    assert not wf._streaming_eligible()


def test_partial_fit_stats_are_one_shot():
    """A fold refit after a streamed fit re-observes its own data, never
    silently reusing full-data statistics (leakage guard)."""
    ft = _ft(PORT)
    est = mod(PORT, "ops.scalers").FillMissingWithMean()
    a = mod(PORT, "features.feature_builder").FeatureBuilder(
        ft.Real, "a").as_predictor()
    est.set_input(a)
    est.accept_partial_fits([(2, 10.0), (2, 30.0)])
    ds = mod(PORT, "types.dataset").Dataset({
        "a": mod(PORT, "types.columns").NumericColumn(
            np.array([1.0, 2.0]), np.array([True, True]), ft.Real)})
    assert est.fit(ds).fill == pytest.approx(10.0)  # streamed (10+30)/4
    assert est.fit(ds).fill == pytest.approx(1.5)  # consumed: the data


def test_runner_pipelined_ingest_knob_matches_reference(tmp_path):
    paths = _csv_workflow_shards(tmp_path, nshards=2, rows=200)
    caches = {}
    for pkg in (REF, PORT):
        wf, _, vec = _wf(pkg, None)
        runner = mod(pkg, "workflow.runner").OpWorkflowRunner(wf)
        params = mod(pkg, "workflow.params").OpParams(custom_params={
            "ingest_shards": paths, "ingest_workers": 2,
        })
        res = runner.run("train", params)
        caches[pkg] = np.asarray(
            res.model._train_data_cache[vec.name].values)
    assert len(caches[PORT]) == 400
    assert np.array_equal(caches[PORT], caches[REF])


def test_streaming_zero_rows_keeps_the_schema(tmp_path):
    """Header-only shards stream to 0-row columns of the raw features'
    types (the batch path's shape), not a column-less dataset."""
    p = str(tmp_path / "empty.csv")
    with open(p, "w") as f:
        f.write("y,a,cat\n")
    wf, _, _ = _wf(PORT, _pipelined_reader(PORT, [p], workers=1))
    raw = wf._ingest_streaming()
    assert sorted(raw.column_names()) == ["a", "cat", "y"]
    assert len(raw) == 0


# -- streamed sufficient-statistics fit --------------------------------------

def test_linreg_fit_from_stats_matches_reference():
    r = np.random.RandomState(13)
    n, d = 20_000, 6
    X = r.randn(n, d).astype(np.float32)
    beta = r.randn(d)
    y = X @ beta + 0.05 * r.randn(n)
    fits = {}
    for pkg in (REF, PORT):
        cls = mod(pkg, "models.linear_regression").OpLinearRegression
        kw = {"device": "cpu"} if pkg == PORT else {}
        est = cls(reg_param=1e-3, elastic_net_param=0.2, **kw)
        stats = [cls.streaming_fit_stats(X[at:at + 2_500], y[at:at + 2_500])
                 for at in range(0, n, 2_500)]
        fits[pkg] = (est.fit_from_stats(stats), est.fit_arrays(X, y))
    streamed, batch = fits[PORT]
    np.testing.assert_allclose(streamed["beta"], fits[REF][0]["beta"],
                               rtol=1e-12, atol=0)
    assert streamed["intercept"] == pytest.approx(
        fits[REF][0]["intercept"], rel=1e-12, abs=0)
    assert np.allclose(batch["beta"], streamed["beta"], atol=1e-4)
    assert np.abs(streamed["beta"] - beta).max() < 0.05
    with pytest.raises(ValueError, match="at least one chunk"):
        mod(PORT, "models.linear_regression").OpLinearRegression(
            device="cpu").fit_from_stats([])


# -- validate_stream ---------------------------------------------------------

def test_validate_stream_matches_reference_and_batch():
    """Fold masks built chunk by chunk during ingest select what the batch
    path selects, and what the reference's validate_stream selects (CV
    means within 1e-5)."""
    r = np.random.RandomState(3)
    n, d = 6_000, 4
    X = r.randn(n, d).astype(np.float32)
    y = (X @ np.array([1.0, -0.5, 0.25, 0.0]) + 0.5 * r.randn(n)
         > 0).astype(float)
    grid = [{"reg_param": 1e-3}, {"reg_param": 1e-1}]
    step = 1_000
    order = list(range(0, n, step))
    np.random.RandomState(4).shuffle(order)
    results = {}
    for pkg in (REF, PORT):
        kw = {"device": "cpu"} if pkg == PORT else {}
        cv = mod(pkg, "selector.validator").OpCrossValidation(
            num_folds=N_FOLDS, stratify=True, **kw)
        cv.evaluator = mod(
            pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
        lr = mod(pkg, "models.logistic_regression").OpLogisticRegression(
            max_iter=15, **kw)
        chunks = (((0, at // step), X[at:at + step], y[at:at + step])
                  for at in order)
        results[pkg] = (cv.validate_stream([(lr, grid)], chunks),
                        cv.validate([(lr, grid)], X, y))
        assert cv._streamed_masks is None  # one-shot
    streamed, batch = results[PORT]
    assert streamed.best_params == batch.best_params
    assert streamed.best_metric == pytest.approx(batch.best_metric,
                                                 abs=1e-12)
    want = results[REF][0]
    assert streamed.best_params == want.best_params
    for got_r, want_r in zip(streamed.all_results, want.all_results):
        assert got_r["params"] == want_r["params"]
        assert abs(got_r["metric"] - want_r["metric"]) <= 1e-5


# -- observability -----------------------------------------------------------

def test_ingest_shard_spans_join_ambient_trace(tmp_path):
    obs_trace = mod(PORT, "obs.trace")
    paths = _write_shards(tmp_path, nshards=3, rows=300)
    tracer = obs_trace.reset_tracer()
    pl = _pl(PORT)
    with obs_trace.span("test.root") as root:
        for _ in pl.InputPipeline(pl.shard(paths), _schema(PORT),
                                  workers=3).chunks():
            pass
        trace_id = root.trace_id
    shard_spans = [s for s in tracer.spans(trace_id)
                   if s["name"] == "ingest.shard"]
    assert {s["attrs"]["shard"] for s in shard_spans} == {0, 1, 2}
    for s in shard_spans:
        assert s["attrs"]["rows"] == 300
        assert s["attrs"]["quarantined"] == 0
    obs_trace.reset_tracer()


def test_pipeline_gauges_and_knobs_registered(tmp_path):
    paths = _write_shards(tmp_path, nshards=2, rows=300)
    pl = _pl(PORT)
    pipe = pl.InputPipeline(pl.shard(paths), _schema(PORT), workers=2,
                            buffer_chunks=3)
    for _ in pipe.chunks():
        pass
    doc = mod(PORT, "obs.metrics").metrics_registry().to_json()["series"]
    assert "pipeline.buffer_depth" in doc
    assert doc["pipeline.chunks"]["value"] >= 2
    assert "pipeline.producer_stall_ms" in doc
    assert "pipeline.consumer_stall_ms" in doc
    snap = pipe.stats.snapshot()
    assert snap["knobs"] == {"workers": 2, "buffer_chunks": 3}
    assert snap["rows"] == 600 and set(snap["shards"]) == {0, 1}


def test_pipeline_imports_without_pyarrow():
    """The chip host has no pyarrow: the module and its CSV/Avro routes
    must not import it."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(_pl(PORT)))
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                   ast.ImportFrom))]
    names = {a.name for n in top for a in n.names} | {
        getattr(n, "module", None) or "" for n in top}
    assert not any("pyarrow" in x or "pandas" in x for x in names)
