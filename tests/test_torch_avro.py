"""Avro and Parquet readers and writers: the torch package's copies
against the JAX package's.

* The round trip of the JAX package's ``tests/test_avro_fuzz.py`` over its
  10-type random schema: each package writes the same dataset
  (``save_dataset_avro``), each file reads back in either package
  (``read_avro_records``) to the same schema and records, and the records
  hold the written values.
* The quarantine cases of ``tests/test_data_plane.py``: type-flipped Avro
  records, a truncated trailing block, a string-typed Parquet numeric;
  quarantined row indices equal to the reference's, strict raising the
  first offender.
* ``AvroReader``/``ParquetReader``/``csv_to_avro`` datasets equal to the
  reference's, and ``OpWorkflow.compute_data_up_to(path=)``'s file read
  back by ``AvroReader``.

Tolerances: exact, but the fuzz values the reference's own test compares
approximately (geolocations rtol 1e-9, map values and floats by
``pytest.approx``, ragged date lists to 0.5 ms).
"""
from __future__ import annotations

import numpy as np
import pytest

from tests.test_workflow_fuzz import _random_data
from torch_parity import PORT, REF, mod, passenger_slice, passengers, \
    reset_uids, workflow

AV = {pkg: mod(pkg, "readers.avro_reader") for pkg in (REF, PORT)}
FT = {pkg: mod(pkg, "types.feature_types") for pkg in (REF, PORT)}
FB = {pkg: mod(pkg, "features.feature_builder").FeatureBuilder
      for pkg in (REF, PORT)}

#: the fuzz schema of tests/test_workflow_fuzz.py: (type, column)
FUZZ_COLUMNS = [("Real", "amount"), ("Integral", "count"), ("Binary", "flag"),
                ("PickList", "color"), ("Text", "note"), ("Date", "joined"),
                ("DateList", "visits"), ("Geolocation", "site"),
                ("RealMap", "attrs"), ("MultiPickList", "tags")]


def _fuzz_dataset(pkg: str, data: dict):
    cols = mod(pkg, "types.columns")
    return mod(pkg, "types.dataset").Dataset({
        name: cols.column_from_list(data[name], getattr(FT[pkg], kind))
        for kind, name in FUZZ_COLUMNS})


def _check_record(rec: dict, cols: dict, i: int) -> None:
    """One read-back record against the written row, as the reference's
    fuzz test checks it."""
    for name, values in cols.items():
        want, got = values[i], rec.get(name)
        if want is None or (isinstance(want, (list, dict, set)) and not want):
            assert got in (None, [], {}), (name, i, got)
        elif name == "site":
            np.testing.assert_allclose(np.asarray(got, float),
                                       np.asarray(want, float), rtol=1e-9)
        elif name == "attrs":
            assert set(got) == set(want)
            for k in want:
                assert got[k] == pytest.approx(want[k])
        elif name == "tags":
            assert sorted(got) == sorted(want)
        elif name == "visits":
            np.testing.assert_allclose(np.asarray(got, float),
                                       np.asarray(want, float), rtol=0,
                                       atol=0.5)
        elif isinstance(want, float):
            assert got == pytest.approx(want)
        else:
            assert got == want, (name, i, got, want)


@pytest.mark.parametrize("seed,p_null", [(51, 0.1), (52, 0.4)])
def test_avro_roundtrip_fuzz_across_packages(tmp_path, seed, p_null):
    n = 60
    data = _random_data(np.random.RandomState(seed), n, p_null)
    paths, cols = {}, None
    for pkg in (REF, PORT):
        ds = _fuzz_dataset(pkg, data)
        paths[pkg] = str(tmp_path / f"{pkg}.avro")
        assert AV[pkg].save_dataset_avro(ds, paths[pkg]) == n
        written = {name: ds[name].to_list() for name in ds.column_names()}
        if cols is None:
            cols = written
        assert written == cols
    read = {}
    for writer in (REF, PORT):
        for reader in (REF, PORT):
            read[writer, reader] = AV[reader].read_avro_records(paths[writer])
    schema, records = read[PORT, PORT]
    assert len(records) == n
    for (w, r), (s, recs) in read.items():
        assert s == schema and recs == records, (w, r)
    for i, rec in enumerate(records):
        _check_record(rec, cols, i)


def _quarantine_features(pkg: str):
    fb, f = FB[pkg], FT[pkg]
    return [fb(f.RealNN, "y").as_response(), fb(f.Real, "a").as_predictor(),
            fb(f.PickList, "c").as_predictor()]


ROW_SCHEMA = {"type": "record", "name": "Row",
              "fields": [{"name": "y", "type": ["null", "double"]},
                         {"name": "a", "type": ["null", "string"]},
                         {"name": "c", "type": ["null", "string"]}]}


def _datasets(make_reader):
    """``make_reader(pkg)`` -> reader; (datasets, readers) by package, the
    two datasets equal."""
    ds, readers = {}, {}
    for pkg in (REF, PORT):
        readers[pkg] = make_reader(pkg)
        ds[pkg] = readers[pkg].generate_dataset(_quarantine_features(pkg))
    assert ds[PORT].column_names() == ds[REF].column_names()
    assert ds[PORT].to_pylists() == ds[REF].to_pylists()
    return ds, readers


def test_avro_quarantine_isolates_type_flips(tmp_path):
    recs = [{"y": float(i % 2), "a": str(i * 0.5), "c": "u"}
            for i in range(10)]
    recs[3]["a"] = "garbage!"
    recs[7]["a"] = "also-bad"
    path = str(tmp_path / "r.avro")
    AV[PORT].write_avro_records(path, ROW_SCHEMA, recs, codec="null")
    ds, readers = _datasets(
        lambda pkg: AV[pkg].AvroReader(path, errors="quarantine"))
    assert len(ds[PORT]) == 8
    q = readers[PORT].quarantine
    assert q.total == 2 == readers[REF].quarantine.total
    assert sorted(r.row_index for r in q.rows) == [3, 7]
    assert all(r.reason == "type_flip" and r.column == "a" for r in q.rows)
    quarantine = mod(PORT, "schema.quarantine")
    with pytest.raises(quarantine.MalformedRowError) as exc:
        AV[PORT].AvroReader(path, errors="strict").generate_dataset(
            _quarantine_features(PORT))
    assert exc.value.row_index == 3
    ds, _ = _datasets(lambda pkg: AV[pkg].AvroReader(path))
    assert len(ds[PORT]) == 10 and ds[PORT]["a"].to_list()[3] is None


def test_avro_truncated_file_quarantines_its_tail(tmp_path):
    recs = [{"y": 1.0, "a": "1.5", "c": "u"} for _ in range(50)]
    path = str(tmp_path / "blocks.avro")
    AV[PORT].write_avro_records(path, ROW_SCHEMA, recs, codec="null",
                                block_records=16)
    with open(path, "rb") as f:
        data = f.read()
    cut = str(tmp_path / "cut.avro")
    with open(cut, "wb") as f:
        f.write(data[: len(data) - 40])        # chop mid final block
    read = AV[PORT].read_avro_records
    with pytest.raises((EOFError, IndexError, ValueError)):
        read(cut)
    with pytest.raises(mod(PORT, "schema.quarantine").MalformedRowError):
        read(cut, errors="strict")
    out = {}
    for pkg in (REF, PORT):
        buf = mod(pkg, "schema.quarantine").QuarantineBuffer(source=cut)
        out[pkg] = (AV[pkg].read_avro_records(cut, errors="quarantine",
                                              quarantine=buf), buf)
    (schema, got), buf = out[PORT]
    assert (schema, got) == out[REF][0]
    assert len(got) == 48 and buf.total == out[REF][1].total >= 1


def test_parquet_quarantine_string_typed_numeric(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    path = str(tmp_path / "p.parquet")
    pq.write_table(pa.table({"y": [1.0, 0.0, 1.0, 0.0],
                             "a": ["1.5", "junk", "2.5", None],
                             "c": ["u", "v", "w", "u"]}), path)
    ds, readers = _datasets(
        lambda pkg: AV[pkg].ParquetReader(path, errors="quarantine"))
    assert len(ds[PORT]) == 3
    q = readers[PORT].quarantine
    assert q.total == 1 and q.rows[0].row_index == 1
    assert q.rows[0].column == "a"
    with pytest.raises(mod(PORT, "schema.quarantine").MalformedRowError) \
            as exc:
        AV[PORT].ParquetReader(path, errors="strict").generate_dataset(
            _quarantine_features(PORT))
    assert exc.value.row_index == 1


def test_csv_to_avro_and_avro_reader_match_the_reference(tmp_path):
    """A README-columns CSV converted to Avro by each package, read back
    by each package's AvroReader: the same datasets."""
    csv = mod(PORT, "examples.synthetic").write_readme_csv(
        str(tmp_path / "p.csv"), 300)

    def features(pkg):
        fb, f = FB[pkg], FT[pkg]
        return [fb(f.RealNN, "survived").as_response(),
                fb(f.PickList, "sex").as_predictor(),
                fb(f.Real, "age").as_predictor(),
                fb(f.Real, "fare").as_predictor()]

    out = {}
    for writer in (REF, PORT):
        path = str(tmp_path / f"{writer}.avro")
        assert AV[writer].csv_to_avro(csv, path, features(writer)) == 300
        for reader in (REF, PORT):
            ds = AV[reader].AvroReader(path).generate_dataset(
                features(reader))
            out[writer, reader] = (ds.column_names(), ds.to_pylists())
    first = out[REF, REF]
    assert all(v == first for v in out.values())
    assert first[1]["age"].count(None) > 0


def test_compute_data_up_to_path_reads_back(tmp_path):
    """``OpWorkflow.compute_data_up_to(feature, path=)`` writes the
    dataset it returns; ``AvroReader`` reads its raw columns back equal."""
    reset_uids(PORT)
    survived, checked, pred = passenger_slice(PORT)
    wf = workflow(PORT, pred, passengers(PORT, 400))
    path = str(tmp_path / "upto.avro")
    data = wf.compute_data_up_to(checked, path=path)
    schema, records = AV[PORT].read_avro_records(path)
    assert len(records) == len(data) == 400
    docs = [f.get("doc", f["name"]) for f in schema["fields"]]
    assert docs == data.column_names()
    raw = AV[PORT].AvroReader(path).generate_dataset([survived])
    assert raw["survived"].to_list() == data["survived"].to_list()
