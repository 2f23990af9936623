"""The torch package's CSV reader (``readers/csv_reader.py``,
``readers/fast_csv.py``) and its native bridge (``utils/native.py``)
against the JAX package's: the same CSV gives bit-equal datasets (values
and masks) on the native route, on the python route and through
``infer_schema``; the checked modes raise and quarantine alike; the
reader's fault points fire alike; and the bridge builds its own library
under ``transmogrifai_tpu_torch/_build/`` and never writes ``native/``."""
import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import PORT, REF, mod

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_ROWS = 3000


def _features(pkg: str, with_text: bool = False):
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    feats = [fb(ft.RealNN, "survived").as_response(),
             fb(ft.PickList, "sex").as_predictor(),
             fb(ft.Real, "age").as_predictor(),
             fb(ft.Real, "fare").as_predictor()]
    if with_text:
        feats.append(fb(ft.Text, "note").as_predictor())
    return feats


def _assert_datasets_equal(a, b) -> None:
    assert sorted(a.columns()) == sorted(b.columns())
    assert len(a) == len(b)
    for name in a.columns():
        ca, cb = a[name], b[name]
        if hasattr(ca, "mask"):
            np.testing.assert_array_equal(np.asarray(ca.values),
                                          np.asarray(cb.values))
            np.testing.assert_array_equal(np.asarray(ca.mask),
                                          np.asarray(cb.mask))
        else:
            assert list(ca.to_list()) == list(cb.to_list()), name


@pytest.fixture(scope="module")
def readme_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("csv") / "passengers.csv"
    return mod(PORT, "examples.synthetic").write_readme_csv(str(path), N_ROWS)


@pytest.fixture(scope="module")
def tricky_csv(tmp_path_factory):
    """Quoted cells with commas, doubled quotes and embedded newlines, a
    BOM, literal nan and inf, unicode digits, junk numeric cells and
    empty cells."""
    rows = ['survived,sex,age,fare,note']
    notes = ['plain', '"a, b"', '"she said ""hi"""', '"two\nlines"', '',
             'ünïcode', '"x,""y"",\nz"']
    ages = ['34', '', 'nan', '١٢', 'junk', '-0.5', 'inf', '1e3']
    for i in range(400):
        rows.append(",".join([
            str(i % 2), ["male", "female", "", "other"][i % 4],
            ages[i % len(ages)], f"{170.0 + 0.37 * i!r}",
            notes[i % len(notes)]]))
    path = tmp_path_factory.mktemp("csv") / "tricky.csv"
    path.write_bytes(b"\xef\xbb\xbf" + ("\n".join(rows) + "\n").encode())
    return str(path)


def _read(pkg: str, path: str, with_text: bool = False, **kw):
    reader = mod(pkg, "readers.csv_reader").CSVReader(path, **kw)
    return reader, reader.generate_dataset(_features(pkg, with_text))


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("which", ["readme", "tricky"])
def test_datasets_bit_equal_to_reference(readme_csv, tricky_csv, which,
                                         use_native):
    path = readme_csv if which == "readme" else tricky_csv
    with_text = which == "tricky"
    if use_native:
        assert mod(PORT, "readers.fast_csv").fast_path_available()
    got = _read(PORT, path, with_text, use_native=use_native)[1]
    want = _read(REF, path, with_text, use_native=use_native)[1]
    _assert_datasets_equal(got, want)
    if which == "readme":
        assert len(got) == N_ROWS
        age = got["age"]
        assert 0 < int((~np.asarray(age.mask)).sum()) < N_ROWS // 5


def test_native_route_is_traced_and_matches_python_route(readme_csv):
    """The README CSV reads through the native scanner (one
    ``ingest.read`` span of format ``csv_native`` inside the reader's
    own span) and the two routes agree."""
    tr = mod(PORT, "obs.trace").reset_tracer()
    native = _read(PORT, readme_csv)[1]
    spans = {s["name"] + ":" + s["attrs"]["format"]: s for s in tr.spans()}
    assert set(spans) == {"ingest.read:csv", "ingest.read:csv_native"}
    assert spans["ingest.read:csv_native"]["parent"] == \
        spans["ingest.read:csv"]["span"]
    assert spans["ingest.read:csv"]["attrs"]["rows"] == N_ROWS
    assert spans["ingest.read:csv"]["attrs"]["route"] == "native"
    _assert_datasets_equal(native, _read(PORT, readme_csv,
                                         use_native=False)[1])


def test_infer_schema_matches_reference(readme_csv, tricky_csv):
    for path in (readme_csv, tricky_csv):
        got = mod(PORT, "readers.csv_reader").CSVReader(path).infer_schema()
        want = mod(REF, "readers.csv_reader").CSVReader(path).infer_schema()
        assert {k: v.__name__ for k, v in got.items()} == \
            {k: v.__name__ for k, v in want.items()}


@pytest.fixture(scope="module")
def bad_csv(tmp_path_factory):
    """A truncated row (row 3), a type flip in ``age`` (row 7) and an
    extra field (row 11) among clean rows."""
    rows = ["survived,sex,age,fare"]
    for i in range(20):
        cells = [str(i % 2), "male", str(20 + i), f"{150.5 + i}"]
        if i == 3:
            cells = cells[:3]
        elif i == 7:
            cells[2] = "forty"
        elif i == 11:
            cells.append("extra")
        rows.append(",".join(cells))
    path = tmp_path_factory.mktemp("csv") / "bad.csv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_strict_raises_like_reference(bad_csv):
    errs = []
    for pkg in (REF, PORT):
        q = mod(pkg, "schema.quarantine")
        with pytest.raises(q.MalformedRowError) as info:
            _read(pkg, bad_csv, errors="strict")
        e = info.value
        errs.append((e.row_index, e.reason, e.column, e.excerpt, str(e)))
    assert errs[0] == errs[1]
    assert errs[1][:3] == (3, "truncated_row", None)


def test_quarantine_keeps_and_counts_like_reference(bad_csv):
    out = []
    for pkg in (REF, PORT):
        reader, ds = _read(pkg, bad_csv, errors="quarantine")
        out.append((ds, reader.quarantine.snapshot()))
    (ds_ref, q_ref), (ds_port, q_port) = out
    _assert_datasets_equal(ds_port, ds_ref)
    assert q_port == q_ref
    assert len(ds_port) == 17 and q_port["total"] == 3
    assert q_port["by_reason"] == {"truncated_row": 1, "type_flip": 1,
                                   "extra_fields": 1}


@pytest.mark.parametrize("errors", ["strict", "quarantine"])
def test_native_checked_modes_match_reference(bad_csv, tmp_path, errors):
    """``read_csv_columnar``'s own checked modes (the scanner sees type
    flips; ragged rows are the python reader's) agree with the JAX
    package's on a CSV without ragged rows."""
    lines = pathlib.Path(bad_csv).read_text().splitlines()
    path = tmp_path / "flip.csv"
    path.write_text("\n".join(lines[:4] + lines[5:12] + lines[13:]) + "\n")
    out = []
    for pkg in (REF, PORT):
        ft = mod(pkg, "types.feature_types")
        schema = {"survived": ft.RealNN, "sex": ft.PickList,
                  "age": ft.Real, "fare": ft.Real}
        q = mod(pkg, "schema.quarantine")
        buf = q.QuarantineBuffer(source=str(path))
        call = lambda: mod(pkg, "readers.fast_csv").read_csv_columnar(  # noqa
            str(path), schema, errors=errors, quarantine=buf)
        if errors == "strict":
            with pytest.raises(q.MalformedRowError) as info:
                call()
            out.append((info.value.row_index, info.value.reason,
                        info.value.column, info.value.excerpt))
        else:
            cols = call()
            out.append(({k: (np.asarray(c.values).tolist(),
                             np.asarray(getattr(c, "mask", [])).tolist())
                         for k, c in cols.items()}, buf.snapshot()))
    assert out[0] == out[1]


def test_reader_fault_points_fire_alike(readme_csv):
    """``reader.malformed_row`` and ``reader.type_flip`` armed in both
    packages corrupt the same rows, which land in the same quarantine."""
    out = []
    for pkg in (REF, PORT):
        faults = mod(pkg, "faults")
        faults.configure("reader.malformed_row:on=5 reader.type_flip:on=9")
        try:
            reader, ds = _read(pkg, readme_csv, errors="quarantine")
        finally:
            faults.reset()
        out.append((ds, reader.quarantine.snapshot()))
    (ds_ref, q_ref), (ds_port, q_port) = out
    assert q_port == q_ref
    assert q_port["total"] == 2 and len(ds_port) == N_ROWS - 2
    assert {r["reason"] for r in q_port["rows"]} == {"truncated_row",
                                                     "type_flip"}
    _assert_datasets_equal(ds_port, ds_ref)


def test_native_load_fault_takes_the_python_route(readme_csv):
    """``native.load`` armed: the scanner reports itself unavailable and
    the reader reads through ``csv``, with the same dataset."""
    faults = mod(PORT, "faults")
    faults.configure("native.load")
    try:
        assert not mod(PORT, "readers.fast_csv").fast_path_available()
        tr = mod(PORT, "obs.trace").reset_tracer()
        reader, ds = _read(PORT, readme_csv)
    finally:
        faults.reset()
    assert reader.route == "python"
    (read_span,) = [s for s in tr.spans() if s["attrs"]["format"] == "csv"]
    assert read_span["attrs"]["route"] == "python"
    _assert_datasets_equal(ds, _read(REF, readme_csv, use_native=False)[1])


def _sha(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_bridge_builds_its_own_library():
    """The bridge loads ``transmogrifai_tpu_torch/_build/libtxkernels.so``
    and leaves ``native/libtxkernels.so`` as it was."""
    native_so = ROOT / "native" / "libtxkernels.so"
    before = _sha(native_so)
    bridge = mod(PORT, "utils.native")
    lib = bridge.get_lib()
    assert lib is not None
    want = ROOT / PORT / "_build" / "libtxkernels.so"
    assert pathlib.Path(bridge.lib_path()) == want
    assert pathlib.Path(lib._name) == want and want.exists()
    assert _sha(native_so) == before


_BUILD_CHILD = r"""
import sys
sys.modules["jax"] = None
from transmogrifai_tpu_torch.utils import native
src_dir, build_dir = sys.argv[1], sys.argv[2]
native._SRC = src_dir + "/txkernels.cpp"
native._SRC_TREES = src_dir + "/txtrees.cpp"
native.BUILD_DIR = build_dir
native._LIB = build_dir + "/libtxkernels.so"
lib = native.get_lib()
assert lib is not None and lib._name == native._LIB
assert native.csv_scan(b"1,2\n3,4\n", 2, [1, 1])[0] == 2
print("OK")
"""


def test_concurrent_builds_leave_one_whole_library(tmp_path, subprocess_env):
    """Four processes build at once into an empty build directory (the
    parallel test workers' case): each loads a whole library, no
    temporary file is left, and the sources' directory, with the
    JAX package's library in it, is not written."""
    src = tmp_path / "native"
    src.mkdir()
    for name in ("txkernels.cpp", "txtrees.cpp", "libtxkernels.so"):
        (src / name).write_bytes((ROOT / "native" / name).read_bytes())
    so = src / "libtxkernels.so"
    os.utime(so, (1_000_000_000, 1_000_000_000))  # older than its sources
    before = (so.stat().st_mtime_ns, _sha(so))
    build = tmp_path / "_build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_CHILD, str(src), str(build)],
        env=subprocess_env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0 and out.strip() == "OK", err[-2000:]
    assert sorted(os.listdir(build)) == ["libtxkernels.so"]
    assert (so.stat().st_mtime_ns, _sha(so)) == before
    assert sorted(os.listdir(src)) == ["libtxkernels.so", "txkernels.cpp",
                                       "txtrees.cpp"]
