"""Model save and load of the torch package against the JAX package's.

* A save -> load round trip of a small README workflow (the README's
  front, a model selector over logistic regression) re-scores
  bit-identically, interpreted and through ``score_function()``.
* The artifact document equals the JAX package's for the same workflow:
  ``format_version``, ``result_features``, ``raw_features``,
  ``blacklisted_raw``, and each stage's class short name,
  ``operation_name``, ``params`` and state keys.
* The cases of the JAX package's tests/test_model_io_corruption.py, run
  against this package's ``model_io``, and a kill mid-save in a child
  process (``TX_FAULTS="io.save_model.crash:on=1"`` and ``...crash_window``)
  that leaves the previous artifact loadable.
* ``interop.load_reference_artifact`` of an artifact the JAX package
  saved scores within each family's tolerance of the JAX package's own
  ``score()``.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import PORT, REF, SERVE_FAMILIES, mixed_pipeline, mod, \
    reset_uids

from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.interop import load_reference_artifact
from transmogrifai_tpu_torch.serialization import model_io
from transmogrifai_tpu_torch.testkit.drills import CRASH_SAVER_TEMPLATE
from transmogrifai_tpu_torch.serialization.model_io import (
    ARRAYS_NPZ,
    LAST_GOOD_SUFFIX,
    MANIFEST_JSON,
    MODEL_JSON,
    SCHEMA_JSON,
    ModelIntegrityError,
    ModelLoadError,
    load_model,
    verify_artifact,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_README = 400


# -- a small README workflow, in either package --------------------------------
def readme_workflow(pkg: str, csv: str):
    """README.md's front (``age.fill_missing_with_mean().z_normalize()``,
    ``transmogrify``, ``sanity_check``) and a selector over logistic
    regression's default grid, reading ``csv``; the torch package's on the
    CPU.  Returns (workflow, prediction name)."""
    reset_uids(pkg)
    mod(pkg, "dsl")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    fac = mod(pkg, "selector.factories")
    dev = {"device": "cpu"} if pkg == PORT else {}
    survived = fb(ft.RealNN, "survived").as_response()
    sex = fb(ft.PickList, "sex").as_predictor()
    age = fb(ft.Real, "age").as_predictor()
    fare = fb(ft.Real, "fare").as_predictor()
    normed_age = age.fill_missing_with_mean().z_normalize()
    features = mod(pkg, "ops.transmogrifier").transmogrify(
        [sex, age, fare, normed_age])
    checked = survived.sanity_check(features, remove_bad_features=True, **dev)
    lr = mod(pkg, "models.logistic_regression").OpLogisticRegression(**dev)
    pred = fac.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, models_and_parameters=[(lr, fac.lr_grid())], **dev,
    ).set_input(survived, checked).get_output()
    wf = mod(pkg, "workflow.workflow").OpWorkflow(**dev)
    wf.set_result_features(pred).set_reader(
        mod(pkg, "readers.csv_reader").CSVReader(csv))
    return wf, pred.name


@pytest.fixture(scope="module")
def readme(tmp_path_factory):
    """{pkg: (model, artifact path)} and the CSV's records."""
    root = tmp_path_factory.mktemp("readme_io")
    csv = mod(PORT, "examples.synthetic").write_readme_csv(
        str(root / "readme.csv"), N_README)
    mp = pytest.MonkeyPatch()
    mp.setenv("TX_PRODUCT_MESH", "0")
    out = {}
    try:
        for pkg in (REF, PORT):
            wf, _ = readme_workflow(pkg, csv)
            model = wf.train()
            path = str(root / f"model_{pkg}")
            model.save(path)
            out[pkg] = (model, path)
    finally:
        mp.undo()
    data = mod(PORT, "readers.csv_reader").CSVReader(csv).generate_dataset(
        out[PORT][0].raw_features, {})
    records = [
        {f.name: data[f.name].to_list()[i] for f in out[PORT][0].raw_features
         if not f.is_response}
        for i in range(60)
    ]
    return out, csv, data, records


def _port_scores(model, data):
    return model.score(data)[model.result_features[0].name].to_list()


def test_readme_round_trip_rescores_bit_identically(readme):
    out, csv, data, records = readme
    model, path = out[PORT]
    assert verify_artifact(path) is None
    assert os.path.exists(os.path.join(path, SCHEMA_JSON))
    assert not any(n.startswith("xla_cache") for n in os.listdir(path))
    wf, _ = readme_workflow(PORT, csv)
    loaded = model.load(path, wf)
    assert loaded.device == "cpu"
    assert loaded._train_data_cache is None  # scores without the caches
    assert _port_scores(loaded, data) == _port_scores(model, data)
    for backend in ("numpy", "torch"):
        before = model.score_function(fused_backend=backend)
        after = loaded.score_function(fused_backend=backend)
        assert after.fused_backend == backend and after.fused_reason is None
        assert after.score_batch(records) == before.score_batch(records)
    # the schema contract travels with the artifact
    assert loaded.schema_contract is not None
    assert loaded.schema_contract.to_json() == model.schema_contract.to_json()


def _doc(path: str) -> dict:
    with open(os.path.join(path, MODEL_JSON)) as f:
        return json.load(f)


def _stage_view(st: dict) -> dict:
    params = model_io._decode(st["params"], _NoArrays())
    return {
        "class": st["class"].rpartition(".")[2],
        "operation_name": st["operation_name"],
        "params": params,
        "state_keys": sorted(st["state"]["__dict__"]),
    }


class _NoArrays:
    def __getitem__(self, key):
        return f"<array {key}>"


def test_artifact_document_matches_reference(readme):
    out, _, _, _ = readme
    ref, port = _doc(out[REF][1]), _doc(out[PORT][1])
    for key in ("format_version", "result_features", "raw_features",
                "blacklisted_raw"):
        assert port[key] == ref[key], key
    assert len(port["stages"]) == len(ref["stages"])
    for sp, sr in zip(port["stages"], ref["stages"]):
        assert _stage_view(sp) == _stage_view(sr), sr["class"]
        if "estimator" in sr:
            assert sp["estimator"]["class"].rpartition(".")[2] == \
                sr["estimator"]["class"].rpartition(".")[2]
    with open(os.path.join(out[PORT][1], MANIFEST_JSON)) as f:
        files = json.load(f)["files"]
    assert sorted(files) == [ARRAYS_NPZ, MODEL_JSON, SCHEMA_JSON]


def test_saved_tensors_come_back_on_the_load_device(tmp_path):
    """State held as a torch tensor is written as numpy and restored as a
    tensor on the workflow's device."""
    import torch

    arrays: dict = {}
    enc = model_io._encode({"w": torch.arange(3.0), "a": np.ones(2)},
                           arrays, "s0")
    assert isinstance(arrays["s0.w"], np.ndarray)
    dec = model_io._decode(enc, arrays, "cpu")
    assert isinstance(dec["w"], torch.Tensor) and dec["w"].device.type == "cpu"
    assert dec["w"].tolist() == [0.0, 1.0, 2.0]
    assert isinstance(dec["a"], np.ndarray)


# -- the corruption cases (tests/test_model_io_corruption.py) -----------------
def tiny_pipeline(n: int = 100, seed: int = 1):
    """The JAX package's ``tiny_drill_pipeline`` in this package, on the
    CPU: (workflow, data)."""
    reset_uids(PORT)
    mod(PORT, "dsl")
    fb = mod(PORT, "features.feature_builder").FeatureBuilder
    ft = mod(PORT, "types.feature_types")
    rng = np.random.RandomState(seed)
    data = {
        "y": (rng.rand(n) > 0.5).astype(float).tolist(),
        "a": rng.randn(n).tolist(),
        "c": [("u", "v", "w")[i % 3] for i in range(n)],
    }
    y = fb(ft.RealNN, "y").as_response()
    a = fb(ft.Real, "a").as_predictor()
    c = fb(ft.PickList, "c").as_predictor()
    vec = mod(PORT, "ops.transmogrifier").transmogrify([a, c])
    pred = mod(PORT, "models.logistic_regression").OpLogisticRegression(
        reg_param=0.01).set_input(y, vec).get_output()
    wf = mod(PORT, "workflow.workflow").OpWorkflow(device="cpu")
    wf.set_result_features(pred).set_input_dataset(data)
    return wf, data


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One trained and saved artifact per module; cases copy it."""
    root = tmp_path_factory.mktemp("golden")
    wf, data = tiny_pipeline()
    path = str(root / "m")
    wf.train().save(path)
    return path, data


def _copy(saved_path, tmp_path):
    dst = str(tmp_path / "m")
    shutil.copytree(saved_path, dst)
    return dst


def _truncate(path: str, keep) -> None:
    with open(path, "r+b") as f:
        f.truncate(keep(os.path.getsize(path)))


def _case_truncated_npz(path, data):
    _truncate(os.path.join(path, ARRAYS_NPZ), lambda s: s // 2)
    err = verify_artifact(path)
    assert err is not None and "truncated" in err
    with pytest.raises(ModelIntegrityError, match="truncated"):
        load_model(path, tiny_pipeline()[0])


def _case_bitflipped_json(path, data):
    jpath = os.path.join(path, MODEL_JSON)
    with open(jpath, "r+b") as f:
        f.seek(os.path.getsize(jpath) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x40]))  # same length, different bytes
    err = verify_artifact(path)
    assert err is not None and "SHA-256" in err
    with pytest.raises(ModelIntegrityError, match="SHA-256"):
        load_model(path, tiny_pipeline()[0])


def _case_missing_npz_key(path, data):
    npz_path = os.path.join(path, ARRAYS_NPZ)
    with np.load(npz_path, allow_pickle=False) as npz:
        arrays = {k: npz[k] for k in npz.files}
    dropped = sorted(arrays)[0]
    arrays.pop(dropped)
    np.savez_compressed(npz_path, **arrays)
    # recompute the manifest so only the key mismatch remains detectable
    with open(npz_path, "rb") as f:
        blob = f.read()
    mpath = os.path.join(path, MANIFEST_JSON)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["files"][ARRAYS_NPZ] = {
        "sha256": hashlib.sha256(blob).hexdigest(), "bytes": len(blob),
    }
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ModelLoadError) as exc:
        load_model(path, tiny_pipeline()[0])
    msg = str(exc.value)
    assert dropped in msg and ARRAYS_NPZ in msg
    assert "KeyError" not in msg


def _case_recovers_from_last_good(path, data):
    shutil.copytree(path, path + LAST_GOOD_SUFFIX)
    _truncate(os.path.join(path, ARRAYS_NPZ), lambda s: s - 10)
    model = load_model(path, tiny_pipeline()[0])
    scored = model.score(data)
    assert len(next(iter(scored.columns().values()))) == len(data["y"])


def _case_both_corrupt(path, data):
    shutil.copytree(path, path + LAST_GOOD_SUFFIX)
    for p in (path, path + LAST_GOOD_SUFFIX):
        _truncate(os.path.join(p, ARRAYS_NPZ), lambda s: s // 2)
    with pytest.raises(ModelIntegrityError, match="last-good"):
        load_model(path, tiny_pipeline()[0])


def _case_missing_manifest_legacy(path, data):
    os.remove(os.path.join(path, MANIFEST_JSON))
    assert verify_artifact(path) is None
    assert load_model(path, tiny_pipeline()[0]) is not None


def _case_legacy_corrupt_npz(path, data):
    os.remove(os.path.join(path, MANIFEST_JSON))
    _truncate(os.path.join(path, ARRAYS_NPZ), lambda s: s // 2)
    with pytest.raises(ModelLoadError):
        load_model(path, tiny_pipeline()[0])


def _case_publish_by_copy(path, data):
    tmp = path + ".tmp-12345"
    shutil.copytree(path, tmp)
    model_io._publish_by_copy(tmp, path, path + LAST_GOOD_SUFFIX,
                              reason="drill")
    assert verify_artifact(path) is None
    assert verify_artifact(path + LAST_GOOD_SUFFIX) is None
    assert not os.path.isdir(tmp)


CORRUPTION_CASES = {
    "truncated_npz_refused": _case_truncated_npz,
    "bitflipped_model_json_refused": _case_bitflipped_json,
    "missing_npz_key_names_stage_and_file": _case_missing_npz_key,
    "corrupt_primary_recovers_from_last_good": _case_recovers_from_last_good,
    "both_artifacts_corrupt_is_loud": _case_both_corrupt,
    "missing_manifest_is_legacy_tolerated": _case_missing_manifest_legacy,
    "legacy_corrupt_npz_raises_model_load_error": _case_legacy_corrupt_npz,
    "publish_by_copy_fallback_verifies": _case_publish_by_copy,
}


@pytest.mark.parametrize("case", list(CORRUPTION_CASES))
def test_corrupt_artifacts(case, saved, tmp_path):
    CORRUPTION_CASES[case](_copy(saved[0], tmp_path), saved[1])


def test_crashed_save_tempdirs_are_reaped(tmp_path):
    """Tempdirs of a dead writer go at the next save; a live writer's
    stays."""
    wf, _ = tiny_pipeline()
    model = wf.train()
    path = str(tmp_path / "m")
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    dead = f"{path}.tmp-{proc.pid}"        # provably dead pid
    live = f"{path}.tmp-{os.getppid()}"    # provably live pid
    for d in (dead, live):
        os.makedirs(d)
        open(os.path.join(d, "model.json"), "w").close()
    model.save(path)
    assert not os.path.isdir(dead)
    assert os.path.isdir(live)
    assert verify_artifact(path) is None


def test_swap_save_carries_colocated_extras(tmp_path):
    wf, _ = tiny_pipeline()
    model = wf.train()
    path = str(tmp_path / "m")
    model.save(path)
    with open(os.path.join(path, "summary.json"), "w") as f:
        f.write('{"kept": true}')
    model.save(path)  # the swap carries the extra forward
    assert os.path.exists(os.path.join(path, "summary.json"))
    assert verify_artifact(path) is None
    assert verify_artifact(path + LAST_GOOD_SUFFIX) is None


def test_roundtrip_scores_match_after_swap_save(tmp_path):
    wf, data = tiny_pipeline()
    model = wf.train()
    path = str(tmp_path / "m")
    model.save(path)
    model.save(path)
    before = _port_scores(model, data)
    m2 = load_model(path, tiny_pipeline()[0])
    assert _port_scores(m2, data) == before


#: the kill-during-save child: the port's testkit template (the tiny
#: drill pipeline on the CPU, the same stages as ``tiny_pipeline``)
CRASH_SAVER = CRASH_SAVER_TEMPLATE

@pytest.mark.parametrize("point", [
    "io.save_model.crash", "io.save_model.crash_window",
])
def test_kill_during_save_leaves_loadable_artifact(tmp_path, point):
    path = str(tmp_path / "m")
    script = tmp_path / "saver.py"
    script.write_text(CRASH_SAVER.format(
        repo=REPO, tests=os.path.join(REPO, "tests"), path=path,
        fault=f"{point}:on=1"))
    env = dict(os.environ)
    env.pop("TX_FAULTS", None)
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          timeout=300)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT  # really crashed
    if point == "io.save_model.crash":
        # death inside the tempdir write: v1 in place, verified
        assert verify_artifact(path) is None
    else:
        # death between the swap renames: last-good holds v1
        assert not os.path.isdir(path)
        assert verify_artifact(path + LAST_GOOD_SUFFIX) is None
    wf, data = tiny_pipeline()
    m2 = load_model(path, wf)
    assert len(_port_scores(m2, data)) == len(data["y"])


# -- weights carried across from the JAX package's artifact --------------------
#: probability / prediction tolerance of the torch package's interpreted
#: scores against the JAX package's ``score()`` on the same weights: the
#: JAX package scores linear heads in float32 on its device path
SCORE_ATOL = {"lr": 1e-6, "nb": 1e-5, "svc": 1e-9, "linreg": 1e-5,
              "rf": 1e-6, "gbt": 1e-6, "rf_reg": 1e-5, "gbt_reg": 1e-5,
              "glm": 1e-9, "mlp": 1e-6}


@pytest.mark.parametrize("family", list(SERVE_FAMILIES))
def test_load_reference_artifact_scores_like_reference(family, tmp_path):
    reset_uids(REF)
    ref_wf, records, pred_name = mixed_pipeline(REF, family)
    ref_model = ref_wf.train()
    ref_model.save(str(tmp_path / "ref"))
    reset_uids(PORT)
    port_wf, _, _ = mixed_pipeline(PORT, family)
    port_model = load_reference_artifact(str(tmp_path / "ref"), port_wf)
    assert port_model.device == "cpu"
    assert port_model.schema_contract is not None
    data = ref_wf._input_data
    want = ref_model.score(data)[pred_name]
    got = port_model.score(data)[pred_name]
    for field in ("prediction", "raw_prediction", "probability"):
        w, g = getattr(want, field, None), getattr(got, field, None)
        if w is None:
            assert g is None, field
            continue
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64),
                                   rtol=0, atol=SCORE_ATOL[family])


def test_load_model_refuses_a_reference_artifact(tmp_path, monkeypatch):
    """``load_model`` imports no class the artifact names outside the torch
    package: a JAX-package artifact is refused before any import, and
    ``interop.load_reference_artifact`` reads it, with jax and the JAX
    package unimportable throughout."""
    reset_uids(REF)
    ref_wf, _, pred_name = mixed_pipeline(REF, "lr")
    ref_wf.train().save(str(tmp_path / "ref"))
    for name in list(sys.modules):
        if name.partition(".")[0] in ("jax", "jaxlib", REF):
            monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "jax", None)
    monkeypatch.setitem(sys.modules, REF, None)
    reset_uids(PORT)
    port_wf, _, _ = mixed_pipeline(PORT, "lr")
    with pytest.raises(ModelLoadError, match="load_reference_artifact") as exc:
        load_model(str(tmp_path / "ref"), port_wf)
    assert f"{REF}." in str(exc.value)
    reset_uids(PORT)
    port_wf, _, _ = mixed_pipeline(PORT, "lr")
    model = load_reference_artifact(str(tmp_path / "ref"), port_wf)
    assert pred_name in model.score(port_wf._input_data)
