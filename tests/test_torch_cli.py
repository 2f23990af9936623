"""The operator CLI and the project generator, port against reference.

``python -m transmogrifai_tpu_torch.cli`` is a host copy of the JAX
package's ``cli.py``.  Held on the CPU:

* the generator: for the same CSV and flags, every generated file is
  text-equal to the reference's apart from the package name and the
  device seam (``build_workflow(device="cuda")`` and the smoke test's
  ``device="cpu"``), and the contracts of the JAX package's
  tests/test_cli.py and tests/test_cli_fuzz.py hold.  The generated
  projects train and score as generated, with ``build_workflow`` asked
  for the CPU; the three trains run as one-thread child processes
  started together by a module fixture (the fuzz CSVs' two are in
  tests/test_torch_cli_fuzz.py);
* the operator commands (``registry``, ``obs``, ``autotune``, ``fleet``,
  ``continuous``): over one directory the port's JSON document is the
  reference's, and the contracts of the reference's ``tx ...`` tests
  hold on port-written directories.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import PORT, REF, mod, reset_uids, strip_volatile

from transmogrifai_tpu_torch import cli
from transmogrifai_tpu_torch.cli import generate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a generated script run as generated, with its build_workflow asked for
#: the CPU (the project's one device seam) and torch at one thread
_RUN_ON_CPU = """
import functools, importlib, sys
sys.path.insert(0, {proj!r})
sys.argv = [{script!r}] + {args!r}
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
import main
main.build_workflow = functools.partial(main.build_workflow, device="cpu")
importlib.import_module({module!r}).main()
"""


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env.pop("TX_FAULTS", None)
    return env


def _start(proj: str, module: str, args=()) -> subprocess.Popen:
    script = os.path.join(proj, module + ".py")
    src = _RUN_ON_CPU.format(proj=proj, script=script, args=list(args),
                             module=module)
    return subprocess.Popen([sys.executable, "-c", src], cwd=proj,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 500.0):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    return proc.returncode, out, err


def _run(proj: str, module: str, args=()):
    return _finish(_start(proj, module, args))


# -- the CSVs of the JAX package's generator tests -------------------------------

def _binary_csv(path, rng, n=200):
    with open(path, "w") as f:
        f.write("y,x1,x2,cat\n")
        for _ in range(n):
            x1, x2 = rng.randn(), rng.randn()
            y = int(x1 + 0.5 * x2 + 0.3 * rng.randn() > 0)
            cat = "a" if rng.rand() > 0.5 else "b"
            f.write(f"{y},{x1:.4f},{x2:.4f},{cat}\n")
    return str(path)


def _iris_csv(path, rng, n=150):
    with open(path, "w") as f:
        f.write("species,a,b\n")
        for i in range(n):
            k = i % 3
            f.write(f"{['setosa', 'versicolor', 'virginica'][k]},"
                    f"{rng.randn() + k:.4f},{rng.randn() - k:.4f}\n")
    return str(path)


def _tricky_csv(path, rng, n=120):
    with open(path, "w") as f:
        f.write("label,1st col,x\n")
        for i in range(n):
            f.write(f"{1 + (i % 2)},{rng.randn():.4f},{rng.randn():.4f}\n")
    return str(path)


#: name -> (csv writer, generate kwargs): the trained projects
PROJECTS = {
    "binary": (_binary_csv, dict(response="y", name="TestApp")),
    "multiclass": (_iris_csv, dict(response="species", name="McApp")),
    "tricky": (_tricky_csv, dict(response="label", name="TrickyApp")),
}


def _project_rng(name: str):
    return np.random.RandomState(42)


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """Each project generated by the port, with its train started at once
    (one thread a child): name -> {csv, dir, main, proc}."""
    yield from start_projects(tmp_path_factory.mktemp("projects"), PROJECTS,
                              _project_rng)


def start_projects(base, projects: dict, rng_of):
    """Generate each of ``projects`` under ``base`` and start its train
    (one thread a child); yields name -> {csv, dir, main, proc} and kills
    what is still running afterwards."""
    out = {}
    try:
        for name, (write, kw) in projects.items():
            d = base / name
            d.mkdir()
            csv_path = write(d / "data.csv", rng_of(name))
            proj = str(d / "proj")
            main_py = generate(csv_path, output=proj, **kw)
            out[name] = {"csv": csv_path, "dir": proj, "main": main_py,
                         "proc": _start(proj, "main")}
        yield out
    finally:
        for p in out.values():
            if p["proc"].poll() is None:
                p["proc"].kill()
                p["proc"].communicate(timeout=30)


def _trained(projects, name):
    p = projects[name]
    if "result" not in p:
        p["result"] = _finish(p["proc"])
    rc, out, err = p["result"]
    assert rc == 0, err[-3000:]
    return p, out


# -- the generated text against the reference's -----------------------------------

def _port_text(ref_text: str) -> str:
    """The reference's generated text as the port emits it: the package
    renamed, ``build_workflow`` taking the device, the smoke test asking
    for the CPU instead of setting ``JAX_PLATFORMS``."""
    text = re.sub(r"\btransmogrifai_tpu\b", PORT, ref_text)
    text = text.replace("def build_workflow():",
                        'def build_workflow(device="cuda"):')
    text = text.replace("        OpWorkflow()\n",
                        "        OpWorkflow(device=device)\n")
    text = text.replace('\nos.environ.setdefault("JAX_PLATFORMS", "cpu")\n\n',
                        "\n")
    return text.replace("app.build_workflow()",
                        'app.build_workflow(device="cpu")')


@pytest.mark.parametrize("name", sorted(PROJECTS))
def test_generated_files_equal_reference_apart_from_the_seams(
        tmp_path, name):
    write, kw = PROJECTS[name]
    csv_path = write(tmp_path / "data.csv", _project_rng(name))
    generate(csv_path, output=str(tmp_path / "port"), **kw)
    mod(REF, "cli").generate(csv_path, output=str(tmp_path / "ref"), **kw)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert names == ["README.md", "main.py", "params.json", "score.py",
                     "serve.py", "test_smoke.py"]
    for fname in names:
        got = (tmp_path / "port" / fname).read_text(encoding="utf-8")
        want = (tmp_path / "ref" / fname).read_text(encoding="utf-8")
        assert got == _port_text(want), fname
    main_src = (tmp_path / "port" / "main.py").read_text(encoding="utf-8")
    assert 'def build_workflow(device="cuda"):' in main_src
    smoke = (tmp_path / "port" / "test_smoke.py").read_text()
    assert 'build_workflow(device="cpu")' in smoke
    assert "JAX" not in smoke


def test_infer_problem_kind_equal_to_reference():
    ref = mod(REF, "cli").infer_problem_kind
    for values in ([0, 1, 1, 0], [0.0, 1.0, 2.0] * 10, [1.5, 2.7, 3.14],
                   ["yes", "no"], ["a", "b", "c", None], [1, 2, 1, 2],
                   [1, 3, 7] * 5, ["0", "1", "nan", "0"],
                   list(range(40)), ["x"] * 3 + ["y"]):
        assert cli.infer_problem_kind(values) == ref(values), values


# -- the contracts of the JAX package's tests/test_cli.py ---------------------------

def test_generate_and_run_project(projects):
    p, out = _trained(projects, "binary")
    assert os.path.exists(p["main"])
    assert os.path.exists(os.path.join(p["dir"], "README.md"))
    src = open(p["main"]).read()
    assert "BinaryClassificationModelSelector" in src
    assert "as_response()" in src
    assert "Selected model" in out
    assert "model saved" in out
    rc, out2, err2 = _run(p["dir"], "score")
    assert rc == 0, err2[-2000:]
    assert "scored 200 rows" in out2


def test_generate_multiclass_text_labels(projects):
    p, out = _trained(projects, "multiclass")
    src = open(p["main"]).read()
    assert "MultiClassificationModelSelector" in src
    assert "LABELS = ['setosa', 'versicolor', 'virginica']" in src
    assert "map_values" in src
    assert "Selected model" in out


def test_generate_overrides_idcol_and_type_refinement(tmp_path, rng):
    n = 120
    path = tmp_path / "refine.csv"
    with open(path, "w") as f:
        f.write("rowid,y,email,freeform,x\n")
        for i in range(n):
            f.write(f"{i},{i % 2},user{i}@example.com,"
                    f"word{i % 50} text {i},{rng.randn():.4f}\n")
    out = tmp_path / "proj_ref"
    main_py = generate(
        str(path), response="y", name="RefApp", output=str(out),
        overrides={"freeform": mod(PORT, "types.feature_types").TextArea},
        id_col="rowid",
    )
    src = open(main_py).read()
    assert "ft.Email, 'email'" in src
    assert "ft.TextArea, 'freeform'" in src
    assert "rowid" not in src.split("def build_workflow")[0].replace(
        "# --", "")


def test_infer_problem_kind():
    from transmogrifai_tpu_torch.cli import infer_problem_kind

    assert infer_problem_kind([0, 1, 1, 0]) == ("binary", [])
    assert infer_problem_kind([0.0, 1.0, 2.0] * 10) == ("multiclass", [])
    assert infer_problem_kind([1.5, 2.7, 3.14, 9.9]) == ("regression", [])
    assert infer_problem_kind(["yes", "no"]) == ("binary", ["no", "yes"])
    k, labels = infer_problem_kind(["a", "b", "c", None])
    assert k == "multiclass" and labels == ["a", "b", "c"]
    assert infer_problem_kind([1, 2, 1, 2]) == ("binary", [1.0, 2.0])
    assert infer_problem_kind([1, 3, 7] * 5) == ("multiclass",
                                                 [1.0, 3.0, 7.0])
    assert infer_problem_kind(["0", "1", "nan", "0"]) == ("binary", [])
    with pytest.raises(ValueError, match="no usable values"):
        infer_problem_kind(["nan", "nan"])


def test_generate_rejects_dirty_response_and_bad_idcol(tmp_path):
    path = tmp_path / "dirty.csv"
    with open(path, "w") as f:
        f.write("y,x\nnan,1.0\n1,2.0\n0,3.0\n")
    with pytest.raises(ValueError, match="missing/non-finite"):
        generate(str(path), response="y", name="X",
                 output=str(tmp_path / "p1"))
    clean = tmp_path / "clean.csv"
    with open(clean, "w") as f:
        f.write("y,x\n1,2.0\n0,3.0\n")
    with pytest.raises(ValueError, match="cannot be the same"):
        generate(str(clean), response="y", name="X",
                 output=str(tmp_path / "p2"), id_col="y")
    uni = tmp_path / "uni.csv"
    with open(uni, "w", encoding="utf-8") as f:
        f.write("y,x²\n1,2.0\n0,3.0\n1,4.0\n0,5.0\n")
    main_py = generate(str(uni), response="y", name="U",
                       output=str(tmp_path / "p3"))
    compile(open(main_py, encoding="utf-8").read(), main_py, "exec")


def test_generate_handles_label_column_and_nonidentifiers(projects,
                                                          tmp_path):
    p, out = _trained(projects, "tricky")
    src = open(p["main"]).read()
    assert "LABELS = [1.0, 2.0]" in src  # {1,2} re-indexed to 0/1
    compile(src, p["main"], "exec")
    assert "Selected model" in out
    with pytest.raises(KeyError, match="id column"):
        generate(p["csv"], response="label", name="X",
                 output=str(tmp_path / "nope"), id_col="typo")


def test_ask_accepts_index_alias_and_reprompts():
    from transmogrifai_tpu_torch.cli import ask

    opts = [("binary", ["binary", "yes"]), ("regression", ["regression"])]
    feed = iter(["bogus", "1"])
    assert ask("Kind?", opts, input_fn=lambda q: next(feed)) == "regression"
    assert ask("Kind?", opts, input_fn=lambda q: "YES") == "binary"
    assert ask("Kind?", opts, input_fn=lambda q: "0") == "binary"


def test_ask_answers_map_short_circuits_stdin():
    from transmogrifai_tpu_torch.cli import ask

    def explode(q):
        raise AssertionError("stdin used despite answers map")

    got = ask(
        "Problem kind for response 'y'",
        [("binary", ["binary"]), ("multiclass", ["multiclass"])],
        answers={"problem kind": "multiclass"},
        input_fn=explode,
    )
    assert got == "multiclass"


def test_generate_interactive_dialogue(tmp_path, rng):
    csv_file = _binary_csv(tmp_path / "data.csv", rng)
    out = tmp_path / "proj_interactive"
    feed = iter(["yes", "none"])
    main_py = generate(
        csv_file, response="y", name="InteractiveApp", output=str(out),
        interactive=True, input_fn=lambda q: next(feed),
    )
    assert "BinaryClassificationModelSelector" in open(main_py).read()


def test_generate_with_answers_file(tmp_path, rng):
    from transmogrifai_tpu_torch.cli import load_answers, main

    csv_file = _binary_csv(tmp_path / "data.csv", rng)
    answers = tmp_path / "answers.txt"
    answers.write_text(
        "problem kind => binary\nwhich column is the row id => cat\n")
    amap = load_answers(str(answers))
    assert amap == {
        "problem kind": "binary", "which column is the row id": "cat",
    }
    out = tmp_path / "proj_answers"
    rc = main([
        "gen", "--input", csv_file, "--response", "y",
        "--name", "AnswersApp", "--output", str(out),
        "--answers", str(answers),
    ])
    assert rc == 0
    src = open(out / "main.py").read()
    assert "BinaryClassificationModelSelector" in src
    assert not re.search(
        r'FeatureBuilder\([^)]*"cat"\)[^\n]*as_predictor', src)


def test_ask_strict_and_layered_answers():
    from transmogrifai_tpu_torch.cli import ask

    opts = [("a", ["colA"]), ("b", ["colB"])]
    with pytest.raises(ValueError, match="no entry"):
        ask("Which id column?", opts, answers={"unrelated": "colA"},
            strict=True)
    with pytest.raises(ValueError, match="invalid answer"):
        ask("Which id column?", opts, answers={"which id": "nope"},
            strict=True)
    assert ask("Which id column?", opts,
               answers={"which": "nope", "which id": "colB"},
               strict=True) == "b"
    assert ask("Which id column?", opts, answers={"unrelated": "colA"},
               strict=False, input_fn=lambda q: "colB") == "b"


def test_load_answers_rejects_malformed_lines(tmp_path):
    from transmogrifai_tpu_torch.cli import load_answers

    good = tmp_path / "good.txt"
    good.write_text("# comment\n\nwhich id=>colB\nproblem kind => binary\n")
    assert load_answers(str(good)) == {
        "which id": "colB", "problem kind": "binary",
    }
    bad = tmp_path / "bad.txt"
    bad.write_text("which id colB\n")
    with pytest.raises(ValueError, match="expected 'prefix => answer'"):
        load_answers(str(bad))


def test_ask_empty_answers_dict_is_still_strict():
    from transmogrifai_tpu_torch.cli import ask

    with pytest.raises(ValueError, match="no entry"):
        ask("Which id column?", [("a", ["colA"])], answers={}, strict=True)


def test_cli_generated_project_has_serve_template(tmp_path):
    import ast

    csv = tmp_path / "d.csv"
    rows = ["y,a,c"] + [
        f"{i % 2},{i * 0.1:.1f},{('u', 'v')[i % 2]}" for i in range(40)
    ]
    csv.write_text("\n".join(rows) + "\n")
    out = tmp_path / "proj"
    generate(str(csv), "y", "App", str(out))
    src = (out / "serve.py").read_text()
    ast.parse(src)
    assert "MicroBatchScheduler" in src
    assert "compile_endpoint" in src
    assert "from transmogrifai_tpu_torch.serving import (" in src


# -- operator commands: the reference's JSON over the same directory -------------

def _both(capsys, argv):
    """(rc, doc) of the port's CLI and of the reference's over ``argv``."""
    rc = cli.main(list(argv))
    got = capsys.readouterr().out
    ref_rc = mod(REF, "cli").main(list(argv))
    want = capsys.readouterr().out
    return (rc, got), (ref_rc, want)


def _tiny_model(pkg: str):
    from torch_parity import tiny_pipeline

    reset_uids(pkg)
    return tiny_pipeline(pkg)[0].train()


def test_cli_list_promote_rollback_roundtrip(tmp_path, capsys):
    """The reference's registry roundtrip on a port registry, and each
    step's document equal to the reference CLI's on a reference registry
    driven the same way (timestamps and hashes aside)."""
    docs = {}
    for pkg in (PORT, REF):
        c = cli if pkg == PORT else mod(REF, "cli")
        model = _tiny_model(pkg)
        root = str(tmp_path / f"reg-{pkg}")
        reg = mod(pkg, "registry").ModelRegistry(root)
        reg.publish(model)
        reg.publish(model)
        steps = []
        assert c.main(["registry", "promote", "--root", root,
                       "--version", "v1"]) == 0
        steps.append(json.loads(capsys.readouterr().out))
        assert c.main(["registry", "promote", "--root", root,
                       "--version", "v2", "--to", "canary"]) == 0
        steps.append(json.loads(capsys.readouterr().out))
        assert c.main(["registry", "list", "--root", root,
                       "--lineage"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["stable"] == "v1" and doc["canary"] == "v2"
        assert [e["event"] for e in doc["lineage"]][:2] == [
            "publish", "publish"]
        steps.append(doc)
        assert c.main(["registry", "rollback", "--root", root,
                       "--reason", "drill"]) == 0
        event = json.loads(capsys.readouterr().out)
        assert event["version"] == "v2" and event["reason"] == "drill"
        steps.append(event)
        assert c.main(["registry", "promote", "--root", root,
                       "--version", "v2"]) == 2
        err = json.loads(capsys.readouterr().out)
        assert "error" in err
        steps.append(err)
        docs[pkg] = steps
    volatile = ("created_unix", "unix", "t", "ts", "time", "published_at",
                "sha256", "digest", "root", "path", "artifact_sha256",
                "fingerprint", "size_bytes", "bytes", "error", "model_uid",
                "runtime", "versions_meta")
    got = strip_volatile(docs[PORT], volatile)
    want = strip_volatile(docs[REF], volatile)
    assert [sorted(d) for d in got] == [sorted(d) for d in want]
    assert got[3] == want[3]  # the rollback event


def test_cli_verify_exits_nonzero_on_damage(tmp_path, capsys):
    root = str(tmp_path / "reg")
    mod(PORT, "registry").ModelRegistry(root).publish(_tiny_model(PORT))
    assert cli.main(["registry", "verify", "--root", root]) == 0
    assert json.loads(capsys.readouterr().out)["ok"]
    npz = os.path.join(root, "versions", "v1", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff")
    assert cli.main(["registry", "verify", "--root", root]) == 1
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"]
    assert cli.main(["registry", "list", "--root",
                     str(tmp_path / "nope")]) == 2
    assert "no registry" in json.loads(capsys.readouterr().out)["error"]
    (rc, got), (ref_rc, want) = _both(
        capsys, ["registry", "list", "--root", str(tmp_path / "nope")])
    assert rc == ref_rc == 2 and json.loads(got) == json.loads(want)


def test_publish_crash_cli_verify_reports_prior_intact(tmp_path, capsys):
    from transmogrifai_tpu_torch.faults import injection as faults
    from transmogrifai_tpu_torch.testkit.drills import (
        REGISTRY_CRASH_PUBLISHER_TEMPLATE,
        drill_env,
    )

    root = str(tmp_path / "reg")
    script = tmp_path / "publisher.py"
    script.write_text(REGISTRY_CRASH_PUBLISHER_TEMPLATE.format(
        repo=REPO, root=root, fault="registry.publish_crash:on=1"))
    env = dict(drill_env(), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          timeout=300)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT
    rc = cli.main(["registry", "verify", "--root", root])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["ok"]
    assert report["versions"]["v1"] is None


def test_trace_cli_skips_truncated_jsonl_lines(tmp_path, capsys):
    mod(PORT, "obs.trace").reset_tracer()
    tr = mod(PORT, "obs.trace").tracer()
    with tr.span("whole"):
        pass
    p = str(tmp_path / "spans.jsonl")
    tr.export_jsonl(p)
    with open(p) as f:
        content = f.read()
    with open(p, "w") as f:
        f.write(content)
        f.write('{"trace": "t", "span": 1, "name": "torn mid-wri')
    argv = ["obs", "trace", "--path", p, "--slowest", "3"]
    (rc, got), (ref_rc, want) = _both(capsys, argv)
    assert rc == ref_rc == 0
    out = json.loads(got)
    assert out["lines_skipped"] == 1
    assert out["trees"][0]["name"] == "whole"
    assert out == json.loads(want)


def test_slo_cli_over_export_and_agg_dir(tmp_path, capsys):
    obs = mod(PORT, "obs")
    reg = obs.metrics_registry()
    reg.counter("jobs.bad").inc(50)
    reg.counter("jobs.total").inc(100)
    cfg = tmp_path / "slo.json"
    cfg.write_text(json.dumps({"slos": [
        {"name": "bad-jobs", "kind": "ratio", "numerator": "jobs.bad",
         "denominator": "jobs.total", "objective": 0.01,
         "windows_s": [300.0, 60.0]}]}))
    out_dir = str(tmp_path / "export")
    obs.export_obs(out_dir)
    volatile = ("t", "evaluated_unix", "unix", "ts", "since")
    (rc, got), (ref_rc, want) = _both(
        capsys, ["obs", "slo", "--path", out_dir, "--config", str(cfg)])
    report = json.loads(got)
    assert rc == ref_rc == 1
    assert report["firing"] == ["bad-jobs"]
    assert report["objectives"]["bad-jobs"]["ratio"] == 0.5
    assert strip_volatile(report, volatile) \
        == strip_volatile(json.loads(want), volatile)
    agg_dir = str(tmp_path / "agg")
    obs.ship_now(agg_dir)
    rc = cli.main(["obs", "slo", "--path", agg_dir, "--config", str(cfg)])
    assert rc == 1
    assert json.loads(capsys.readouterr().out)["firing"] == ["bad-jobs"]
    cfg.write_text(json.dumps({"slos": [
        {"name": "bad-jobs", "kind": "ratio", "numerator": "jobs.bad",
         "denominator": "jobs.total", "objective": 0.9}]}))
    rc = cli.main(["obs", "slo", "--path", out_dir, "--config", str(cfg)])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["firing"] == []


def test_trace_cli_merges_fleet_shards(tmp_path, capsys):
    obs = mod(PORT, "obs")
    agg_dir = str(tmp_path / "agg")
    tr = obs.tracer()
    with tr.span("merge.root"):
        with tr.span("merge.child"):
            pass
    obs.ship_now(agg_dir)
    rc = cli.main(["obs", "trace", "--path", agg_dir])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fleet"]["shards_live"] == 1
    root = next(t for t in out["trees"] if t["name"] == "merge.root")
    assert [c["name"] for c in root["children"]] == ["merge.child"]
    ref_rc = mod(REF, "cli").main(["obs", "trace", "--path", agg_dir])
    want = json.loads(capsys.readouterr().out)
    assert ref_rc == 0
    assert [t["name"] for t in want["trees"]] \
        == [t["name"] for t in out["trees"]]


def test_fleet_status_cli_over_agg_dir_and_drain_command(tmp_path, capsys):
    obs = mod(PORT, "obs")
    agg = tmp_path / "obs"
    obs.metrics_registry().counter("drill.fleet_cli").inc()
    obs.ship_now(str(agg), instance="replica-9",
                 extra={"fleet": {"generation": 3, "version": "v7",
                                  "rows_scored": 123}})
    (rc, got), (ref_rc, want) = _both(
        capsys, ["fleet", "status", "--path", str(agg)])
    assert rc == ref_rc == 0
    doc = json.loads(got)
    assert doc["replicas"]["replica-9"]["fleet"]["version"] == "v7"
    assert doc["replicas"]["replica-9"]["heartbeat_age_s"] is not None
    assert strip_volatile(doc, ("heartbeat_age_s",)) \
        == strip_volatile(json.loads(want), ("heartbeat_age_s",))
    control = tmp_path / "control"
    rc = cli.main(["fleet", "drain", "--path", str(control),
                   "--replica", "replica-9"])
    assert rc == 0
    with open(control / "commands" / "replica-9.json") as f:
        cmd = json.load(f)
    assert cmd == {"replica": "replica-9", "drain": True,
                   "t": pytest.approx(cmd["t"])}
    rc = cli.main(["fleet", "drain", "--path", str(control),
                   "--replica", "replica-9", "--undrain"])
    assert rc == 0
    with open(control / "commands" / "replica-9.json") as f:
        assert json.load(f)["drain"] is False
    capsys.readouterr()
    (rc, _got), (ref_rc, _want) = _both(
        capsys, ["fleet", "status", "--path", str(tmp_path / "nope")])
    assert rc == ref_rc == 2


def test_cli_autotune_report(tmp_path, capsys):
    from test_torch_autotune import _selector_workflow

    loc = str(tmp_path / "model")
    mod(PORT, "workflow.runner").OpWorkflowRunner(
        _selector_workflow(PORT, n=400)).run(
        "train", mod(PORT, "workflow.params").OpParams(
            model_location=loc,
            custom_params={"autotune": True, "autotune_min_rows": 200}))
    (rc, got), (ref_rc, want) = _both(
        capsys, ["autotune", "report", "--path", loc])
    assert rc == ref_rc == 0
    doc = json.loads(got)
    assert doc["cost_model"]["observations"] > 0
    assert doc["selection"]
    assert doc == json.loads(want)
    (rc2, _), (ref_rc2, _) = _both(
        capsys, ["autotune", "report", "--path", str(tmp_path / "nowhere")])
    assert rc2 == ref_rc2 == 2


def test_direct_mode_continuous_status_cli(tmp_path, capsys):
    """The CLI part of the reference's direct-mode drill: after a trigger
    cycle promotes, ``tx continuous status`` renders the trainer's status
    document from its dir or its file, as the reference's CLI does."""
    from test_torch_continuous import _drive

    trainer, _v1, cycles = _drive(PORT, str(tmp_path))
    status_name = mod(PORT, "continuous").STATUS_FILENAME
    (rc, got), (ref_rc, want) = _both(
        capsys, ["continuous", "status", "--path", str(tmp_path)])
    assert rc == ref_rc == 0
    out = json.loads(got)
    assert out["status"]["counters"]["refits"] == 1
    assert out["source"].endswith(status_name)
    assert out == json.loads(want)
    assert cli.main(["continuous", "status", "--path",
                     os.path.join(str(tmp_path), status_name)]) == 0
    capsys.readouterr()
    assert cli.main(["continuous", "status", "--path",
                     str(tmp_path / "nope")]) == 2
    assert trainer.promotes == 1 and cycles


def test_main_rejects_unknown_commands(capsys):
    with pytest.raises(SystemExit):
        cli.main(["nope"])
    with pytest.raises(SystemExit):
        cli.main(["bulk"])
    capsys.readouterr()


def test_module_entry_point_prints_help():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None; "
         "from transmogrifai_tpu_torch.cli import main; "
         "raise SystemExit(main(sys.argv[1:]))", "--help"],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for cmd in ("registry", "obs", "autotune", "fleet", "continuous",
                "bulk", "gen"):
        assert cmd in proc.stdout
