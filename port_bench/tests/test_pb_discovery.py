"""Cells, configurations, mixes and per-layer metrics are found by name:
a later change adds one by adding files and BENCHMARK.json entries, and
edits no file that is there.  BENCHMARK.json keeps to the contract's
shape."""
from __future__ import annotations

import json
import re

import pytest

from pb_helpers import ROOT, TINY_CELL, bench_copy
from port_bench.harness import catalog
from port_bench.harness.recorder import Recording

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "port_bench/run.py"]
    assert s["paths"] == ["port_bench"]
    assert 1 <= s["run_seconds"] <= 51
    names = [c["name"] for c in s["configs"]]
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        assert (ROOT / c["file"]).is_file()
    cells = [w["name"] for w in s["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (ROOT / "port_bench/mixes" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "port_bench/limits" / f"{w['name']}.json").is_file()
    metrics = s["end_to_end"] + s["per_layer"]
    assert "setup_s" in [m["name"] for m in s["end_to_end"]]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["moves"] == "train_s"
        assert set(m.get("workloads", cells)) <= set(cells)
        catalog.load_metric(ROOT / "port_bench", m["name"])
    for name in names + cells:
        assert NAME.match(name)


def test_every_cell_loads():
    for w in spec()["workloads"]:
        cell = catalog.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.limits is not None
        assert [m["name"] for m in cell.end_to_end] == ["train_s", "setup_s"]


def test_benchmark_grids_are_the_upstream_grids():
    """The mixes state the grids the port's factory builds, so the
    reference, which reads the mix, follows the program."""
    from transmogrifai_tpu_torch.selector import factories
    from port_bench.reference.pipeline import grid

    mix = json.loads((ROOT / "port_bench/mixes/lr_gbt_cv.json").read_text())
    fams = {f["model_type"]: f for f in mix["selector"]["families"]}
    assert grid(fams["OpLogisticRegression"]) == factories.lr_grid()
    assert grid(fams["OpGBTClassifier"]) == factories.gbt_grid()


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root, bench = bench_copy(tmp_path)
    cfg = json.loads((bench / "configs/higgs.json").read_text())
    cfg["name"] = "throwaway"
    cfg["columns"] = cfg["columns"][:3]
    cfg["label"]["terms"] = cfg["label"]["terms"][2:3]
    (bench / "configs/throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "mixes/lr_gbt_cv.json").read_text())
    mix["name"] = "throwaway_mix"
    mix["pool"] = 3
    (bench / "mixes/throwaway_mix.json").write_text(json.dumps(mix))
    (bench / "metrics/throwaway_ms.py").write_text(
        "SHIMS = [('pb_nowhere', None, 'f', 'fit.x')]\nKERNELS = {}\n\n"
        "def read(rec):\n    return 1e3 * rec.span_seconds('fit.x')\n")
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "throwaway", "source": "https://example.org",
                         "file": "port_bench/configs/throwaway.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "throwaway.mix", "config": "throwaway",
                           "traffic": "throwaway_mix", "chips": 1,
                           "why": "a test"})
    s["per_layer"].append({"name": "throwaway_ms", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "a test", "moves": "train_s",
                           "workloads": ["throwaway.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))

    cell = catalog.load_cell("throwaway.mix", root=root, bench_dir=bench)
    assert cell.config["name"] == "throwaway"
    assert cell.mix["pool"] == 3 and cell.limits is None
    assert [m["name"] for m in cell.per_layer] == ["throwaway_ms"]
    reader = cell.metric_module("throwaway_ms")
    rec = Recording(trains=1)
    assert reader.read(rec) == 0.0
    # the cells that were there are untouched by the addition
    other = catalog.load_cell(TINY_CELL, root=root, bench_dir=bench)
    assert "throwaway_ms" not in [m["name"] for m in other.per_layer]


def test_an_unknown_cell_is_refused(tmp_path):
    root, bench = bench_copy(tmp_path)
    with pytest.raises(KeyError):
        catalog.load_cell("no.such", root=root, bench_dir=bench)
