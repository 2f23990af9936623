"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix.  A configuration is the file its entry names; a mix is
``mixes/<traffic>.json``; a per-layer metric is the module
``metrics/<name>.py``; a cell's correctness limits are
``limits/<cell>.json``.  A later change adds a cell, a configuration, a mix
or a metric by adding such files and entries; nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its parts loaded."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: Optional[dict]
    end_to_end: list
    per_layer: list
    bench_dir: Path

    def metric_module(self, name: str):
        return load_metric(self.bench_dir, name)


def benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return _load(path)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its configuration,
    mix and limits read from ``bench_dir``."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load(Path(root) / cfg_entry["file"])
    mix = _load(Path(bench_dir) / "mixes" / f"{w['traffic']}.json")
    lim_path = Path(bench_dir) / "limits" / f"{name}.json"
    limits = _load(lim_path) if lim_path.is_file() else None
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        bench_dir=Path(bench_dir),
    )


def load_metric(bench_dir: Path, name: str):
    """The reader module ``metrics/<name>.py`` (its file name is the
    metric's name, dots and dashes as underscores)."""
    fname = name.replace(".", "_").replace("-", "_") + ".py"
    path = Path(bench_dir) / "metrics" / fname
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{fname[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
