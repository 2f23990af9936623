"""Helpers of the benchmark's CPU tests: a throwaway copy of the benchmark
with a small cell, and a run of it on the CPU."""
from __future__ import annotations

import io
import json
import shutil
import sys
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a small mix of the cell's families with small grids, for the CPU
TINY_MIX = {
    "name": "tiny_cv",
    "selector": {
        "num_folds": 3, "seed": 42,
        "families": [
            {"model_type": "OpLogisticRegression",
             "grid": {"reg_param": [0.01, 0.2], "elastic_net_param": [0.1]},
             "fixed": {}},
            {"model_type": "OpGBTClassifier",
             "grid": {"max_depth": [3], "min_info_gain": [0.001, 0.01]},
             "fixed": {"num_trees": 5}},
        ],
        "splitter": {"kind": "DataBalancer", "sample_fraction": 0.1,
                     "reserve_test_fraction": 0.1, "seed": 42},
    },
    "pool": 2,
    "warmup": {"trains": 1},
    "check": {"sampled_tree_candidates": 1},
}

#: limits of the small cell on the CPU (the port's plain CPU routes:
#: float32 moments, float32 trees), from CPU readings at TINY_ROWS rows:
#: 12 seeds of the program read at most 0, 5.1e-6, 2.9e-3 and 6.7e-8, 4
#: seeds of the bfloat16 control at least 2.5e-3, 0.085, 6.2e-3 and 3.1e-4
TINY_LIMITS = {
    "design_gap": {"limit": 1e-6},
    "sanity_gap": {"limit": 1e-4},
    "selection_gap": {"limit": 5e-3},
    "holdout_gap": {"limit": 1e-5},
}
TINY_ROWS = 1500
TINY_CELL = "higgs.tiny_cv"


def bench_copy(tmp: Path, limits=TINY_LIMITS, mix=TINY_MIX) -> tuple:
    """(root, bench_dir) of a copy of the benchmark under ``tmp`` with the
    small cell ``TINY_CELL`` added."""
    root = Path(tmp) / "checkout"
    bench = root / "port_bench"
    shutil.copytree(ROOT / "port_bench", bench,
                    ignore=shutil.ignore_patterns("tests", "_cache",
                                                  "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": TINY_CELL, "config": "higgs",
                              "traffic": mix["name"], "chips": 1,
                              "why": "the CPU tests' small cell"})
    for m in spec["per_layer"]:
        m.setdefault("workloads", []).append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "mixes" / f"{mix['name']}.json").write_text(json.dumps(mix))
    if limits is not None:
        (bench / "limits" / f"{TINY_CELL}.json").write_text(json.dumps(limits))
    return root, bench


@contextmanager
def factory_grids(mix=TINY_MIX):
    """The port's selector factory builds ``mix``'s grids (a benchmark mix
    states the factory's own), so the small cell's selector stays small."""
    from transmogrifai_tpu_torch.selector import factories
    from port_bench.reference.pipeline import grid

    fams = {f["model_type"]: f for f in mix["selector"]["families"]}
    saved = factories.lr_grid, factories.gbt_grid
    factories.lr_grid = lambda: grid(fams["OpLogisticRegression"])
    factories.gbt_grid = lambda: grid(fams["OpGBTClassifier"])
    try:
        yield
    finally:
        factories.lr_grid, factories.gbt_grid = saved


def run_cpu(root: Path, bench: Path, *args) -> tuple:
    """(exit code, the last line of standard output as JSON or None) of a
    run of the copy's small cell on the CPU."""
    from port_bench.harness import cell

    out = io.StringIO()
    with redirect_stdout(out), factory_grids():
        rc = cell.main(["--workload", TINY_CELL, *args], root=root,
                       bench_dir=bench, device="cpu", rows=TINY_ROWS)
    lines = [l for l in out.getvalue().splitlines() if l.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), lines
