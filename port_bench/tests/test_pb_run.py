"""A run of the harness on the CPU (its look for a chip skipped) at a few
rows: the last line's keys, a sound run judged correct, the bfloat16
control and each fault the cells can have judged not correct.

The faults (``pb_faults.py``) are planted in the program underneath the
timed path, one run each.
"""
from __future__ import annotations

import json

import pytest
import torch

from pb_faults import FAULTS, plant
from pb_helpers import TINY_CELL, bench_copy, factory_grids, run_cpu

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def sound(copy):
    return run_cpu(*copy, "--seed", str(SEED), "--seconds", "0.1",
                   "--trace", "0")


def test_last_line_keys(sound):
    rc, last, _ = sound
    assert rc == 0
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "check"
    assert set(last["metrics"]) == {"train_s", "setup_s"}
    for m in last["metrics"].values():
        assert m["unit"] == "s" and m["value"] > 0
    assert last["attempted"] >= 1 and last["failed"] == 0
    assert set(last["check"]) == {"design_gap", "sanity_gap",
                                  "selection_gap", "holdout_gap"}
    for v in last["check"].values():
        assert set(v) == {"value", "limit"}


def test_sound_run_is_correct(sound):
    rc, last, _ = sound
    assert last["correct"] is True, last["check"]


def test_the_control_is_not_correct(copy):
    """The reference in bfloat16 in the program's place fails a number."""
    from port_bench.harness import catalog, cell, check

    root, bench = copy
    c = catalog.load_cell(TINY_CELL, root=root, bench_dir=bench)
    run = cell.Run(c, SEED, device="cpu", rows=1500)
    raw = run.raw(0)
    ctrl = run.reference(raw, dtype=torch.bfloat16)
    ref = run.reference(raw, tree_points=check.tree_points(
        c.mix, ctrl.winner, SEED), winner=ctrl.winner)
    ok, table = check.judge(check.numbers(ctrl, ref), c.limits)
    assert not ok, table


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_is_not_correct(fault, copy, monkeypatch):
    plant(fault, monkeypatch.setattr)
    rc, last, _ = run_cpu(*copy, "--seed", str(SEED), "--seconds", "0.1",
                          "--trace", "0")
    assert rc == 0
    assert last["correct"] is False, json.dumps(last["check"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_small_cell_on_the_card(card, copy):
    """The small cell through the card's routes (K1, K2 on the card): the
    run completes and the check's numbers come back."""
    from port_bench.harness import cell
    import io
    from contextlib import redirect_stdout

    root, bench = copy
    out = io.StringIO()
    with redirect_stdout(out), factory_grids():
        rc = cell.main(["--workload", TINY_CELL, "--seed", str(SEED),
                        "--seconds", "0.1", "--trace", "1"], root=root,
                       bench_dir=bench, device="cuda", rows=20_000)
    assert rc == 0
    last = json.loads(out.getvalue().splitlines()[-1])
    assert last["device"]["busy_s"] > 0
    assert last["check"]["design_gap"]["value"] == 0.0
