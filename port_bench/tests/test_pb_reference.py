"""The plain reference: its pieces against direct definitions, and its
whole train() against the port's with ``device="cpu"`` at a few rows."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pb_helpers import TINY_CELL, TINY_ROWS, bench_copy, factory_grids
from port_bench.reference import rank, split, trees


def pairwise_auroc(y, s):
    pos, neg = s[y == 1], s[y == 0]
    wins = (pos[:, None] > neg[None, :]).sum() + 0.5 * (
        pos[:, None] == neg[None, :]).sum()
    return wins / (len(pos) * len(neg))


def test_auroc_is_the_pairwise_rate_with_ties():
    rng = np.random.default_rng(0)
    y = (rng.random(400) < 0.4).astype(float)
    s = np.round(rng.random(400) + 0.3 * y, 1)  # many ties
    assert rank.auroc(y, s) == pytest.approx(pairwise_auroc(y, s))


def test_binned_auroc_is_exact_when_the_bins_separate_the_scores():
    rng = np.random.default_rng(1)
    y = (rng.random(300) < 0.5).astype(float)
    s = rng.integers(0, 50, 300).astype(float)   # 50 levels, 1024 bins
    val = rng.random(300) < 0.5
    got = rank.binned_auroc(y, s, val, 1024)
    assert got == pytest.approx(pairwise_auroc(y[val], s[val]))


def test_folds_are_stratified_and_cover_every_row():
    y = (np.arange(1000) % 3 == 0).astype(float)
    m = split.stratified_folds(y, 3, 42)
    assert m.shape == (3, 1000)
    assert ((~m).sum(axis=0) == 1).all()      # each row validates once
    for f in range(3):
        assert abs(y[~m[f]].mean() - y.mean()) < 0.01


def test_holdout_is_a_tenth_and_disjoint():
    tr, ho = split.holdout(1001, 0.1, 42)
    assert len(ho) == 100 and len(tr) == 901
    assert not set(tr) & set(ho)


def test_balance_weights_only_for_a_rare_class():
    y = np.r_[np.ones(5), np.zeros(95)]
    w = split.balance_weights(y, 0.1)
    assert (w[y == 0] == 1).all()
    assert w[y == 1].sum() / w.sum() == pytest.approx(0.1)
    assert (split.balance_weights(np.r_[np.ones(50), np.zeros(50)], 0.1)
            == 1).all()


def test_a_tree_finds_a_planted_split():
    x = np.linspace(0, 1, 400, dtype=np.float32)[:, None]
    y = (x[:, 0] > 0.5).astype(np.float64)
    edges = trees.quantile_edges(x, 32)
    bins = trees.to_bins(torch.as_tensor(x), edges)
    stats = torch.as_tensor(np.stack([np.ones(400), 1 - y, y], 1))
    heap = trees.fit_tree(bins, stats, 2, 32, "gini", 1.0, 0.01)
    assert trees.split_points(heap, edges[0]) == [float(edges[0][15])]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One train of the small cell by the port on the CPU and by the
    reference."""
    from port_bench.harness import catalog, cell, program

    root, bench = bench_copy(tmp_path_factory.mktemp("ref"))
    c = catalog.load_cell(TINY_CELL, root=root, bench_dir=bench)
    run = cell.Run(c, 31337, device="cpu", rows=TINY_ROWS)
    raw = run.raw(0)
    with factory_grids():
        model, built = run.train(program.to_dataset(raw, c.config))
    prog = program.extract(model, built)
    ref = run.reference(raw, tree_points=None, winner=prog.winner)
    return prog, ref


def test_reference_design_matrix_is_the_ports(pair):
    prog, ref = pair
    assert prog.columns == ref.columns
    assert np.array_equal(prog.design, ref.design)


def test_reference_keeps_the_ports_columns(pair):
    prog, ref = pair
    assert prog.keep == ref.keep
    ok = ref.stats["variance"] >= 1e-5
    np.testing.assert_allclose(prog.stats["corr"][ok], ref.stats["corr"][ok],
                               atol=1e-5)


def test_reference_linear_fold_metrics_are_the_ports(pair):
    prog, ref = pair
    have = {(c["family"], tuple(sorted(c["params"].items()))): c
            for c in prog.candidates}
    for c in ref.candidates:
        if c["family"] == "OpLogisticRegression":
            p = have[(c["family"], tuple(sorted(c["params"].items())))]
            np.testing.assert_allclose(p["folds"], c["folds"], atol=1e-4)


def test_reference_holdout_scores_are_the_ports(pair):
    prog, ref = pair
    np.testing.assert_allclose(prog.holdout_scores, ref.holdout_scores,
                               atol=1e-4)
