"""Genuine multi-process runs of the torch package's distributed runtime,
the port of the JAX package's ``tests/test_multiprocess.py``.

Two spawned gloo worlds (``torch_mesh_world.py``):

* 2 ranks joined through ``initialize(coordinator_address=...)``: each
  contributes its half of the rows through ``host_local_to_global``;
  ``all_reduce_stats`` and ``fused_moments_sharded`` on those per-rank
  blocks equal the full-data answer, a host input that differs between
  the ranks raises, and forest fold fits and the batched LR core (also
  with the fixed-point exit) over the split rows equal one process's;
* 4 ranks bootstrapped through the ``torchrun`` variables (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) as a 2x2
  ``('replica', 'data')`` mesh: the LR, SVM and linear-regression grids
  with candidates split over ``replica`` and rows over ``data``, and GBT
  fold fits over all four ranks, against one process.

Tolerances are the reference test's: moments and sums atol 1e-4, betas
5e-4, forest heaps bit-equal (gini counts are integers), GBT tree
structure bit-equal and float leaf stats atol 2e-4, f0 1e-5.
"""
import socket

import numpy as np
import pytest

from torch_mesh_world import check_result, run_world


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("multiprocess2", 2, tmp_path_factory.mktemp("mp2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    port = _free_port()

    def env(rank):
        return {"TX_WORLD_ENV_BOOTSTRAP": "1", "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(port), "WORLD_SIZE": "4",
                "RANK": str(rank), "LOCAL_RANK": str(rank)}

    return run_world("multiprocess4", 4, tmp_path_factory.mktemp("mp4"),
                     env_extra=env)


def test_two_process_mesh_and_row_hand_off(world2):
    for rank, got in enumerate(check_result(world2, "mesh_and_row_hand_off")):
        assert got["shape"] == (40, 5)
        assert got["offset"] == 20 * rank
        np.testing.assert_allclose(got["col_sums"], got["want"], atol=1e-4)


@pytest.mark.parametrize("check", ["fused_moments_on_rank_blocks",
                                   "replicated_host_input"])
def test_two_process_fused_moments(world2, check):
    for got in check_result(world2, check):
        for k, (g, w) in enumerate(zip(got["got"], got["want"])):
            if k < 5:
                np.testing.assert_allclose(g, w, atol=1e-4)
            else:
                np.testing.assert_array_equal(g, w)  # min/max are exact


def test_two_process_host_input_guard(world2):
    for got in check_result(world2, "host_input_guard"):
        assert got["raised"] and "multi-process" in got["raised"]


def test_two_process_forest_fold_fits_bit_identical(world2):
    for got in check_result(world2, "forest_fold_fits_across_ranks"):
        for hs, hl in zip(got["sharded"], got["single"]):
            np.testing.assert_array_equal(hs, hl)


@pytest.mark.parametrize("fixed_point", [False, True])
def test_two_process_lr_core(world2, fixed_point):
    per_rank = check_result(world2, "lr_core_across_ranks")
    for got in per_rank:
        g = got[fixed_point]
        for s, w in zip(g["sharded"], g["single"]):
            np.testing.assert_allclose(s, w, atol=5e-4)
        assert g["collectives"] > 0
    # every rank left the fixed-point loop with the same betas
    np.testing.assert_array_equal(per_rank[0][fixed_point]["sharded"][0],
                                  per_rank[1][fixed_point]["sharded"][0])


def test_four_process_2x2_mesh_from_the_environment(world4):
    per_rank = check_result(world4, "mesh_2x2_from_env")
    assert [g["coords"] for g in per_rank] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(g["shape"] == (2, 2) for g in per_rank)


@pytest.mark.parametrize("family", ["lr", "svc", "linreg"])
def test_four_process_linear_grid_on_the_2x2_mesh(world4, family):
    per_rank = check_result(world4, "linear_cores_on_the_2x2_mesh")
    for got in per_rank:
        g = got[family]
        for s, w in zip(g["sharded"], g["single"]):
            np.testing.assert_allclose(s, w, atol=5e-4)
    for other in per_rank[1:]:
        np.testing.assert_array_equal(other[family]["sharded"][0],
                                      per_rank[0][family]["sharded"][0])


def test_four_process_gbt_fold_fits(world4):
    for got in check_result(world4, "gbt_fold_fits_on_four_ranks"):
        (f0_g, heaps_g), (f0_l, heaps_l) = got["sharded"], got["single"]
        np.testing.assert_allclose(f0_g, f0_l, atol=1e-5)
        for k, (hg, hl) in enumerate(zip(heaps_g, heaps_l)):
            if hl.dtype.kind in "ib":  # tree structure: bit parity
                np.testing.assert_array_equal(hg, hl, err_msg=f"heap {k}")
            else:  # float leaf stats: the reduction's order
                np.testing.assert_allclose(hg, hl, atol=2e-4)
