"""The torch package's multi-process runtime helpers
(``parallel/distributed.py``, ``parallel/mesh.py``) against the JAX
package's ``tests/test_distributed.py`` contracts.

The reference runs them on its 8-device virtual CPU mesh in one process;
the port's mesh is the ranks of a process group, so its checks run once
on a spawned gloo world of 2 ranks (``torch_mesh_world.py``, ~5 s) and
each is reported as its own case.  The reference's "rows not divisible by
the mesh" raise has no port counterpart: the port's blocks may be
unequal, so such rows reduce exactly (``unequal_blocks_reduce_exactly``).
"""
import numpy as np
import pytest

from torch_mesh_world import check_result, run_world
from torch_parity import PORT, REF, mod

CHECKS = [
    "global_mesh_and_all_reduce",
    "host_local_to_global",
    "rejects_mismatched_leading_axes",
    "unequal_blocks_reduce_exactly",
    "rejects_scalar_and_bad_axis",
    "host_local_to_global_rejects",
    "local_mesh_reduces_locally",
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("distributed", 2, tmp_path_factory.mktemp("dist"))


def _assert_check(name, got):
    if name == "global_mesh_and_all_reduce":
        assert got["size"] == 2
        np.testing.assert_allclose(got["s"], got["want_s"], rtol=1e-6)
        np.testing.assert_allclose(got["ss"], got["want_ss"], rtol=1e-6)
        # the reference's own reduction over its 8-device mesh
        ref = mod(REF, "parallel.distributed")
        X = np.arange(64, dtype=np.float32).reshape(16, 4)
        s, ss = ref.all_reduce_stats(
            lambda x: (x.sum(axis=0), (x * x).sum(axis=0)),
            ref.global_mesh(("data",)), X)
        np.testing.assert_allclose(got["s"], np.asarray(s), rtol=1e-6)
        np.testing.assert_allclose(got["ss"], np.asarray(ss), rtol=1e-6)
    elif name == "host_local_to_global":
        assert got["shape"] == (7, 5) and got["offset"] == got["lo"]
        assert got["rows_equal"]
    elif name == "rejects_mismatched_leading_axes":
        assert got["raised"] and "array 1 has" in got["raised"]
    elif name in ("unequal_blocks_reduce_exactly", "local_mesh_reduces_locally"):
        np.testing.assert_array_equal(got["s"], got["want"])
    elif name in ("rejects_scalar_and_bad_axis", "host_local_to_global_rejects"):
        assert "0-d" in got["scalar"]
        assert "no axis 'rows'" in got["axis"]


@pytest.mark.parametrize("name", CHECKS)
def test_distributed_contract_on_two_ranks(world, name):
    per_rank = check_result(world, name)
    for got in per_rank:
        _assert_check(name, got)
    if name == "host_local_to_global":
        assert [g["offset"] for g in per_rank] == [0, 4]  # array_split order


def test_initialize_noop_single_process(monkeypatch):
    dist = mod(PORT, "parallel.distributed")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize()  # must not raise or block in a single process
    assert dist._initialized is False  # a no-op must not latch
    import torch.distributed

    assert not torch.distributed.is_initialized()


def test_single_process_has_no_product_mesh(monkeypatch):
    """World 1 (no process group): every product path stays the
    single-device one, as the reference's one-device meshes are None."""
    mesh = mod(PORT, "parallel.mesh")
    monkeypatch.delenv("TX_PRODUCT_MESH", raising=False)
    assert mesh.data_mesh_or_none() is None
    assert mesh.cv_mesh_or_none(24) is None
    assert mesh.world_size() == 1 and mesh.is_writer()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(1)


@pytest.mark.parametrize("n,parts", [(1999, 4), (7, 2), (3, 4), (0, 2),
                                     (16, 8)])
def test_row_blocks_follow_array_split(n, parts):
    mesh = mod(PORT, "parallel.mesh")
    want = np.array_split(np.arange(n), parts)
    for i in range(parts):
        lo, hi = mesh.block_bounds(n, parts, i)
        np.testing.assert_array_equal(np.arange(lo, hi), want[i])


def test_pad_rows_to_multiple_matches_reference():
    port = mod(PORT, "parallel.mesh").pad_rows_to_multiple
    ref = mod(REF, "parallel.mesh").pad_rows_to_multiple
    a = np.arange(21, dtype=np.float32).reshape(7, 3)
    for m in (1, 4, 7, 8):
        (pp, pn), (rp, rn) = port(a, m), ref(a, m)
        np.testing.assert_array_equal(pp, rp)
        assert pn == rn
