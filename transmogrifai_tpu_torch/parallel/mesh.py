"""Device meshes over the ranks of a ``torch.distributed`` process group.

Counterpart of ``transmogrifai_tpu/parallel/mesh.py`` (reference: Spark's
partition / treeAggregate substrate, SURVEY §2.9/§5.8).  The JAX package
is single-controller: one process addresses every local device and a
``jax.sharding.Mesh`` names them.  This package takes the PyTorch idiom,
one process per GPU as ``torchrun`` launches it: a device of the mesh is
a rank of the default process group, each rank drives its own GPU
(``cuda:{LOCAL_RANK}``, see ``distributed.initialize``), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, ``('data',)`` or ``('replica', 'data')``.

Rows of the design matrix split over the ``data`` axis, CV candidates
over the ``replica`` axis.  Where XLA inserts a ``psum`` for a reduction
that crosses row shards, the port calls ``dist.all_reduce`` on the
mesh's data group itself (``distributed.RowReducer``).  The product path
takes the reference's *replicated host input* contract: every rank holds
the whole host design matrix and fits on its own row block, cut in
``np.array_split`` order (:func:`row_block`).  Blocks may be unequal, so
no row is padded where the reference padded only because GSPMD shards
must be equal.

Without a process group, or with a world of one rank, or with
``TX_PRODUCT_MESH=0``, :func:`data_mesh_or_none` and
:func:`cv_mesh_or_none` return None, as the reference's do with one
device, and every path is the single-device one.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def world_size() -> int:
    """Ranks of the default process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def available_devices(min_count: int = 1) -> list[int]:
    """The mesh's devices: the ranks of the default process group (rank
    0 alone without one).  ``min_count`` is accepted for the reference's
    signature; a rank cannot borrow devices it was not launched with."""
    return list(range(world_size()))


def mesh_device_type() -> str:
    """``"cuda"`` when the default group carries CUDA tensors on NCCL,
    else ``"cpu"``: a gloo world on one card keeps a CPU-typed mesh (its
    collectives still take CUDA tensors) so that ``DeviceMesh`` does not
    try to give every rank a card of its own."""
    if not (dist.is_initialized() and torch.cuda.is_available()):
        return "cpu"
    return "cuda" if "nccl" in str(dist.get_backend()).lower() else "cpu"


#: (default group, shape, axis names) -> DeviceMesh.  A mesh's groups are
#: created by a collective call on every rank, so each is made once.
_meshes: dict = {}


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
):
    """A ``DeviceMesh`` over every rank of the default group, of ``shape``
    (default ``(n_devices, 1, ...)``).  The mesh must cover the world:
    ``torch.distributed`` cannot leave a rank out of a mesh it joins.
    Raises ``MeshShapeError`` otherwise and ``RuntimeError`` without a
    process group (``distributed.initialize``)."""
    from .distributed import MeshShapeError

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: call "
            "transmogrifai_tpu_torch.parallel.distributed.initialize() "
            "(or launch under torchrun) first"
        )
    world = dist.get_world_size()
    if shape is None:
        n = n_devices or world
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise MeshShapeError(
            f"make_mesh: shape {shape} does not match axes {tuple(axis_names)}"
        )
    if int(np.prod(shape)) != world:
        raise MeshShapeError(
            f"make_mesh: a mesh of shape {shape} needs {int(np.prod(shape))} "
            f"ranks, but the process group has {world}"
        )
    from torch.distributed.device_mesh import init_device_mesh

    key = (id(dist.distributed_c10d._get_default_group()), shape,
           tuple(axis_names))
    mesh = _meshes.get(key)
    if mesh is None:
        mesh = init_device_mesh(mesh_device_type(), shape,
                                mesh_dim_names=tuple(axis_names))
        _meshes[key] = mesh
    return mesh


def _product_mesh_enabled(min_devices: int) -> bool:
    if os.environ.get("TX_PRODUCT_MESH", "1") == "0":
        return False
    return world_size() >= min_devices


def data_mesh_or_none(min_devices: int = 2):
    """1-axis ``data`` mesh over every rank, or None when the world has
    fewer than ``min_devices`` ranks (or ``TX_PRODUCT_MESH=0`` disables
    product-path sharding).  The train, validate and SanityChecker paths
    call this to decide whether to split their row axis - the Spark
    partition analog."""
    if not _product_mesh_enabled(min_devices):
        return None
    return make_mesh(axis_names=("data",))


def cv_mesh_or_none(n_replicas: int, min_devices: int = 2):
    """2-axis ``('replica', 'data')`` mesh for the CV fold x grid fan-out
    (the Future-pool analog, reference OpValidator.scala:289-306): the
    replica axis takes the largest divisor r of the world that also
    divides ``n_replicas`` with r^2 <= world, keeping the data axis -
    where the [n, d] matrix lives - at least as large as the replica
    axis."""
    if not _product_mesh_enabled(min_devices):
        return None
    nd = world_size()
    r = 1
    for cand in range(1, int(np.sqrt(nd)) + 1):
        if nd % cand == 0 and n_replicas % cand == 0:
            r = cand
    return make_mesh(axis_names=("replica", "data"), shape=(r, nd // r))


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def block_bounds(n: int, parts: int, index: int) -> tuple[int, int]:
    """[lo, hi) of block ``index`` when ``n`` rows split into ``parts``
    blocks in ``np.array_split`` order (the first ``n % parts`` blocks
    hold one row more)."""
    q, r = divmod(int(n), int(parts))
    lo = index * q + min(index, r)
    return lo, lo + q + (1 if index < r else 0)


def row_block(n: int, mesh, axis: str = "data") -> tuple[int, int]:
    """[lo, hi) of this rank's rows of an ``n``-row array over ``axis``."""
    return block_bounds(n, axis_size(mesh, axis), axis_index(mesh, axis))


def shard_rows(arr, mesh, axis: str = "data"):
    """This rank's block of ``arr``'s leading axis (a view): the port's
    form of placing an array with its rows sharded over the mesh, for
    the replicated host input every rank holds."""
    lo, hi = row_block(arr.shape[0], mesh, axis)
    return arr[lo:hi]


def replicate(arr, mesh):
    """Every rank already holds a replicated input: returned as it is."""
    return arr


def pad_rows_to_multiple(arr: np.ndarray, multiple: int, fill=0.0):
    """Pad the leading axis so it divides evenly across shards; returns
    (padded, n_valid).  The port's blocks may be unequal, so its product
    path never needs this; it is kept for callers of the reference's
    helper."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_shape = (rem,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)]), n


class LocalMesh:
    """A mesh of this rank alone, with no process group: every axis has
    size 1 and ``get_group`` returns None, so the collectives over it are
    local.  The shrink target of a multi-process world
    (``resilience.survivor_mesh``): a survivor cannot form a new group
    while a peer that holds the rendezvous store is gone."""

    device_type = "cpu"

    def __init__(self, axis_names: Sequence[str] = ("data",)) -> None:
        self.mesh_dim_names = tuple(axis_names)
        self.shape = (1,) * len(self.mesh_dim_names)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_group(self, mesh_dim=None):
        return None


def is_writer() -> bool:
    """Whether this process writes the files every rank would race on (a
    saved model, a CV checkpoint): rank 0 of a process group, or the one
    process of a single-process run."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
