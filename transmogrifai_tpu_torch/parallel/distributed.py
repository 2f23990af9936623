"""The multi-process runtime on ``torch.distributed``: bootstrap, meshes,
row hand-off and the row reductions.

Counterpart of ``transmogrifai_tpu/parallel/distributed.py`` (reference:
Spark's shuffle, broadcast and driver-mediated treeAggregate, SURVEY
§2.9/§5.8).  The JAX package rides ``jax.distributed`` and lets XLA
insert ``psum``; this package runs one process per GPU and calls the
collectives itself - NCCL for CUDA tensors, gloo for CPU tensors (and for
CUDA tensors where a world shares one card, as the CPU tests and the
one-card chip run do).

* ``initialize``           - ``init_process_group`` from the variables
                             ``torchrun`` sets (``MASTER_ADDR``,
                             ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
                             ``LOCAL_RANK``) or from explicit arguments;
                             idempotent, a no-op without either, and under
                             the bootstrap deadline ``TX_MESH_INIT_TIMEOUT_S``
                             (default 60 s): an absent coordinator raises
                             :class:`MeshBootstrapError` instead of hanging.
                             Each rank then drives ``cuda:{LOCAL_RANK}``.
* ``global_mesh``          - a mesh over every rank
* ``host_local_to_global`` - the reader -> partition hand-off: each rank's
                             own row block, with the global row count and
                             its offset (:class:`RowShard`)
* ``all_reduce_stats``     - driverless treeAggregate: each rank reduces
                             its rows, the partials are summed over the
                             mesh's data group
* :class:`RowReducer`      - the row reductions of the sharded fits (the
                             ``psum`` XLA inserts for the reference): one
                             all-reduce per call over the data group, the
                             identity without a mesh

Shape problems fail before any collective: a 0-d input, a missing axis or
mismatched leading axes raise :class:`MeshShapeError` naming the array
and the axis.  Blocks may be unequal (``mesh.block_bounds``), so rows
indivisible by the mesh are not an error here, unlike the reference,
whose GSPMD shards must be equal.  Recovery from stalled collectives
lives in ``parallel/resilience.py``.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..faults import injection as _faults
from ..obs import trace as _obs_trace
from ..utils.device import set_rank_device
from .mesh import axis_index, axis_size, block_bounds, make_mesh, row_block

_initialized = False
#: the backend string this module initialised the default group with
_backend: Optional[str] = None

DEFAULT_INIT_TIMEOUT_S = 60.0

#: the variables torchrun sets; any of them means "one process of a
#: multi-process job" (init_method="env://" reads them)
_BOOTSTRAP_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                  "LOCAL_RANK")


class MeshBootstrapError(RuntimeError):
    """initialize() could not bring up the process group within the
    bootstrap deadline: the coordinator is absent, unreachable, or a peer
    never registered (SURVEY §5.3: a missing coordinator must page, not
    hang forever)."""


class MeshShapeError(ValueError):
    """An array handed to the mesh helpers cannot shard as asked (0-d,
    mismatched leading axes, or an axis the mesh lacks) - raised up front
    with the offending array named, before any collective."""


def default_backend() -> str:
    """``"cpu:gloo,cuda:nccl"`` where CUDA is present, else ``"gloo"``."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: Optional[float] = None,
    backend: Optional[str] = None,
) -> None:
    """Bring up the default process group.  No-op for a single process
    (no arguments and none of the ``torchrun`` variables); with no
    arguments it reads those variables (``init_method="env://"``).
    ``coordinator_address`` is ``host:port`` (TCP rendezvous) or any
    ``init_method`` URL such as ``file:///path``.  ``backend`` defaults
    to :func:`default_backend`.

    The connect runs in a daemon worker joined with ``timeout_s``
    (default ``TX_MESH_INIT_TIMEOUT_S``, 60 s): a coordinator that never
    answers raises :class:`MeshBootstrapError` naming the address, and
    ``_initialized`` latches only on success, so a failed bootstrap can
    be retried.  The ``mesh.init_no_coordinator`` fault point drills the
    absent coordinator without a network.  A group brought up by the
    caller (``init_process_group`` under ``torchrun``) is adopted.  On
    success each rank's current CUDA device becomes ``LOCAL_RANK`` (else
    the rank modulo the device count), so ``device="cuda"`` means the
    rank's own GPU."""
    global _initialized, _backend
    if _initialized and dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    env_driven = any(k in os.environ for k in _BOOTSTRAP_ENV)
    if not explicit and not env_driven:
        # single process: nothing to bring up, and no latch, so a later
        # call with real coordinator arguments still initialises
        return
    if timeout_s is None:
        timeout_s = float(
            os.environ.get("TX_MESH_INIT_TIMEOUT_S", DEFAULT_INIT_TIMEOUT_S))
    backend = backend or default_backend()
    if explicit:
        address = coordinator_address or "env://"
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
    else:
        address = "{}:{}".format(os.environ.get("MASTER_ADDR", "<env>"),
                                 os.environ.get("MASTER_PORT", "<env>"))
        world = int(os.environ.get("WORLD_SIZE", 1))
        rank = int(os.environ.get("RANK", 0))
    no_coordinator = _faults.fires("mesh.init_no_coordinator")
    outcome: dict = {}

    def _connect() -> None:
        try:
            if no_coordinator is not None:
                # drill: the coordinator is absent - block like a dead
                # dial instead of touching the real rendezvous
                time.sleep(no_coordinator.delay)
                return
            if not dist.is_initialized():
                outcome["created"] = True
                dist.init_process_group(
                    backend=backend,
                    init_method=(_init_method(address) if explicit
                                 else "env://"),
                    world_size=world, rank=rank,
                )
            outcome["ok"] = True
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            outcome["error"] = e

    with _obs_trace.span("mesh.bootstrap", address=str(address),
                         timeout_s=round(timeout_s, 3)) as sp:
        worker = threading.Thread(target=_connect, daemon=True,
                                  name="tx-mesh-bootstrap")
        worker.start()
        worker.join(timeout_s)
        if "error" in outcome:
            raise outcome["error"]  # _initialized stays False: retryable
        if not outcome.get("ok"):
            sp.set_attr("outcome", "timeout")
            from .resilience import mesh_telemetry

            mesh_telemetry().record_bootstrap_timeout(address, timeout_s)
            raise MeshBootstrapError(
                f"mesh bootstrap did not reach coordinator {address!r} "
                f"within {timeout_s:.0f}s (TX_MESH_INIT_TIMEOUT_S): "
                "coordinator down, address wrong, or a peer never "
                "registered"
            )
        sp.set_attr("outcome", "ok")
    _backend = backend if outcome.get("created") else str(dist.get_backend())
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        set_rank_device(local % torch.cuda.device_count())
    _initialized = True


def shutdown() -> None:
    """Destroy the default group this module brought up (so that later
    work runs at world 1 with no group) and forget its meshes."""
    global _initialized, _backend
    from . import mesh as _mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    _mesh._meshes.clear()
    set_rank_device(None)
    _initialized, _backend = False, None


def global_mesh(axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None):
    """Mesh over every rank of every host.  With one axis the data axis
    spans them all; a leading ``replica`` axis keeps each CV replica's
    data group together."""
    return make_mesh(axis_names=tuple(axis_names), shape=shape)


# -- shape checks -------------------------------------------------------------

def _require_axis(op: str, mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise MeshShapeError(f"{op}: mesh has no axis {axis!r} (axes: {names})")
    return axis_size(mesh, axis)


def _leading_rows(op: str, name: str, a, axis: str) -> int:
    shape = tuple(a.shape) if hasattr(a, "shape") else np.shape(a)
    if len(shape) < 1:
        raise MeshShapeError(
            f"{op}: {name} is 0-d (shape {shape}) - it has no leading axis "
            f"to shard over mesh axis {axis!r}"
        )
    return int(shape[0])


# -- collectives ----------------------------------------------------------------

def collective_device() -> torch.device:
    """Where small bookkeeping tensors of a collective live: the rank's
    card on an NCCL group, else the CPU (gloo)."""
    backend = _backend or (str(dist.get_backend()) if dist.is_initialized()
                           else "gloo")
    if "nccl" in backend.lower() and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_ranked(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), in rank order of
    ``group``; ``[t]`` without a group."""
    if group is None:
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def _gathered_counts(n_local: int, group) -> list[int]:
    """Each rank's row count in rank order of ``group``."""
    dev = collective_device()
    return [int(c) for c in all_gather_ranked(
        torch.tensor([n_local], dtype=torch.int64, device=dev), group)]


@dataclass
class RowShard:
    """One rank's row block of a global array: ``local`` holds rows
    ``[offset, offset + len(local))`` of ``global_rows`` (the port's form
    of a globally sharded ``jax.Array``)."""

    local: Any
    global_rows: int
    offset: int

    @property
    def shape(self) -> tuple:
        return (self.global_rows,) + tuple(self.local.shape[1:])


def host_local_to_global(local_rows, mesh, axis: str = "data") -> RowShard:
    """Each rank contributes its own row block of the design matrix;
    returns it as a :class:`RowShard` with the global row count and the
    block's offset (rank order along ``axis``).  Blocks may differ in
    size.  One collective: the row counts' all-gather."""
    _require_axis("host_local_to_global", mesh, axis)
    n_local = _leading_rows("host_local_to_global", "local_rows",
                            local_rows, axis)
    counts = _gathered_counts(n_local, mesh.get_group(axis))
    me = axis_index(mesh, axis)
    return RowShard(local_rows, int(sum(counts)), int(sum(counts[:me])))


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _local_block(a, mesh, axis: str):
    """This rank's rows of a replicated array, or a RowShard's own."""
    if isinstance(a, RowShard):
        return a.local
    lo, hi = row_block(a.shape[0], mesh, axis)
    return a[lo:hi]


def all_reduce_stats(fn, mesh, *arrays, axis: str = "data"):
    """``fn`` over row-sharded inputs, summed over the mesh: each rank
    applies ``fn`` to its row block (of a replicated array, or a
    :class:`RowShard`'s own rows) and every output is all-reduced with
    SUM over the ``axis`` group - the treeAggregate analog, valid for an
    ``fn`` whose outputs are sums over rows.  Inputs become torch tensors
    (a host array on the CPU, or on the rank's card on an NCCL group);
    outputs come back as tensors of ``fn``'s structure."""
    _require_axis("all_reduce_stats", mesh, axis)
    n0: Optional[int] = None
    i0 = 0
    for i, a in enumerate(arrays):
        n = (a.global_rows if isinstance(a, RowShard)
             else _leading_rows("all_reduce_stats", f"array {i}", a, axis))
        if n0 is None:
            n0, i0 = n, i
        elif n != n0:
            raise MeshShapeError(
                f"all_reduce_stats: array {i} has {n} rows (shape "
                f"{tuple(a.shape)}) but array {i0} has {n0} - row-sharded "
                f"inputs must agree on the leading axis"
            )
    dev = collective_device()
    blocks = [_as_tensor(_local_block(a, mesh, axis), dev) for a in arrays]
    out = fn(*blocks)
    leaves = list(out) if isinstance(out, (tuple, list)) else [out]
    group = mesh.get_group(axis)
    for t in leaves:
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return type(out)(leaves) if isinstance(out, (tuple, list)) else leaves[0]


def replicated_digest(a) -> int:
    """A 63-bit fingerprint of a host array or tensor: its shape and an
    even sample of at most 64 rows (the first and last included), so that
    ranks can check cheaply that they hold the same replicated input."""
    n = int(a.shape[0])
    idx = np.unique(np.linspace(0, max(n - 1, 0), num=min(n, 64)).astype(np.int64))
    rows = a[torch.as_tensor(idx)] if isinstance(a, torch.Tensor) else a[idx]
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    h = hashlib.blake2b(digest_size=8)
    h.update(repr(tuple(a.shape)).encode())
    h.update(np.ascontiguousarray(rows).tobytes())
    return int.from_bytes(h.digest(), "little") >> 1


def check_replicated(op: str, group, *arrays) -> None:
    """Raise ``ValueError`` unless every rank of ``group`` holds the same
    arrays (by :func:`replicated_digest`): a host input is only valid on
    a multi-process runtime when it is replicated on every process."""
    if group is None or dist.get_world_size(group) == 1:
        return
    dev = collective_device()
    mine = torch.tensor([replicated_digest(a) for a in arrays],
                        dtype=torch.int64, device=dev)
    lo, hi = mine.clone(), mine.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise ValueError(
            f"{op} received a host-resident input that differs between the "
            "ranks of a multi-process runtime; pass each rank's own rows "
            "as parallel.distributed.host_local_to_global(...) (host "
            "inputs are only valid when replicated on every process)"
        )


class RowReducer:
    """The reductions over rows of a fit whose rows are split over a
    mesh's ``data`` group - the ``psum`` that XLA inserts for the
    reference, issued here as ``dist.all_reduce``.  Without a mesh (world
    1, the default) every method is the identity, so the single-device
    fit runs op for op as before.  ``n_rows`` is the global row count."""

    def __init__(self, mesh=None, n_rows: Optional[int] = None,
                 axis: str = "data") -> None:
        self.mesh = mesh
        self.group = None if mesh is None else mesh.get_group(axis)
        self.n_rows = n_rows
        self.collectives = 0

    @property
    def sharded(self) -> bool:
        return self.group is not None

    def sum(self, *ts: torch.Tensor) -> tuple:
        """Each tensor summed over the group, in one all-reduce of their
        flattened concatenation (one dtype)."""
        if self.group is None:
            return ts
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self.collectives += 1
        out, i = [], 0
        for t in ts:
            out.append(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()
        return tuple(out)

    def mean_rows(self, X: torch.Tensor) -> torch.Tensor:
        """Column means over the global rows."""
        if self.group is None:
            return X.mean(dim=0)
        return self.sum(X.sum(dim=0))[0] / self.n_rows

    def any(self, flag: torch.Tensor) -> bool:
        """True when ``flag`` holds on any rank (MAX over the group)."""
        if self.group is None:
            return bool(flag)
        v = flag.reshape(1).to(torch.int32)
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        self.collectives += 1
        return bool(v[0])

    def sum_ranked(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group in rank order (an all-gather, then
        the adds in a fixed order), so the same partials give the same
        bits from run to run whatever schedule the backend's all-reduce
        takes."""
        if self.group is None:
            return t
        parts = all_gather_ranked(t, self.group)
        self.collectives += 1
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


def gather_candidates(t: torch.Tensor, mesh, axis: str = "replica"):
    """The candidate blocks of a ``replica`` split, all-gathered and
    concatenated in candidate order (rank order along ``axis``)."""
    if mesh is None or axis not in tuple(mesh.mesh_dim_names or ()):
        return t
    return torch.cat(all_gather_ranked(t, mesh.get_group(axis)), dim=0)


def candidate_block(B: int, mesh, axis: str = "replica") -> tuple[int, int]:
    """[lo, hi) of this rank's candidates when B split over ``axis``."""
    if mesh is None or axis not in tuple(mesh.mesh_dim_names or ()):
        return 0, B
    return block_bounds(B, axis_size(mesh, axis), axis_index(mesh, axis))
