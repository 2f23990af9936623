"""Hand-written CUDA kernels of the package, their wrappers and their plain
versions.

Counterpart of ``transmogrifai_tpu/parallel/pallas_kernels.py``.  Each
kernel's CUDA source lives under ``transmogrifai_tpu_torch/csrc/``; at
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``_build/`` (one library per
source, named by the hash of its text and of every ``csrc`` header it
includes, such as ``tile_ring.cuh``) and loaded with ``ctypes``.

A wrapper takes a tensor's device as the whole dispatch rule: for a CPU
tensor it runs the kernel's plain torch version (what the CPU tests
exercise); for a CUDA tensor it launches the kernel or raises - it never
falls back.  Each wrapper counts its launches in ``<wrapper>.launches``.
A kernel that does not build or launch raises :class:`KernelError`, and
:func:`is_device_fault` is the one rule by which the serving and
registry layers tell such a fault (or a ``torch.AcceleratorError``) from
an error they may degrade around: a device fault is never degraded away.

Kernels:

* ``fused_moments`` (``csrc/fused_moments.cu``) - the SanityChecker's
  one-sweep column moments; replaces ``pallas_kernels._moments_pallas``.
  ``fused_moments_sharded`` runs it on each rank's row block of a mesh and
  all-reduces the partials (the JAX package's ``fused_moments_sharded``).
* ``bin_matrix`` (``csrc/bin_matrix.cu``) - the tree learner's quantile
  binning of the design matrix, written in the learner's device dtype;
  replaces ``pallas_kernels._bin_pallas``.  It is also the first step of
  every tree head in the device-fused scoring program
  (``models/trees.predict_arrays_torch``), once per scored batch.

Each kernel also has a ``*_floor`` function (``fused_moments_floor``,
``bin_matrix_floor``): an empty kernel launched with the kernel's own
grid, threads and dynamic shared memory for the same arguments, which a
timing puts beside the kernel to tell the launch from the work.  It
computes nothing and counts no launch.  ``bin_matrix_on_route`` launches
K2 with its ring or small route forced, whichever its plan would choose,
to time the two beside each other; it counts no launch either.

NaN in ``bin_matrix``: a NaN x takes the count of the column's non-NaN
edges, as the host binning does (numpy's ``searchsorted`` and the C++
``tx_bin_data`` both sort NaN last).  The JAX package's traceable mirror
``trees._bin_xla`` maps NaN to +inf and then counts the edges below +inf;
the two agree unless an edge is +inf itself.  The port never pads edge
rows (they are the training column's quantiles), so an edge is +inf only
where the training column held +inf; there the device program follows
the host route, which is what its rows are held against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.distributed as dist

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: kernel name -> (source under csrc/, {C entry point: its argtypes}); each
#: ``*_floor`` entry launches an empty kernel with the kernel's own grid,
#: threads and dynamic shared memory (what the launch alone costs)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNELS = {
    "fused_moments": ("fused_moments.cu", {
        "tx_fused_moments": (_P, _P, _L, _I, _P, _L, _P, _I, _P, _P,
                             ctypes.POINTER(_L), ctypes.POINTER(_I)),
        "tx_fused_moments_floor": (_P, _P, _L, _I, _P),
    }),
    "bin_matrix": ("bin_matrix.cu", {
        "tx_bin_matrix": (_P, _P, _L, _I, _I, _I, _P, _I, _P),
        "tx_bin_matrix_floor": (_P, _L, _I, _I, _I, _P),
    }),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build (``nvcc`` missing or failing),
    to load, or to launch (a CUDA error, or the kernel refusing a shape)."""


#: the errors that mean the card or one of its kernels failed
DEVICE_FAULTS = (KernelError,) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)


def is_device_fault(e: BaseException) -> bool:
    """True for a :class:`KernelError` or a ``torch.AcceleratorError``:
    errors that a serving or registry catch-all re-raises unchanged
    instead of degrading (re-scoring row by row, serving cold, re-scoring
    a canary's rows on stable)."""
    return isinstance(e, DEVICE_FAULTS)
#: kernel name -> nvcc's output (ptxas' registers, shared memory and
#: spills of each kernel) for the libraries this process compiled
BUILD_LOG: dict[str, str] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _sources(name: str) -> list[Path]:
    """The kernel's source and every file it includes by a quoted
    ``#include``, followed through the headers, in a fixed order."""
    todo, seen = [CSRC / KERNELS[name][0]], []
    while todo:
        path = todo.pop(0)
        if path not in seen:
            seen.append(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())]
    return seen


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in _sources(name):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns name -> path
    of the shared library.  Raises :class:`KernelError` when nvcc is
    missing, and naming the source and nvcc's output when a compile
    fails."""
    names = list(KERNELS) if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        if not (os.path.isfile(nvcc) and os.access(nvcc, os.X_OK)):
            raise KernelError(
                f"nvcc not found: {nvcc} is not an executable (set CUDA_HOME "
                "or put nvcc on PATH)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / KERNELS[n][0])]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{KERNELS[n][0]}:\n{out.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[n])  # atomic: a reader never sees half
                BUILD_LOG[n] = out.decode(errors="replace")
        if failed:
            raise KernelError("nvcc failed for " + "\n".join(failed))
    return paths


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            entries = KERNELS[name][1]
            try:
                lib = ctypes.CDLL(str(path))
                fns = {entry: getattr(lib, entry) for entry in entries}
            except (OSError, AttributeError) as e:
                raise KernelError(f"cannot load {name} from {path}: {e}") from e
            for entry, fn in fns.items():
                fn.argtypes = list(entries[entry])
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


# ---------------------------------------------------------------------------
# fused moments
# ---------------------------------------------------------------------------
#: the plain version's chunk size: it widens one chunk at a time to
#: float64 and combines the partials in float64, so the widened copy stays
#: bounded.  The kernel combines in float64 by design and needs no chunks.
_CHUNK_ROWS = 1 << 22
#: (device index, stream handle) -> the kernel's float64 partial scratch
#: and its combine counters, as large as the largest plan on the stream
#: needed; every launch leaves the counters at 0 for the next on its stream
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
#: the C entry's code for scratch shorter than its plan needs (kErrScratch
#: in csrc/fused_moments.cu)
_MOMENTS_ERR_SCRATCH = -1


def _launch_moments(lib, x: torch.Tensor, y: torch.Tensor, out: torch.Tensor,
                    stream: int) -> int:
    """Launch the moments kernel on x, y into ``out`` on ``stream`` with
    the stream's scratch.  Where the scratch is shorter than the C entry's
    plan for these inputs, the entry says what it needs without launching;
    the scratch grows to that and the launch is made again.  Returns the C
    entry's code."""
    n, d = x.shape
    key = (x.device.index, stream)
    if key not in _scratch:
        _scratch[key] = (
            torch.empty(0, dtype=torch.float64, device=x.device),
            torch.zeros(0, dtype=torch.int32, device=x.device))
    need_partial, need_counters = _L(0), _I(0)
    for _ in range(2):  # the plan for the same inputs needs no more twice
        partial, counter = _scratch[key]
        rc = lib.tx_fused_moments(
            x.data_ptr(), y.data_ptr(), n, d, partial.data_ptr(),
            partial.numel(), counter.data_ptr(), counter.numel(),
            out.data_ptr(), stream, ctypes.byref(need_partial),
            ctypes.byref(need_counters))
        if rc != _MOMENTS_ERR_SCRATCH:
            return rc
        if need_partial.value > partial.numel():
            partial = torch.empty(need_partial.value, dtype=torch.float64,
                                  device=x.device)
        if need_counters.value > counter.numel():
            counter = torch.zeros(need_counters.value, dtype=torch.int32,
                                  device=x.device)
        _scratch[key] = (partial, counter)
    return rc


def _combine_moments_f64(parts):
    """Combine per-chunk 7-tuples in float64 (5 sums, then min/max)."""
    acc = None
    for p in parts:
        p = [v.to(torch.float64) for v in p]
        if acc is None:
            acc = p
        else:
            for j in range(5):
                acc[j] = acc[j] + p[j]
            acc[5] = torch.minimum(acc[5], p[5])
            acc[6] = torch.maximum(acc[6], p[6])
    return acc


def _moments_chunk_f64(x: torch.Tensor, y: torch.Tensor):
    """One chunk's five sums accumulated in float64 (each float32 value
    widened exactly first), and its float32 min and max."""
    xd, yd = x.to(torch.float64), y.to(torch.float64)
    return (
        xd.sum(dim=0), (xd * xd).sum(dim=0), (xd * yd[:, None]).sum(dim=0),
        yd.sum(), (yd * yd).sum(), x.amin(dim=0), x.amax(dim=0),
    )


def fused_moments_plain(x: torch.Tensor, y: torch.Tensor):
    """The plain torch version of :func:`fused_moments`: the same seven
    results from torch reductions (the JAX package's ``fused_moments``
    contract).  The sums, squared sums and cross sums accumulate in
    float64, chunk by chunk above ``_CHUNK_ROWS`` rows, and come back as
    float32: a float32 sum in torch's order moves an off-centre column's
    Pearson correlation by 2.5e-5 relative at 2 000 rows."""
    n = x.shape[0]
    acc = _combine_moments_f64(
        _moments_chunk_f64(x[i: i + _CHUNK_ROWS], y[i: i + _CHUNK_ROWS])
        for i in range(0, n, _CHUNK_ROWS)
    )
    return tuple(v.to(torch.float32) for v in acc)


def _check_moments_args(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(
            f"fused_moments takes float32 x and y, got {x.dtype} and {y.dtype}"
        )
    if x.dim() != 2 or y.dim() != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(
            "fused_moments takes x [n, d] and y [n], got "
            f"{tuple(x.shape)} and {tuple(y.shape)}"
        )
    n, d = x.shape
    if n < 1 or d < 1:
        raise ValueError(f"fused_moments needs n >= 1 and d >= 1, got {n}, {d}")
    if x.device != y.device:
        raise ValueError(
            f"fused_moments: x on {x.device} but y on {y.device}"
        )


def fused_moments(x: torch.Tensor, y: torch.Tensor):
    """One-pass column moments of [n, d] x against label y.

    Returns (x_sum, x_sq_sum, xy_sum, y_sum, y_sq_sum, x_min, x_max) as
    float32 tensors on x's device: five [d] vectors and two 0-d scalars
    (the contract of the JAX package's ``fused_moments``).  min/max
    propagate NaN.  A CPU input runs :func:`fused_moments_plain`; a CUDA
    input (any storage offset, such as a row view ``x[1:]``) launches
    ``csrc/fused_moments.cu`` on the current stream without
    synchronising.
    """
    _check_moments_args(x, y)
    if x.device.type == "cpu":
        return fused_moments_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"fused_moments: unsupported device {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("fused_moments takes contiguous x and y")
    n, d = x.shape
    lib = _load("fused_moments")
    with torch.cuda.device(x.device):
        out = torch.empty(5 * d + 2, dtype=torch.float32, device=x.device)
        rc = _launch_moments(lib, x, y, out,
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"fused_moments kernel launch failed: CUDA error {rc}")
    fused_moments.launches += 1
    x_sum, x_sq, xy, x_min, x_max = out[: 5 * d].view(5, d).unbind(0)
    y_sum, y_sq = out[5 * d:].unbind(0)
    return x_sum, x_sq, xy, y_sum, y_sq, x_min, x_max


fused_moments.launches = 0


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches on a CUDA tensor, not {x.device}")


def fused_moments_floor(x: torch.Tensor, y: torch.Tensor) -> None:
    """Launch an empty kernel with :func:`fused_moments`' grid, threads and
    dynamic shared memory for these inputs, on the current stream: what the
    launch alone costs, to time beside the kernel.  Computes nothing and is
    not counted in ``fused_moments.launches``."""
    _check_moments_args(x, y)
    _require_cuda(x, "fused_moments_floor")
    lib = _load("fused_moments")
    with torch.cuda.device(x.device):
        rc = lib.tx_fused_moments_floor(
            x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"fused_moments_floor launch failed: CUDA error {rc}")


def fused_moments_sharded(x, y, mesh, device=None):
    """:func:`fused_moments` with the row axis split over ``mesh``'s
    ``data`` group: each rank runs the kernel (K1 on a CUDA device) on its
    own row block, then the ranks all-reduce the five sums in float64
    (SUM) and the extremes (MIN of ``[x_min, -x_max]``).  An empty block
    contributes 0, +inf and -inf.  Returns the seven float32 results on
    the rank's device, equal on every rank.

    ``x`` and ``y`` are either the replicated inputs every rank holds (a
    host array or a tensor; the rank takes its ``np.array_split`` block,
    ``mesh.row_block``) or each rank's own rows as
    ``distributed.host_local_to_global`` gives them.  A replicated host
    input is only valid when it is the same on every rank: the ranks
    compare a fingerprint of it first and raise ``ValueError`` otherwise,
    as the JAX package raises for a host input on a multi-process
    runtime.  No masked variant is needed: unequal blocks need no padding
    rows.  ``device`` (default: the input tensor's, else ``"cuda"``) is
    where the kernel runs for a host input."""
    from ..utils.device import resolve_device
    from .distributed import RowShard, check_replicated
    from .mesh import row_block

    group = mesh.get_group("data")
    if isinstance(x, RowShard) or isinstance(y, RowShard):
        if not (isinstance(x, RowShard) and isinstance(y, RowShard)):
            raise ValueError(
                "fused_moments_sharded takes x and y both replicated or both "
                "as host_local_to_global row shards")
        xb, yb = x.local, y.local
    else:
        check_replicated("fused_moments_sharded", group, x, y)
        lo, hi = row_block(x.shape[0], mesh)
        xb, yb = x[lo:hi], y[lo:hi]
    if device is None:
        device = xb.device if isinstance(xb, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    d = int(xb.shape[1])
    if xb.shape[0]:
        xt = torch.as_tensor(xb).to(device=dev, dtype=torch.float32).contiguous()
        yt = torch.as_tensor(yb).to(device=dev, dtype=torch.float32).contiguous()
        x_sum, x_sq, xy, y_sum, y_sq, x_min, x_max = fused_moments(xt, yt)
        sums = torch.cat([x_sum, x_sq, xy, y_sum.reshape(1),
                          y_sq.reshape(1)]).to(torch.float64)
        ext = torch.cat([x_min, -x_max]).to(torch.float64)
    else:
        sums = torch.zeros(3 * d + 2, dtype=torch.float64, device=dev)
        ext = torch.full((2 * d,), float("inf"), dtype=torch.float64,
                         device=dev)
    if group is not None:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(ext, op=dist.ReduceOp.MIN, group=group)
    sums, ext = sums.to(torch.float32), ext.to(torch.float32)
    return (sums[:d], sums[d:2 * d], sums[2 * d:3 * d], sums[3 * d],
            sums[3 * d + 1], ext[:d], -ext[d:])


# ---------------------------------------------------------------------------
# quantile binning
# ---------------------------------------------------------------------------
#: the plain version's chunk: at most this many [rows, d, E] compares at
#: once (the JAX package's jnp fallback cap), so the boolean broadcast
#: never materializes whole (1M x 512 x 63 would be 32 GB)
_BIN_CHUNK_ELEMS = 1 << 27
_BIN_DTYPES = (torch.int8, torch.int32)
#: the C entry's codes for a launch plan that does not fit (kErrEdges,
#: kErrGrid in csrc/bin_matrix.cu, which plans the grid) and for a route
#: forced on its column-tiled plan (kErrRoute)
_BIN_ERR_EDGES, _BIN_ERR_GRID, _BIN_ERR_ROUTE = -1, -2, -3
#: the C entry's route argument: the plan's own, or the one forced
_BIN_ROUTES = {None: -1, "ring": 0, "small": 1}


def bin_matrix_plain(x: torch.Tensor, edges: torch.Tensor,
                     out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The plain torch version of :func:`bin_matrix`: a row-chunked
    comparison count, as the JAX package's jnp fallback computes it.  (A
    ``torch.searchsorted`` would rank a NaN x at 0, not after the edges.)"""
    n, d = x.shape
    n_edges = edges.shape[1]
    nan_free = (~torch.isnan(edges)).sum(dim=1).to(torch.int32)
    block = max(1, min(n, _BIN_CHUNK_ELEMS // max(d * n_edges, 1)))
    out = torch.empty((n, d), dtype=out_dtype, device=x.device)
    for i in range(0, n, block):
        xb = x[i: i + block]
        count = (edges[None, :, :] < xb[:, :, None]).sum(
            dim=-1, dtype=torch.int32)
        out[i: i + block] = torch.where(
            torch.isnan(xb), nan_free[None, :], count).to(out_dtype)
    return out


def _check_bin_args(x: torch.Tensor, edges: torch.Tensor,
                    out_dtype: torch.dtype) -> None:
    if x.dtype != torch.float32 or edges.dtype != torch.float32:
        raise TypeError(
            f"bin_matrix takes float32 x and edges, got {x.dtype} and "
            f"{edges.dtype}"
        )
    if x.dim() != 2 or edges.dim() != 2 or edges.shape[0] != x.shape[1]:
        raise ValueError(
            "bin_matrix takes x [n, d] and edges [d, E], got "
            f"{tuple(x.shape)} and {tuple(edges.shape)}"
        )
    n, d = x.shape
    if n < 1 or d < 1:
        raise ValueError(f"bin_matrix needs n >= 1 and d >= 1, got {n}, {d}")
    if out_dtype not in _BIN_DTYPES:
        raise TypeError(f"bin_matrix writes int8 or int32, not {out_dtype}")
    if out_dtype == torch.int8 and edges.shape[1] + 1 > 127:
        raise ValueError(
            f"bin_matrix: int8 bins take at most 126 edges per column "
            f"(max_bins <= 127), got {edges.shape[1]}"
        )
    if x.device != edges.device:
        raise ValueError(
            f"bin_matrix: x on {x.device} but edges on {edges.device}"
        )


def bin_matrix(x: torch.Tensor, edges: torch.Tensor,
               out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Quantile bins [n, d] of float32 x [n, d] against per-column edges
    [d, E]: the count of edges strictly below each x
    (``np.searchsorted(side='left')``), and for a NaN x the count of
    non-NaN edges - the contract of the JAX package's ``bin_matrix`` -
    written as ``out_dtype`` (int8 or int32).  A CPU input runs
    :func:`bin_matrix_plain`; a CUDA input (any storage offset, such as a
    row view ``x[3:]``) launches ``csrc/bin_matrix.cu`` on the current
    stream without synchronising."""
    _check_bin_args(x, edges, out_dtype)
    if x.device.type == "cpu":
        return bin_matrix_plain(x, edges, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bin_matrix: unsupported device {x.device}")
    out = _launch_bins(x, edges, out_dtype, None)
    bin_matrix.launches += 1
    return out


bin_matrix.launches = 0


def _launch_bins(x: torch.Tensor, edges: torch.Tensor, out_dtype: torch.dtype,
                 route) -> torch.Tensor:
    """Launch the binning kernel on CUDA x and edges on the current stream,
    on the plan's route (``route`` None) or the one named."""
    if not (x.is_contiguous() and edges.is_contiguous()):
        raise ValueError("bin_matrix takes contiguous x and edges")
    n, d = x.shape
    n_edges = edges.shape[1]
    out = torch.empty((n, d), dtype=out_dtype, device=x.device)
    lib = _load("bin_matrix")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tx_bin_matrix(
            x.data_ptr(), edges.data_ptr(), n, d, n_edges,
            int(out_dtype == torch.int8), out.data_ptr(), _BIN_ROUTES[route],
            stream,
        )
    if rc == _BIN_ERR_EDGES:
        raise KernelError(
            f"bin_matrix: {n_edges} edges per column exceed the kernel's "
            "shared memory"
        )
    if rc == _BIN_ERR_GRID:
        raise KernelError(f"bin_matrix: {n} x {d} exceeds the kernel's grid")
    if rc == _BIN_ERR_ROUTE:
        raise KernelError(
            f"bin_matrix: {n} x {d} with {n_edges} edges takes the "
            f"column-tiled kernel, not the {route} route")
    if rc != 0:
        raise KernelError(f"bin_matrix kernel launch failed: CUDA error {rc}")
    return out


def bin_matrix_on_route(x: torch.Tensor, edges: torch.Tensor,
                        out_dtype: torch.dtype, route: str) -> torch.Tensor:
    """:func:`bin_matrix` on CUDA tensors with its ``"ring"`` or
    ``"small"`` route forced, whichever the launch plan would choose: to
    time the two routes beside each other where the plan picks one.  The
    same bins; counts no launch; raises :class:`KernelError` where the
    edge table takes the column-tiled kernel."""
    _check_bin_args(x, edges, out_dtype)
    _require_cuda(x, "bin_matrix_on_route")
    if route not in ("ring", "small"):
        raise ValueError(f"bin_matrix_on_route: no route {route!r}")
    return _launch_bins(x, edges, out_dtype, route)


def bin_matrix_floor(x: torch.Tensor, edges: torch.Tensor,
                     out_dtype: torch.dtype = torch.int32) -> None:
    """Launch an empty kernel with :func:`bin_matrix`'s grid, threads and
    dynamic shared memory for these arguments, on the current stream: what
    the launch alone costs, to time beside the kernel.  Computes nothing
    and is not counted in ``bin_matrix.launches``."""
    _check_bin_args(x, edges, out_dtype)
    _require_cuda(x, "bin_matrix_floor")
    lib = _load("bin_matrix")
    with torch.cuda.device(x.device):
        rc = lib.tx_bin_matrix_floor(
            x.data_ptr(), x.shape[0], x.shape[1], edges.shape[1],
            int(out_dtype == torch.int8),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"bin_matrix_floor launch failed: CUDA error {rc}")

#: every kernel wrapper, whose launch counts a run resets and reads
WRAPPERS = (fused_moments, bin_matrix)
