"""ctypes bridge to the C++ host kernels (``native/txkernels.cpp``).

Counterpart of ``transmogrifai_tpu/utils/native.py``.  It compiles the
same C++ sources (``native/txkernels.cpp`` and ``native/txtrees.cpp``, so
the library holds the same symbols) with ``g++`` at first use, into a
library of its own, ``transmogrifai_tpu_torch/_build/libtxkernels.so``;
it never writes under ``native/``.  Several processes may build at once
(parallel test workers): each compiles to a temporary file in
``_build/`` and renames it into place, so a reader sees either no
library or a whole one.  When the compiler is missing, the callers take
their python paths (the CSV reader reads through ``csv``), as the JAX
package's do.  The C++ side is host code: the quote-aware CSV scanner,
numeric parsing and murmur3 text hashing.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG)
_SRC = os.path.join(_REPO_ROOT, "native", "txkernels.cpp")
_SRC_TREES = os.path.join(_REPO_ROOT, "native", "txtrees.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(BUILD_DIR, "libtxkernels.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile the sources into ``_LIB`` through a temporary file in the
    same directory and an atomic rename."""
    srcs = [s for s in (_SRC, _SRC_TREES) if os.path.exists(s)]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".libtxkernels.", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", *srcs, "-o", tmp],
            check=True, capture_output=True, timeout=240,
        )
        os.chmod(tmp, 0o755)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def lib_path() -> str:
    """Where the bridge builds and loads its library."""
    return _LIB


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    from ..faults import injection as _faults

    if _faults.inject_unavailable("native.load"):
        # fault drill: the shared library "fails to load" on this call;
        # checked BEFORE the memo so the degradation is per-call and the
        # process recovers the real lib once the drill disarms
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = any(
            os.path.exists(s) and os.path.getmtime(s) > os.path.getmtime(_LIB)
            for s in (_SRC, _SRC_TREES)
        ) if os.path.exists(_LIB) else True
        if stale:
            built = any(
                os.path.exists(s) for s in (_SRC, _SRC_TREES)
            ) and _build()
            # a stale-but-present .so is still usable if the rebuild failed
            # (e.g. no g++ on the serving host)
            if not built and not os.path.exists(_LIB):
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.tx_murmur3_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.tx_tokenize_hash_tf.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_uint32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.tx_parse_doubles.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        try:  # CSV scan kernels (may be absent in a stale lib)
            lib.tx_csv_index.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.tx_csv_index.restype = ctypes.c_int64
            lib.tx_csv_cells.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
        except AttributeError:
            pass
        try:  # GIL-free byte counting (sharded-pipeline workers)
            lib.tx_count_byte.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.tx_count_byte.restype = ctypes.c_int64
            lib.tx_set_csv_threads.argtypes = [ctypes.c_int64]
            lib.tx_set_csv_threads.restype = None
        except AttributeError:
            pass
        try:  # tree learner entry points (native/txtrees.cpp)
            lib.tx_fit_forest_hist.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.tx_fit_gbt_hist.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.tx_predict_forest_hist.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.tx_bin_data.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ]
        except AttributeError:  # stale lib without the tree symbols
            pass
        _lib = lib
        return _lib


def has_tree_symbols() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "tx_fit_forest_hist")


def pack_strings(values: Sequence[Optional[str]]) -> tuple[np.ndarray, np.ndarray]:
    """Pack optional strings into (utf-8 byte buffer, offsets[n+1])."""
    encoded = [v.encode("utf-8") if v else b"" for v in values]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    data = np.frombuffer(b"".join(encoded), dtype=np.uint8).copy()
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)
    return data, offsets


def murmur3_batch(values: Sequence[Optional[str]], seed: int = 42) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    data, offsets = pack_strings(values)
    out = np.zeros(len(values), dtype=np.uint32)
    lib.tx_murmur3_batch(
        data.ctypes.data, offsets.ctypes.data, len(values),
        np.uint32(seed), out.ctypes.data,
    )
    return out


def tokenize_hash_tf(
    values: Sequence[Optional[str]],
    dims: int,
    seed: int = 42,
    min_token_length: int = 1,
    binary: bool = False,
) -> Optional[np.ndarray]:
    """Fused tokenize+hash TF; None if the native lib is unavailable.

    The C++ kernel is byte-oriented: it lowercases ASCII only and hashes
    tokens from a 4096-byte buffer.  The JAX package recomputes rows where
    that could diverge from its python tokenizer (any non-ASCII
    character, or a row past the buffer) on the exact python path; that
    tokenizer comes with the text vectorizers, so such rows raise here.
    """
    lib = get_lib()
    if lib is None:
        return None
    if any(v is not None and (len(v) > 4096 or not v.isascii())
           for v in values):
        raise NotImplementedError(
            "the exact python tokenizer for non-ASCII or long rows is not "
            "ported to the torch package yet (ROADMAP.md queue 1, item 2)")
    data, offsets = pack_strings(values)
    out = np.zeros((len(values), dims), dtype=np.float32)
    lib.tx_tokenize_hash_tf(
        data.ctypes.data, offsets.ctypes.data, len(values),
        np.int32(dims), np.uint32(seed), np.int32(min_token_length),
        np.int32(1 if binary else 0), out.ctypes.data,
    )
    return out


def csv_scan(
    buf: bytes, ncols: int, modes: np.ndarray
) -> Optional[tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Quote-aware CSV scan of one byte chunk via the C++ kernels.

    ``modes`` [ncols] uint8 selects per-column work: 0 = skip, 1 =
    numeric parse, 2 = text cell offsets (bool arrays are accepted as
    numeric-vs-skip for convenience).  Returns (nrows, num_vals
    [ncols, nrows] f64, num_mask [ncols, nrows] bool, cell_begin
    [ncols, nrows] i64, cell_end) - column-major so each column is a
    contiguous slice; the offset arrays are 0-row dummies when no text
    column was requested - or None when the native lib (or the CSV
    symbols) is unavailable.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "tx_csv_index"):
        return None
    modes8 = np.ascontiguousarray(modes, dtype=np.uint8)
    data = np.frombuffer(buf, dtype=np.uint8)
    if data.size == 0:
        z = np.zeros((ncols, 0))
        return 0, z, z.astype(bool), z.astype(np.int64), z.astype(np.int64)
    cap = count_byte(buf, 0x0A)
    if cap is None:  # stale lib without the symbol
        cap = int(np.count_nonzero(data == 0x0A))
    cap += 1
    row_starts = np.zeros(cap, dtype=np.int64)
    nrows = int(
        lib.tx_csv_index(data.ctypes.data, data.size, row_starts.ctypes.data)
    )
    any_mat = bool((modes8 != 0).any())
    num_vals = np.zeros((ncols, nrows), dtype=np.float64)
    num_mask = np.zeros((ncols, nrows), dtype=np.uint8)
    # the kernel records offsets for EVERY materialized column (numeric
    # included, feeding the unicode float() retry); slot indexing is
    # col*nrows, so the buffer is full-shape when anything materializes
    off_rows = nrows if any_mat else 0
    cell_begin = np.zeros((ncols, off_rows), dtype=np.int64)
    cell_end = np.zeros((ncols, off_rows), dtype=np.int64)
    lib.tx_csv_cells(
        data.ctypes.data, data.size, row_starts.ctypes.data, nrows,
        np.int32(ncols), modes8.ctypes.data, num_vals.ctypes.data,
        num_mask.ctypes.data, cell_begin.ctypes.data, cell_end.ctypes.data,
    )
    return nrows, num_vals, num_mask.astype(bool), cell_begin, cell_end


def count_byte(buf: bytes, byte: int) -> Optional[int]:
    """Count occurrences of one byte WITHOUT holding the GIL (ctypes
    releases it for the native call) — the sharded input pipeline's
    workers use this for the quote-parity and newline scans that
    ``bytes.count`` would serialize.  None when the lib lacks the
    symbol (callers fall back to bytes.count)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "tx_count_byte"):
        return None
    if not buf:
        return 0
    return int(lib.tx_count_byte(buf, len(buf), int(byte)))


def set_csv_threads(n: int) -> bool:
    """Install (n >= 1) or clear (n = 0) the dynamic per-scan thread cap
    for ``tx_csv_cells`` — an atomic the kernel reads, NOT an environment
    mutation (setenv while another thread's scan getenv()s is
    use-after-free UB).  The sharded input pipeline caps fan-out through
    this while its workers run.  Returns False when the lib (or symbol)
    is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "tx_set_csv_threads"):
        return False
    lib.tx_set_csv_threads(int(n))
    return True


def parse_doubles(values: Sequence[Optional[str]]) -> Optional[tuple[np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    data, offsets = pack_strings(values)
    out = np.zeros(len(values), dtype=np.float64)
    mask = np.zeros(len(values), dtype=np.uint8)
    lib.tx_parse_doubles(
        data.ctypes.data, offsets.ctypes.data, len(values),
        out.ctypes.data, mask.ctypes.data,
    )
    return out, mask.astype(bool)
