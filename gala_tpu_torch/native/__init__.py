"""Native (C++/OpenMP) preprocessing, loaded through ctypes.

The C++ source is this package's own `csr_ops.cpp`, a verbatim copy of
the JAX package's (tests/test_torch_host.py keeps the two equal), so both
packages run the same host code and the port reads nothing of the JAX
package, and `csr_stable.cpp`, the port's own stable counting sort, which
`coo_to_csr_native` runs in place of the copy's `coo_to_csr_i32`: that
one places edges through atomic per-row cursors, so a row's edge order,
and with it the layouts' slot order and float sums, changed from run to
run.  Both are compiled lazily on first use with g++ into one library in
the port's build directory (`gala_tpu_torch/_build/`, git-ignored);
nothing is written next to the sources.  Every entry point has a NumPy
fallback in gala_tpu_torch.data, so environments without a toolchain
(or without the source) lose speed, not functionality.
Set GALA_TPU_NO_NATIVE=1 to force the NumPy paths.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csr_ops.cpp")
_STABLE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csr_stable.cpp")
_SO = os.path.join(_PKG, "_build", "_csr_ops.so")

_lib = None


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # build under a private name and rename: concurrent test workers
    # never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", _SRC, _STABLE_SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("GALA_TPU_NO_NATIVE") or not os.path.exists(_SRC):
        return None
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
            os.path.getmtime(_SRC), os.path.getmtime(_STABLE_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    for fn in (lib.coo_to_csr_i32, lib.coo_to_csr_stable_i32):
        fn.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
    lib.fill_ell_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fill_bell_i32.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.grow_mask_i8.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.stage_dedup_i32.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.plan_blocks_count_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.plan_blocks_fill_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.keys_symmetric_i64.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.keys_symmetric_i64.restype = ctypes.c_int
    lib.rgg2d_count.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rgg2d_fill.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.omp_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def coo_to_csr_native(src, dst, vals, n_rows: int):
    """Returns (row_ptr i64, out_src i32, out_dst i32, out_vals f32) or
    None when native is unavailable.  Each row's edges keep their input
    order: bitwise the NumPy path's argsort(dst, kind="stable")."""
    lib = _load()
    if lib is None:
        return None
    return _coo_to_csr(lib.coo_to_csr_stable_i32, src, dst, vals, n_rows)


def coo_to_csr_cursors(src, dst, vals, n_rows: int):
    """The copied source's own coo_to_csr_i32 (atomic per-row cursors: a
    row's edge order follows thread timing), which coo_to_csr_native
    replaced; kept for measuring the stable sort against it
    (scripts/csr_sort_torch.py, chip_smoke.py's [csr-stable])."""
    lib = _load()
    if lib is None:
        return None
    return _coo_to_csr(lib.coo_to_csr_i32, src, dst, vals, n_rows)


def _coo_to_csr(fn, src, dst, vals, n_rows: int):
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    e = src.shape[0]
    vals_arr = (
        np.ascontiguousarray(vals, dtype=np.float32) if vals is not None else None
    )
    row_ptr = np.zeros(n_rows + 1, np.int64)
    out_src = np.empty(e, np.int32)
    out_dst = np.empty(e, np.int32)
    out_vals = np.empty(e, np.float32)
    fn(
        n_rows, e,
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        _ptr(vals_arr, ctypes.c_float) if vals_arr is not None else None,
        _ptr(row_ptr, ctypes.c_int64), _ptr(out_src, ctypes.c_int32),
        _ptr(out_dst, ctypes.c_int32), _ptr(out_vals, ctypes.c_float),
    )
    return row_ptr, out_src, out_dst, out_vals


def fill_bell_native(dst, src, csr_vals, row_ptr, slot_base,
                     cols_flat, vals_flat, edge_flat=None) -> bool:
    """Parallel binned-ELL slot fill; False when native is unavailable."""
    lib = _load()
    if lib is None:
        return False
    e = dst.shape[0]
    lib.fill_bell_i32(
        e,
        _ptr(dst, ctypes.c_int32), _ptr(src, ctypes.c_int32),
        _ptr(csr_vals, ctypes.c_float),
        _ptr(row_ptr, ctypes.c_int64), _ptr(slot_base, ctypes.c_int64),
        _ptr(cols_flat, ctypes.c_int32), _ptr(vals_flat, ctypes.c_float),
        _ptr(edge_flat, ctypes.c_int64) if edge_flat is not None else None,
    )
    return True


def fill_ell_native(n_rows, k, row_ptr, src, csr_vals, vstart,
                    cols, vals, perm, vrow) -> bool:
    lib = _load()
    if lib is None:
        return False
    lib.fill_ell_i32(
        n_rows, k,
        _ptr(row_ptr, ctypes.c_int64), _ptr(src, ctypes.c_int32),
        _ptr(csr_vals, ctypes.c_float), _ptr(vstart, ctypes.c_int64),
        _ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_float),
        _ptr(perm, ctypes.c_int32), _ptr(vrow, ctypes.c_int32),
    )
    return True


def grow_mask_native(src, dst, mask) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    mask_in = np.ascontiguousarray(mask, dtype=np.uint8)
    mask_out = mask_in.copy()
    lib.grow_mask_i8(
        src.shape[0],
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        _ptr(mask_in, ctypes.c_uint8), _ptr(mask_out, ctypes.c_uint8),
    )
    return mask_out.astype(bool)


def plan_blocks_count_native(cols2: np.ndarray):
    """Count-only pass of the block planner: per-chunk unique-8-row-block
    counts (OpenMP) — the cheap probe make_plan's VMEM-budget loop runs
    before paying for the fill.  None without native."""
    lib = _load()
    if lib is None:
        return None
    c_chunks = cols2.shape[0]
    rk = int(np.prod(cols2.shape[1:]))
    flat = np.ascontiguousarray(cols2.reshape(c_chunks, rk), dtype=np.int32)
    counts = np.empty(c_chunks, np.int32)
    lib.plan_blocks_count_i32(
        c_chunks, rk, _ptr(flat, ctypes.c_int32), _ptr(counts, ctypes.c_int32)
    )
    return counts


def plan_blocks_native(cols2: np.ndarray, u: int | None = None):
    """Per-chunk 8-row-block plan for the Pallas bell kernels (OpenMP).

    cols2: (C, R, k) int source-row ids (already chunk-padded).  Returns
    (blocks (C, U) int32, locals (C, R, k) int32, U) matching
    bell_spmm.plan_chunks' pure-NumPy plan — or None without native.
    Pass u (the known max unique-block count, e.g. from a prior
    plan_blocks_count_native probe) to skip the count pass.
    """
    lib = _load()
    if lib is None:
        return None
    c_chunks = cols2.shape[0]
    rk = int(np.prod(cols2.shape[1:]))
    flat = np.ascontiguousarray(cols2.reshape(c_chunks, rk), dtype=np.int32)
    if u is None:
        counts = np.empty(c_chunks, np.int32)
        lib.plan_blocks_count_i32(
            c_chunks, rk, _ptr(flat, ctypes.c_int32),
            _ptr(counts, ctypes.c_int32),
        )
        u = int(counts.max())
    blocks = np.empty((c_chunks, u), np.int32)
    locals_ = np.empty((c_chunks, rk), np.int32)
    lib.plan_blocks_fill_i32(
        c_chunks, rk, u, _ptr(flat, ctypes.c_int32),
        _ptr(blocks, ctypes.c_int32), _ptr(locals_, ctypes.c_int32),
    )
    return blocks, locals_.reshape(cols2.shape), u


def stage_dedup_native(cols, bounds):
    """Parallel per-chunk dedup (OpenMP): cols (S,) int32, bounds list of
    (start, end) slot ranges.  Returns (uniq_buf, counts, local) with
    uniq_buf sharing cols' layout (chunk c's uniques at
    uniq_buf[start:start+counts[c]]) — or None without native."""
    lib = _load()
    if lib is None:
        return None
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    starts = np.ascontiguousarray([b[0] for b in bounds], dtype=np.int64)
    ends = np.ascontiguousarray([b[1] for b in bounds], dtype=np.int64)
    uniq = np.empty_like(cols)
    counts = np.empty(len(bounds), np.int64)
    local = np.empty_like(cols)
    lib.stage_dedup_i32(
        len(bounds),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(cols, ctypes.c_int32),
        _ptr(uniq, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
        _ptr(local, ctypes.c_int32),
    )
    return uniq, counts, local


def keys_symmetric_native(key_fwd, key_bwd):
    """Parallel sorted-key equality (the is_symmetric hot path).

    MUTATES both arrays (sorts in place).  Returns True/False, or None
    when native is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    kf = np.ascontiguousarray(key_fwd, dtype=np.int64)
    kb = np.ascontiguousarray(key_bwd, dtype=np.int64)
    if kf.shape != kb.shape:
        return False
    r = lib.keys_symmetric_i64(kf.shape[0], _ptr(kf, ctypes.c_int64),
                               _ptr(kb, ctypes.c_int64))
    return bool(r)


def thread_count() -> int:
    """OpenMP thread count of the native library (1 = no parallelism;
    callers use this to prefer NumPy's optimized serial sorts on
    single-core hosts)."""
    lib = _load()
    return int(lib.omp_threads()) if lib is not None else 0


def rgg2d_native(pts: np.ndarray, radius: float):
    """(src i64, dst i64) directed neighbor pairs of a 2-D random
    geometric graph, or None when native is unavailable.  Grid-hash
    search: Python buckets nodes by cell (vectorized counting sort),
    the C++ passes run the 9-cell distance tests that dominate the
    pure-Python generator (~160s -> ~2s at 1.5M nodes / 25M edges)."""
    lib = _load()
    if lib is None:
        return None
    n = pts.shape[0]
    cell = max(radius, 1e-6)
    nx = int(np.ceil(1.0 / cell))
    gx = np.minimum((pts[:, 0] / cell).astype(np.int64), nx - 1)
    gy = np.minimum((pts[:, 1] / cell).astype(np.int64), nx - 1)
    key = gx * nx + gy
    order = np.argsort(key, kind="stable")
    nodes_by_cell = np.ascontiguousarray(order, np.int32)
    cell_start = np.zeros(nx * nx + 1, np.int64)
    np.add.at(cell_start[1:], key, 1)
    np.cumsum(cell_start, out=cell_start)
    px = np.ascontiguousarray(pts[:, 0], np.float64)
    py = np.ascontiguousarray(pts[:, 1], np.float64)
    counts = np.zeros(nx * nx, np.int64)
    lib.rgg2d_count(
        nx, _ptr(px, ctypes.c_double), _ptr(py, ctypes.c_double),
        float(radius) * float(radius),
        _ptr(cell_start, ctypes.c_int64), _ptr(nodes_by_cell, ctypes.c_int32),
        _ptr(counts, ctypes.c_int64),
    )
    offsets = np.zeros(nx * nx + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    e = int(offsets[-1])
    out_src = np.empty(e, np.int32)
    out_dst = np.empty(e, np.int32)
    lib.rgg2d_fill(
        nx, _ptr(px, ctypes.c_double), _ptr(py, ctypes.c_double),
        float(radius) * float(radius),
        _ptr(cell_start, ctypes.c_int64), _ptr(nodes_by_cell, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int64),
        _ptr(out_src, ctypes.c_int32), _ptr(out_dst, ctypes.c_int32),
    )
    return out_src.astype(np.int64), out_dst.astype(np.int64)
