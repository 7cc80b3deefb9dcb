"""ctypes bindings for the native host-side sparse preprocessing library.

Builds ``src/sparse_pack.cpp`` with g++ on first use (cached next to the
source, rebuilt when the source changes); every entry point has a
numpy-vectorized fallback so the package works without a toolchain.

Public functions (all take scipy.sparse / numpy inputs):
  csr_to_ell_arrays(A)            -> (vals, cols)        ELL pack
  bsr_to_blockell_arrays(A,br,bc) -> (blocks, bcols)     blocked-ELL pack
  csr_to_banded_arrays(A, offsets)-> (diags, dropped)    diagonal storage
  csr_band_offsets(A, max_out)    -> offsets | None      distinct diagonals
  rcm_ordering(A)                 -> perm                reverse Cuthill-McKee
  balance_partition(A, p)         -> bounds (p+1,)       nnz-balanced rows
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "load_native", "native_available",
    "csr_to_ell_arrays", "bsr_to_blockell_arrays", "csr_to_banded_arrays",
    "csr_band_offsets", "rcm_ordering", "balance_partition",
    "sell_pack_csr", "sell_rowsel_pack_csr",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "sparse_pack.cpp")
_LIB = os.path.join(_HERE, "src", "libeujl_native.so")
_lock = threading.Lock()
_lib = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)


def _build() -> str | None:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", _LIB],
            check=True, capture_output=True, timeout=240)
        return _LIB
    except (OSError, subprocess.SubprocessError):
        return None


def load_native():
    """The loaded ctypes library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.csr_max_degree.restype = ctypes.c_int64
        lib.csr_max_degree.argtypes = [_i64p, ctypes.c_int64]
        for suf, fp in (("f64", _f64p), ("f32", _f32p)):
            fn = getattr(lib, f"csr_to_ell_{suf}")
            fn.restype = None
            fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i32p,
                           fp, fp, _i32p]
            fn = getattr(lib, f"bsr_to_blockell_{suf}")
            fn.restype = None
            fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           _i64p, _i32p, fp, fp, _i32p]
            fn = getattr(lib, f"csr_to_banded_{suf}")
            fn.restype = None
            fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p,
                           _i32p, fp, fp, _i64p]
        lib.csr_band_offsets.restype = ctypes.c_int64
        lib.csr_band_offsets.argtypes = [ctypes.c_int64, _i64p, _i32p, _i64p,
                                         ctypes.c_int64]
        lib.rcm_ordering.restype = None
        lib.rcm_ordering.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p]
        lib.balance_partition.restype = None
        lib.balance_partition.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                          _i64p, _i64p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctype)


def _csr_parts(A):
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    return indptr, indices


def csr_to_ell_arrays(A, dtype=None):
    """(vals (n,w), cols (n,w)) padded-ELL arrays from scipy CSR."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, indices = _csr_parts(A)
    dt = np.dtype(dtype) if dtype is not None else A.data.dtype
    data = np.ascontiguousarray(A.data, dtype=dt)
    counts = np.diff(indptr)
    w = max(1, int(counts.max())) if n else 1
    lib = load_native()
    if lib is not None and dt in (np.float32, np.float64):
        vals = np.empty((n, w), dtype=dt)
        cols = np.empty((n, w), dtype=np.int32)
        fp = _f64p if dt == np.float64 else _f32p
        fn = lib.csr_to_ell_f64 if dt == np.float64 else lib.csr_to_ell_f32
        fn(n, w, _ptr(indptr, _i64p), _ptr(indices, _i32p), _ptr(data, fp),
           _ptr(vals, fp), _ptr(cols, _i32p))
        return vals, cols
    # numpy-vectorized fallback
    vals = np.zeros((n, w), dtype=dt)
    cols = np.zeros((n, w), dtype=np.int32)
    row = np.repeat(np.arange(n), counts)
    pos = np.arange(len(data)) - np.repeat(indptr[:-1], counts)
    vals[row, pos] = data
    cols[row, pos] = indices
    return vals, cols


def bsr_to_blockell_arrays(A, br: int, bc: int | None = None, dtype=None):
    """(blocks (nbr,w,br,bc), bcols (nbr,w)) blocked-ELL from scipy sparse."""
    import scipy.sparse as sp

    bc = bc if bc is not None else br
    B = sp.bsr_matrix(A.tocsr(), blocksize=(br, bc))
    B.sort_indices()
    nbr = B.shape[0] // br
    indptr = np.ascontiguousarray(B.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(B.indices, dtype=np.int32)
    dt = np.dtype(dtype) if dtype is not None else B.data.dtype
    data = np.ascontiguousarray(B.data, dtype=dt)
    counts = np.diff(indptr)
    w = max(1, int(counts.max())) if nbr else 1
    lib = load_native()
    if lib is not None and dt in (np.float32, np.float64):
        blocks = np.empty((nbr, w, br, bc), dtype=dt)
        bcols = np.empty((nbr, w), dtype=np.int32)
        fp = _f64p if dt == np.float64 else _f32p
        fn = (lib.bsr_to_blockell_f64 if dt == np.float64
              else lib.bsr_to_blockell_f32)
        fn(nbr, w, br * bc, _ptr(indptr, _i64p), _ptr(indices, _i32p),
           _ptr(data, fp), _ptr(blocks, fp), _ptr(bcols, _i32p))
        return blocks, bcols
    blocks = np.zeros((nbr, w, br, bc), dtype=dt)
    bcols = np.zeros((nbr, w), dtype=np.int32)
    row = np.repeat(np.arange(nbr), counts)
    pos = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
    blocks[row, pos] = data
    bcols[row, pos] = indices
    return blocks, bcols


def csr_to_banded_arrays(A, offsets, dtype=None):
    """(diags (k,n), dropped) diagonal storage; `dropped` counts entries
    outside the given offsets (caller decides whether that is an error)."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, indices = _csr_parts(A)
    dt = np.dtype(dtype) if dtype is not None else A.data.dtype
    data = np.ascontiguousarray(A.data, dtype=dt)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lib = load_native()
    if lib is not None and dt in (np.float32, np.float64):
        diags = np.empty((len(offs), n), dtype=dt)
        dropped = np.zeros((1,), dtype=np.int64)
        fp = _f64p if dt == np.float64 else _f32p
        fn = (lib.csr_to_banded_f64 if dt == np.float64
              else lib.csr_to_banded_f32)
        fn(n, len(offs), _ptr(offs, _i64p), _ptr(indptr, _i64p),
           _ptr(indices, _i32p), _ptr(data, fp), _ptr(diags, fp),
           _ptr(dropped, _i64p))
        return diags, int(dropped[0])
    diags = np.zeros((len(offs), n), dtype=dt)
    counts = np.diff(indptr)
    row = np.repeat(np.arange(n), counts)
    o = indices.astype(np.int64) - row
    for k, off in enumerate(offs):
        sel = o == off
        diags[k, row[sel]] = data[sel]
    dropped = int((~np.isin(o, offs)).sum())
    return diags, dropped


def csr_band_offsets(A, max_out: int = 64):
    """Sorted distinct diagonals of A, or None if more than ``max_out``."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, indices = _csr_parts(A)
    lib = load_native()
    if lib is not None:
        out = np.empty((max_out,), dtype=np.int64)
        cnt = lib.csr_band_offsets(n, _ptr(indptr, _i64p),
                                   _ptr(indices, _i32p), _ptr(out, _i64p),
                                   max_out)
        return None if cnt < 0 else out[:cnt].copy()
    row = np.repeat(np.arange(n), np.diff(indptr))
    offs = np.unique(indices.astype(np.int64) - row)
    return None if len(offs) > max_out else offs


def rcm_ordering(A):
    """Reverse Cuthill–McKee permutation (perm[new] = old) of A's pattern
    (symmetrized)."""
    A = A.tocsr()
    n = A.shape[0]
    S = (A + A.T).tocsr()
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    lib = load_native()
    if lib is not None:
        perm = np.empty((n,), dtype=np.int32)
        lib.rcm_ordering(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                         _ptr(perm, _i32p))
        return perm
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return reverse_cuthill_mckee(S).astype(np.int32)


def balance_partition(A, p: int):
    """(p+1,) contiguous row-partition boundaries minimizing max part nnz."""
    A = A.tocsr()
    n = A.shape[0]
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    lib = load_native()
    if lib is not None:
        bounds = np.empty((p + 1,), dtype=np.int64)
        lib.balance_partition(n, p, _ptr(indptr, _i64p), _ptr(bounds, _i64p))
        return bounds
    # greedy fallback at the ideal target
    total = indptr[-1]
    target = total / p
    bounds = np.zeros((p + 1,), dtype=np.int64)
    j = 0
    for part in range(1, p):
        want = part * target
        j = int(np.searchsorted(indptr, want))
        bounds[part] = min(max(j, bounds[part - 1]), n)
    bounds[p] = n
    return bounds


def sell_pack_csr(A, window: int = 1024):
    """Native SELL-window pack of a scipy CSR matrix: returns
    (vals (T,8,128), lidx (T,8,128) int32, group_ptr (G+1) int32,
    win_row (G) int32) or None when the native library is unavailable.
    Raises ValueError when a group's columns exceed its window (same
    contract as the numpy packer in ops/sell.py)."""
    lib = load_native()
    if lib is None:
        return None
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    G = (n + 127) // 128
    B = (G + 7) // 8
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    group_ptr = np.empty(G + 1, np.int32)
    win_row = np.empty(B, np.int32)
    lib.sell_plan.restype = ctypes.c_int64
    T = lib.sell_plan(ctypes.c_int64(n), ctypes.c_int64(window),
                      _ptr(indptr, _i64p), _ptr(indices, _i32p),
                      _ptr(group_ptr, _i32p), _ptr(win_row, _i32p))
    if T < 0:
        blk = -T - 1
        raise ValueError(
            f"block {blk}: column span exceeds the {window}-wide window; "
            "RCM-permute, widen the window, or use block-ELL/banded")
    dt = A.dtype if A.dtype in (np.float32, np.float64) else np.float64
    data = np.ascontiguousarray(A.data, dtype=dt)
    # chunk-DMA capacity: max tiles per 8-group block (+ trailing pad)
    gp_blk = group_ptr[np.minimum(np.arange(B + 1) * 8, G)]
    cap = max(int(np.max(np.diff(gp_blk))) if B else 1, 1)
    vals = np.zeros((T + cap, 8, 128), dt)
    lidx = np.zeros((T + cap, 8, 128), np.int32)
    fill = lib.sell_fill_f32 if dt == np.float32 else lib.sell_fill_f64
    fp = _f32p if dt == np.float32 else _f64p
    fill(ctypes.c_int64(n), _ptr(indptr, _i64p), _ptr(indices, _i32p),
         _ptr(data, fp), _ptr(group_ptr, _i32p), _ptr(win_row, _i32p),
         ctypes.c_int64(T), _ptr(vals, fp), _ptr(lidx, _i32p))
    return vals, lidx, group_ptr, win_row, cap


def sell_rowsel_pack_csr(A, window: int = 2048):
    """Native rowsel SELL pack (per-sublane window-row binding; see
    ops/sell.py). Returns (vals, lidx, group_ptr, win_row, cap)
    or None without the native library."""
    lib = load_native()
    if lib is None:
        return None
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    G = (n + 127) // 128
    B = (G + 7) // 8
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    group_ptr = np.empty(G + 1, np.int32)
    win_row = np.empty(B, np.int32)
    lib.sell_rowsel_plan.restype = ctypes.c_int64
    T = lib.sell_rowsel_plan(ctypes.c_int64(n), ctypes.c_int64(window),
                             _ptr(indptr, _i64p), _ptr(indices, _i32p),
                             _ptr(group_ptr, _i32p), _ptr(win_row, _i32p))
    if T < 0:
        raise ValueError(
            f"block {-T - 1}: column span exceeds the {window}-wide "
            "window; RCM-permute, widen the window, or use another "
            "container")
    dt = A.dtype if A.dtype in (np.float32, np.float64) else np.float64
    data = np.ascontiguousarray(A.data, dtype=dt)
    gp_blk = group_ptr[np.minimum(np.arange(B + 1) * 8, G)]
    cap = max(int(np.max(np.diff(gp_blk))) if B else 1, 1)
    vals = np.zeros((T + cap, 8, 128), dt)
    lidx = np.zeros((T + cap, 8, 128), np.int32)
    fill = (lib.sell_rowsel_fill_f32 if dt == np.float32
            else lib.sell_rowsel_fill_f64)
    fp = _f32p if dt == np.float32 else _f64p
    fill(ctypes.c_int64(n), ctypes.c_int64(window), _ptr(indptr, _i64p),
         _ptr(indices, _i32p), _ptr(data, fp), _ptr(group_ptr, _i32p),
         _ptr(win_row, _i32p), ctypes.c_int64(T), _ptr(vals, fp),
         _ptr(lidx, _i32p))
    return vals, lidx, group_ptr, win_row, cap
