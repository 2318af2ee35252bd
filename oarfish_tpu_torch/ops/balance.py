"""Flow-balanced bucket-row placement (ctypes binding of csrc/balance.cpp).

Counterpart of the JAX package's `ops/balance.py` (host code, kept as a copy
so this package stands alone; the native library is built into this
package's own build directory).

The v4 EM's route quota Q covers the MAX per-(src,dst)-chunk flow of the
alignment map between the transcript-side and read-side bucket layouts
(`static_permute.GlobalRoute`). Random row placement leaves that max
2-3x above the mean flow; the greedy placer drives it toward the mean,
shrinking the quota tensor and the gather networks of both routes.

Three passes per layout build (`em_v4._v4_layout`):
  1. transcript scalar: balance per-chunk transcript-side load;
  2. read vector: place each read minimizing its max (txp-chunk,
     read-chunk) cell;
  3. transcript vector re-pass: re-place transcripts against the chosen
     read layout (transposed flow matrix).
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("oarfish_tpu_torch")

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()  # one thread builds and loads, others wait

BAL_CHR = 16384  # balancing granularity: the finest route chunk (CR=128)


def get_lib():
    """ctypes handle to the native placer (the repository's
    `csrc/balance.cpp`), built at first use into the package's build
    directory (`kernels/build.py`); None without a compiler."""
    with _lib_lock:
        return _load_lib()


def _load_lib():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    from ..kernels.build import host_library

    lib = host_library("oarfish_balance", "balance.cpp",
                       flags=["-march=native"])
    if lib is None:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.oarfish_balance_greedy.restype = ctypes.c_int64
    lib.oarfish_balance_greedy.argtypes = [
        ctypes.c_int64, i64p, i32p, i32p, ctypes.c_int64, i64p, i64p,
        i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p,
        i32p, i64p,
    ]
    lib.oarfish_balance_repair.restype = ctypes.c_int64
    lib.oarfish_balance_repair.argtypes = [
        ctypes.c_int64, i64p, i32p, i32p, ctypes.c_int64, i64p, i64p,
        i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, i32p, i64p,
    ]
    lib.oarfish_v4_read_slots.restype = None
    lib.oarfish_v4_read_slots.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
        ctypes.c_int32,
    ]
    lib.oarfish_v4_small_slots.restype = None
    lib.oarfish_v4_small_slots.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
        ctypes.c_int32,
    ]
    lib.oarfish_ramp_fill.restype = None
    lib.oarfish_ramp_fill.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.oarfish_rank_by_key.restype = ctypes.c_int64
    lib.oarfish_rank_by_key.argtypes = [
        ctypes.c_int64, i64p, ctypes.c_int64, i64p, i64p, i64p,
    ]
    lib.oarfish_flows2d.restype = ctypes.c_int64
    lib.oarfish_flows2d.argtypes = [
        ctypes.c_int64, i64p, i64p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p,
    ]
    lib.oarfish_v4_big_slots.restype = None
    lib.oarfish_v4_big_slots.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p,
        ctypes.c_int32,
    ]
    lib.oarfish_gather_div_i32.restype = None
    lib.oarfish_gather_div_i32.argtypes = [
        ctypes.c_int64, i64p, ctypes.c_void_p, ctypes.c_int64, i32p,
        ctypes.c_int32,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def read_slots(off, aln_base, ib, bstart, bK, row, slot_out,
               threads: int = 0) -> bool:
    """Native fill of read-side column-major slots: item i's
    alignments j land at slot_out[aln_base[i]+j]. Returns False when
    the library is unavailable (caller uses the NumPy form)."""
    lib = get_lib()
    if lib is None:
        return False
    lib.oarfish_v4_read_slots(
        len(ib), np.ascontiguousarray(off, np.int64),
        np.ascontiguousarray(aln_base, np.int64),
        np.ascontiguousarray(ib, np.int64),
        np.ascontiguousarray(bstart, np.int64),
        np.ascontiguousarray(bK, np.int64),
        np.ascontiguousarray(row, np.int64), slot_out, threads,
    )
    return True


def small_slots(tid, rank, out_pos, bst, bK, row_of, slot_out,
                threads: int = 0) -> bool:
    """Native fill of small-transcript slots:
    slot_out[out_pos[k]] = colmajor(bst[t], bK[t], row_of[t], rank[k])
    for t = tid[k]. Returns False when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    lib.oarfish_v4_small_slots(
        len(tid), np.ascontiguousarray(tid, np.int64),
        np.ascontiguousarray(rank, np.int64),
        np.ascontiguousarray(out_pos, np.int64),
        np.ascontiguousarray(bst, np.int64),
        np.ascontiguousarray(bK, np.int64),
        np.ascontiguousarray(row_of, np.int64), slot_out, threads,
    )
    return True


def big_slots(tid, rank, big_index, big_off_log, capk: int,
              big_start: int, bp: int, bq: int, slot_out,
              threads: int = 0) -> bool:
    """Native fill of big-transcript slots in ONE pass over all
    alignments (non-big entries untouched). Returns False when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    lib.oarfish_v4_big_slots(
        len(tid), np.ascontiguousarray(tid, np.int64),
        np.ascontiguousarray(rank, np.int64),
        np.ascontiguousarray(big_index, np.int64),
        np.ascontiguousarray(big_off_log, np.int64),
        capk, big_start, bp, bq, slot_out, threads,
    )
    return True


def gather_div_i32(src, idx, div: int, threads: int = 0):
    """Native out[i] = src[idx[i]] // div as int32 (idx None:
    elementwise). Returns None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int64)
    n = len(src) if idx is None else len(idx)
    out = np.empty(n, dtype=np.int32)
    if idx is None:
        lib.oarfish_gather_div_i32(n, src, None, div, out, threads)
    else:
        idx = np.ascontiguousarray(idx, np.int64)
        lib.oarfish_gather_div_i32(
            n, src, idx.ctypes.data_as(ctypes.c_void_p), div, out,
            threads,
        )
    return out


def ramp_fill(off, base, total: int):
    """Native CSR expansion out[off[i]+j] = base[i]+j; None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(total, dtype=np.int64)
    lib.oarfish_ramp_fill(
        len(base), np.ascontiguousarray(off, np.int64),
        np.ascontiguousarray(base, np.int64), out,
    )
    return out


def rank_by_key(key, T: int):
    """Native stable counting sort by small int key: returns
    (order, rank-within-run, run_start[T+1]) or None when the library
    is unavailable. Raises on out-of-range keys."""
    lib = get_lib()
    if lib is None:
        return None
    key = np.ascontiguousarray(key, np.int64)
    order = np.empty(len(key), np.int64)
    rank = np.empty(len(key), np.int64)
    run_start = np.empty(T + 1, np.int64)
    rc = lib.oarfish_rank_by_key(len(key), key, T, order, rank, run_start)
    if rc != 0:
        raise ValueError(f"rank_by_key: key out of range [0, {T})")
    return order, rank, run_start


def flows2d(a, b, div, n_src, n_dst, idx=None):
    """Native 2-D flow histogram F[a//div, b//div] (+1 per element of
    `idx`, or per position when idx is None). Returns None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    F = np.zeros((n_src, n_dst), dtype=np.int32)
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(b, np.int64)
    if idx is None:
        rc = lib.oarfish_flows2d(
            len(a), a, b, None, 0, div, n_src, n_dst, F
        )
    else:
        idx = np.ascontiguousarray(idx, np.int64)
        rc = lib.oarfish_flows2d(
            len(a), a, b,
            idx.ctypes.data_as(ctypes.c_void_p), len(idx),
            div, n_src, n_dst, F,
        )
    if rc != 0:
        raise IndexError(
            f"flows2d: index out of range for [{n_src}, {n_dst}] "
            f"grid at div={div}"
        )
    return F


def greedy_place(
    item_off: np.ndarray,
    src_cell: np.ndarray,
    item_bucket: np.ndarray,
    buckets: List[Tuple[int, int, int]],  # (start, K, ngroups) per bucket
    n_dst: int,
    n_src: int,
    order: np.ndarray,
    F: Optional[np.ndarray] = None,
    chunk: int = BAL_CHR,
) -> Tuple[np.ndarray, int, np.ndarray]:
    """Place items into bucket rows; returns (row_within_bucket per item,
    final max cell, F). `F` may carry preloaded contributions of items
    with fixed placement (e.g. big transcripts)."""
    lib = get_lib()
    assert lib is not None
    n_items = len(item_off) - 1
    item_off = np.ascontiguousarray(item_off, dtype=np.int64)
    src_cell = np.ascontiguousarray(src_cell, dtype=np.int32)
    item_bucket = np.ascontiguousarray(item_bucket, dtype=np.int32)
    starts = np.ascontiguousarray([b[0] for b in buckets], dtype=np.int64)
    ks = np.ascontiguousarray([b[1] for b in buckets], dtype=np.int64)
    ngs = np.ascontiguousarray([b[2] for b in buckets], dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    if F is None:
        F = np.zeros(n_src * n_dst, dtype=np.int32)
    else:
        F = np.ascontiguousarray(F.reshape(-1), dtype=np.int32)
    out_row = np.zeros(max(n_items, 1), dtype=np.int64)
    mx = lib.oarfish_balance_greedy(
        n_items, item_off, src_cell, item_bucket, len(buckets), starts,
        ks, ngs, chunk, np.int32(n_dst), np.int32(n_src), order, F,
        out_row,
    )
    if mx < 0:
        raise RuntimeError("balance_greedy: insufficient bucket capacity")
    return out_row[:n_items], int(mx), F.reshape(n_src, n_dst)


def repair_place(
    item_off: np.ndarray,
    src_cell: np.ndarray,
    item_bucket: np.ndarray,
    buckets: List[Tuple[int, int, int]],
    n_dst: int,
    n_src: int,
    row_within: np.ndarray,
    F: np.ndarray,
    target: int,
    chunk: int,
    max_rounds: int = 4,
) -> Tuple[np.ndarray, int, np.ndarray]:
    """Local-search repair of an incumbent placement: re-place items
    touching cells with load > `target` (exhaustive class scan). The
    repair granularity `chunk` is the SELECTED route chunk, so `target`
    is an actual quota boundary. Returns (rows, max, F) like
    `greedy_place`; `row_within` and `F` are updated copies."""
    lib = get_lib()
    assert lib is not None
    n_items = len(item_off) - 1
    item_off = np.ascontiguousarray(item_off, dtype=np.int64)
    src_cell = np.ascontiguousarray(src_cell, dtype=np.int32)
    item_bucket = np.ascontiguousarray(item_bucket, dtype=np.int32)
    starts = np.ascontiguousarray([b[0] for b in buckets], dtype=np.int64)
    ks = np.ascontiguousarray([b[1] for b in buckets], dtype=np.int64)
    ngs = np.ascontiguousarray([b[2] for b in buckets], dtype=np.int64)
    out_row = np.ascontiguousarray(row_within, dtype=np.int64).copy()
    F = np.ascontiguousarray(F.reshape(-1), dtype=np.int32).copy()
    mx = lib.oarfish_balance_repair(
        n_items, item_off, src_cell, item_bucket, len(buckets), starts,
        ks, ngs, chunk, np.int32(n_dst), np.int32(n_src),
        np.int64(target), np.int64(max_rounds), F, out_row,
    )
    return out_row[:n_items], int(mx), F.reshape(n_src, n_dst)
