"""Loader for the optional C++ symbolic-analysis kernels.

The hot host-side graph algorithms (AMD ordering, symbolic fill, etree
build) have C++ implementations in native/symbolic.cpp, built into
libbaspacho_symbolic.so and called through ctypes. Everything has a pure
NumPy/Python fallback, so the library works without the native build; the
native path is auto-selected when the shared object is present.

This mirrors the split in the reference where symbolic analysis runs in
optimized C++ (SparseStructure.cpp, EliminationTree.cpp) while here the
numeric path is JAX/XLA instead of BLAS/CUDA.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _maybe_build(native_dir: str) -> None:
    """Build (or rebuild) the shared object from source when missing or
    stale. The binary is not checked into version control — it is always
    produced from the committed symbolic.cpp, so it can't silently drift
    from source."""
    src = os.path.join(native_dir, "symbolic.cpp")
    so = os.path.join(native_dir, "libbaspacho_symbolic.so")
    if not os.path.exists(src):
        return
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return
    import subprocess
    try:
        subprocess.run(["make", "-C", native_dir, "-s"], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        pass  # pure-Python fallbacks cover everything


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.abspath(__file__))
    native_dir = os.path.join(here, "..", "native")
    _maybe_build(native_dir)
    candidates = [
        os.path.join(native_dir, "libbaspacho_symbolic.so"),
        os.path.join(here, "libbaspacho_symbolic.so"),
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                _bind(lib)
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.bs_amd_order.restype = ctypes.c_int
    lib.bs_amd_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.bs_full_elim_fill_count.restype = ctypes.c_int64
    lib.bs_full_elim_fill_count.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.bs_full_elim_fill_fill.restype = ctypes.c_int
    lib.bs_full_elim_fill_fill.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i64p]
    lib.bs_indep_elim_fill_count.restype = ctypes.c_int64
    lib.bs_indep_elim_fill_count.argtypes = [
        ctypes.c_int64, i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.bs_indep_elim_fill_fill.restype = ctypes.c_int
    lib.bs_indep_elim_fill_fill.argtypes = [ctypes.c_int64, i64p]
    lib.bs_build_etree.restype = ctypes.c_int
    lib.bs_build_etree.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p]
    lib.bs_level_schedule.restype = ctypes.c_int
    lib.bs_level_schedule.argtypes = [ctypes.c_int64, i64p, i64p,
                                      ctypes.c_int64, i64p]
    lib.bs_pairs_to_csr.restype = ctypes.c_int64
    lib.bs_pairs_to_csr.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                    i64p, ctypes.c_int64, ctypes.c_int64,
                                    i64p, i64p]
    lib.bs_sym_perm.restype = ctypes.c_int64
    lib.bs_sym_perm.argtypes = [ctypes.c_int64, i64p, i64p, i64p,
                                ctypes.c_int64, ctypes.c_int64, i64p, i64p]
    lib.bs_transpose.restype = ctypes.c_int
    lib.bs_transpose.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i64p]
    lib.bs_skel_build.restype = ctypes.c_int64
    lib.bs_skel_build.argtypes = [ctypes.c_int64, ctypes.c_int64] + [i64p] * 15
    lib.bs_skel_chain_data.restype = ctypes.c_int
    lib.bs_skel_chain_data.argtypes = [ctypes.c_int64] + [i64p] * 8
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.bs_plan_below_rows.restype = ctypes.c_int
    lib.bs_plan_below_rows.argtypes = [ctypes.c_int64] + [i64p] * 4 + \
        [i32p, i64p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bs_perm_block_offsets.restype = ctypes.c_int
    lib.bs_perm_block_offsets.argtypes = \
        [ctypes.c_int64] + [i64p] * 9 + [i64p, i64p, u8p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.bs_compute_merges.restype = ctypes.c_int64
    lib.bs_compute_merges.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
        f64p, f64p, f64p, f64p, f64p, f64p, ctypes.c_int64, i64p, i64p]


def _as_i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def available() -> bool:
    return _load() is not None


def try_amd_order(ptrs: np.ndarray, inds: np.ndarray) -> Optional[np.ndarray]:
    """Returns perm (perm[i] = old index at new position i) or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(ptrs) - 1
    ptrs = np.ascontiguousarray(ptrs, dtype=np.int64)
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.bs_amd_order(n, _as_i64p(ptrs), _as_i64p(inds), _as_i64p(perm))
    if rc != 0:
        return None
    return perm


def try_full_elim_fill(ptrs: np.ndarray,
                       inds: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Full symbolic Cholesky fill; returns (out_ptrs, out_inds) or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(ptrs) - 1
    ptrs = np.ascontiguousarray(ptrs, dtype=np.int64)
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    out_ptrs = np.empty(n + 1, dtype=np.int64)
    total = lib.bs_full_elim_fill_count(n, _as_i64p(ptrs), _as_i64p(inds),
                                        _as_i64p(out_ptrs))
    if total < 0:
        return None
    out_inds = np.empty(total, dtype=np.int64)
    rc = lib.bs_full_elim_fill_fill(n, _as_i64p(ptrs), _as_i64p(inds),
                                    _as_i64p(out_ptrs), _as_i64p(out_inds))
    if rc != 0:
        return None
    return out_ptrs, out_inds


def try_indep_elim_fill(ptrs: np.ndarray, inds: np.ndarray, start: int,
                        end: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Independent-elimination fill; returns (out_ptrs, out_inds) or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(ptrs) - 1
    ptrs = np.ascontiguousarray(ptrs, dtype=np.int64)
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    out_ptrs = np.empty(n + 1, dtype=np.int64)
    total = lib.bs_indep_elim_fill_count(n, _as_i64p(ptrs), _as_i64p(inds),
                                         int(start), int(end),
                                         _as_i64p(out_ptrs))
    if total < 0:
        return None
    out_inds = np.empty(total, dtype=np.int64)
    rc = lib.bs_indep_elim_fill_fill(total, _as_i64p(out_inds))
    if rc != 0:
        return None
    return out_ptrs, out_inds


def try_pairs_to_csr(rows, cols, order, dedup, sort_cols):
    """CSR from (row, col) pairs via C++ radix passes; returns
    (ptrs, inds) or None."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = len(rows)
    out_ptrs = np.empty(order + 1, np.int64)
    out_inds = np.empty(nnz, np.int64)
    m = lib.bs_pairs_to_csr(order, nnz, _as_i64p(rows), _as_i64p(cols),
                            1 if dedup else 0, 1 if sort_cols else 0,
                            _as_i64p(out_ptrs), _as_i64p(out_inds))
    if m < 0:
        return None
    return out_ptrs, out_inds[:m]


def try_sym_perm(ptrs, inds, map_perm, lower_half, sort_cols):
    """Symmetric permutation in C++; returns (ptrs, inds) or None."""
    lib = _load()
    if lib is None:
        return None
    ptrs = np.ascontiguousarray(ptrs, dtype=np.int64)
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    map_perm = np.ascontiguousarray(map_perm, dtype=np.int64)
    order = len(ptrs) - 1
    out_ptrs = np.empty(order + 1, np.int64)
    out_inds = np.empty(len(inds), np.int64)
    m = lib.bs_sym_perm(order, _as_i64p(ptrs), _as_i64p(inds),
                        _as_i64p(map_perm), 1 if lower_half else 0,
                        1 if sort_cols else 0, _as_i64p(out_ptrs),
                        _as_i64p(out_inds))
    if m < 0:
        return None
    return out_ptrs, out_inds[:m]


def try_transpose(ptrs, inds):
    """CSR transpose (per-row sorted) in C++; returns (ptrs, inds) or
    None."""
    lib = _load()
    if lib is None:
        return None
    ptrs = np.ascontiguousarray(ptrs, dtype=np.int64)
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    order = len(ptrs) - 1
    out_ptrs = np.empty(order + 1, np.int64)
    out_inds = np.empty(len(inds), np.int64)
    rc = lib.bs_transpose(order, _as_i64p(ptrs), _as_i64p(inds),
                          _as_i64p(out_ptrs), _as_i64p(out_inds))
    if rc != 0:
        return None
    return out_ptrs, out_inds


def try_skel_build(span_start, lump_to_span, col_ptr, row_ind):
    """Phase-1 skeleton construction (padding-independent arrays + both
    board orderings). Returns a dict of arrays or None; raises
    AssertionError on invalid structure (mirroring the Python
    constructor's validation)."""
    lib = _load()
    if lib is None:
        return None
    num_spans = len(span_start) - 1
    num_lumps = len(lump_to_span) - 1
    nchains = len(row_ind)
    span_start = np.ascontiguousarray(span_start, dtype=np.int64)
    lump_to_span = np.ascontiguousarray(lump_to_span, dtype=np.int64)
    col_ptr = np.ascontiguousarray(col_ptr, dtype=np.int64)
    row_ind = np.ascontiguousarray(row_ind, dtype=np.int64)
    out = {
        "span_to_lump": np.empty(num_spans + 1, np.int64),
        "lump_start": np.empty(num_lumps + 1, np.int64),
        "span_offset_in_lump": np.empty(num_spans + 1, np.int64),
        "chain_rows_till_end": np.empty(nchains, np.int64),
        "below_rows": np.empty(num_lumps, np.int64),
        "board_col_ptr": np.empty(num_lumps + 1, np.int64),
        "board_row_lump": np.empty(nchains + num_lumps, np.int64),
        "board_chain_col_ord": np.empty(nchains + num_lumps, np.int64),
        "board_row_ptr": np.empty(num_lumps + 1, np.int64),
        "board_col_lump": np.empty(nchains, np.int64),
        "board_col_ord": np.empty(nchains, np.int64),
    }
    nboards = lib.bs_skel_build(
        num_spans, num_lumps, _as_i64p(span_start), _as_i64p(lump_to_span),
        _as_i64p(col_ptr), _as_i64p(row_ind),
        _as_i64p(out["span_to_lump"]), _as_i64p(out["lump_start"]),
        _as_i64p(out["span_offset_in_lump"]),
        _as_i64p(out["chain_rows_till_end"]), _as_i64p(out["below_rows"]),
        _as_i64p(out["board_col_ptr"]), _as_i64p(out["board_row_lump"]),
        _as_i64p(out["board_chain_col_ord"]), _as_i64p(out["board_row_ptr"]),
        _as_i64p(out["board_col_lump"]), _as_i64p(out["board_col_ord"]))
    assert nboards >= 0, "invalid block structure"
    nreal = nboards - num_lumps
    out["board_row_lump"] = out["board_row_lump"][:nboards]
    out["board_chain_col_ord"] = out["board_chain_col_ord"][:nboards]
    out["board_col_lump"] = out["board_col_lump"][:nreal]
    out["board_col_ord"] = out["board_col_ord"][:nreal]
    return out


def try_plan_below_rows(span_start, lump_to_span, col_ptr, row_ind,
                        total_below):
    """Below-row RHS expansion (build_plan hot path); returns
    (global_rows int32, lump_row_ptr int64) or None."""
    lib = _load()
    if lib is None:
        return None
    num_lumps = len(col_ptr) - 1
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (span_start, lump_to_span, col_ptr, row_ind)]
    global_rows = np.empty(int(total_below), np.int32)
    lump_row_ptr = np.empty(num_lumps + 1, np.int64)
    rc = lib.bs_plan_below_rows(
        num_lumps, *(_as_i64p(a) for a in args),
        global_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _as_i64p(lump_row_ptr))
    if rc != 0:
        return None
    return global_rows, lump_row_ptr


def try_perm_block_offsets(row_idx, col_idx, perm, span_to_lump,
                           col_stride, span_offset_in_lump,
                           chain_col_ptr, chain_row_span, chain_data):
    """Vectorized permuted block lookup; returns (off, stride, flip)
    int64/int64/bool arrays, or None (native lib missing or a queried
    block absent — caller falls back to the numpy path and its assert)."""
    lib = _load()
    if lib is None:
        return None
    nq = len(row_idx)
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (row_idx, col_idx, perm, span_to_lump, col_stride,
                      span_offset_in_lump, chain_col_ptr, chain_row_span,
                      chain_data)]
    off = np.empty(nq, np.int64)
    stride = np.empty(nq, np.int64)
    flip = np.empty(nq, np.uint8)
    rc = lib.bs_perm_block_offsets(
        nq, *(_as_i64p(a) for a in args), _as_i64p(off), _as_i64p(stride),
        flip.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return off, stride, flip.astype(bool)


def try_skel_chain_data(span_start, lump_start, col_ptr, row_ind,
                        chain_rows_till_end, col_stride, panel_base):
    """Phase-2 skeleton construction: per-chain flat data offsets."""
    lib = _load()
    if lib is None:
        return None
    num_lumps = len(col_ptr) - 1
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (span_start, lump_start, col_ptr, row_ind,
                      chain_rows_till_end, col_stride, panel_base)]
    chain_data = np.empty(len(row_ind) + 1, np.int64)
    rc = lib.bs_skel_chain_data(num_lumps, *(_as_i64p(a) for a in args),
                                _as_i64p(chain_data))
    if rc != 0:
        return None
    return chain_data


def try_compute_merges(csc_ptrs, csc_rows, psize, parent, node_size,
                       node_rows, node_row_blocks, forbid_merge,
                       syge_costs, asmbl_costs, comp_model,
                       max_supernode_size):
    """Greedy cost-model supernode merge loop (the symbolic-analysis hot
    loop). Mutates node_size/num_merged the way the Python loop does;
    returns (merge_with, num_merged, num_merges) or None when the native
    library is unavailable. Bit-identical decisions to the Python loop
    (same double arithmetic, same heap tie-breaking)."""
    lib = _load()
    if lib is None:
        return None
    n = len(parent)
    f64p = ctypes.POINTER(ctypes.c_double)

    def as_f64(a):
        return np.ascontiguousarray(a, dtype=np.float64)

    csc_ptrs = np.ascontiguousarray(csc_ptrs, dtype=np.int64)
    csc_rows = np.ascontiguousarray(csc_rows, dtype=np.int64)
    psize = np.ascontiguousarray(psize, dtype=np.int64)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    node_rows = np.ascontiguousarray(node_rows, dtype=np.int64)
    node_row_blocks = np.ascontiguousarray(node_row_blocks, dtype=np.int64)
    forbid = np.ascontiguousarray(forbid_merge, dtype=np.int64)
    sy = as_f64(syge_costs)
    asm = as_f64(asmbl_costs)
    pp = as_f64(comp_model.potrf_params)
    tp = as_f64(comp_model.trsm_params)
    sp = as_f64(comp_model.syge_params)
    ap = as_f64(comp_model.asmbl_params)
    merge_with = np.empty(n, dtype=np.int64)
    num_merged = np.empty(n, dtype=np.int64)
    nm = lib.bs_compute_merges(
        n, _as_i64p(csc_ptrs), _as_i64p(csc_rows), _as_i64p(psize),
        _as_i64p(parent), _as_i64p(node_size), _as_i64p(node_rows),
        _as_i64p(node_row_blocks), _as_i64p(forbid),
        sy.ctypes.data_as(f64p), asm.ctypes.data_as(f64p),
        pp.ctypes.data_as(f64p), tp.ctypes.data_as(f64p),
        sp.ctypes.data_as(f64p), ap.ctypes.data_as(f64p),
        int(max_supernode_size), _as_i64p(merge_with),
        _as_i64p(num_merged))
    if nm < 0:
        return None
    return merge_with, num_merged, int(nm), sy, asm


def try_level_schedule(board_row_ptr, board_col_lump, max_factor_lump):
    """Elimination-tree level schedule; returns (n,) levels or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(board_row_ptr) - 1
    brp = np.ascontiguousarray(board_row_ptr, dtype=np.int64)
    bcl = np.ascontiguousarray(board_col_lump, dtype=np.int64)
    levels = np.zeros(n, dtype=np.int64)
    rc = lib.bs_level_schedule(n, _as_i64p(brp), _as_i64p(bcl),
                               int(max_factor_lump), _as_i64p(levels))
    if rc != 0:
        return None
    return levels


def try_build_etree(ptrs: np.ndarray, inds: np.ndarray, param_size: np.ndarray):
    """Elimination tree + per-node row stats; returns
    (parent, node_rows, node_row_blocks, per_col_counts_csr) or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(ptrs) - 1
    ptrs = np.ascontiguousarray(ptrs, dtype=np.int64)
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    param_size = np.ascontiguousarray(param_size, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    node_rows = np.zeros(n, dtype=np.int64)
    node_row_blocks = np.zeros(n, dtype=np.int64)
    rc = lib.bs_build_etree(n, _as_i64p(ptrs), _as_i64p(inds),
                            _as_i64p(param_size), _as_i64p(parent),
                            _as_i64p(node_rows), _as_i64p(node_row_blocks))
    if rc != 0:
        return None
    return parent, node_rows, node_row_blocks
