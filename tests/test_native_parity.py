"""C++/Python planner parity: the native symbolic kernels must make
bit-identical decisions to their pure-Python fallbacks on the same input
(the claim the merge loop's docstring makes; here it is enforced).

AMD is exempt from bitwise identity — the native quotient-graph AMD and
the Python minimum-degree fallback are different (both valid) orderings —
so it is checked for validity only.
"""

import numpy as np
import pytest

from baspacho_tpu import native
from baspacho_tpu.elimination_tree import (MAX_SUPERNODE_SIZE,
                                           EliminationTree)
from baspacho_tpu.ops.plan import build_plan
from baspacho_tpu.sparse_structure import SparseStructure
from baspacho_tpu.testing import SparseMatGenerator

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def _problems():
    out = []
    for seed in (1, 2):
        gen = SparseMatGenerator.gen_flat(120, 0.08, seed=seed)
        out.append((gen.to_structure(), np.full(120, 3)))
    gen = SparseMatGenerator.gen_grid(12, 12, 0.3, seed=3)
    out.append((gen.to_structure(), np.full(144, 2)))
    gen = SparseMatGenerator.gen_flat(60, 0.1, seed=4)
    gen.add_schur_set(300, 0.02)
    out.append((gen.to_structure(), np.full(360, 3)))
    return out


def _lower_csr(ss: SparseStructure) -> SparseStructure:
    return ss.clear(clear_lower=False)  # keep the lower half


def test_full_elim_fill_parity(monkeypatch):
    for ss, _ in _problems():
        low = _lower_csr(ss)
        native_res = low.add_full_elimination_fill()
        monkeypatch.setattr(native, "try_full_elim_fill",
                            lambda *a, **k: None)
        py_res = low.add_full_elimination_fill()
        monkeypatch.undo()
        np.testing.assert_array_equal(native_res.ptrs, py_res.ptrs)
        np.testing.assert_array_equal(native_res.inds, py_res.inds)


def test_indep_elim_fill_parity(monkeypatch):
    for ss, _ in _problems():
        low = _lower_csr(ss)
        n = low.order
        for start, end in [(0, n // 3), (n // 4, n // 2)]:
            native_res = low.add_independent_elimination_fill(start, end)
            monkeypatch.setattr(native, "try_indep_elim_fill",
                                lambda *a, **k: None)
            py_res = low.add_independent_elimination_fill(start, end)
            monkeypatch.undo()
            np.testing.assert_array_equal(native_res.ptrs, py_res.ptrs)
            np.testing.assert_array_equal(native_res.inds, py_res.inds)


def test_level_schedule_parity(monkeypatch):
    from baspacho_tpu import BackendType, Settings, create_solver
    for ss, psize in _problems():
        solver = create_solver(Settings(backend=BackendType.PLANNED),
                               psize, ss)
        native_levels = np.asarray(solver.plan.lump_levels)
        monkeypatch.setattr(native, "try_level_schedule",
                            lambda *a, **k: None)
        plan_py = build_plan(solver.skel, solver.sparse_elim_ranges,
                             solver.plan.max_factor_lump)
        monkeypatch.undo()
        np.testing.assert_array_equal(native_levels,
                                      np.asarray(plan_py.lump_levels))


def _run_merges(ss, psize, force_python, monkeypatch):
    low = _lower_csr(ss)
    et = EliminationTree(np.asarray(psize, dtype=np.int64), low)
    et.build_tree()
    if force_python:
        monkeypatch.setattr(native, "try_compute_merges",
                            lambda *a, **k: None)
    et.process_tree(detect_sparse_elim_ranges=True)
    if force_python:
        monkeypatch.undo()
    return et


def test_compute_merges_parity(monkeypatch):
    """The native bs_compute_merges must be bit-identical to the Python
    heapq loop: same merge_with, same merged-node counts, same final
    supernode partition."""
    for ss, psize in _problems():
        et_native = _run_merges(ss, psize, False, monkeypatch)
        et_py = _run_merges(ss, psize, True, monkeypatch)
        assert et_native.num_merges == et_py.num_merges
        np.testing.assert_array_equal(et_native.merge_with,
                                      et_py.merge_with)
        np.testing.assert_array_equal(et_native.num_merged_nodes,
                                      et_py.num_merged_nodes)
        np.testing.assert_array_equal(et_native.lump_to_span,
                                      et_py.lump_to_span)
        np.testing.assert_array_equal(et_native.perm_inverse,
                                      et_py.perm_inverse)
        # cost accumulators feed later stages; they must match closely
        # (float associativity may differ slightly between the loops)
        np.testing.assert_allclose(et_native.syge_costs, et_py.syge_costs,
                                   rtol=1e-9, atol=1e-18)


def test_amd_both_paths_valid(monkeypatch):
    for ss, _ in _problems():
        low = _lower_csr(ss)
        p_native = low.fill_reducing_permutation()
        monkeypatch.setattr(native, "try_amd_order", lambda *a, **k: None)
        p_py = low.fill_reducing_permutation()
        monkeypatch.undo()
        for p in (p_native, p_py):
            assert sorted(p.tolist()) == list(range(low.order))


def test_skel_build_parity(monkeypatch):
    """The C++ skeleton constructor (bs_skel_build/bs_skel_chain_data)
    must produce bit-identical arrays to the vectorized numpy path, for
    both the packed (pad_fn=None) and the padded bucket layout."""
    from baspacho_tpu import BackendType, Settings, create_solver
    from baspacho_tpu.block_matrix import CoalescedBlockMatrixSkel
    from baspacho_tpu.ops.planned_backend import storage_pad

    fields = ("span_to_lump", "lump_start", "span_offset_in_lump",
              "chain_rows_till_end", "below_rows", "board_col_ptr",
              "board_row_lump", "board_chain_col_ord", "board_row_ptr",
              "board_col_lump", "board_col_ord", "col_stride",
              "padded_below", "panel_base", "chain_data")
    for ss, psize in _problems():
        solver = create_solver(Settings(backend=BackendType.REF),
                               psize, ss)
        sk = solver.skel
        args = (sk.span_start, sk.lump_to_span, sk.chain_col_ptr,
                sk.chain_row_span)
        for pad_fn in (None, storage_pad):
            nat = CoalescedBlockMatrixSkel(*args, pad_fn=pad_fn)
            monkeypatch.setattr(native, "try_skel_build",
                                lambda *a, **k: None)
            py = CoalescedBlockMatrixSkel(*args, pad_fn=pad_fn)
            monkeypatch.undo()
            for f in fields:
                np.testing.assert_array_equal(
                    getattr(nat, f), getattr(py, f), err_msg=f)


def test_structure_ops_parity(monkeypatch):
    """bs_pairs_to_csr / bs_sym_perm / bs_transpose must be bit-identical
    to the numpy paths (counting sorts are stable in both)."""
    rng = np.random.RandomState(5)
    for ss, _ in _problems():
        low = _lower_csr(ss)
        perm = rng.permutation(low.order).astype(np.int64)
        results = []
        for force_py in (False, True):
            if force_py:
                monkeypatch.setattr(native, "try_pairs_to_csr",
                                    lambda *a, **k: None)
                monkeypatch.setattr(native, "try_sym_perm",
                                    lambda *a, **k: None)
                monkeypatch.setattr(native, "try_transpose",
                                    lambda *a, **k: None)
            t = low.transpose()
            sp = low.symmetric_permutation(perm, lower_half=True,
                                           sort_indices=True)
            spu = low.symmetric_permutation(perm, lower_half=False,
                                            sort_indices=True)
            srt = low.sort_indices()
            rb = sp.extract_right_bottom(low.order // 3)
            if force_py:
                monkeypatch.undo()
            results.append((t, sp, spu, srt, rb))
        for a, b in zip(results[0], results[1]):
            np.testing.assert_array_equal(a.ptrs, b.ptrs)
            np.testing.assert_array_equal(a.inds, b.inds)
