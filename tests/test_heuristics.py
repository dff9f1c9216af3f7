"""Unit tests for the planner's ordering and regime heuristics.

Covers two planner knobs:
  * _bottom_permutation — the identity/RCM locality pick for Schur-heavy
    problems (solver.py) vs the AMD default (reference Solver.cpp:659);
  * the batched-regime merge-candidate selection in create_solver
    (solver.py), including the custom-computation-model path.
"""

import numpy as np
import pytest

from baspacho_tpu import BackendType, Settings, create_solver
from baspacho_tpu.solver import _batched_factor_cost, _bottom_permutation
from baspacho_tpu.sparse_structure import SparseStructure
from baspacho_tpu.testing import SparseMatGenerator, random_spd_data


def _pairs_to_ss(rows, cols, n):
    import scipy.sparse as sp

    m = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    m = ((m + m.T) + sp.eye(n)).tocsr()
    m.sort_indices()
    return SparseStructure(np.asarray(m.indptr, np.int64),
                           np.asarray(m.indices, np.int64))


def _banded_schur_problem(n_elim=400, n_bottom=40, window=4, seed=0):
    """n_elim eliminable params, each touching a NARROW window of the
    bottom system (BA landmarks along a trajectory)."""
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for e in range(n_elim):
        c0 = int(e * n_bottom / n_elim)
        for r in range(c0, min(c0 + window, n_bottom)):
            rows.append(n_elim + r)
            cols.append(e)
    # banded bottom coupling
    for r in range(n_bottom - 1):
        rows.append(n_elim + r + 1)
        cols.append(n_elim + r)
    return _pairs_to_ss(np.array(rows), np.array(cols), n_elim + n_bottom)


def _scattered_schur_problem(n_elim=400, n_bottom=40, seed=0):
    """Same sizes, but every eliminable param touches RANDOM bottom rows
    (no locality to preserve)."""
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for e in range(n_elim):
        for r in rng.choice(n_bottom, 3, replace=False):
            rows.append(n_elim + int(r))
            cols.append(e)
    for r in range(n_bottom - 1):
        rows.append(n_elim + r + 1)
        cols.append(n_elim + r)
    return _pairs_to_ss(np.array(rows), np.array(cols), n_elim + n_bottom)


def test_bottom_permutation_keeps_locality_on_banded():
    ss = _banded_schur_problem()
    n_elim, n_bottom = 400, 40
    ss_bottom = ss.extract_right_bottom(n_elim)
    perm = _bottom_permutation(Settings(backend=BackendType.PLANNED), ss,
                               ss_bottom, n_elim, n_elim + n_bottom)
    # banded + elim-dominated: must take the locality branch; on an
    # already perfectly banded bottom, identity has minimal bandwidth
    assert np.array_equal(perm, np.arange(n_bottom))


def test_bottom_permutation_rcm_beats_scrambled_band():
    ss = _banded_schur_problem()
    n_elim, n_bottom = 400, 40
    # scramble the bottom's user order: RCM should win the bandwidth pick
    rng = np.random.RandomState(3)
    scram = rng.permutation(n_bottom)
    inv = np.empty(n_bottom, np.int64)
    inv[scram] = np.arange(n_bottom)
    ss_bottom = ss.extract_right_bottom(n_elim).symmetric_permutation(
        inv, lower_half=True)
    # rebuild a full ss whose bottom is the scrambled one (the elim
    # columns' spread stays narrow in VALUE terms regardless of label
    # order, so recompute it against scrambled labels)
    rows, cols = [], []
    er = ss.expanded_rows()
    ec = ss.inds
    for r, c in zip(er, ec):
        rr = n_elim + inv[r - n_elim] if r >= n_elim else r
        cc = n_elim + inv[c - n_elim] if c >= n_elim else c
        rows.append(max(rr, cc))
        cols.append(min(rr, cc))
    ss2 = _pairs_to_ss(np.array(rows), np.array(cols), n_elim + n_bottom)
    perm = _bottom_permutation(Settings(backend=BackendType.PLANNED), ss2,
                               ss_bottom, n_elim, n_elim + n_bottom)
    ident_bw = np.percentile(
        np.abs(ss_bottom.expanded_rows() - ss_bottom.inds), 90)
    inv2 = np.empty(n_bottom, np.int64)
    inv2[perm] = np.arange(n_bottom)
    got_bw = np.percentile(
        np.abs(inv2[ss_bottom.expanded_rows()] - inv2[ss_bottom.inds]), 90)
    assert got_bw <= ident_bw  # RCM recovered (or matched) the band


def test_bottom_permutation_amd_on_scattered():
    ss = _scattered_schur_problem()
    n_elim, n_bottom = 400, 40
    ss_bottom = ss.extract_right_bottom(n_elim)
    perm = _bottom_permutation(Settings(backend=BackendType.PLANNED), ss,
                               ss_bottom, n_elim, n_elim + n_bottom)
    want = ss_bottom.fill_reducing_permutation()
    assert np.array_equal(perm, want)  # no locality -> AMD default


def test_bottom_permutation_amd_when_bottom_dominates():
    # given_elim_end < 4 * bottom order -> always AMD, even if banded
    ss = _banded_schur_problem(n_elim=100, n_bottom=40)
    ss_bottom = ss.extract_right_bottom(100)
    perm = _bottom_permutation(Settings(backend=BackendType.PLANNED), ss,
                               ss_bottom, 100, 140)
    want = ss_bottom.fill_reducing_permutation()
    assert np.array_equal(perm, want)


# -- batched-regime merge-candidate selection ---------------------------

def _flatlike(seed=5, n=300):
    gen = SparseMatGenerator.gen_flat(n, 0.1, seed=seed)
    return gen.to_structure(), np.full(n, 3)


def test_regime_coarsening_triggers_and_is_correct():
    ss, psizes = _flatlike()
    s_ref = create_solver(Settings(backend=BackendType.REF), psizes, ss)
    s_pl = create_solver(Settings(backend=BackendType.PLANNED), psizes, ss)
    # the dense flat core must land in the candidate-selection window and
    # coarsen to fewer lumps than the reference-model merge
    assert 2 < s_ref.skel.num_lumps
    assert s_pl.skel.num_lumps <= s_ref.skel.num_lumps
    # numerics unaffected by the regime choice
    data = random_spd_data(s_pl.data_size, s_pl.order, 1, np.float64)
    data = np.asarray(s_pl.skel.damp(data, 0.0, s_pl.order * 1.5))
    f = s_pl.factor(data)
    dense = s_pl.skel.densify(data, fill_upper_half=True)
    L = np.tril(s_pl.skel.densify(np.asarray(f)))
    assert np.abs(L @ L.T - dense).max() < 1e-8 * np.abs(dense).max()


def test_regime_selection_applies_to_custom_model():
    from baspacho_tpu.computation_model import (model_default,
                                                scale_constant_terms)

    ss, psizes = _flatlike()
    base = model_default
    custom = scale_constant_terms(base, 2.0)
    s_custom = create_solver(Settings(backend=BackendType.PLANNED,
                                      computation_model=custom),
                             psizes, ss)
    s_default = create_solver(Settings(backend=BackendType.PLANNED),
                              psizes, ss)
    # the custom-model path must not silently skip candidate selection:
    # both land in the same coarse-lump regime (identical or near counts)
    assert abs(s_custom.skel.num_lumps - s_default.skel.num_lumps) <= 2


def test_batched_cost_prefers_fewer_levels_on_tiny_flops():
    """The evaluator's raison d'etre: for op-overhead-bound trees the
    coarser candidate must cost less despite more padded flops."""
    ss, psizes = _flatlike()
    from baspacho_tpu.computation_model import (model_default,
                                                scale_constant_terms)
    from baspacho_tpu.elimination_tree import EliminationTree
    from baspacho_tpu.solver import _pad_fn_for
    from baspacho_tpu.utils import inverse_permutation

    settings = Settings(backend=BackendType.PLANNED)
    perm = ss.fill_reducing_permutation()
    inv = inverse_permutation(perm)
    ssb = ss.symmetric_permutation(inv, lower_half=True)
    sizes = np.empty(len(psizes), np.int64)
    sizes[inv] = psizes
    base = model_default
    pad_fn = _pad_fn_for(settings)

    et = EliminationTree(sizes, ssb, base)
    et.build_tree()
    et.process_tree(False, [], False)
    et.compute_aggregate_struct(False)
    fine = _batched_factor_cost(et, pad_fn)
    fine_lumps = len(et.lump_to_span) - 1

    et.remerge(scale_constant_terms(base, 64.0), False, [], False)
    et.compute_aggregate_struct(False)
    coarse = _batched_factor_cost(et, pad_fn)
    coarse_lumps = len(et.lump_to_span) - 1

    if coarse_lumps < fine_lumps:
        assert coarse < fine
