"""createSolver policy matrix (reference tests/CreateSolverTest.cpp):
all fill policies x elim ranges x elim-last ids, asserting can_factor_up_to
and reordering invariants."""

import numpy as np
import pytest

from baspacho_tpu import AddFillPolicy, BackendType, Settings, create_solver
from baspacho_tpu.testing import SparseMatGenerator, random_spd_data


def problem(seed=0, n=14, schur=56):
    gen = SparseMatGenerator.gen_flat(n, 0.3, seed=seed)
    gen.add_schur_set(schur, 0.12)
    ss = gen.to_structure()
    return ss, np.full(ss.order, 2), schur


@pytest.mark.parametrize("policy,expect_cfut", [
    (AddFillPolicy.COMPLETE, "all"),
    (AddFillPolicy.FOR_AUTO_ELIMS, "elim_end"),
    (AddFillPolicy.FOR_GIVEN_ELIMS, "given_end"),
    (AddFillPolicy.NONE, "zero"),
])
def test_policies(policy, expect_cfut):
    ss, psizes, schur = problem()
    solver = create_solver(Settings(add_fill_policy=policy), psizes, ss,
                           sparse_elim_ranges=[0, schur])
    n = len(psizes)
    if expect_cfut == "all":
        assert solver.can_factor_up_to == n
    elif expect_cfut == "zero":
        assert solver.can_factor_up_to == 0
    elif expect_cfut == "given_end":
        assert solver.can_factor_up_to == schur
    else:  # elim end >= given end
        assert schur <= solver.can_factor_up_to <= n
    if policy in (AddFillPolicy.NONE, AddFillPolicy.FOR_GIVEN_ELIMS):
        assert np.array_equal(solver.permutation, np.arange(n))


def test_elim_range_partial_factor_matches_dense_schur():
    """FOR_GIVEN_ELIMS: factor_up_to(schur end) against dense formula."""
    ss, psizes, schur = problem(seed=2)
    solver = create_solver(
        Settings(add_fill_policy=AddFillPolicy.FOR_GIVEN_ELIMS),
        psizes, ss, sparse_elim_ranges=[0, schur])
    data = random_spd_data(solver.data_size, solver.order, 3)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    t = schur
    o = solver.span_vector_offset(t)
    m = solver.skel.densify(data, fill_upper_half=True)
    part = solver.skel.densify(np.asarray(solver.factor_up_to(data, t)))
    l11_want = np.linalg.cholesky(m[:o, :o])
    assert np.max(np.abs(np.tril(part[:o, :o]) - l11_want)) < 1e-9
    l21_want = np.linalg.solve(l11_want, m[:o, o:]).T
    # only structurally-present entries are stored
    mask = solver.skel.densify(np.ones(solver.data_size))[o:, :o] != 0
    assert np.max(np.abs((part[o:, :o] - l21_want) * mask)) < 1e-9


def test_elim_last_ids_land_last():
    gen = SparseMatGenerator.gen_flat(20, 0.25, seed=7)
    ss = gen.to_structure()
    psizes = np.full(20, 3)
    last = {2, 9, 15, 18}
    solver = create_solver(Settings(), psizes, ss, elim_last_ids=last)
    spans = sorted(int(solver.permutation[i]) for i in last)
    assert spans == [16, 17, 18, 19]
    # partial factor up to the elim-last boundary must be legal
    boundary = 16
    sp = solver.skel.span_offset_in_lump[boundary]
    assert sp == 0  # merges must not cross the no-cross boundary
    data = random_spd_data(solver.data_size, solver.order, 1)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    solver.factor_up_to(data, boundary)


def test_no_sparse_elim_detection_flag():
    ss, psizes, schur = problem(seed=4)
    s_off = create_solver(
        Settings(find_sparse_elimination_ranges=False), psizes, ss)
    assert s_off.sparse_elim_ranges == []
    s_on = create_solver(Settings(), psizes, ss)
    assert len(s_on.sparse_elim_ranges) >= 2


def test_backends_agree():
    ss, psizes, schur = problem(seed=5, n=10, schur=30)
    data = None
    results = []
    for backend in (BackendType.REF, BackendType.PLANNED):
        solver = create_solver(Settings(backend=backend), psizes, ss,
                               sparse_elim_ranges=[0, schur])
        if data is None:
            data = random_spd_data(solver.data_size, solver.order, 9)
            # note: data sizes differ between layouts; rebuild per backend
        d = random_spd_data(solver.data_size, solver.order, 9)
        d = np.asarray(solver.skel.damp(d, 0.0, solver.order * 1.5))
        dense_in = solver.skel.densify(d, fill_upper_half=True)
        L = np.tril(solver.skel.densify(np.asarray(solver.factor(d))))
        results.append((dense_in, L))
    # same user problem produces the same dense input? layouts differ in
    # random data, so compare L L^T vs input per backend instead
    for dense_in, L in results:
        assert np.max(np.abs(L @ L.T - dense_in)) < 1e-8


def test_level_reorder_option():
    """level_reorder=True renumbers lumps level-major; factorization must
    stay correct (buckets become contiguous storage slices)."""
    ss, psizes, schur = problem(seed=8, n=12, schur=56)
    solver = create_solver(
        Settings(backend=BackendType.PLANNED, level_reorder=True),
        psizes, ss, sparse_elim_ranges=[0, schur])
    data = random_spd_data(solver.data_size, solver.order, 11)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    dense = solver.skel.densify(data, fill_upper_half=True)
    L = np.tril(solver.skel.densify(np.asarray(solver.factor(data))))
    assert np.max(np.abs(L @ L.T - dense)) < 1e-8
    # levels must be non-decreasing along the post-elim lump order
    lv = solver.plan.lump_levels[schur:]
    assert np.all(np.diff(lv) >= 0)


def test_numeric_input_validation():
    """Wrong-shaped inputs raise with clear messages (the reference guards
    every numeric op with BASPACHO_CHECK*, DebugMacros.h)."""
    import numpy as np
    import pytest
    from baspacho_tpu import Settings, create_solver
    from baspacho_tpu.testing import SparseMatGenerator, random_spd_data

    gen = SparseMatGenerator.gen_flat(10, 0.3, seed=1)
    solver = create_solver(Settings(), np.full(10, 2), gen.to_structure())
    data = random_spd_data(solver.data_size, solver.order, 1)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    with pytest.raises(ValueError, match="elements"):
        solver.factor(data[:-1])
    f = solver.factor(data)
    with pytest.raises(ValueError, match="order"):
        solver.solve(f, np.zeros(solver.order + 1))


def _banded_fixture(sloppy):
    """Lower-half CSR: 160 elim params + 40 bottom params. Every elim
    column is touched by two ADJACENT (in user order) bottom rows, so the
    locality test in _bottom_permutation passes; the bottom-bottom
    coupling is a path graph — laid out banded (user order = path order)
    or 'sloppy' (path vertices interleaved across the two halves, user
    bandwidth ~20 where RCM recovers bandwidth 1)."""
    n_elim, n_bot = 160, 40
    order = n_elim + n_bot
    pos = np.arange(n_bot)
    if sloppy:
        # path vertex k sits at user position (k//2) + 20*(k%2)
        pos = (np.arange(n_bot) // 2) + (n_bot // 2) * (np.arange(n_bot) % 2)
    rows, cols = [], []
    rows += list(range(order))
    cols += list(range(order))          # diagonal
    for j in range(n_elim):             # elim col j <- bottom window
        b = j // 4
        for r in {b, min(b + 1, n_bot - 1)}:
            rows.append(n_elim + int(pos[r]))
            cols.append(j)
    for k in range(n_bot - 1):          # bottom path edges
        a, b = int(pos[k]), int(pos[k + 1])
        rows.append(n_elim + max(a, b))
        cols.append(n_elim + min(a, b))
    rows, cols = np.array(rows), np.array(cols)
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    ptrs = np.searchsorted(rows, np.arange(order + 1))
    from baspacho_tpu.sparse_structure import SparseStructure
    return SparseStructure(ptrs, cols), n_elim


def test_bottom_permutation_banded_picks_identity():
    """User order already banded: the measured-bandwidth pick must keep
    it (identity), preserving the chunk locality downstream."""
    from baspacho_tpu.solver import _bottom_permutation
    ss, elim_end = _banded_fixture(sloppy=False)
    ssb = ss.extract_right_bottom(elim_end)
    perm = _bottom_permutation(Settings(backend=BackendType.PLANNED),
                               ss, ssb, elim_end, ss.order)
    assert np.array_equal(perm, np.arange(ssb.order))


def test_bottom_permutation_sloppy_picks_rcm():
    """Banded-but-sloppy user order: RCM must win the bandwidth pick and
    actually reduce the 90th-percentile bandwidth."""
    from baspacho_tpu.solver import _bottom_permutation
    ss, elim_end = _banded_fixture(sloppy=True)
    ssb = ss.extract_right_bottom(elim_end)
    perm = _bottom_permutation(Settings(backend=BackendType.PLANNED),
                               ss, ssb, elim_end, ss.order)
    assert not np.array_equal(perm, np.arange(ssb.order))
    er, ec = ssb.expanded_rows(), ssb.inds

    def p90(p):
        inv = np.empty(ssb.order, np.int64)
        inv[p] = np.arange(ssb.order)
        return np.percentile(np.abs(inv[er] - inv[ec]), 90)

    assert p90(perm) < p90(np.arange(ssb.order))
    assert np.array_equal(perm, ssb.rcm_permutation())


def test_bottom_permutation_scattered_falls_back_to_amd():
    """Elim columns touching SCATTERED bottom rows (large median spread)
    must fall back to the fill-reducing (AMD) ordering."""
    from baspacho_tpu.solver import _bottom_permutation
    rng = np.random.RandomState(3)
    n_elim, n_bot = 160, 40
    order = n_elim + n_bot
    rows = list(range(order))
    cols = list(range(order))
    for j in range(n_elim):
        for r in rng.choice(n_bot, 3, replace=False):
            rows.append(n_elim + int(r))
            cols.append(j)
    rows, cols = np.array(rows), np.array(cols)
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    # dedupe
    keep = np.concatenate([[True], (np.diff(rows) != 0) | (np.diff(cols) != 0)])
    rows, cols = rows[keep], cols[keep]
    ptrs = np.searchsorted(rows, np.arange(order + 1))
    from baspacho_tpu.sparse_structure import SparseStructure
    ss = SparseStructure(ptrs, cols)
    ssb = ss.extract_right_bottom(n_elim)
    perm = _bottom_permutation(Settings(backend=BackendType.PLANNED),
                               ss, ssb, n_elim, order)
    assert np.array_equal(perm, ssb.fill_reducing_permutation())


def test_regime_candidates_coarsen_and_stay_correct():
    """Op-overhead-bound regime (bottom lumps in (2, 64]): the candidate
    mechanism may only COARSEN the merge (fewer lumps), never break
    numerics, and must leave flop-bound problems untouched."""
    gen = SparseMatGenerator.gen_flat(220, 0.1, seed=37)
    ss = gen.to_structure()
    psizes = np.full(220, 3)
    s_ref = create_solver(Settings(backend=BackendType.REF), psizes, ss)
    s_pl = create_solver(Settings(backend=BackendType.PLANNED), psizes, ss)
    base_lumps = s_ref.skel.num_lumps
    assert 2 < base_lumps <= 64, "fixture must land in the regime window"
    assert s_pl.skel.num_lumps <= base_lumps
    data = random_spd_data(s_pl.data_size, s_pl.order, 5)
    data = np.asarray(s_pl.skel.damp(data, 0.0, s_pl.order * 1.5))
    dense = s_pl.skel.densify(data, fill_upper_half=True)
    L = np.tril(s_pl.skel.densify(np.asarray(s_pl.factor(data))))
    assert np.max(np.abs(L @ L.T - dense)) / np.abs(dense).max() < 1e-5


def test_regime_candidates_apply_to_custom_model():
    """A user-provided computation model must take the SAME candidate
    path as the default (a coarsening that silently turned off for
    custom models would miss it)."""
    from baspacho_tpu.computation_model import model_default
    gen = SparseMatGenerator.gen_flat(220, 0.1, seed=37)
    ss = gen.to_structure()
    psizes = np.full(220, 3)
    s_def = create_solver(Settings(backend=BackendType.PLANNED), psizes, ss)
    s_cus = create_solver(
        Settings(backend=BackendType.PLANNED,
                 computation_model=model_default), psizes, ss)
    assert s_cus.skel.num_lumps == s_def.skel.num_lumps
    assert np.array_equal(s_cus.skel.lump_start, s_def.skel.lump_start)
