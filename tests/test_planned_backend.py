"""Planned (level-scheduled bucketed) backend parity tests: same oracles
as the ref-backend suites, mirroring how the reference validates its fast
backends (CudaFactorTest/CudaSolveTest reuse the FactorTest oracles)."""

import numpy as np
import pytest

from baspacho_tpu import BackendType, Settings, create_solver
from baspacho_tpu.testing import SparseMatGenerator, random_spd_data


def build(seed, n=30, fill=0.08, schur=0, elim_ranges=(), psize=(1, 4)):
    gen = SparseMatGenerator.gen_flat(n, fill, seed=seed)
    if schur:
        gen.add_schur_set(schur, 0.12)
    ss = gen.to_structure()
    rng = np.random.RandomState(seed)
    param_sizes = rng.randint(psize[0], psize[1], size=ss.order)
    solver = create_solver(Settings(backend=BackendType.PLANNED),
                           param_sizes, ss,
                           sparse_elim_ranges=list(elim_ranges))
    data = random_spd_data(solver.data_size, solver.order, seed + 77)
    data = solver.skel.damp(data, 0.0, solver.order * 1.5)
    return solver, np.asarray(data)


@pytest.mark.parametrize("seed", range(3))
def test_planned_factor_solve(seed):
    solver, data = build(seed)
    dense = solver.skel.densify(data, fill_upper_half=True)
    l_oracle = np.linalg.cholesky(dense)
    f = np.asarray(solver.factor(data))
    assert np.max(np.abs(np.tril(solver.skel.densify(f)) - l_oracle)) < 1e-9

    rng = np.random.RandomState(seed)
    rhs = rng.rand(solver.order, 3)
    got = np.asarray(solver.solve(f, rhs))
    want = np.linalg.solve(l_oracle.T, np.linalg.solve(l_oracle, rhs))
    assert np.max(np.abs(got - want)) < 1e-8


def test_planned_factor_with_elim_range():
    solver, data = build(0, n=15, fill=0.2, schur=60, elim_ranges=[0, 60])
    dense = solver.skel.densify(data, fill_upper_half=True)
    l_oracle = np.linalg.cholesky(dense)
    f = np.asarray(solver.factor(data))
    assert np.max(np.abs(np.tril(solver.skel.densify(f)) - l_oracle)) < 1e-9


def test_planned_partial_and_addmv():
    solver, data = build(1, n=40, fill=0.05)
    nl = solver.skel.num_lumps
    assert nl >= 2
    t = int(solver.skel.lump_to_span[max(1, nl // 2)])
    o = solver.span_vector_offset(t)
    full = np.asarray(solver.factor(data))
    part = np.asarray(
        solver.factor_from(np.asarray(solver.factor_up_to(data, t)), t))
    assert np.max(np.abs(full - part)) < 1e-9

    m = solver.skel.densify(data, fill_upper_half=True)
    rng = np.random.RandomState(3)
    x = rng.rand(solver.order, 2)
    out = rng.rand(solver.order, 2)
    got = np.asarray(solver.add_mv_from(data, t, x, out, 0.5))
    want = out.copy()
    want[o:] += 0.5 * (m[o:, o:] @ x[o:])
    assert np.max(np.abs(got - want)) < 1e-9


def test_planned_batched_matches_single():
    solver, data = build(2, n=20, fill=0.15)
    batch = 3
    datas = np.stack([data * (1.0 + 0.01 * b) for b in range(batch)])
    single = [np.asarray(solver.factor(datas[b])) for b in range(batch)]
    batched = np.asarray(solver.factor(datas))
    for b in range(batch):
        assert np.max(np.abs(batched[b] - single[b])) < 1e-10


def test_planned_batched_dense_update_path():
    """Batched (vmapped) factor through the dense W W^T update path."""
    solver, data = build(4, n=12, fill=0.3, schur=70, elim_ranges=[0, 70])
    sched = solver.backend._factor_schedule(0, solver.skel.num_lumps)
    assert any(lev[3] is not None for lev in sched), "dense path not hit"
    batch = 3
    datas = np.stack([data * (1.0 + 0.02 * b) for b in range(batch)])
    batched = np.asarray(solver.factor(datas))
    for b in range(batch):
        single = np.asarray(solver.factor(datas[b]))
        assert np.max(np.abs(batched[b] - single)) < 1e-10
        dense = solver.skel.densify(datas[b], fill_upper_half=True)
        L = np.tril(solver.skel.densify(single))
        assert np.max(np.abs(L @ L.T - dense)) < 1e-8


def test_dense_w_and_oh_modes_agree():
    """The scatter-built-W dense mode and the chunked one-hot mode must
    produce identical factors and solves (they are two mechanisms for the
    same compact-U update)."""
    import os

    from baspacho_tpu.testing import SparseMatGenerator, random_spd_data

    gen = SparseMatGenerator.gen_flat(120, 0.12, seed=11)
    ss = gen.to_structure()
    results = {}
    for mode in ("w", "oh"):
        os.environ["BASPACHO_FORCE_DENSE_MODE"] = mode
        try:
            solver = create_solver(Settings(backend=BackendType.PLANNED),
                                   np.full(120, 3), ss)
            sched = solver.backend._factor_schedule(
                0, solver.skel.num_lumps)
            modes = {lev[3]["mode"] for lev in sched if lev[3] is not None}
            assert modes <= {mode}, f"forced {mode}, got {modes}"
            data = random_spd_data(solver.data_size, solver.order, 5)
            data = np.asarray(solver.skel.damp(data, 0.0,
                                               solver.order * 1.5))
            f = solver.factor(data)
            rhs = np.random.RandomState(2).rand(solver.order, 2)
            x = solver.solve(f, rhs)
            results[mode] = (np.asarray(f), np.asarray(x))
        finally:
            os.environ.pop("BASPACHO_FORCE_DENSE_MODE", None)
    if "w" not in results or "oh" not in results:
        return  # problem too small to trigger dense on one mode
    np.testing.assert_allclose(results["w"][0], results["oh"][0],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(results["w"][1], results["oh"][1],
                               rtol=1e-8, atol=1e-10)


def test_dense_sg_and_row_modes_agree():
    """The span-granular one-hot accumulation (sg) must match the
    row-granular form on factor AND solve for a span-uniform Schur set
    (reference family: FLAT+SCHUR, TestingMatGen.cpp schur sets)."""
    import os

    gen = SparseMatGenerator.gen_flat(60, 0.3, seed=5)
    gen.add_schur_set(400, 0.06)
    ss = gen.to_structure()
    psize = np.full(460, 3)
    results = {}
    for mode in ("sg", "row"):
        os.environ["BASPACHO_FORCE_DENSE_MODE"] = mode
        try:
            solver = create_solver(Settings(backend=BackendType.PLANNED),
                                   psize, ss, sparse_elim_ranges=[0, 400])
            sched = solver.backend._factor_schedule(
                0, solver.skel.num_lumps)
            has_sg = any(lev[3] is not None and
                         lev[3].get("sg") is not None for lev in sched)
            assert has_sg == (mode == "sg")
            data = random_spd_data(solver.data_size, solver.order, 3)
            data = np.asarray(solver.skel.damp(data, 0.0,
                                               solver.order * 1.5))
            f = solver.factor(data)
            rhs = np.random.RandomState(2).rand(solver.order, 2)
            x = solver.solve(f, rhs)
            results[mode] = (np.asarray(f), np.asarray(x))
        finally:
            os.environ.pop("BASPACHO_FORCE_DENSE_MODE", None)
    np.testing.assert_allclose(results["sg"][0], results["row"][0],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(results["sg"][1], results["row"][1],
                               rtol=1e-8, atol=1e-10)


def test_dense_sg_triangular_full_space():
    """Random-fill Schur sets have no compact-space locality: the sg
    accumulation must switch to full-space chunks with a lower
    block-triangle + mirror (tri), and still match the row form."""
    import os

    gen = SparseMatGenerator.gen_flat(350, 0.1, seed=7)
    gen.add_schur_set(1200, 0.04)
    ss = gen.to_structure()
    psize = np.full(1550, 3)
    results = {}
    for mode in ("sg", "row"):
        os.environ["BASPACHO_FORCE_DENSE_MODE"] = mode
        try:
            solver = create_solver(Settings(backend=BackendType.PLANNED),
                                   psize, ss, sparse_elim_ranges=[0, 1200])
            if mode == "sg":
                sched = solver.backend._factor_schedule(
                    0, solver.skel.num_lumps)
                tris = [lev[3]["sg"]["tri"] for lev in sched
                        if lev[3] is not None and
                        lev[3].get("sg") is not None]
                assert tris and tris[0] is not None, \
                    "expected triangular blocking on the random-fill level"
            data = random_spd_data(solver.data_size, solver.order, 3)
            data = np.asarray(solver.skel.damp(data, 0.0,
                                               solver.order * 1.5))
            f = solver.factor(data)
            results[mode] = np.asarray(f)
        finally:
            os.environ.pop("BASPACHO_FORCE_DENSE_MODE", None)
    np.testing.assert_allclose(results["sg"], results["row"],
                               rtol=1e-8, atol=1e-10)


def test_dense_update_run_crossing_diag_below_boundary():
    """Regression: a dense-update row run whose below span is id-consecutive
    with the target's own spans must split at the diag/below storage
    boundary (padded panels have a gap at panel_base + stride^2). Minimal
    reproducing structure: span sizes [2,2,3,3], single-span
    lumps, lower-half columns {0:[0,2,3], 1:[1,2,3], 2:[2,3], 3:[3]} —
    target lump 2's run [2,3] crosses its own-span boundary."""
    from baspacho_tpu.block_matrix import CoalescedBlockMatrixSkel
    from baspacho_tpu.ops.planned_backend import storage_pad
    from baspacho_tpu.solver import Solver
    from baspacho_tpu.testing import random_spd_data

    span_start = [0, 2, 4, 7, 10]
    lump_to_span = [0, 1, 2, 3, 4]
    cols = {0: [0, 2, 3], 1: [1, 2, 3], 2: [2, 3], 3: [3]}
    col_ptr = np.cumsum([0] + [len(cols[i]) for i in range(4)])
    row_ind = np.concatenate([cols[i] for i in range(4)])
    skel = CoalescedBlockMatrixSkel(span_start, lump_to_span, col_ptr,
                                    row_ind, pad_fn=storage_pad)
    solver = Solver(skel, [], np.arange(4), BackendType.PLANNED)
    solver.backend.ROW_NS = 1.0  # force the dense path on a tiny problem
    sched = solver.backend._factor_schedule(0, skel.num_lumps)
    assert any(lev[3] is not None for lev in sched), "dense path not hit"

    data = random_spd_data(skel.data_size, skel.order, 5)
    data = np.asarray(skel.damp(data, 0.0, skel.order * 1.5))
    dense = skel.densify(data, fill_upper_half=True)
    l_oracle = np.linalg.cholesky(dense)
    f = np.asarray(solver.factor(data))
    assert np.max(np.abs(np.tril(skel.densify(f)) - l_oracle)) < 1e-10


def test_dense_outlier_routing():
    """Dense-level origins with far-flung couplings (BA loop closures)
    must route through the block-pair path while the rest stays in the
    compact one-hot space — factor AND solve against dense oracles.
    Uses AddFillPolicy.FOR_GIVEN_ELIMS (identity ordering) so the
    window/closure locality structure is preserved deterministically."""
    from baspacho_tpu import AddFillPolicy
    from baspacho_tpu.ops.planned_backend import PlannedBackend
    from baspacho_tpu.sparse_structure import SparseStructure
    from baspacho_tpu.utils import cum_sum_vec

    rng = np.random.RandomState(3)
    n_cams, n_pts, w = 30, 300, 3
    base = np.sort(rng.randint(0, n_cams - w, size=n_pts))
    cols = {p: sorted({int(base[p] + k) for k in
                       rng.choice(w, 2, replace=False)})
            for p in range(n_pts)}
    for p in rng.choice(n_pts, n_pts // 5, replace=False):  # closures
        cols[p] = sorted(set(cols[p]) |
                         {int(rng.randint(0, n_cams))})
    # lower-half CSR rows: pt rows reference themselves; cam rows
    # reference their points and themselves
    n = n_pts + n_cams
    row_cols = [[] for _ in range(n)]
    for p, cs in cols.items():
        row_cols[p].append(p)
        for c in cs:
            row_cols[n_pts + c].append(p)
    for c in range(n_cams):
        row_cols[n_pts + c].append(n_pts + c)
    ptrs = cum_sum_vec([len(r) for r in row_cols])
    inds = np.concatenate([sorted(r) for r in row_cols])
    ss = SparseStructure(ptrs, inds)
    sizes = np.array([3] * n_pts + [9] * n_cams)

    old_floor = PlannedBackend.SUB_FLOOR
    old_wmax = PlannedBackend.W_MAX_ELEMS
    PlannedBackend.SUB_FLOOR = 16  # let the adaptive cap bite at this
    #                                small scale
    PlannedBackend.W_MAX_ELEMS = 0  # force the one-hot dense mode (the
    #                                 W-scatter mode has no outliers)
    import os
    os.environ["BASPACHO_FORCE_ASSEMBLY"] = "dense"
    try:
        solver = create_solver(
            Settings(backend=BackendType.PLANNED,
                     add_fill_policy=AddFillPolicy.FOR_GIVEN_ELIMS),
            sizes, ss, sparse_elim_ranges=[0, n_pts])
        sched = solver.backend._factor_schedule(
            0, int(solver.skel.span_to_lump[solver.can_factor_up_to]))
    finally:
        PlannedBackend.SUB_FLOOR = old_floor
        PlannedBackend.W_MAX_ELEMS = old_wmax
        os.environ.pop("BASPACHO_FORCE_ASSEMBLY", None)
    has_out = any(lev[3] is not None and lev[3]["outliers"]
                  for lev in sched)
    assert has_out, "no outliers triggered; test structure needs tuning"

    data = random_spd_data(solver.data_size, solver.order, 9)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    dense = solver.skel.densify(data, fill_upper_half=True)
    t = solver.can_factor_up_to
    o = solver.span_vector_offset(t)
    part = np.asarray(solver.factor_up_to(data, t))
    # partial-factor Schur oracle on the eliminated range
    l11 = np.linalg.cholesky(dense[:o, :o])
    l21 = dense[o:, :o] @ np.linalg.inv(l11).T
    got_l11 = np.tril(solver.skel.densify(part)[:o, :o])
    assert np.max(np.abs(got_l11 - l11)) < 1e-9
    got_l21 = solver.skel.densify(part)[o:, :o]
    assert np.max(np.abs(got_l21 - l21)) < 1e-8
    schur_want = dense[o:, o:] - l21 @ l21.T
    got_schur = solver.skel.densify(part, fill_upper_half=True)[o:, o:]
    mask = np.abs(dense[o:, o:]) + np.abs(schur_want) > 0
    assert np.max(np.abs((got_schur - schur_want) * mask)) < 1e-8

    # fused-solve outlier path: L then Lt over the eliminated range must
    # equal the composition of the (independently oracled) partial solves
    import jax.numpy as jnp
    k = int(solver.skel.span_to_lump[t])
    fn, aux = solver.backend.make_solve(0, k)
    rhs = rng.rand(solver.order, 2)
    got = np.asarray(fn(jnp.asarray(part), jnp.asarray(rhs),
                        tuple(jnp.asarray(a) for a in aux)))
    want = np.asarray(solver.solve_lt_up_to(
        part, t, solver.solve_l_up_to(part, t, rhs)))
    assert np.max(np.abs(got - want)) < 1e-9


def test_panel_cap_splits_buckets(monkeypatch):
    """Oversized shape groups split into capped sub-buckets (a memory
    bound on each materialized panel tensor); factor and solve must be
    exact fallbacks of the same math. A 16 KiB cap (dense float64 panel
    bytes: a few dozen panels of this problem's level 0) forces several
    contiguous sub-buckets on a Schur problem while leaving planning
    economics realistic."""
    monkeypatch.setenv("BASPACHO_PANEL_BYTES_CAP", str(16 << 10))
    solver, data = build(3, n=20, fill=0.15, schur=240,
                         elim_ranges=[0, 240], psize=(3, 4))
    sched = solver.backend._factor_schedule(0, solver.skel.num_lumps)
    assert len(sched[0][0]) >= 2  # the cap actually split level 0
    dense = solver.skel.densify(data, fill_upper_half=True)
    l_oracle = np.linalg.cholesky(dense)
    f = np.asarray(solver.factor(data))
    assert np.max(np.abs(np.tril(solver.skel.densify(f)) - l_oracle)) < 1e-9
    rng = np.random.RandomState(3)
    rhs = rng.rand(solver.order, 2)
    got = np.asarray(solver.solve(f, rhs))
    want = np.linalg.solve(l_oracle.T, np.linalg.solve(l_oracle, rhs))
    assert np.max(np.abs(got - want)) < 1e-8


def test_dense_sg_nine_wide_spans():
    """sg accumulation with 9-wide bottom spans — the BAL camera shape
    (s3=9, the size the north-star problem runs at level 0): must match
    the row-granular form on factor AND solve, and the solve must match
    the dense oracle."""
    import os

    gen = SparseMatGenerator.gen_flat(16, 0.3, seed=9)
    gen.add_schur_set(220, 0.05)
    ss = gen.to_structure()
    psize = np.concatenate([np.full(220, 3), np.full(16, 9)])
    results = {}
    for mode in ("sg", "row"):
        os.environ["BASPACHO_FORCE_DENSE_MODE"] = mode
        try:
            solver = create_solver(Settings(backend=BackendType.PLANNED),
                                   psize, ss, sparse_elim_ranges=[0, 220])
            if mode == "sg":
                sched = solver.backend._factor_schedule(
                    0, solver.skel.num_lumps)
                sgs = [lev[3].get("sg") for lev in sched
                       if lev[3] is not None]
                assert any(s is not None and s["s3"] == 9 for s in sgs), \
                    "expected an s3=9 span-granular level"
            data = random_spd_data(solver.data_size, solver.order, 4)
            data = np.asarray(solver.skel.damp(data, 0.0,
                                               solver.order * 1.5))
            f = solver.factor(data)
            rhs = np.random.RandomState(6).rand(solver.order, 1)
            x = solver.solve(f, rhs)
            results[mode] = (np.asarray(f), np.asarray(x))
        finally:
            os.environ.pop("BASPACHO_FORCE_DENSE_MODE", None)
        dense = solver.skel.densify(data, fill_upper_half=True)
        want = np.linalg.solve(dense, rhs)
        assert np.max(np.abs(results[mode][1] - want)) < 1e-7
    np.testing.assert_allclose(results["sg"][0], results["row"][0],
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(results["sg"][1], results["row"][1],
                               rtol=1e-7, atol=1e-9)


def test_planned_batched_sg_update_path(monkeypatch):
    """Batched (vmapped) factor+solve through the span-granular (sg)
    dense update — the mode BAL-scale and schursize=50000 levels run."""
    monkeypatch.setenv("BASPACHO_FORCE_DENSE_MODE", "sg")
    gen = SparseMatGenerator.gen_flat(40, 0.3, seed=12)
    gen.add_schur_set(300, 0.06)
    ss = gen.to_structure()
    solver = create_solver(Settings(backend=BackendType.PLANNED),
                           np.full(340, 3), ss,
                           sparse_elim_ranges=[0, 300])
    sched = solver.backend._factor_schedule(0, solver.skel.num_lumps)
    assert any(lev[3] is not None and lev[3].get("sg") is not None
               for lev in sched), "sg path not hit"
    data = random_spd_data(solver.data_size, solver.order, 8)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    batch = 3
    datas = np.stack([data * (1.0 + 0.02 * b) for b in range(batch)])
    rhs = np.random.RandomState(4).rand(batch, solver.order, 1)
    fb = np.asarray(solver.factor(datas))
    xb = np.asarray(solver.solve(fb, rhs))
    for b in range(batch):
        single_f = np.asarray(solver.factor(datas[b]))
        assert np.max(np.abs(fb[b] - single_f)) < 1e-10
        dense = solver.skel.densify(datas[b], fill_upper_half=True)
        want = np.linalg.solve(dense, rhs[b])
        assert np.max(np.abs(xb[b] - want)) < 1e-7


@pytest.mark.parametrize("cp", [4, 8, 9, 256, 257, 512, 1024])
def test_factor_panels_widths_match_dense_oracle(cp):
    """The panel potrf + below trsm + explicit inverse, at widths on both
    sides of every former route threshold, against float64 numpy."""
    import jax.numpy as jnp

    from baspacho_tpu.ops.planned_backend import PlannedBackend

    be = PlannedBackend.__new__(PlannedBackend)  # routes need no plan
    rng = np.random.RandomState(cp)
    B, rp = 2, 8
    m = rng.rand(B, cp, cp) - 0.5
    diag = m @ m.transpose(0, 2, 1) + cp * np.eye(cp)
    below = rng.rand(B, rp, cp)
    L, x, Linv = be._factor_panels(jnp.asarray(diag), jnp.asarray(below),
                                   cp, jnp.float64)
    L = np.tril(np.asarray(L))
    Lw = np.linalg.cholesky(diag)
    assert np.max(np.abs(L - Lw)) < 1e-9 * cp
    x_want = np.linalg.solve(Lw, below.transpose(0, 2, 1)).transpose(0, 2, 1)
    assert np.max(np.abs(np.asarray(x) - x_want)) < 1e-9 * cp
    eye = np.broadcast_to(np.eye(cp), (B, cp, cp))
    assert np.max(np.abs(np.tril(np.asarray(Linv)) @ Lw - eye)) < 1e-9 * cp


@pytest.mark.parametrize("dtype,itemsize", [(np.float32, 4), (np.float64, 8)])
def test_panel_bytes_dense(dtype, itemsize):
    """A (cp+rp, cp) panel costs its dense bytes at the element size —
    no padding of small minor dimensions."""
    from baspacho_tpu.ops.planned_backend import PlannedBackend

    assert PlannedBackend._panel_bytes(64, 4, dtype) == 68 * 4 * itemsize
    assert PlannedBackend._panel_bytes(0, 512, dtype) == 512 * 512 * itemsize
    # plans charge float64: one plan serves f32 and f64 data
    assert PlannedBackend._panel_bytes(64, 4) == 68 * 4 * 8


def test_fuse_same_cp_charges_max_rp(monkeypatch):
    """Solve-side bucket fusion reads every member at the group's max rp:
    each fused group's B * panel_bytes(max rp) must respect the cap, and
    no member may be lost."""
    from baspacho_tpu.ops.planned_backend import LumpBucket, PlannedBackend

    solver, _ = build(3, n=20, fill=0.15, schur=240, elim_ranges=[0, 240],
                      psize=(3, 4))
    be = solver.backend
    cp = 4

    def bucket(B, rp):
        lb = LumpBucket(rp=rp, cp=cp, off=np.arange(B, dtype=np.int32),
                        rows=np.full(B, rp, np.int32),
                        cols=np.full(B, cp, np.int32),
                        vec_off=np.arange(B, dtype=np.int32),
                        below_idx=np.zeros((B, max(rp, 1)), np.int32))
        lb.members = np.arange(B)
        return lb

    # 10 panels at rp=8 (384 B each) then 2 at rp=24 (896 B each):
    # per-member accounting would fuse them (3840 + 1792 = 5632 B under
    # the cap), but the fused tensor is 12 panels at rp=24 = 10752 B
    small, wide = bucket(10, 8), bucket(2, 24)
    cap = 6000
    monkeypatch.setenv("BASPACHO_PANEL_BYTES_CAP", str(cap))
    fused = be._fuse_same_cp([small, wide])
    assert sum(len(f.off) for f in fused) == 12
    for f in fused:
        assert len(f.off) * be._panel_bytes(f.rp, cp) <= cap
    assert len(fused) == 2


def test_factor_solve_bitwise_repeatable_on_cpu(monkeypatch):
    """On the CPU the same data factors and solves to bitwise the same
    result, including block-pair scatter-add assembly (the GPU may use
    atomics there, so on the card only agreement within tolerance
    holds — see tests/test_gpu_device.py)."""
    monkeypatch.setenv("BASPACHO_FORCE_ASSEMBLY", "pairs")
    gen = SparseMatGenerator.gen_grid(20, 20, 0.25, seed=37)
    ss = gen.to_structure()
    solver = create_solver(Settings(backend=BackendType.PLANNED),
                           np.full(400, 3), ss)
    sched = solver.backend._factor_schedule(0, solver.skel.num_lumps)
    assert any(lev[1] for lev in sched), "pair assembly not hit"
    data = random_spd_data(solver.data_size, solver.order, 3)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    f1, f2 = np.asarray(solver.factor(data)), np.asarray(solver.factor(data))
    assert np.array_equal(f1, f2)
    rhs = np.random.RandomState(1).rand(solver.order, 2)
    assert np.array_equal(np.asarray(solver.solve(f1, rhs)),
                          np.asarray(solver.solve(f1, rhs)))


def test_empty_range_factor_and_solves_are_identity():
    """factor_from / solve_*_from at the last span cover no lumps: they
    return their input unchanged instead of building an empty bucket."""
    solver, data = build(0)
    n = solver.skel.num_spans
    f = np.asarray(solver.factor(data))
    np.testing.assert_array_equal(np.asarray(solver.factor_from(f, n)), f)
    rhs = np.random.RandomState(2).rand(solver.order, 1)
    np.testing.assert_array_equal(
        np.asarray(solver.solve_l_from(f, n, rhs)), rhs)
    np.testing.assert_array_equal(
        np.asarray(solver.solve_lt_from(f, n, rhs)), rhs)
