"""Stats/profiling subsystem tests: OpStat counters, per-op profiling of
the planned schedule, and computation-model fitting round trip."""

import numpy as np

from baspacho_tpu import BackendType, Settings, create_solver
from baspacho_tpu.computation_model import ComputationModel
from baspacho_tpu.stats import fit_computation_model, profile_factor
from baspacho_tpu.testing import SparseMatGenerator, random_spd_data


def make(n=30, fill=0.1, seed=0, backend=BackendType.PLANNED):
    gen = SparseMatGenerator.gen_flat(n, fill, seed=seed)
    ss = gen.to_structure()
    solver = create_solver(Settings(backend=backend), np.full(n, 2), ss)
    data = random_spd_data(solver.data_size, solver.order, seed)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    return solver, data


def test_solver_stats_collect():
    solver, data = make()
    solver.enable_stats()
    f = solver.factor(data)
    rhs = np.random.RandomState(0).rand(solver.order)
    solver.solve(f, rhs)
    assert solver.stats.factor.num_runs == 1
    assert solver.stats.solve_l.num_runs == 1
    assert solver.stats.factor.total_time > 0
    solver.reset_stats()
    assert solver.stats.factor.num_runs == 0
    solver.print_stats()


def test_profile_and_fit():
    import os

    # force the pair-scatter assembly mode: syge samples only exist on
    # pair levels (dense W-mode levels time the product as dense_upd)
    os.environ["BASPACHO_FORCE_ASSEMBLY"] = "pairs"
    try:
        solver, data = make(n=150, fill=0.03, seed=1)
        assert solver.skel.num_lumps > 1
        records = profile_factor(solver, data, reps=1)
    finally:
        os.environ.pop("BASPACHO_FORCE_ASSEMBLY", None)
    ops = {r[0] for r in records}
    assert "potrf" in ops and "trsm" in ops and "syge" in ops
    cm = fit_computation_model(records)
    assert isinstance(cm, ComputationModel)
    # fitted model must produce finite positive-ish estimates
    assert np.isfinite(cm.potrf_est(64.0))
    assert np.isfinite(cm.syge_est(32, 32, 16))


def test_profile_solve_stages():
    solver, data = make(n=80, fill=0.06, seed=2)
    f = solver.factor(data)
    rhs = np.random.RandomState(1).rand(solver.order)
    records = solver.profile_solve_ops(f, rhs, reps=1)
    ops = {r[0] for r in records}
    assert "solveL" in ops and "solveLt" in ops
    # per-stage stats land in print_stats (MatOps.h:84-101 parity)
    assert solver.stats.solve_diag_l.num_runs > 0
    assert solver.stats.solve_diag_lt.num_runs > 0
    solver.print_stats()


def test_profile_factor_dense_level_correct():
    """Profiling a problem with a dense-update level must replay it with
    real semantics: the replayed data after profiling equals factor(data)
    (dense levels must not be skipped on replay)."""
    import jax.numpy as jnp

    import os

    gen = SparseMatGenerator.gen_flat(40, 0.1, seed=5)
    gen.add_schur_set(400, 0.03)
    ss = gen.to_structure()
    os.environ["BASPACHO_FORCE_ASSEMBLY"] = "dense"
    try:
        solver = create_solver(Settings(backend=BackendType.PLANNED),
                               np.full(440, 2), ss,
                               sparse_elim_ranges=[0, 400])
        dense_levels = [lev for lev in solver.backend._factor_schedule(
            0, solver.skel.num_lumps) if lev[3] is not None]
    finally:
        os.environ.pop("BASPACHO_FORCE_ASSEMBLY", None)
    assert dense_levels, "test problem must trigger the dense-update path"
    data = random_spd_data(solver.data_size, solver.order, 7)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    records = profile_factor(solver, data, reps=1)
    assert any(r[0] == "dense_upd" for r in records)
    # reconstruct: replaying every level must reproduce the factor
    import jax
    be = solver.backend
    sched = be._factor_schedule(0, solver.skel.num_lumps)
    aux = []
    max_win = 2
    for lev in sched:
        max_win = max(max_win, be._register_factor_level(lev, aux))
    aux = tuple(jnp.asarray(a) for a in aux)
    mask = solver.skel.padding_mask()
    d = jnp.asarray(data) * jnp.asarray(mask).astype(jnp.asarray(data).dtype)
    ext = jnp.concatenate([d, jnp.zeros(max_win, d.dtype)])
    for lev in sched:
        ext = jax.jit(lambda e, lev=lev: be._run_factor_level(
            e, lev, aux))(ext)
    replayed = np.asarray(ext[:solver.data_size])
    expect = np.asarray(solver.factor(data))
    np.testing.assert_allclose(replayed, expect, rtol=1e-10, atol=1e-12)


def test_custom_computation_model_used():
    # a model with huge assembly cost must merge more aggressively
    gen = SparseMatGenerator.gen_flat(40, 0.08, seed=3)
    ss = gen.to_structure()
    cheap_asmbl = ComputationModel(
        potrf_params=[0, 0, 0, 1e-9], trsm_params=[0, 0, 0, 0, 0, 1e-9],
        syge_params=[0, 0, 0, 0, 0, 1e-9], asmbl_params=[1e-12, 0, 0, 0])
    costly_asmbl = ComputationModel(
        potrf_params=[0, 0, 0, 1e-9], trsm_params=[0, 0, 0, 0, 0, 1e-9],
        syge_params=[0, 0, 0, 0, 0, 1e-9], asmbl_params=[1e-2, 0, 0, 0])
    s1 = create_solver(Settings(computation_model=cheap_asmbl),
                       np.full(40, 2), ss)
    s2 = create_solver(Settings(computation_model=costly_asmbl),
                       np.full(40, 2), ss)
    assert s2.skel.num_lumps <= s1.skel.num_lumps
