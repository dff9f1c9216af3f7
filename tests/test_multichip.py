"""Multi-device sharding tests on the 8-virtual-CPU mesh (conftest sets
xla_force_host_platform_device_count=8).

The multi-chip contract: batched factor+solve data-parallel over a
jax.sharding.Mesh must produce per-shard results identical to the
unsharded vmap (one instruction stream, N data streams — the reference's
batched CUDA mode, Solver.cpp:459, lifted to a device mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from baspacho_tpu import BackendType, Settings, create_solver
from baspacho_tpu.testing import SparseMatGenerator, random_spd_data


def _build(n=16, fill=0.25, seed=3, backend=BackendType.PLANNED):
    gen = SparseMatGenerator.gen_flat(n, fill, seed=seed)
    ss = gen.to_structure()
    rng = np.random.RandomState(seed)
    psize = rng.randint(1, 4, size=n)
    solver = create_solver(Settings(backend=backend), psize, ss)
    data = np.asarray(random_spd_data(solver.data_size, solver.order, seed))
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    return solver, data


@pytest.mark.parametrize("backend",
                         [BackendType.PLANNED, BackendType.REF])
def test_dp_sharded_factor_solve_matches_vmap(backend):
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    solver, data = _build(backend=backend)
    batch = 16
    datas = np.stack([data * (1.0 + 0.01 * b) for b in range(batch)])
    rhs = np.random.RandomState(0).rand(batch, solver.order, 2)

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("dp",))
    dsh = NamedSharding(mesh, P("dp"))

    factor_fn, aux_f = solver.backend.make_factor(0, solver.skel.num_lumps)
    solve_l, aux_l = solver.backend.make_solve_l(0, solver.skel.num_lumps)
    solve_lt, aux_t = solver.backend.make_solve_lt(0, solver.skel.num_lumps)
    aux_f = tuple(jnp.asarray(a) for a in aux_f)
    aux_l = tuple(jnp.asarray(a) for a in aux_l)
    aux_t = tuple(jnp.asarray(a) for a in aux_t)

    def one(d, r):
        f = factor_fn(d, aux_f)
        return f, solve_lt(f, solve_l(f, r, aux_l), aux_t)

    sharded = jax.jit(jax.vmap(one), in_shardings=(dsh, dsh),
                      out_shardings=(dsh, dsh))
    f_sh, x_sh = sharded(jax.device_put(datas, dsh),
                         jax.device_put(rhs, dsh))
    # each output is sharded over dp
    assert len(f_sh.sharding.device_set) == 8
    assert len(x_sh.sharding.device_set) == 8

    plain = jax.jit(jax.vmap(one))
    f_ref, x_ref = plain(jnp.asarray(datas), jnp.asarray(rhs))
    # bit-identical per shard: the sharded program runs the same XLA
    # computation per device as the single-device vmap
    np.testing.assert_array_equal(np.asarray(f_sh), np.asarray(f_ref))
    np.testing.assert_array_equal(np.asarray(x_sh), np.asarray(x_ref))

    # and numerics are right: L L^T == damped input per batch element
    for b in (0, batch - 1):
        L = np.tril(solver.skel.densify(np.asarray(f_sh[b])))
        dense = solver.skel.densify(datas[b], fill_upper_half=True)
        assert np.max(np.abs(L @ L.T - dense)) < 1e-9


def test_graft_dryrun_impl_runs_inline():
    """The dryrun body itself must execute on this 8-device CPU mesh."""
    import __graft_entry__ as g
    g._dryrun_impl(8)


def _sharded_case(gen, psize, elim=()):
    ss = gen.to_structure()
    solver = create_solver(Settings(backend=BackendType.PLANNED),
                           np.asarray(psize), ss,
                           sparse_elim_ranges=list(elim))
    data = np.asarray(random_spd_data(solver.data_size, solver.order, 5))
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5))
    return solver, data


@pytest.mark.parametrize("case", ["flat_w", "schur_oh", "grid_pairs"])
def test_single_factor_sharded_over_mesh(case, monkeypatch):
    """ONE factorization sharded across 8 devices (per-level panel work
    split, all_gather + psum coupling) must match the single-device
    factor to reduction-order tolerance. Covers all three level-update
    mechanisms: scatter-built W, chunked one-hot, block pairs. The plan
    is built at the first factor, so the forcing variables stay set
    until the factors are done."""
    assert len(jax.devices()) >= 8
    if case == "flat_w":
        solver, data = _sharded_case(
            SparseMatGenerator.gen_flat(150, 0.1, seed=4), np.full(150, 3))
    elif case == "schur_oh":
        gen = SparseMatGenerator.gen_flat(40, 0.1, seed=6)
        gen.add_schur_set(500, 0.03)
        monkeypatch.setenv("BASPACHO_FORCE_DENSE_MODE", "oh")
        solver, data = _sharded_case(gen, np.full(540, 2), elim=[0, 500])
    else:  # grid: pairs-mode levels
        monkeypatch.setenv("BASPACHO_FORCE_ASSEMBLY", "pairs")
        solver, data = _sharded_case(
            SparseMatGenerator.gen_grid(10, 10, 0.3, seed=7),
            np.full(100, 3))

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("shard",))
    f_sh = np.asarray(solver.factor_sharded(data, mesh))
    f_ref = np.asarray(solver.factor(data))
    np.testing.assert_allclose(f_sh, f_ref, rtol=1e-9, atol=1e-11)
    # numerics: L L^T == damped input
    L = np.tril(solver.skel.densify(f_sh))
    dense = solver.skel.densify(data, fill_upper_half=True)
    assert np.max(np.abs(L @ L.T - dense)) / np.abs(dense).max() < 1e-9


@pytest.mark.parametrize("case", ["flat", "schur"])
def test_single_solve_sharded_over_mesh(case):
    """ONE solve sharded across 8 devices (per-level bucket split, one
    psum of the RHS delta per level) must match the single-device solve
    to reduction-order tolerance."""
    assert len(jax.devices()) >= 8
    if case == "flat":
        solver, data = _sharded_case(
            SparseMatGenerator.gen_flat(150, 0.1, seed=9), np.full(150, 3))
    else:
        gen = SparseMatGenerator.gen_flat(40, 0.1, seed=11)
        gen.add_schur_set(500, 0.03)
        solver, data = _sharded_case(gen, np.full(540, 2), elim=[0, 500])

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("shard",))
    f = solver.factor(data)
    rhs = np.random.RandomState(3).rand(solver.order, 2)
    got = np.asarray(solver.solve_sharded(f, rhs, mesh))
    want = np.asarray(solver.solve(f, rhs))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)
    # 1-d rhs path + correctness vs dense oracle
    got1 = np.asarray(solver.solve_sharded(f, rhs[:, 0], mesh))
    dense = solver.skel.densify(np.asarray(data), fill_upper_half=True)
    want1 = np.linalg.solve(dense, rhs[:, 0])
    assert np.abs(got1 - want1).max() < 1e-8
