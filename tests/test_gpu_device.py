"""On-card accuracy slice (run on a GPU machine:
`python -m pytest -m gpu tests/test_gpu_device.py`).

The CPU suite asserts numerics under float64; this slice asserts the
float32 accuracy contract where the card's arithmetic actually runs:
factor, stored-inverse solve, partial factor/solve, block mat-vec,
batched solve, refinement to the float64 contract, and repeat agreement.
Float epsilons are the reference's (tests/FactorTest.cpp:30-41 uses
1e-7..4e-5 for float). Without a GPU every test skips."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

F32_TOL = 4e-5


@pytest.fixture(scope="module")
def gpu():
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {d.platform})")
    return d


def _build(gen, psize, elim=()):
    from baspacho_tpu import BackendType, Settings, create_solver
    from baspacho_tpu.testing import random_spd_data

    solver = create_solver(Settings(backend=BackendType.PLANNED),
                           np.asarray(psize), gen.to_structure(),
                           sparse_elim_ranges=list(elim))
    data = np.asarray(random_spd_data(solver.data_size, solver.order, 5,
                                      np.float32))
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5),
                      np.float32)
    return solver, data


def _schur(SG):
    gen = SG.gen_flat(40, 0.1, seed=11)
    gen.add_schur_set(500, 0.03)
    return gen, np.full(540, 2), (0, 500)


CASES = {
    "flat": lambda SG: (SG.gen_flat(40, 0.15, seed=3), np.full(40, 3), ()),
    "schur": _schur,
}


def _case(name):
    from baspacho_tpu.testing import SparseMatGenerator

    return _build(*CASES[name](SparseMatGenerator))


def _dense(solver, data):
    return solver.skel.densify(np.asarray(data, np.float64),
                               fill_upper_half=True)


def _factor_residual(solver, data, f):
    dense = _dense(solver, data)
    L = np.tril(solver.skel.densify(np.asarray(f, np.float64)))
    return np.abs(L @ L.T - dense).max() / np.abs(dense).max()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_solve_oracle_on_device(gpu, case):
    """Factor residual and stored-inverse solve vs the float64 host dense
    oracle."""
    solver, data = _case(case)
    f = solver.factor(data)
    assert np.all(np.isfinite(np.asarray(f)))
    rel = _factor_residual(solver, data, f)
    assert rel < F32_TOL, f"factor residual {rel:.3e}"

    rhs = np.random.RandomState(3).rand(solver.order, 2).astype(np.float32)
    x = solver.solve(f, rhs)
    want = np.linalg.solve(_dense(solver, data), rhs.astype(np.float64))
    assert _rel(x, want) < F32_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_partial_factor_solve_on_device(gpu, case):
    """factor_up_to + factor_from equals the full factor, and the partial
    L / Lt solves compose to the full solve."""
    solver, data = _case(case)
    nl = solver.skel.num_lumps
    t = int(solver.skel.lump_to_span[max(1, nl // 2)])
    full = solver.factor(data)
    part = solver.factor_from(solver.factor_up_to(data, t), t)
    assert _rel(part, full) < F32_TOL

    rhs = np.random.RandomState(4).rand(solver.order, 1).astype(np.float32)
    v = solver.solve_l_up_to(full, t, rhs)
    v = solver.solve_l_from(full, t, v)
    v = solver.solve_lt_from(full, t, v)
    x = solver.solve_lt_up_to(full, t, v)
    want = np.linalg.solve(_dense(solver, data), rhs.astype(np.float64))
    assert _rel(x, want) < F32_TOL


def test_add_mv_on_device(gpu):
    """out + alpha * M x on the bottom-right corner from a span."""
    solver, data = _case("schur")
    t = int(solver.skel.lump_to_span[solver.skel.num_lumps // 2])
    o = solver.span_vector_offset(t)
    rng = np.random.RandomState(6)
    x = rng.rand(solver.order, 2).astype(np.float32)
    out = rng.rand(solver.order, 2).astype(np.float32)
    got = solver.add_mv_from(data, t, x, out, 0.5)
    m = _dense(solver, data)
    want = out.astype(np.float64)
    want[o:] += 0.5 * (m[o:, o:] @ x[o:])
    assert _rel(got, want) < F32_TOL


def test_batched_factor_solve_on_device(gpu):
    """vmapped factor and solve: every matrix against the dense oracle
    (one instruction stream, N data streams — the reference batched
    contract, BatchedCudaFactorTest.cpp)."""
    import jax.numpy as jnp

    solver, data = _case("flat")
    datas = np.stack([data * np.float32(1.0 + 0.01 * b) for b in range(4)])
    rhs = np.random.RandomState(7).rand(4, solver.order, 1).astype(
        np.float32)
    fb = np.asarray(solver.factor(jnp.asarray(datas)))
    xb = np.asarray(solver.solve(fb, rhs))
    for b in range(4):
        assert _factor_residual(solver, datas[b], fb[b]) < F32_TOL, b
        want = np.linalg.solve(_dense(solver, datas[b]),
                               rhs[b].astype(np.float64))
        assert _rel(xb[b], want) < F32_TOL, b


def test_solve_refined_on_device(gpu):
    """A float32 factor refined against the float64 matrix on the card
    reaches the float64 contract."""
    import jax.numpy as jnp

    solver, data = _case("schur")
    f = solver.factor(data)
    d64 = jnp.asarray(data, jnp.float64)
    b = jnp.asarray(np.random.RandomState(8).rand(solver.order))
    x = solver.solve_refined(d64, f, b, iterations=3)
    r = b - solver.add_mv_from(d64, 0, x, jnp.zeros_like(x), 1.0)
    rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(b))
    assert rel <= 1e-10, rel


@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_repeat_on_device(gpu, case):
    """Factoring the same data twice agrees within the float contract.
    Not bitwise: on the GPU, XLA's scatter-add assembly may use atomics,
    and grid/meri factors measured on an H100 differ between two runs
    (see PERF.md); bitwise repeatability holds on the CPU only."""
    solver, data = _case(case)
    f1, f2 = solver.factor(data), solver.factor(data)
    assert _rel(f2, f1) < F32_TOL
    rhs = np.random.RandomState(9).rand(solver.order, 1).astype(np.float32)
    assert _rel(solver.solve(f1, rhs), solver.solve(f1, rhs)) < F32_TOL
