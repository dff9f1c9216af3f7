"""BAL bundle adjustment tests: projection model, file round-trip, and
LM convergence with Schur-eliminated points (reference
OptimizeBaAtLarge.cpp / BaAtLargeBench.cpp scenario)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from baspacho_tpu.bal import (BalProblem, build_ba_optimizer, load_bal,
                              make_random_bal, rodrigues_rotate, save_bal,
                              snavely_project)
from baspacho_tpu.optimizer import OptimizerSettings, BlockJacobiPrecond


def test_rodrigues_vs_matrix():
    rng = np.random.RandomState(0)
    for _ in range(5):
        r = rng.randn(3)
        x = rng.randn(3)
        theta = np.linalg.norm(r)
        k = r / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                      [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
        got = np.asarray(rodrigues_rotate(jnp.asarray(r), jnp.asarray(x)))
        assert np.max(np.abs(got - R @ x)) < 1e-12


def test_bal_roundtrip(tmp_path):
    p = make_random_bal(n_cams=3, n_pts=10, seed=1)
    path = os.path.join(tmp_path, "prob.txt")
    save_bal(path, p)
    q = load_bal(path)
    assert np.allclose(p.cameras, q.cameras)
    assert np.allclose(p.points, q.points)
    assert np.array_equal(p.obs_cam, q.obs_cam)
    assert np.allclose(p.obs_uv, q.obs_uv)


def test_ba_converges_from_noisy_init():
    prob = make_random_bal(n_cams=5, n_pts=60, track_len=4, seed=2)
    noisy = BalProblem(
        prob.cameras + np.random.RandomState(3).randn(*prob.cameras.shape)
        * np.array([1e-3, 1e-3, 1e-3, 1e-2, 1e-2, 1e-2, 0, 0, 0]),
        prob.points + np.random.RandomState(4).randn(*prob.points.shape)
        * 0.02,
        prob.obs_cam, prob.obs_pt, prob.obs_uv)
    opt, pts, cams = build_ba_optimizer(noisy)
    opt.build_solver(OptimizerSettings())
    assert opt.solver.sparse_elim_ranges[:2] == [0, 60]
    stats = opt.optimize(OptimizerSettings(max_iters=20))
    assert stats["final_cost"] < 1e-9


def test_ba_pcg_path_converges():
    prob = make_random_bal(n_cams=5, n_pts=60, track_len=4, seed=5)
    noisy = BalProblem(
        prob.cameras.copy(),
        prob.points + np.random.RandomState(6).randn(*prob.points.shape)
        * 0.02,
        prob.obs_cam, prob.obs_pt, prob.obs_uv)
    opt, _, _ = build_ba_optimizer(noisy)
    stats = opt.optimize(OptimizerSettings(
        max_iters=15, use_pcg=True, precond=BlockJacobiPrecond,
        pcg_tol=1e-10, pcg_max_iters=80))
    assert stats["final_cost"] < 1e-8


def test_ba_grad_hess_f32_has_no_mixed_dtype_dots():
    """float32 variables with float64 constants (observations): every dot
    of the Hessian assembly must take operands of its result dtype — the
    GPU refuses a GEMM with f64 operands and an f32 result."""
    import jax

    from baspacho_tpu import BackendType

    prob = make_random_bal(n_cams=4, n_pts=40, track_len=3, seed=2)
    opt, _, _ = build_ba_optimizer(prob)
    for fam in opt.families:
        fam.values = fam.values.astype(jnp.float32)
    opt.build_solver(OptimizerSettings(backend=BackendType.PLANNED))
    values = [f.values for f in opt.families]
    cost, grad, hdata = opt.compute_grad_hess(values)
    assert grad.dtype == jnp.float32 and hdata.dtype == jnp.float32

    jaxpr = jax.make_jaxpr(
        lambda v: opt._grad_hess_impl(v, opt._gather_aux(), "float32"))(
            values)

    def dots(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from dots(sub)

    found = list(dots(jaxpr.jaxpr))
    assert found
    for eqn in found:
        out = eqn.outvars[0].aval.dtype
        assert all(v.aval.dtype == out for v in eqn.invars), eqn
