#!/usr/bin/env python
"""Smoke run of the main path on one NVIDIA GPU.

Drives the planned backend through the user entry points
(`create_solver`/`Solver`, `Optimizer`) at the benchmark's real sizes and
checks every result against an independent reference:

  A. oracle      flat1000 and meri7: factor residual and solve error
                 against the float64 dense oracle
  B. schur_full  FLAT n=1000 + 50,000 Schur landmarks (order 153,000):
                 factor, solve, residual via add_mv_from, and
                 solve_refined against the float64 matrix on the device
  C. batch       256 x flat200, vmapped factor and solve (each matrix
                 against the dense oracle) and jax.grad through
                 make_differentiable_solve against the dense f64 gradient
  D. ba          BAL bundle adjustment at the bal_full shape (871 cams,
                 527,480 landmarks): two LM iterations through
                 Optimizer.optimize, cost must decrease

Each phase prints one JSON line; the last line of a passing run is
`{"ok": true, "device": {...}}`. Any failed phase makes the exit code
non-zero. There is no CPU fallback: without a GPU the script exits 1.

  python chip_smoke.py               # phases A-D on one card
  python chip_smoke.py --four-cards  # sharded paths on 4 cards only
"""

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

# reference float epsilon (tests/FactorTest.cpp:30-41): bound on the
# relative factor residual and solve error of a float32 factorization
F32_TOL = 4e-5
# float64 accuracy contract reached by iterative refinement
REFINED_TOL = 1e-10
# gradient of |x|^2 through the differentiable solve: every entry is a
# product of two float32 solves (x and the adjoint y), each within F32_TOL
GRAD_TOL = 2 * F32_TOL
# sharded vs single-card results: both are float32 factorizations within
# the float contract, summed in another order across cards
SHARD_TOL = F32_TOL
# sharded vs single-card solve: the sharded solve sums each level's RHS
# updates by scatter-add (the single-card one by matmuls against W), so
# its float32 rounding grows with the updates per row: 1.1e-5 at order
# 18,000 and 2.0e-5 at order 63,000 (4-device CPU mesh)
SHARD_SOLVE_TOL = 1e-4


def read_card():
    """`name, power.limit` of each card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        sys.exit(f"chip_smoke: cannot read the card with nvidia-smi: {e}")
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        sys.exit("chip_smoke: nvidia-smi found no card "
                 f"(rc {out.returncode}): {out.stderr.strip()}")
    return lines


def timed(fn):
    """(result, wall seconds) of fn() run to completion on the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def cold_warm(fn):
    """First call (compile + run) and second call (run) wall times."""
    out, cold = timed(fn)
    out, warm = timed(fn)
    return out, cold, warm


def rel_max(a, b):
    """max|a - b| / max|b| in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def spd_data(solver, seed):
    """float32 factor-layout data of a diagonally damped SPD matrix."""
    from baspacho_tpu.testing import random_spd_data

    data = random_spd_data(solver.data_size, solver.order, seed, np.float32)
    return np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5),
                      np.float32)


def planned_solver(psize, ss, elim):
    from baspacho_tpu import BackendType, Settings, create_solver

    t0 = time.perf_counter()
    solver = create_solver(Settings(backend=BackendType.PLANNED),
                           psize, ss, sparse_elim_ranges=list(elim))
    return solver, time.perf_counter() - t0


def dense_checks(solver, data, f, x, rhs):
    """Factor residual max|LL^T - A| / max|A| and solve error against
    numpy.linalg.solve, both in float64 on the host."""
    dense = solver.skel.densify(data.astype(np.float64), fill_upper_half=True)
    L = np.tril(solver.skel.densify(np.asarray(f, np.float64)))
    resid = float(np.abs(L @ L.T - dense).max() / np.abs(dense).max())
    want = np.linalg.solve(dense, np.asarray(rhs, np.float64))
    return resid, rel_max(x, want)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_oracle(problems):
    """A: factor + solve of each (name, gen, psize, elim) vs the dense
    oracle."""
    import jax.numpy as jnp

    out = {"problems": {}}
    ok = True
    for name, gen, psize, elim in problems:
        solver, t_sym = planned_solver(psize, gen.to_structure(), elim)
        data = spd_data(solver, 1)
        jd = jnp.asarray(data)
        f, f_cold, f_warm = cold_warm(lambda: solver.factor(jd))
        rhs = np.random.RandomState(0).rand(solver.order, 1).astype(
            np.float32)
        jr = jnp.asarray(rhs)
        x, s_cold, s_warm = cold_warm(lambda: solver.solve(f, jr))
        resid, err = dense_checks(solver, data, f, x, rhs)
        good = resid <= F32_TOL and err <= F32_TOL
        ok &= good
        out["problems"][name] = {
            "order": solver.order, "lumps": solver.skel.num_lumps,
            "levels": solver.backend.num_levels,
            "factor_residual": resid, "solve_error": err,
            "tol": F32_TOL, "ok": good, "symbolic_s": t_sym,
            "factor_s": {"cold": f_cold, "warm": f_warm},
            "solve_s": {"cold": s_cold, "warm": s_warm}}
    out["ok"] = ok
    return out


def phase_schur(gen, psize, elim):
    """B: factor + solve of one large Schur system; residual via
    add_mv_from, then solve_refined against the float64 matrix."""
    import jax.numpy as jnp

    solver, t_sym = planned_solver(psize, gen.to_structure(), elim)
    data = spd_data(solver, 1)
    jd = jnp.asarray(data)
    f, f_cold, f_warm = cold_warm(lambda: solver.factor(jd))
    factor_ok = solver.check_factor(f)
    b = np.random.RandomState(0).rand(solver.order).astype(np.float64)
    jb32 = jnp.asarray(b, jnp.float32)
    x, s_cold, s_warm = cold_warm(lambda: solver.solve(f, jb32))

    d64 = jnp.asarray(data, jnp.float64)
    b64 = jnp.asarray(b)

    def residual(x):
        x = jnp.asarray(x, jnp.float64)
        r = b64 - solver.add_mv_from(d64, 0, x, jnp.zeros_like(x), 1.0)
        return float(jnp.linalg.norm(r) / jnp.linalg.norm(b64))

    resid = residual(x)
    refined = {}
    xr = None
    for iters in (2, 3, 4, 5):
        xr, t_ref = timed(lambda: solver.solve_refined(d64, f, b64, iters))
        refined = {"iterations": iters, "residual": residual(xr),
                   "wall_s": t_ref}
        if refined["residual"] <= REFINED_TOL:
            break
    ok = bool(factor_ok and np.all(np.isfinite(np.asarray(x)))
              and refined["residual"] <= REFINED_TOL)
    return {"order": solver.order, "lumps": solver.skel.num_lumps,
            "levels": solver.backend.num_levels, "symbolic_s": t_sym,
            "factor_finite_positive_diag": factor_ok,
            "solve_relative_residual": resid,
            "refined": refined, "refined_tol": REFINED_TOL,
            "refined_dtype": str(xr.dtype),
            "factor_s": {"cold": f_cold, "warm": f_warm},
            "solve_s": {"cold": s_cold, "warm": s_warm}, "ok": ok}


def phase_batch(gen, psize, batch):
    """C: vmapped factor + solve of `batch` same-structure matrices, each
    against the dense oracle; jax.grad through the differentiable solve
    against the dense float64 gradient."""
    import jax
    import jax.numpy as jnp

    solver, t_sym = planned_solver(psize, gen.to_structure(), [])
    base = [spd_data(solver, s) for s in range(4)]
    datas = np.stack([base[b % 4] * np.float32(1.0 + 1e-3 * b)
                      for b in range(batch)])
    rhs = np.random.RandomState(0).rand(batch, solver.order, 1).astype(
        np.float32)
    jd, jr = jnp.asarray(datas), jnp.asarray(rhs)
    fb, f_cold, f_warm = cold_warm(lambda: solver.factor(jd))
    xb, s_cold, s_warm = cold_warm(lambda: solver.solve(fb, jr))
    fb, xb = np.asarray(fb), np.asarray(xb)
    worst_resid = worst_err = 0.0
    for b in range(batch):
        resid, err = dense_checks(solver, datas[b], fb[b], xb[b], rhs[b])
        worst_resid = max(worst_resid, resid)
        worst_err = max(worst_err, err)

    # gradient of |x|^2, x = H^-1 g, w.r.t. the stored lower-half data
    fsolve = solver.make_differentiable_solve()
    h0, g0 = jnp.asarray(datas[0]), jnp.asarray(rhs[0, :, 0])
    grad_fn = jax.grad(lambda h, g: jnp.sum(fsolve(h, g) ** 2),
                       argnums=(0, 1))
    (gh, gg), g_cold, g_warm = cold_warm(lambda: grad_fn(h0, g0))
    dense = solver.skel.densify(datas[0].astype(np.float64),
                                fill_upper_half=True)
    x = np.linalg.solve(dense, rhs[0, :, 0].astype(np.float64))
    y = np.linalg.solve(dense, 2.0 * x)      # adjoint: H y = dL/dx
    G = -np.outer(y, x)                       # dL/dH (dense)
    ri, ci = solver.skel.data_coords()
    real = ri < solver.order
    want_h = np.zeros(solver.data_size)
    r, c = ri[real], ci[real]
    # a stored off-diagonal slot stands for H[r, c] and H[c, r]
    want_h[real] = np.where(r == c, G[r, c], G[r, c] + G[c, r])
    grad_err = max(rel_max(gh, want_h), rel_max(gg, y))
    ok = (worst_resid <= F32_TOL and worst_err <= F32_TOL
          and grad_err <= GRAD_TOL)
    return {"batch": batch, "order": solver.order,
            "lumps": solver.skel.num_lumps, "symbolic_s": t_sym,
            "worst_factor_residual": worst_resid,
            "worst_solve_error": worst_err, "tol": F32_TOL,
            "grad_error": grad_err, "grad_tol": GRAD_TOL,
            "factor_s": {"cold": f_cold, "warm": f_warm},
            "solve_s": {"cold": s_cold, "warm": s_warm},
            "grad_s": {"cold": g_cold, "warm": g_warm}, "ok": ok}


def phase_ba(n_cams, n_pts):
    """D: BAL bundle adjustment at the given shape: first LM step's solve
    residual, then two LM iterations through Optimizer.optimize."""
    import jax.numpy as jnp

    from baspacho_tpu import BackendType, native
    from baspacho_tpu.bal import build_ba_optimizer, make_random_bal
    from baspacho_tpu.optimizer import OptimizerSettings

    t0 = time.perf_counter()
    prob = make_random_bal(n_cams, n_pts, track_len=5, track_mode="window",
                           window=24, loop_frac=0.03, noise=1.0, seed=1)
    opt, _, _ = build_ba_optimizer(prob)
    for fam in opt.families:
        fam.values = fam.values.astype(jnp.float32)
    t_gen = time.perf_counter() - t0
    settings = OptimizerSettings(max_iters=2, backend=BackendType.PLANNED)
    t0 = time.perf_counter()
    solver = opt.build_solver(settings)
    t_sym = time.perf_counter() - t0

    values = [f.values for f in opt.families]
    (cost, grad, hdata), gh_cold, gh_warm = cold_warm(
        lambda: opt.compute_grad_hess(values))
    # the first LM trial's damping, as Optimizer.optimize applies it
    lam = settings.init_damping
    damped = solver.skel.damp(hdata, lam, lam)
    f, f_cold, f_warm = cold_warm(lambda: solver.factor(damped))
    x, s_cold, s_warm = cold_warm(lambda: solver.solve(f, -grad))
    r = solver.add_mv_from(damped, 0, x, jnp.zeros_like(x), 1.0) + grad
    step_resid = float(jnp.linalg.norm(r) / jnp.linalg.norm(grad))

    stats, t_opt = timed(lambda: opt.optimize(settings))
    costs = [float(c) for c in stats["costs"]]
    ok = bool(stats["iters"] >= 1 and costs[-1] < costs[0]
              and np.isfinite(step_resid))
    return {"cams": prob.num_cameras, "points": prob.num_points,
            "observations": prob.num_observations, "order": solver.order,
            "lumps": solver.skel.num_lumps,
            "levels": solver.backend.num_levels,
            "native_symbolic_loaded": native.available(),
            "problem_s": t_gen, "symbolic_s": t_sym,
            "grad_hess_s": {"cold": gh_cold, "warm": gh_warm},
            "factor_s": {"cold": f_cold, "warm": f_warm},
            "solve_s": {"cold": s_cold, "warm": s_warm},
            "first_step_solve_residual": step_resid,
            "lm_iters": stats["iters"], "costs": costs,
            "optimize_s": t_opt, "ok": ok}


def phase_four_cards(devices, batch_case, schur_case):
    """Data-parallel batched factor + solve and model-parallel
    factor_sharded/solve_sharded on `devices`, each against the
    single-card result; per-card peak memory of the sharded runs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from baspacho_tpu.utils import with_matmul_precision

    # batch sharded over the cards (one plan, N data streams)
    gen, psize, batch = batch_case
    bsolver, _ = planned_solver(psize, gen.to_structure(), [])
    base = [spd_data(bsolver, s) for s in range(4)]
    datas = np.stack([base[b % 4] * np.float32(1.0 + 1e-3 * b)
                      for b in range(batch)])
    rhs = np.random.RandomState(0).rand(batch, bsolver.order, 1).astype(
        np.float32)
    n = bsolver.skel.num_lumps
    factor_fn, aux_f = bsolver.backend.make_factor(0, n)
    solve_fn, aux_s = bsolver.backend.make_solve(0, n)
    aux_f = tuple(jnp.asarray(a) for a in aux_f)
    aux_s = tuple(jnp.asarray(a) for a in aux_s)

    def one(d, r):
        f = factor_fn(d, aux_f)
        return f, solve_fn(f, r, aux_s)

    mesh = Mesh(np.array(devices), axis_names=("dp",))
    dsh = NamedSharding(mesh, P("dp"))
    step = jax.jit(with_matmul_precision(jax.vmap(one)),
                   in_shardings=(dsh, dsh), out_shardings=(dsh, dsh))
    (f_dp, x_dp), dp_cold, dp_warm = cold_warm(
        lambda: step(jax.device_put(datas, dsh), jax.device_put(rhs, dsh)))
    dp_devices = sorted({s.device.id for s in f_dp.addressable_shards})

    # one factorization and one solve split across the cards
    sgen, spsize, selim = schur_case
    solver, _ = planned_solver(spsize, sgen.to_structure(), selim)
    data = spd_data(solver, 1)
    b = np.random.RandomState(0).rand(solver.order, 1).astype(np.float32)
    shmesh = Mesh(np.array(devices), axis_names=("shard",))
    f_sh, fs_cold, fs_warm = cold_warm(
        lambda: solver.factor_sharded(data, shmesh))
    x_sh, ss_cold, ss_warm = cold_warm(
        lambda: solver.solve_sharded(f_sh, b, shmesh))
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devices]

    # single-card references (after the peaks are read: they land on
    # the first card)
    with jax.default_device(devices[0]):
        f_1 = bsolver.factor(jnp.asarray(datas))
        x_1 = bsolver.solve(f_1, jnp.asarray(rhs))
        sf_1 = solver.factor(jnp.asarray(data))
        sx_1 = solver.solve(sf_1, jnp.asarray(b))
    errs = {"dp_factor": rel_max(f_dp, f_1), "dp_solve": rel_max(x_dp, x_1),
            "sharded_factor": rel_max(f_sh, sf_1),
            "sharded_solve": rel_max(x_sh, sx_1)}
    tols = {"dp_factor": SHARD_TOL, "dp_solve": SHARD_TOL,
            "sharded_factor": SHARD_TOL, "sharded_solve": SHARD_SOLVE_TOL}
    spread = min(peaks) / max(max(peaks), 1)
    ok = (all(errs[k] <= tols[k] for k in errs)
          and len(dp_devices) == len(devices) and spread >= 0.25)
    return {"cards": len(devices), "batch": batch,
            "schur_order": solver.order, "errors_vs_one_card": errs,
            "tol": tols, "dp_shard_devices": dp_devices,
            "peak_bytes_in_use": peaks, "min_over_max_peak": spread,
            "dp_s": {"cold": dp_cold, "warm": dp_warm},
            "factor_sharded_s": {"cold": fs_cold, "warm": fs_warm},
            "solve_sharded_s": {"cold": ss_cold, "warm": ss_warm},
            "ok": ok}


# ----------------------------------------------------------------------
# problems (bench.py's families at their benchmark sizes)
# ----------------------------------------------------------------------
def oracle_problems():
    from bench import synthetic_problems

    probs = synthetic_problems()
    out = []
    for name in ("flat1000", "meri"):
        gen, psize, elim, _, _ = probs[name]()
        out.append((name, gen, psize, elim))
    return out


def schur_full_problem():
    from bench import synthetic_problems

    gen, psize, elim, _, _ = synthetic_problems()["flat_schur_full"]()
    return gen, psize, elim


def run_phase(name, fn, card, precision):
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception as e:  # report the phase as failed, keep going
        traceback.print_exc()
        res = {"ok": False, "error": repr(e)}
    line = {"phase": name, "card": card, **precision, **res,
            "phase_s": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    return bool(res.get("ok"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded checks on 4 cards")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {devices[0]}")
    cards = read_card()
    for ln in cards:
        print(ln, flush=True)
    card = {"name": cards[0].split(",")[0].strip(),
            "power_limit": cards[0].split(",")[-1].strip()}

    from baspacho_tpu import Settings
    from baspacho_tpu.utils import enable_compile_cache

    enable_compile_cache()
    s = Settings()
    precision = {"matmul_precision": s.matmul_precision,
                 "update_precision": s.update_precision or
                 s.matmul_precision}

    from bench import batch_problem

    if args.four_cards:
        if len(devices) < 4:
            sys.exit(f"chip_smoke: --four-cards needs 4 GPUs, found "
                     f"{len(devices)}")
        phases = [("four_cards", lambda: phase_four_cards(
            devices[:4], batch_problem(), schur_full_problem()))]
    else:
        phases = [
            ("oracle", lambda: phase_oracle(oracle_problems())),
            ("schur_full", lambda: phase_schur(*schur_full_problem())),
            ("batch", lambda: phase_batch(*batch_problem())),
            ("ba", lambda: phase_ba(871, 527480)),
        ]
    t0 = time.perf_counter()
    ok = all([run_phase(name, fn, card, precision) for name, fn in phases])
    print(f"chip_smoke: {'passed' if ok else 'FAILED'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        sys.exit(1)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
