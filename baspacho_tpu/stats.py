"""Per-op timing stats and profiling (the reference's OpStat subsystem).

The reference wraps every backend op in an RAII timer (MatOps.h:84-101,
Utils.h:49-121) and can dump per-op (shape, time) records that the
`opt_comp_model` tool fits into a ComputationModel — closing the
auto-tuning loop that calibrates the supernode-merge heuristic.

Under XLA everything fuses into one program, so fine-grained timing needs
a dedicated profiling mode: `profile_factor` re-runs the factor schedule
as separate jitted pieces with device sync between them, recording
(op, shape, seconds) samples. `fit_computation_model` least-squares fits
the polynomial models from such samples (tools/fit_computation_model.py
is the CLI). Coarse stats (whole factor/solve calls) are always cheap to
collect via Solver.enable_stats().
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .computation_model import ComputationModel
from .utils import OpStat


@dataclass
class SolverStats:
    factor: OpStat = field(default_factory=OpStat)
    solve_l: OpStat = field(default_factory=OpStat)
    solve_lt: OpStat = field(default_factory=OpStat)
    add_mv: OpStat = field(default_factory=OpStat)
    # per-op categories (reference MatOps.h:84-101 keeps potrf/trsm/syge/
    # asmbl OpStats on the symbolic ctx); under XLA whole calls fuse, so
    # these are populated by the profiling mode (Solver.profile_ops)
    potrf: OpStat = field(default_factory=OpStat)
    trsm: OpStat = field(default_factory=OpStat)
    syge: OpStat = field(default_factory=OpStat)
    asmbl: OpStat = field(default_factory=OpStat)
    # per-stage solve stats (reference MatOps.h:84-101 keeps 8 solve-stage
    # OpStats: sparse-elim L/Lt, diag solve L/Lt, gemv/gemvT, vector
    # assemble/assembleT); populated by Solver.profile_solve_ops
    sparse_elim_solve_l: OpStat = field(default_factory=OpStat)
    sparse_elim_solve_lt: OpStat = field(default_factory=OpStat)
    solve_diag_l: OpStat = field(default_factory=OpStat)
    solve_diag_lt: OpStat = field(default_factory=OpStat)
    gemv: OpStat = field(default_factory=OpStat)
    gemv_t: OpStat = field(default_factory=OpStat)
    assemble_vec: OpStat = field(default_factory=OpStat)
    assemble_vec_t: OpStat = field(default_factory=OpStat)

    def _all(self):
        return (self.factor, self.solve_l, self.solve_lt, self.add_mv,
                self.potrf, self.trsm, self.syge, self.asmbl,
                self.sparse_elim_solve_l, self.sparse_elim_solve_lt,
                self.solve_diag_l, self.solve_diag_lt, self.gemv,
                self.gemv_t, self.assemble_vec, self.assemble_vec_t)

    def enable(self, enabled: bool = True):
        for s in self._all():
            s.enabled = enabled

    def reset(self):
        for s in self._all():
            s.reset()

    def record_profile(self, records) -> None:
        """Aggregate per-op profile records (see profile_factor /
        profile_solve) into the per-op OpStat counters — the reference's
        printStats layout."""
        by = {"potrf": self.potrf, "trsm": self.trsm, "syge": self.syge,
              "asmbl": self.asmbl,
              "sparseElimSolveL": self.sparse_elim_solve_l,
              "sparseElimSolveLt": self.sparse_elim_solve_lt,
              "solveL": self.solve_diag_l, "solveLt": self.solve_diag_lt,
              "gemv": self.gemv, "gemvT": self.gemv_t,
              "assembleVec": self.assemble_vec,
              "assembleVecT": self.assemble_vec_t}
        for op, a, b, c, t in records:
            st = by.get(op)
            if st is not None:
                was = st.enabled
                st.enabled = True
                st.record(t)
                st.enabled = was

    def __str__(self):
        out = (f"Solver timings:\n  factor: {self.factor}\n"
               f"  solveL: {self.solve_l}\n  solveLt: {self.solve_lt}\n"
               f"  addMv: {self.add_mv}")
        if any(s.num_runs for s in (self.potrf, self.trsm, self.syge,
                                    self.asmbl)):
            out += (f"\nPer-op (profiled):\n  potrf: {self.potrf}\n"
                    f"  trsm: {self.trsm}\n  syge: {self.syge}\n"
                    f"  asmbl: {self.asmbl}")
        solve_stats = (("sparseElimSolveL", self.sparse_elim_solve_l),
                       ("sparseElimSolveLt", self.sparse_elim_solve_lt),
                       ("solveL", self.solve_diag_l),
                       ("solveLt", self.solve_diag_lt),
                       ("gemv", self.gemv), ("gemvT", self.gemv_t),
                       ("assembleVec", self.assemble_vec),
                       ("assembleVecT", self.assemble_vec_t))
        if any(s.num_runs for _, s in solve_stats):
            out += "\nPer-solve-stage (profiled):"
            for name, s in solve_stats:
                out += f"\n  {name}: {s}"
        return out


def _make_amortized_timer(reps: int, min_window: float = 0.04,
                          max_reps: int = 512):
    """Per-op timer: queue n back-to-back dispatches that end in ONE
    block_until_ready, adaptively raising n until the measured window is
    long enough to drown timer and dispatch jitter. A null-op measured
    the same way is subtracted so fitted constants reflect device time,
    not dispatch overhead."""
    import jax
    import jax.numpy as jnp

    def raw(fn, *args):
        out = jax.block_until_ready(fn(*args))  # compile + warm
        n = max(1, reps)
        while True:
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn(*args)
            jax.block_until_ready(out)
            tot = time.perf_counter() - t0
            if tot >= min_window or n >= max_reps:
                return out, tot / n
            n = min(max_reps,
                    max(n * 2, int(np.ceil(n * min_window / max(tot, 1e-6)))))

    _null = jax.jit(lambda x: x * 1.0000001)
    z = jnp.zeros(8, jnp.float32)
    _, null_a = raw(_null, z)
    _, null_b = raw(_null, z)
    null_t = min(null_a, null_b)

    def timed(fn, *args):
        out, t = raw(fn, *args)
        return out, max(t - null_t, 1e-7)

    return timed


def profile_factor(solver, data, reps: int = 5) -> List[Tuple]:
    """Time each bucket op of the planned factor schedule separately.

    Returns records (op, m, n, k, seconds):
      potrf: (n=width*B, 0, 0)     — batched cholesky of B n-blocks
      trsm:  (n=width, k=rows*B)   — batched triangular solve
      syge:  (m=n=rows, k=width)   — batched outer product
      asmbl: (br=blocks, bc=pairs) — block-pair scatter assembly
    The per-sample shapes feed fit_computation_model.
    """
    import jax
    import jax.numpy as jnp

    be = solver.backend
    sched = be._factor_schedule(0, solver.skel.num_lumps)
    aux_all = []
    max_win = 2
    for lev in sched:
        max_win = max(max_win, be._register_factor_level(lev, aux_all))
    aux_all = tuple(jnp.asarray(a) for a in aux_all)
    ext = jnp.concatenate([jnp.asarray(data),
                           jnp.zeros(max_win, jnp.asarray(data).dtype)])
    records = []
    timed = _make_amortized_timer(reps)

    for level in sched:
        lump_buckets, pair_buckets, ptot, dense = level
        prods = []
        for lb in lump_buckets:
            B = len(lb.off)

            def chol_op(e):
                panels = be._read_panels(e, lb)
                return jax.lax.linalg.cholesky(
                    panels[:, :lb.cp] +
                    be._pad_eye(lb.cols, lb.cp, e.dtype),
                    symmetrize_input=False)

            L, t = timed(jax.jit(chol_op), ext)
            records.append(("potrf", lb.cp, B, 0, t))
            if lb.rp > 0:
                def trsm_op(e, L):
                    panels = be._read_panels(e, lb)
                    return jax.lax.linalg.triangular_solve(
                        L, panels[:, lb.cp:], left_side=False, lower=True,
                        transpose_a=True)

                x, t = timed(jax.jit(trsm_op), ext, L)
                records.append(("trsm", lb.cp, lb.rp * B, 0, t))

                if dense is None:
                    # dense W-mode levels never run per-bucket outer
                    # products (the W.W^T product is timed as dense_upd);
                    # timing them anyway would poison the syge fit with
                    # ops the real program doesn't contain
                    def syge_op(x):
                        return jnp.einsum("brk,bsk->brs", x, x,
                                          preferred_element_type=x.dtype)

                    prod, t = timed(jax.jit(syge_op), x)
                    records.append(("syge", lb.rp, lb.rp, lb.cp * B, t))
                    prods.append(prod.reshape(-1))
        if dense is None and prods:
            flat = jnp.concatenate(prods) if len(prods) > 1 else prods[0]
            npairs = sum(len(pb.src_base) for pb in pair_buckets)
            nel = sum(len(pb.src_base) * pb.rsp * pb.csp
                      for pb in pair_buckets)

            def asmbl_op(e, f):
                return be._apply_pairs(e, f, pair_buckets, aux_all)

            ext2, t = timed(jax.jit(asmbl_op), ext, flat)
            records.append(("asmbl", npairs, nel, 0, t))
        elif dense is not None:
            # dense compact-U path: time the level's whole update
            # application (one-hot chunk GEMMs + slice subtractions) as a
            # distinct category (shape semantics differ from the pair
            # asmbl, so it must not pollute that fit)
            def dense_op(e):
                return be._run_dense_level(e, lump_buckets, pair_buckets,
                                           dense, aux_all)

            _, t = timed(jax.jit(dense_op), ext)
            n_slices = len(dense["slices"]) + sum(
                len(d) for _, _, d in dense["slice_scans"])
            records.append(("dense_upd", dense["R"], n_slices, 0, t))
        # run the real level (identical numeric semantics to make_factor,
        # including the dense compact-U path) so later levels profile on
        # realistic eliminated data
        ext = jax.jit(lambda e, lev=level: be._run_factor_level(
            e, lev, aux_all))(ext)
        ext = jax.block_until_ready(ext)
    return records


def profile_solve(solver, factor_data, rhs, reps: int = 5) -> List[Tuple]:
    """Time each stage of the planned solve schedule separately — the
    reference's 8 solve-stage OpStats (MatOps.h:84-101): sparse-elim
    solve L/Lt, per-bucket diagonal solve L/Lt, below gemv/gemvT, and the
    RHS scatter assembles. Returns (op, a, b, c, seconds) records; feed
    them to SolverStats.record_profile for the printStats view."""
    import jax
    import jax.numpy as jnp

    be = solver.backend
    sk = solver.skel
    order = sk.order
    sched = be._solve_schedule(0, sk.num_lumps)
    aux_np = be._solve_aux(sched)
    aux = tuple(jnp.asarray(a) for a in aux_np)
    elim_end_lump = 0
    if solver.sparse_elim_ranges:
        elim_end_lump = int(sk.span_to_lump[solver.sparse_elim_ranges[-1]])

    data = jnp.asarray(factor_data)
    v = jnp.asarray(rhs)
    if v.ndim == 1:
        v = v[:, None]
    ext = jnp.concatenate([data, jnp.zeros(2, data.dtype)])
    vv = jnp.concatenate([v, jnp.zeros((1, v.shape[1]), v.dtype)])
    records = []
    timed = _make_amortized_timer(reps)

    def rec(op, a, b, t):
        records.append((op, a, b, 0, t))

    def stage_ops(sb, transpose):
        is_elim = elim_end_lump > 0 and sb.members is not None and \
            len(sb.members) > 0 and \
            bool(np.all(np.asarray(sb.members) < elim_end_lump))
        B, cp = len(sb.off), sb.cp
        bidx = aux[sb.aux_slot] if sb.rp > 0 else None
        xidx = be._bucket_xidx(sb, order)

        def tri_op(e, w):
            panels = be._read_panels(e, sb)
            L = panels[:, :cp] + be._pad_eye(sb.cols, cp, e.dtype)
            return be._tri(L, w[xidx], transpose)

        x, t = timed(jax.jit(tri_op), ext, vv)
        if is_elim:
            rec("sparseElimSolveLt" if transpose else "sparseElimSolveL",
                cp, B, t)
        else:
            rec("solveLt" if transpose else "solveL", cp, B, t)
        if bidx is not None:
            def gemv_op(e, x):
                panels = be._read_panels(e, sb)
                below = panels[:, cp:]
                if transpose:
                    return jnp.einsum("brk,brn->bkn", below, vv[bidx],
                                      preferred_element_type=vv.dtype)
                return jnp.einsum("brk,bkn->brn", below, x,
                                  preferred_element_type=vv.dtype)

            y, t = timed(jax.jit(gemv_op), ext, x)
            rec("gemvT" if transpose else "gemv", cp, sb.rp * B, t)
            if transpose:
                # the transpose gather vv[bidx] is fused into gemvT; the
                # assembleVecT cost is the gather itself
                def assv_op(w):
                    return w[bidx]

                _, t = timed(jax.jit(assv_op), vv)
                rec("assembleVecT", sb.rp, B, t)
            else:
                def assv_op(w, y):
                    return w.at[bidx].add(-y)

                _, t = timed(jax.jit(assv_op), vv, y)
                rec("assembleVec", sb.rp, B, t)

    # forward pass (replay with the real _diag_solve after timing pieces)
    for buckets in sched:
        for sb in buckets:
            stage_ops(sb, False)
            bidx = aux[sb.aux_slot] if sb.rp > 0 else None
            vv = jax.jit(lambda e, w, sb=sb, bidx=bidx: be._diag_solve(
                e, w, sb, order, False, bidx))(ext, vv)
        vv = jax.block_until_ready(vv)
    for buckets in reversed(sched):
        for sb in buckets:
            stage_ops(sb, True)
            bidx = aux[sb.aux_slot] if sb.rp > 0 else None
            vv = jax.jit(lambda e, w, sb=sb, bidx=bidx: be._diag_solve(
                e, w, sb, order, True, bidx))(ext, vv)
        vv = jax.block_until_ready(vv)
    return records


def fit_computation_model(records: List[Tuple]) -> ComputationModel:
    """Least-squares fit of the polynomial op models from profile records
    (the reference's opt_comp_model, examples/OptimizeCompModel.cpp,
    re-done as four small linear regressions with 1/sqrt(t) weighting)."""
    groups: Dict[str, List] = {"potrf": [], "trsm": [], "syge": [],
                               "asmbl": []}
    for op, a, b, c, t in records:
        if op in groups:  # other categories (dense_upd, solve stages)
            groups[op].append((a, b, c, t))

    def wlsq(X, t):
        """1/sqrt(t)-weighted NON-NEGATIVE least squares: the polynomial
        op models are physically nonnegative in every coefficient, and
        unconstrained fits on few/noisy samples produce negative constants
        that break the merge heuristic (reference fits with LM +
        eigendecomposition-guarded steps, OptimizeCompModel.cpp:64-295;
        NNLS is the simpler guarantee)."""
        from scipy.optimize import nnls
        w = 1.0 / np.sqrt(np.maximum(t, 1e-9))
        sol, _ = nnls(X * w[:, None], t * w)
        return sol

    out = {}
    g = np.array(groups["potrf"] or [(8, 1, 0, 1e-5)])
    # batched ops: time per single instance ~ t / B
    out["potrf"] = wlsq(ComputationModel.d_potrf(g[:, 0]),
                        g[:, 3] / np.maximum(g[:, 1], 1))
    g = np.array(groups["trsm"] or [(8, 8, 0, 1e-5)])
    out["trsm"] = wlsq(ComputationModel.d_trsm(g[:, 0], g[:, 1]), g[:, 3])
    g = np.array(groups["syge"] or [(8, 8, 8, 1e-5)])
    out["syge"] = wlsq(ComputationModel.d_syge(g[:, 0], g[:, 1], g[:, 2]),
                       g[:, 3])
    g = np.array(groups["asmbl"] or [(1, 16, 0, 1e-5)])
    out["asmbl"] = wlsq(ComputationModel.d_asmbl(g[:, 0], g[:, 1]),
                        g[:, 3])
    return ComputationModel(potrf_params=out["potrf"],
                            trsm_params=out["trsm"],
                            syge_params=out["syge"],
                            asmbl_params=out["asmbl"])
