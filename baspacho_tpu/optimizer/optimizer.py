"""Levenberg-Marquardt optimizer over a typed factor graph.

Counterpart of the reference examples/Optimizer.h (the example layer that
drives the solver), redesigned for JAX:

  * Variables live in homogeneous **families** (stacked (N, data_dim)
    arrays with a manifold trait) instead of individually-typed C++
    objects — every per-variable op is a batched array op.
  * Factors live in **factor families**: one residual function vmapped
    over the family's (F,) factor batch. Jacobians come from forward-mode
    autodiff through the manifold retraction by default (the reference
    requires hand-written Jacobian lambdas; those can still be supplied).
  * Gradient/Hessian assembly is a handful of einsums plus deterministic
    `.at[].add` scatters with indices computed from the solver's permuted
    accessor — replacing the reference's per-block writes guarded by an
    IEEE-NaN spinlock (AtomicOps.h): no locks, bitwise-reproducible.
  * The damped-step evaluation (damp -> factor -> solve -> retract ->
    recost) is one jitted program; the LM accept/reject loop runs on host.

Schur trick: families registered in `elim_families` are ordered first and
their span range is passed to create_solver as a sparse elimination range
(landmark elimination in BA). The solve can then optionally run partial
factor + PCG on the reduced system with a choice of preconditioner
(reference Optimizer.h:670-764 "solveFunction").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..solver import BackendType, Settings, create_solver
from ..sparse_structure import SparseStructure
from ..utils import cum_sum_vec, with_matmul_precision
from .pcg import pcg
from .preconditioner import IdentityPrecond
from .soft_loss import TrivialLoss


class VariableFamily:
    """Homogeneous stacked variables. Euclidean by default; pass
    `tangent_dim`/`tangent_step` for manifold types (e.g. SE3)."""

    def __init__(self, values, tangent_dim: Optional[int] = None,
                 tangent_step: Optional[Callable] = None,
                 fixed: bool = False, name: str = ""):
        self.values = jnp.asarray(values)
        assert self.values.ndim == 2
        self.count = self.values.shape[0]
        self.data_dim = self.values.shape[1]
        self.tangent_dim = tangent_dim or self.data_dim
        self.tangent_step = tangent_step or (lambda v, d: v + d)
        self.fixed = fixed
        self.name = name


@dataclass
class _FactorFamily:
    residual_fn: Callable            # (*var_values, *consts) -> (rdim,)
    slots: List[Tuple[int, np.ndarray]]  # (family_id, (F,) indices)
    consts: tuple
    loss: object
    rdim: int


@dataclass
class OptimizerSettings:
    max_iters: int = 50
    init_damping: float = 1e-5
    damping_up: float = 4.0
    damping_down: float = 0.5
    max_damping: float = 1e8
    cost_rel_tol: float = 1e-8
    step_norm_tol: float = 1e-10
    use_pcg: bool = False            # partial factor + PCG on the corner
    pcg_tol: float = 1e-6
    pcg_max_iters: int = 50
    precond: Callable = IdentityPrecond  # precond factory (solver, span)
    backend: BackendType = BackendType.REF
    verbose: bool = False


class Optimizer:
    def __init__(self):
        self.families: List[VariableFamily] = []
        self.factor_families: List[_FactorFamily] = []
        self.elim_families: List[int] = []

    # -- graph construction ---------------------------------------------
    def add_variable_family(self, family: VariableFamily) -> int:
        self.families.append(family)
        return len(self.families) - 1

    def add_factor_family(self, residual_fn: Callable,
                          slots: Sequence[Tuple[int, Sequence[int]]],
                          consts: tuple = (), loss=None) -> int:
        slots = [(int(f), np.asarray(ix, dtype=np.int64))
                 for f, ix in slots]
        n = len(slots[0][1])
        for _, ix in slots:
            assert len(ix) == n
        # probe residual dimension on the first factor
        vals = [self.families[f].values[ix[0]] for f, ix in slots]
        r = residual_fn(*vals, *(jnp.asarray(c)[0] for c in consts))
        rdim = int(np.asarray(r).shape[0])
        self.factor_families.append(_FactorFamily(
            residual_fn=residual_fn, slots=slots, consts=consts,
            loss=loss or TrivialLoss(), rdim=rdim))
        return len(self.factor_families) - 1

    def set_elimination_families(self, family_ids: Sequence[int]) -> None:
        """These families' variables are ordered first and Schur-eliminated
        inside the solver (sparse elimination range)."""
        self.elim_families = list(family_ids)

    # -- solver construction --------------------------------------------
    def _global_order(self):
        """Order families: eliminated first, then the rest (fixed families
        get no params)."""
        order = list(self.elim_families) + \
            [i for i in range(len(self.families))
             if i not in self.elim_families]
        fam_base = {}
        sizes = []
        nxt = 0
        for fi in order:
            fam = self.families[fi]
            if fam.fixed:
                continue
            fam_base[fi] = nxt
            nxt += fam.count
            sizes.extend([fam.tangent_dim] * fam.count)
        return fam_base, np.array(sizes, dtype=np.int64), order

    def build_solver(self, settings: OptimizerSettings):
        fam_base, param_sizes, order = self._global_order()
        self._fam_base = fam_base
        n = len(param_sizes)
        rows = [np.arange(n, dtype=np.int64)]
        cols = [np.arange(n, dtype=np.int64)]
        for ff in self.factor_families:
            gids = [fam_base[f] + ix for f, ix in ff.slots
                    if not self.families[f].fixed]
            for a in range(len(gids)):
                for b in range(a + 1, len(gids)):
                    hi = np.maximum(gids[a], gids[b])
                    lo = np.minimum(gids[a], gids[b])
                    rows.append(hi)
                    cols.append(lo)
        from ..sparse_structure import _csr_from_pairs
        ss = _csr_from_pairs(np.concatenate(rows), np.concatenate(cols), n)

        elim_count = sum(self.families[f].count for f in self.elim_families
                         if not self.families[f].fixed)
        elim_ranges = [0, elim_count] if elim_count else []
        self.solver = create_solver(
            Settings(backend=settings.backend), param_sizes, ss,
            sparse_elim_ranges=elim_ranges)
        self.elim_end_span = elim_count
        self._build_assembly_plans()
        return self.solver

    def _build_assembly_plans(self):
        """Per factor family: internal vector offsets and Hessian block
        (offset, stride, flip) arrays for in-graph index computation."""
        acc = self.solver.accessor()
        self._plans = []
        for ff in self.factor_families:
            slots = []
            for f, ix in ff.slots:
                fam = self.families[f]
                if fam.fixed:
                    slots.append(None)
                    continue
                gid = self._fam_base[f] + ix
                vec_off = acc.param_start(gid)      # (F,) internal offsets
                slots.append(np.asarray(vec_off, dtype=np.int32))
            pairs = []
            live = [k for k in range(len(ff.slots))
                    if slots[k] is not None]
            for a_i, k in enumerate(live):
                for l in live[a_i:]:
                    fk, ixk = ff.slots[k]
                    fl, ixl = ff.slots[l]
                    gk = self._fam_base[fk] + ixk
                    gl = self._fam_base[fl] + ixl
                    if k == l:
                        off, stride = acc.diag_block_offset(gk)
                        flip = np.zeros(len(gk), dtype=bool)
                    else:
                        off, stride, flip = acc.block_offsets(gk, gl)
                    pairs.append((k, l, _i32(off), _i32(stride),
                                  np.asarray(flip)))
            self._plans.append((slots, pairs))

    # -- cost / grad / hessian ------------------------------------------
    CHUNK_OBS = 131072  # factor families beyond this run the grad/Hessian
    #                     assembly as a lax.scan over uniform chunks (so
    #                     per-chunk index/Jacobian tensors stay bounded —
    #                     a 2.6M-observation BA otherwise materializes
    #                     multi-GB index tensors)

    def _gather_aux(self):
        """Large per-family index/const arrays as a pytree passed into the
        jitted computations (baking them in as constants makes lowering
        slow, esp. on remote-compile platforms). Families larger than
        CHUNK_OBS get their arrays padded and reshaped to (nchunks, C,
        ...) plus a validity mask; padded entries index slot 0 but their
        contributions are masked to zero and their scatter targets point
        at the sacrificial grad/Hessian slots."""
        if getattr(self, "_aux", None) is not None:
            return self._aux
        self._aux_chunked = []
        order = self.solver.order
        dsize = self.solver.data_size
        aux = []
        for ff, (slots, pairs) in zip(self.factor_families, self._plans):
            F = len(ff.slots[0][1])
            C = self.CHUNK_OBS
            if F <= C:
                fam_aux = {
                    "ix": [jnp.asarray(ix) for _, ix in ff.slots],
                    "consts": [jnp.asarray(c) for c in ff.consts],
                    "vec_off": [None if v is None else jnp.asarray(v)
                                for v in slots],
                    "pairs": [(jnp.asarray(off), jnp.asarray(stride),
                               jnp.asarray(flip))
                              for _, _, off, stride, flip in pairs],
                    "mask": None,
                }
                aux.append(fam_aux)
                self._aux_chunked.append(False)
                continue
            nc = (F + C - 1) // C
            Fp = nc * C

            def padc(a, fill):
                a = np.asarray(a)
                out = np.concatenate(
                    [a, np.full((Fp - F,) + a.shape[1:], fill, a.dtype)])
                return jnp.asarray(out.reshape((nc, C) + a.shape[1:]))

            mask = np.zeros(Fp, np.float32)
            mask[:F] = 1.0
            fam_aux = {
                "ix": [padc(ix, 0) for _, ix in ff.slots],
                "consts": [padc(np.asarray(c),
                                np.asarray(c).ravel()[0])
                           for c in ff.consts],
                "vec_off": [None if v is None else padc(v, order)
                            for v in slots],
                "pairs": [(padc(off, dsize), padc(stride, 1),
                           padc(flip, False))
                          for _, _, off, stride, flip in pairs],
                "mask": jnp.asarray(mask.reshape(nc, C)),
            }
            aux.append(fam_aux)
            self._aux_chunked.append(True)
        self._aux = aux
        return aux

    def _family_terms(self, values_list, ff: _FactorFamily, fam_aux):
        """Per-factor robustified residual and per-slot Jacobians."""
        vals = [values_list[f][ix]
                for (f, _), ix in zip(ff.slots, fam_aux["ix"])]
        consts = fam_aux["consts"]
        steps = [self.families[f].tangent_step for f, _ in ff.slots]
        tdims = [self.families[f].tangent_dim for f, _ in ff.slots]

        def local(deltas, vs, cs):
            stepped = [s(v, d) for s, v, d in zip(steps, vs, deltas)]
            return ff.residual_fn(*stepped, *cs)

        def one(vs, cs):
            zeros = tuple(jnp.zeros(td, vs[0].dtype) for td in tdims)
            r = local(zeros, vs, cs)
            jacs = jax.jacfwd(local, argnums=0)(zeros, vs, cs)
            return r, jacs

        r, jacs = jax.vmap(one)(tuple(vals), tuple(consts))
        s = jnp.sum(r * r, axis=-1)
        w = ff.loss.weight(s)
        sw = jnp.sqrt(w)
        if fam_aux.get("chunk_mask") is not None:
            sw = sw * fam_aux["chunk_mask"]
        r_w = r * sw[:, None]
        jacs_w = tuple(j * sw[:, None, None] for j in jacs)
        cost = 0.5 * jnp.sum(ff.loss.val(s) *
                             (fam_aux["chunk_mask"]
                              if fam_aux.get("chunk_mask") is not None
                              else 1.0))
        return cost, r_w, jacs_w

    def compute_cost(self, values_list):
        aux = self._gather_aux() if hasattr(self, "_plans") else None
        if getattr(self, "_jit_cost", None) is None:
            def cost_fn(values_list, aux):
                total = 0.0
                for fi, ff in enumerate(self.factor_families):
                    F = len(ff.slots[0][1])
                    ixs = aux[fi]["ix"] if aux else                         [jnp.asarray(ix) for _, ix in ff.slots]
                    cs = aux[fi]["consts"] if aux else                         [jnp.asarray(c) for c in ff.consts]
                    if aux and self._aux_chunked[fi]:
                        # chunked aux arrays are (nc, C, ...): flatten
                        # and drop the padding tail
                        ixs = [a.reshape((-1,) + a.shape[2:])[:F]
                               for a in ixs]
                        cs = [a.reshape((-1,) + a.shape[2:])[:F]
                              for a in cs]
                    vals = [values_list[f][ix]
                            for (f, _), ix in zip(ff.slots, ixs)]
                    r = jax.vmap(lambda vs, c: ff.residual_fn(*vs, *c))(
                        tuple(vals), tuple(cs))
                    total = total + 0.5 * jnp.sum(
                        ff.loss.val(jnp.sum(r * r, axis=-1)))
                return total
            self._jit_cost = jax.jit(with_matmul_precision(cost_fn))
        return self._jit_cost(list(values_list), aux)

    def compute_grad_hess(self, values_list, dtype=None):
        aux = self._gather_aux()
        if getattr(self, "_jit_gh", None) is None:
            self._jit_gh = jax.jit(
                with_matmul_precision(self._grad_hess_impl),
                static_argnames=("dtype",))
        dt = jnp.dtype(dtype) if dtype is not None else \
            jnp.asarray(values_list[0]).dtype
        return self._jit_gh(list(values_list), aux, dtype=jnp.dtype(dt).name)

    def _accumulate_family(self, hdata, grad, values_list, ff, pairs,
                           chunk_aux, dtype):
        """One family's (or one chunk's) grad/Hessian contributions.
        Index tensors are built flat (B, ti*tj): a layout that pads a
        trailing tiny dim would turn a (B, 9, 9)-shaped index tensor into
        gigabytes at BA scale. Residuals and Jacobians are cast to the
        assembly dtype first: constants may carry a wider dtype than the
        variables, and a GEMM whose f64 operands feed an f32 result is
        refused on the GPU."""
        cost, r, jacs = self._family_terms(values_list, ff, chunk_aux)
        r = r.astype(dtype)
        jacs = tuple(j.astype(dtype) for j in jacs)
        for k, vec_off in enumerate(chunk_aux["vec_off"]):
            if vec_off is None:
                continue
            td = self.families[ff.slots[k][0]].tangent_dim
            g = jnp.einsum("bri,br->bi", jacs[k], r,
                           preferred_element_type=dtype)
            idx = vec_off[:, None] + jnp.arange(td)[None, :]
            grad = grad.at[idx].add(g)
        for (k, l, _, _, _), (off, stride, flip) in zip(
                pairs, chunk_aux["pairs"]):
            ti = self.families[ff.slots[k][0]].tangent_dim
            tj = self.families[ff.slots[l][0]].tangent_dim
            h = jnp.einsum("bri,brj->bij", jacs[k], jacs[l],
                           preferred_element_type=dtype)
            rr = (jnp.arange(ti * tj) // tj)[None, :]
            cc = (jnp.arange(ti * tj) % tj)[None, :]
            offb = off[:, None]
            strb = stride[:, None]
            plain = offb + rr * strb + cc
            flipped = offb + cc * strb + rr
            idx = jnp.where(flip[:, None], flipped, plain)
            hdata = hdata.at[idx].add(h.reshape(-1, ti * tj))
        return hdata, grad, cost

    def _grad_hess_impl(self, values_list, aux, dtype):
        dtype = jnp.dtype(dtype)
        solver = self.solver
        hdata = jnp.zeros(solver.data_size + 1, dtype)
        grad = jnp.zeros(solver.order + 1, dtype)
        total_cost = 0.0
        for fi, (ff, (slots, pairs)) in enumerate(
                zip(self.factor_families, self._plans)):
            fam_aux = aux[fi]
            if not self._aux_chunked[fi]:
                ch = dict(fam_aux)
                ch["chunk_mask"] = None
                hdata, grad, cost = self._accumulate_family(
                    hdata, grad, values_list, ff, pairs, ch, dtype)
                total_cost = total_cost + cost
                continue

            xs = {
                "ix": fam_aux["ix"],
                "consts": fam_aux["consts"],
                "vec_off": [v for v in fam_aux["vec_off"]
                            if v is not None],
                "pairs": fam_aux["pairs"],
                "mask": fam_aux["mask"],
            }
            live = [i for i, v in enumerate(fam_aux["vec_off"])
                    if v is not None]

            def body(carry, x, ff=ff, pairs=pairs, live=live):
                hdata, grad, cst = carry
                vo = [None] * len(ff.slots)
                for i, v in zip(live, x["vec_off"]):
                    vo[i] = v
                ch = {"ix": x["ix"], "consts": x["consts"],
                      "vec_off": vo, "pairs": x["pairs"],
                      "chunk_mask": x["mask"]}
                hdata, grad, cost = self._accumulate_family(
                    hdata, grad, values_list, ff, pairs, ch, dtype)
                return (hdata, grad, cst + cost.astype(cst.dtype)), None

            (hdata, grad, total_cost), _ = jax.lax.scan(
                body, (hdata, grad, jnp.asarray(total_cost, dtype)), xs)
        return total_cost, grad[:-1], hdata[:-1]

    # -- diagnostics ------------------------------------------------------
    def verify_jacobians(self, epsilon: float = 1e-5,
                         max_relative_error: float = 1e-3,
                         n_check: int = 100, verbose: bool = False) -> bool:
        """Check each factor family's Jacobians against central finite
        differences through the manifold retraction, on up to `n_check`
        factors per family (reference Optimizer.h:247-320 verifyJacobians;
        there it validates hand-written analytic Jacobians — here the
        autodiff Jacobians, or any user-supplied ones, play that role).
        Returns True when every column's relative error stays below
        `max_relative_error`."""
        ok = True
        for fi, ff in enumerate(self.factor_families):
            F = len(ff.slots[0][1])
            m = min(F, n_check)
            steps = [self.families[f].tangent_step for f, _ in ff.slots]
            tdims = [self.families[f].tangent_dim for f, _ in ff.slots]

            def local(deltas, vs, cs):
                stepped = [s(v, d) for s, v, d in zip(steps, vs, deltas)]
                return ff.residual_fn(*stepped, *cs)

            max_rel = [np.zeros(td) for td in tdims]
            for k in range(m):
                vs = tuple(jnp.asarray(self.families[f].values[ix[k]])
                           for f, ix in ff.slots)
                cs = tuple(jnp.asarray(c)[k] for c in ff.consts)
                zeros = tuple(jnp.zeros(td, vs[0].dtype) for td in tdims)
                jacs = jax.jacfwd(local, argnums=0)(zeros, vs, cs)
                for i, td in enumerate(tdims):
                    jac = np.asarray(jacs[i], dtype=np.float64)
                    for t in range(td):
                        dp = [jnp.zeros(d, vs[0].dtype) for d in tdims]
                        dp[i] = dp[i].at[t].set(epsilon)
                        rp = np.asarray(local(tuple(dp), vs, cs),
                                        dtype=np.float64)
                        dp[i] = dp[i].at[t].set(-epsilon)
                        rm = np.asarray(local(tuple(dp), vs, cs),
                                        dtype=np.float64)
                        num = (rp - rm) / (2 * epsilon)
                        rel = np.linalg.norm(num - jac[:, t]) / (
                            np.linalg.norm(num) + epsilon)
                        max_rel[i][t] = max(max_rel[i][t], rel)
            fam_ok = all(float(mr.max(initial=0.0)) <= max_relative_error
                         for mr in max_rel)
            ok = ok and fam_ok
            if verbose or not fam_ok:
                print(f"factor family {fi}: checked {m}/{F} factors, "
                      f"max col rel errors "
                      f"{[np.round(mr, 6).tolist() for mr in max_rel]} "
                      f"{'OK' if fam_ok else 'FAIL'}")
        return ok

    # -- step -----------------------------------------------------------
    def apply_step(self, values_list, step_vec):
        """Retract tangent step (internal ordering) onto each family."""
        if getattr(self, "_step_idx", None) is None:
            acc = self.solver.accessor()
            self._step_idx = []
            for fi, fam in enumerate(self.families):
                if fam.fixed:
                    self._step_idx.append(None)
                    continue
                gid = self._fam_base[fi] + np.arange(fam.count)
                vec_off = np.asarray(acc.param_start(gid), dtype=np.int32)
                self._step_idx.append(jnp.asarray(
                    vec_off[:, None] + np.arange(fam.tangent_dim)[None, :]))

            def step_fn(values_list, step_vec, idx_list):
                out = list(values_list)
                for fi, fam in enumerate(self.families):
                    if idx_list[fi] is None:
                        continue
                    deltas = step_vec[idx_list[fi]]
                    out[fi] = jax.vmap(fam.tangent_step)(
                        values_list[fi], deltas)
                return out
            self._jit_step = jax.jit(with_matmul_precision(step_fn))
        return self._jit_step(list(values_list), step_vec, self._step_idx)

    def _solve(self, hdata, grad, settings: OptimizerSettings):
        solver = self.solver
        if not settings.use_pcg or self.elim_end_span == 0:
            f = solver.factor(hdata)
            return solver.solve(f, -grad)
        # partial factor + PCG on the reduced camera system
        t = self.elim_end_span
        o = solver.span_vector_offset(t)
        f = solver.factor_up_to(hdata, t)
        v = solver.solve_l_up_to(f, t, -grad)
        precond = settings.precond(solver, t)
        precond.init(f)

        def apply_inv_m(x):
            full = jnp.zeros_like(v).at[o:].set(x)
            return precond.apply(full)[o:]

        def apply_a(x):
            full = jnp.zeros_like(v).at[o:].set(x)
            out = solver.add_mv_from(f, t, full, jnp.zeros_like(full), 1.0)
            return out[o:]

        x_corner, _, _ = pcg(apply_inv_m, apply_a, v[o:],
                             settings.pcg_tol, settings.pcg_max_iters)
        v = v.at[o:].set(x_corner)
        return solver.solve_lt_up_to(f, t, v)

    # -- LM loop --------------------------------------------------------
    def optimize(self, settings: OptimizerSettings = OptimizerSettings()):
        if not hasattr(self, "solver"):
            self.build_solver(settings)
        values = [f.values for f in self.families]
        lam = settings.init_damping
        stats = {"iters": 0, "costs": []}
        cost, grad, hdata = self.compute_grad_hess(values)
        cost = float(cost)
        stats["costs"].append(cost)
        damp_idx = jnp.asarray(self.solver.skel.damp_indices())
        for it in range(settings.max_iters):
            accepted = False
            new_cost = cost  # stays = cost if no trial step ever runs
            while lam <= settings.max_damping:
                # reference damping H_ii += lam * (1 + H_ii)
                # (Optimizer.h addDamping): the additive term keeps
                # variables that no factor observes (zero diagonal) PD
                damped = hdata.at[damp_idx].mul(1.0 + lam).at[damp_idx].add(
                    lam)
                step = self._solve(damped, grad, settings)
                new_values = self.apply_step(values, step)
                new_cost = float(self.compute_cost(new_values))
                if np.isfinite(new_cost) and new_cost < cost:
                    accepted = True
                    break
                lam *= settings.damping_up
            if settings.verbose:
                print(f"iter {it}: cost {cost:.6e} -> {new_cost:.6e} "
                      f"lambda {lam:.1e} "
                      f"{':)' if accepted else ':('}")
            if not accepted:
                break
            step_norm = float(jnp.linalg.norm(step))
            rel_decrease = (cost - new_cost) / max(abs(cost), 1e-30)
            values = new_values
            cost = new_cost
            stats["costs"].append(cost)
            stats["iters"] = it + 1
            lam = max(lam * settings.damping_down, 1e-12)
            cost2, grad, hdata = self.compute_grad_hess(values)
            if rel_decrease < settings.cost_rel_tol or \
                    step_norm < settings.step_norm_tol:
                break
        for fam, v in zip(self.families, values):
            fam.values = v
        stats["final_cost"] = cost
        return stats


def _i32(a):
    return np.asarray(a, dtype=np.int32)
