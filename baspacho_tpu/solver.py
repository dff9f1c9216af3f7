"""Solver: symbolic plan + jitted numeric operations.

Counterpart of the reference Solver/createSolver
(/root/reference/baspacho/baspacho/Solver.{h,cpp}) with a functional,
JAX-idiomatic API: numeric ops take and return arrays (no in-place
mutation), batching is a leading axis handled transparently, and every
(op, range) pair compiles once to a shape-static XLA program that is
reused across solver iterations.

createSolver pipeline (same analysis structure as reference :611-752):
  1. apply given sparse-elim-range fill,
  2. AMD-reorder the remaining bottom-right corner,
  3. elimination tree: auto-detect further elim ranges, merge supernodes
     under the computation model,
  4. compose permutations, build the coalesced factor skeleton.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .accessor import CoalescedAccessor, PermutedCoalescedAccessor
from .block_matrix import CoalescedBlockMatrixSkel
from .computation_model import ComputationModel
from .elimination_tree import EliminationTree
from .ops.plan import build_plan
from .ops.ref_backend import UnrolledBackend
from .sparse_structure import SparseStructure
from .utils import (compose_permutations, cum_sum_vec, inverse_permutation,
                    is_strictly_increasing, with_matmul_precision)


class BackendType(enum.Enum):
    REF = "ref"          # unrolled jitted ops, one op per lump/board
    PLANNED = "planned"  # level-scheduled bucketed batched ops (fast path)


class AddFillPolicy(enum.Enum):
    COMPLETE = 0         # fill for complete factoring, reorder
    FOR_AUTO_ELIMS = 1   # fill for given+auto elim ranges, reorder
    FOR_GIVEN_ELIMS = 2  # fill for given elim ranges only, no reorder
    NONE = 3             # no fill, no reorder


@dataclass
class Settings:
    find_sparse_elimination_ranges: bool = True
    backend: BackendType = BackendType.REF
    add_fill_policy: AddFillPolicy = AddFillPolicy.COMPLETE
    computation_model: Optional[ComputationModel] = None
    # reorder lumps to (segment, level, shape) so batched buckets become
    # contiguous slices. Off by default: it renumbers spans level-major,
    # which fragments the consecutive-span runs that make the assembly's
    # window scatters coarse — a net loss except on very deep trees.
    level_reorder: bool = False
    # matmul precision for all numeric ops. "highest" is plain float32;
    # "high" and "default" let cuBLAS run float32 dots as TF32 on the
    # tensor cores (10-bit mantissa: ~3e-4 relative error on a 1024-deep
    # product vs 1.4e-6 at "highest", measured on an H100).
    matmul_precision: str = "highest"
    # precision of the level-update accumulation GEMMs only (the
    # U = sum x x^T syrk — the FLOP-dominant op on Schur-elimination
    # levels); None follows matmul_precision. "high" (TF32) is faster
    # (flat_schur_full factor 56 vs 86 ms on an H100) but breaks the
    # float contract on bundle adjustment: at the bal_full shape the
    # first LM step's solve residual is 5.5e-5 vs 5.1e-6, and the
    # factor's error against the float64 factor 1.1e-3 vs 5.6e-5.
    update_precision: Optional[str] = None


class Solver:
    def __init__(self, skel: CoalescedBlockMatrixSkel,
                 sparse_elim_ranges: Sequence[int],
                 permutation: np.ndarray,
                 backend: BackendType = BackendType.REF,
                 can_factor_up_to: int = -1,
                 matmul_precision: str = "highest",
                 update_precision: Optional[str] = None):
        self.skel = skel
        self.matmul_precision = matmul_precision
        self.update_precision = update_precision or matmul_precision
        self.sparse_elim_ranges = list(sparse_elim_ranges)
        self.permutation = np.asarray(permutation, dtype=np.int64)
        self.can_factor_up_to = (skel.num_spans if can_factor_up_to < 0
                                 else can_factor_up_to)
        max_lump = (skel.num_lumps
                    if self.can_factor_up_to >= skel.num_spans
                    else int(skel.span_to_lump[self.can_factor_up_to]))
        self.plan = build_plan(skel, self.sparse_elim_ranges, max_lump)
        self.backend_type = backend
        if backend == BackendType.PLANNED:
            from .ops.planned_backend import PlannedBackend
            self.backend = PlannedBackend(self.plan)
            self.backend.update_precision = self.update_precision
        else:
            self.backend = UnrolledBackend(self.plan)
        self._fns = {}
        from .stats import SolverStats
        self.stats = SolverStats()

    # -- stats (reference Solver::enableStats/printStats/resetStats) ----
    def enable_stats(self, enabled: bool = True):
        self.stats.enable(enabled)

    def reset_stats(self):
        self.stats.reset()

    def print_stats(self):
        sk = self.skel
        print(f"Matrix stats:\n  spans: {sk.num_spans}  lumps: "
              f"{sk.num_lumps}  order: {sk.order}\n"
              f"  data size: {sk.data_size}\n"
              f"  levels: {getattr(self.backend, 'num_levels', 'n/a')}\n"
              f"  sparse elim ranges: {self.sparse_elim_ranges}")
        print(self.stats)

    def profile_ops(self, data, reps: int = 5):
        """Per-op profiling mode: re-runs the factor schedule as separate
        synced jitted pieces (the only way to attribute time under XLA
        fusion), records (op, shape..., seconds) samples, and aggregates
        them into the per-op stats shown by print_stats — the reference's
        OpStat-per-category view (MatOps.h:84-101). Returns the raw
        records (the `bench -Z` CSV analog, consumable by
        stats.fit_computation_model)."""
        from .stats import profile_factor
        records = profile_factor(self, data, reps=reps)
        self.stats.record_profile(records)
        return records

    def profile_solve_ops(self, factor_data, rhs, reps: int = 5):
        """Per-stage solve profiling: times each solve stage (sparse-elim
        L/Lt, diag solve L/Lt, gemv/gemvT, RHS assembles) separately and
        aggregates into the per-stage stats shown by print_stats — the
        reference's 8 solve-stage OpStats (MatOps.h:84-101)."""
        from .stats import profile_solve
        records = profile_solve(self, factor_data, rhs, reps=reps)
        self.stats.record_profile(records)
        return records

    def _timed(self, stat, out):
        if stat.enabled:
            import jax
            t0 = __import__("time").perf_counter()
            jax.block_until_ready(out)
            stat.record(__import__("time").perf_counter() - t0)
        return out

    # -- introspection --------------------------------------------------
    @property
    def order(self) -> int:
        return self.skel.order

    @property
    def data_size(self) -> int:
        return self.skel.data_size

    def span_vector_offset(self, span: int) -> int:
        return self.skel.span_vector_offset(span)

    def span_matrix_offset(self, span: int) -> int:
        return self.skel.span_matrix_offset(span)

    def accessor(self) -> PermutedCoalescedAccessor:
        return PermutedCoalescedAccessor(self.skel, self.permutation)

    def internal_accessor(self) -> CoalescedAccessor:
        return CoalescedAccessor(self.skel)

    def param_to_span(self) -> np.ndarray:
        return self.permutation

    # -- internals ------------------------------------------------------
    def _lump_of_span(self, span_index: int) -> int:
        assert 0 <= span_index <= self.skel.num_spans
        assert self.skel.span_offset_in_lump[span_index] == 0
        return int(self.skel.span_to_lump[span_index])

    def _get(self, key, builder, vmap_axes=None):
        """Build + jit a backend function. Builders return (fn, aux) where
        `aux` is a list of large plan index arrays passed as runtime
        operands — embedding them as constants makes XLA lowering and
        compilation pathologically slow.

        All ops trace under `default_matmul_precision(matmul_precision)`
        ("highest" by default): a float32 dot at default precision may
        run in TF32 on the GPU's tensor cores (10-bit mantissa), which
        breaks the reference's float accuracy contract (FactorTest.cpp
        epsilons)."""
        entry = self._fns.get(key)
        if entry is None:
            fn, aux = builder()
            aux = tuple(jnp.asarray(a) for a in aux)
            if vmap_axes is not None:
                fn = jax.vmap(fn, in_axes=(*vmap_axes, None))
            entry = (jax.jit(with_matmul_precision(
                fn, self.matmul_precision)), aux)
            self._fns[key] = entry
        return entry

    def _check_data(self, data):
        """Input validation on the numeric wrappers (the reference guards
        every op with BASPACHO_CHECK*, DebugMacros.h:28-51)."""
        if data.shape[-1] != self.skel.data_size:
            raise ValueError(
                f"data has {data.shape[-1]} elements, factor layout needs "
                f"{self.skel.data_size}")
        if data.ndim > 2:
            raise ValueError("data must be (dataSize,) or (batch, dataSize)")

    def _check_rhs(self, v, batched):
        want = 2 if batched else 1
        if v.ndim not in (want, want + 1):
            raise ValueError(
                f"rhs must have {want} or {want + 1} dims "
                f"({'batched' if batched else 'unbatched'} data), got "
                f"{v.ndim}")
        if v.shape[1 if batched else 0] != self.skel.order:
            raise ValueError(
                f"rhs length {v.shape[1 if batched else 0]} != matrix "
                f"order {self.skel.order}")

    def _run_factor_like(self, op: str, make, data, start_l: int, end_l: int):
        data = jnp.asarray(data)
        self._check_data(data)
        if data.ndim == 1:
            fn, aux = self._get((op, start_l, end_l, 1),
                                lambda: make(start_l, end_l))
            return fn(data, aux)
        assert data.ndim == 2, "data must be (dataSize,) or (batch, dataSize)"
        fn, aux = self._get((op, start_l, end_l, 2),
                            lambda: make(start_l, end_l), vmap_axes=(0,))
        return fn(data, aux)

    def _run_solve_like(self, op: str, make, data, v, start_l: int,
                        end_l: int):
        data = jnp.asarray(data)
        v = jnp.asarray(v)
        self._check_data(data)
        batched = data.ndim == 2
        self._check_rhs(v, batched)
        vec1d = v.ndim == (2 if batched else 1)
        if vec1d:
            v = v[..., None]
        if not batched:
            fn, aux = self._get((op, start_l, end_l, 1),
                                lambda: make(start_l, end_l))
            out = fn(data, v, aux)
        else:
            fn, aux = self._get((op, start_l, end_l, 2),
                                lambda: make(start_l, end_l),
                                vmap_axes=(0, 0))
            out = fn(data, v, aux)
        return out[..., 0] if vec1d else out

    # -- chained executions (benchmarking aid) ---------------------------
    @staticmethod
    def _chain_factor(built):
        raw, aux_np = built

        def chain(data, k, aux):
            return jax.lax.fori_loop(0, k, lambda i, d: raw(d, aux), data)

        return chain, aux_np

    @staticmethod
    def _chain_solve(built):
        raw, aux_np = built

        def chain(data, v, k, aux):
            return jax.lax.fori_loop(0, k,
                                     lambda i, y: raw(data, y, aux), v)

        return chain, aux_np

    def factor_chained(self, data, k: int):
        """k back-to-back factor executions inside ONE program, each
        feeding the next (timing use only — iterations past the first
        factor an already-factored buffer, so values are garbage).
        Differencing two chain lengths isolates pure per-factor device
        time from host dispatch overhead. The trip count is a runtime
        operand — one compile serves every k."""
        data = jnp.asarray(data)
        self._check_data(data)
        n = self.skel.num_lumps
        if data.ndim == 1:
            fn, aux = self._get(("factorChain", 0, n, 1),
                                lambda: self._chain_factor(
                                    self.backend.make_factor(0, n)))
        else:
            fn, aux = self._get(("factorChain", 0, n, 2),
                                lambda: self._chain_factor(
                                    self.backend.make_factor(0, n)),
                                vmap_axes=(0, None))
        return fn(data, jnp.asarray(k, jnp.int32), aux)

    def solve_chained(self, mat_data, rhs, k: int):
        """k back-to-back solve executions inside ONE program (x_{i+1} =
        A^-1 x_i); see factor_chained for why."""
        data = jnp.asarray(mat_data)
        v = jnp.asarray(rhs)
        self._check_data(data)
        batched = data.ndim == 2
        self._check_rhs(v, batched)
        vec1d = v.ndim == (2 if batched else 1)
        if vec1d:
            v = v[..., None]
        n = self.skel.num_lumps
        make = (self.backend.make_solve
                if hasattr(self.backend, "make_solve") else
                self.backend.make_solve_l)
        if not batched:
            fn, aux = self._get(("solveChain", 0, n, 1),
                                lambda: self._chain_solve(make(0, n)))
        else:
            fn, aux = self._get(("solveChain", 0, n, 2),
                                lambda: self._chain_solve(make(0, n)),
                                vmap_axes=(0, 0, None))
        out = fn(data, v, jnp.asarray(k, jnp.int32), aux)
        return out[..., 0] if vec1d else out

    # -- factor ---------------------------------------------------------
    def factor(self, data):
        return self.factor_up_to(data, self.skel.num_spans)

    def factor_up_to(self, data, span_index: int):
        assert span_index <= self.can_factor_up_to
        return self._timed(self.stats.factor, self._run_factor_like(
            "factor", self.backend.make_factor, data,
            0, self._lump_of_span(span_index)))

    def factor_from(self, data, span_index: int):
        return self._run_factor_like(
            "factor", self.backend.make_factor, data,
            self._lump_of_span(span_index), self.skel.num_lumps)

    def factor_sharded(self, data, mesh):
        """Factor ONE matrix with every level's panel work (potrf/trsm
        and the level-update FLOPs) sharded across the devices of a 1-D
        `jax.sharding.Mesh`. Per level: one all_gather of the factored
        panels + (dense levels) one psum of the compact update — model
        parallelism over the supernode batch, across the cards'
        interconnect (NVLink on one host). No reference
        analog (the reference is single-node); complements the batched
        data-parallel path (vmap + sharded leading axis).

        Requires the planned backend. Returns the same factor as
        `factor(data)` up to float reduction order."""
        assert hasattr(self.backend, "make_factor_sharded"), \
            "factor_sharded needs the PLANNED backend"
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        axis = mesh.axis_names[0]
        n = int(mesh.shape[axis])
        data = jnp.asarray(data)
        self._check_data(data)
        assert data.ndim == 1, "factor_sharded shards ONE factorization"
        key = ("factorSharded", axis, n)
        entry = self._fns.get(key)
        if entry is None:
            fn, aux = self.backend.make_factor_sharded(
                0, self.skel.num_lumps, axis, n)
            aux = tuple(jnp.asarray(a) for a in aux)
            wrapped = with_matmul_precision(fn, self.matmul_precision)
            smapped = shard_map(wrapped, mesh=mesh, in_specs=(P(), P()),
                                out_specs=P(), check_vma=False)
            entry = (jax.jit(smapped), aux)
            self._fns[key] = entry
        fn, aux = entry
        return self._timed(self.stats.factor, fn(data, aux))

    def solve_sharded(self, mat_data, rhs, mesh):
        """Solve ONE system with every level's panel work sharded across
        the devices of a 1-D `jax.sharding.Mesh`: each shard accumulates
        its panels' RHS updates into a delta vector, one psum per level
        combines them. Completes the model-parallel story next
        to `factor_sharded` (no reference analog — the reference is
        single-node). `mat_data` must come from factor/factor_sharded
        (the solve uses the embedded panel inverses)."""
        assert hasattr(self.backend, "make_solve_sharded"), \
            "solve_sharded needs the PLANNED backend"
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        axis = mesh.axis_names[0]
        n = int(mesh.shape[axis])
        data = jnp.asarray(mat_data)
        v = jnp.asarray(rhs)
        self._check_data(data)
        assert data.ndim == 1, "solve_sharded shards ONE solve"
        self._check_rhs(v, False)
        vec1d = v.ndim == 1
        if vec1d:
            v = v[:, None]
        key = ("solveSharded", axis, n)
        entry = self._fns.get(key)
        if entry is None:
            fn, aux = self.backend.make_solve_sharded(
                0, self.skel.num_lumps, axis, n)
            aux = tuple(jnp.asarray(a) for a in aux)
            wrapped = with_matmul_precision(fn, self.matmul_precision)
            smapped = shard_map(wrapped, mesh=mesh,
                                in_specs=(P(), P(), P()), out_specs=P(),
                                check_vma=False)
            entry = (jax.jit(smapped), aux)
            self._fns[key] = entry
        fn, aux = entry
        out = fn(data, v, aux)
        return out[:, 0] if vec1d else out

    # -- solve ----------------------------------------------------------
    def solve(self, mat_data, rhs):
        n = self.skel.num_lumps
        if hasattr(self.backend, "make_solve"):
            # fused single-program L+Lt solve (planned backend)
            return self._timed(self.stats.solve_l, self._run_solve_like(
                "solveFull", self.backend.make_solve, mat_data, rhs, 0, n))
        rhs = self._timed(self.stats.solve_l, self._run_solve_like(
            "solveL", self.backend.make_solve_l, mat_data, rhs, 0, n))
        return self._timed(self.stats.solve_lt, self._run_solve_like(
            "solveLt", self.backend.make_solve_lt, mat_data, rhs, 0, n))

    def solve_l(self, mat_data, rhs):
        return self.solve_l_up_to(mat_data, self.skel.num_spans, rhs)

    def solve_lt(self, mat_data, rhs):
        return self.solve_lt_up_to(mat_data, self.skel.num_spans, rhs)

    def solve_l_up_to(self, mat_data, span_index: int, rhs):
        return self._run_solve_like("solveL", self.backend.make_solve_l,
                                    mat_data, rhs, 0,
                                    self._lump_of_span(span_index))

    def solve_lt_up_to(self, mat_data, span_index: int, rhs):
        return self._run_solve_like("solveLt", self.backend.make_solve_lt,
                                    mat_data, rhs, 0,
                                    self._lump_of_span(span_index))

    def solve_l_from(self, mat_data, span_index: int, rhs):
        return self._run_solve_like("solveL", self.backend.make_solve_l,
                                    mat_data, rhs,
                                    self._lump_of_span(span_index),
                                    self.skel.num_lumps)

    def solve_lt_from(self, mat_data, span_index: int, rhs):
        return self._run_solve_like("solveLt", self.backend.make_solve_lt,
                                    mat_data, rhs,
                                    self._lump_of_span(span_index),
                                    self.skel.num_lumps)

    # -- matvec / pseudo-factor -----------------------------------------
    def add_mv_from(self, mat_data, span_index: int, x, out, alpha=1.0):
        """out += alpha * M x on the bottom-right corner from span_index."""
        start_l = self._lump_of_span(span_index)
        mat_data = jnp.asarray(mat_data)
        x = jnp.asarray(x)
        out = jnp.asarray(out)
        batched = mat_data.ndim == 2
        vec1d = x.ndim == (2 if batched else 1)
        if vec1d:
            x, out = x[..., None], out[..., None]
        alpha = jnp.asarray(alpha, mat_data.dtype)
        if not batched:
            fn, aux = self._get(("addMv", start_l, 1),
                                lambda: self.backend.make_add_mv(start_l))
            res = fn(mat_data, x, out, alpha, aux)
        else:
            fn, aux = self._get(("addMv", start_l, 2),
                                lambda: self.backend.make_add_mv(start_l),
                                vmap_axes=(0, 0, 0, None))
            res = fn(mat_data, x, out, alpha, aux)
        return res[..., 0] if vec1d else res

    def check_factor(self, factored) -> bool:
        """Singularity/NaN detection: True iff every diagonal entry of L
        is finite and positive. (The reference captures cusolver's potrf
        info but never surfaces it — listed under "possible future
        improvements" in its README; here it's a one-liner over the
        factor's diagonal.) Works on batched data (checks all)."""
        f = jnp.asarray(factored)
        d = jnp.take(f, jnp.asarray(self.skel.damp_indices()), axis=-1)
        return bool(jnp.all(jnp.isfinite(d) & (d > 0)))

    def solve_refined(self, mat_data, factor_data, rhs,
                      iterations: int = 2):
        """Mixed-precision solve via iterative refinement.

        `factor_data` is a (typically float32) factorization
        of the matrix held at higher precision in `mat_data`. Each round
        computes the residual r = b - M x at the matrix precision (block
        mat-vec) and corrects with a low-precision solve — recovering the
        reference's float64 accuracy contract (FactorTest.cpp epsilons)
        while all O(n^3) work stays in float32. This inverts the
        reference's LowerPrecSolvePrecond trick (Preconditioner.h:146):
        there a float factor preconditions a double solver; here it IS the
        solver, refined.
        """
        rhs = jnp.asarray(rhs)
        mat = jnp.asarray(mat_data)
        lp = jnp.asarray(factor_data)
        x = self.solve(lp, rhs.astype(lp.dtype)).astype(rhs.dtype)
        for _ in range(iterations):
            r = rhs - self.add_mv_from(mat, 0, x, jnp.zeros_like(x), 1.0)
            dx = self.solve(lp, r.astype(lp.dtype)).astype(rhs.dtype)
            x = x + dx
        return x

    def make_differentiable_solve(self):
        """Returns a jax-differentiable `f(hdata, rhs) -> x` solving
        H x = rhs for the SPD block matrix held in `hdata` (lower-half
        coalesced layout).

        Gradients use the implicit-function theorem instead of
        differentiating through the factorization's internals (the
        Theseus use case — the reference is the GPU solver behind that
        differentiable-LM library, which wraps it in exactly this kind of
        custom backward): with y = H^{-1} g,
            bar_rhs = y,
            bar_H   = -y x^T  (symmetrized onto the stored lower half:
                      bar_hdata[slot(i,j)] = -(y_i x_j + x_i y_j), i > j,
                      and -y_i x_i on the diagonal).
        The backward pass is two triangular solves against the forward
        factor — no extra factorization."""
        ri, ci = self.skel.data_coords()
        ri = jnp.asarray(ri)
        ci = jnp.asarray(ci)

        @jax.custom_vjp
        def diff_solve(hdata, rhs):
            return self.solve(self.factor(hdata), rhs)

        def fwd(hdata, rhs):
            f = self.factor(hdata)
            x = self.solve(f, rhs)
            return x, (f, x)

        def bwd(res, g):
            f, x = res
            y = self.solve(f, g)
            # pad with a zero row so sentinel coords (order) read 0
            pad = [(0, 1)] + [(0, 0)] * (x.ndim - 1)
            xe = jnp.pad(x, pad)
            ye = jnp.pad(y, pad)
            if x.ndim == 1:
                prod = ye[ri] * xe[ci] + xe[ri] * ye[ci]
                diag = ye[ri] * xe[ci]
            else:  # (order, nrhs): sum over rhs columns
                prod = jnp.einsum("kn,kn->k", ye[ri], xe[ci]) + \
                    jnp.einsum("kn,kn->k", xe[ri], ye[ci])
                diag = jnp.einsum("kn,kn->k", ye[ri], xe[ci])
            bar_h = -jnp.where(ri == ci, diag, prod)
            return bar_h.astype(jnp.asarray(x).dtype), y

        diff_solve.defvjp(fwd, bwd)
        return diff_solve

    def pseudo_factor_from(self, data, span_index: int):
        data = jnp.asarray(data)
        n = self.skel.num_spans
        if data.ndim == 1:
            fn, aux = self._get(("pseudo", span_index, 1),
                                lambda: self.backend.make_pseudo_factor(
                                    span_index, n))
            return fn(data, aux)
        fn, aux = self._get(("pseudo", span_index, 2),
                            lambda: self.backend.make_pseudo_factor(
                                span_index, n), vmap_axes=(0,))
        return fn(data, aux)


def _level_shape_reorder(span_sizes, lump_to_span, col_start, row_param,
                         segment_bounds, pad_fn):
    """Reorder lumps to (segment, level, padded-shape) order.

    Any lump order consistent with the update DAG (origins before targets)
    is a valid elimination order with the same fill; sorting each segment
    by level then padded panel shape makes every (level, shape) bucket a
    CONTIGUOUS run of lumps — with the padded storage layout this turns
    all batched panel addressing in the planned backend into plain
    reshapes of contiguous slices (no gathers). Segments (sparse-elim
    ranges, the middle, an elim-last tail) are preserved in place.

    Returns (new_lump_order old-ids, span_old_to_new).
    """
    num_lumps = len(lump_to_span) - 1
    num_spans = int(lump_to_span[-1])
    counts = lump_to_span[1:] - lump_to_span[:-1]
    span_to_lump = np.repeat(np.arange(num_lumps, dtype=np.int64), counts)

    widths = np.add.reduceat(span_sizes, lump_to_span[:-1]) \
        if num_spans else np.zeros(num_lumps, dtype=np.int64)
    widths[counts == 0] = 0
    rp_sizes = span_sizes[row_param]
    col_rows = np.zeros(num_lumps, dtype=np.int64)
    ne = col_start[1:] > col_start[:-1]
    sums = np.concatenate([[0], np.cumsum(rp_sizes)])
    col_rows = sums[col_start[1:]] - sums[col_start[:-1]]
    below = col_rows - widths

    levels = np.zeros(num_lumps, dtype=np.int64)
    for l in range(num_lumps):
        tls = span_to_lump[row_param[col_start[l]:col_start[l + 1]]]
        tls = np.unique(tls[tls > l])
        if len(tls):
            np.maximum.at(levels, tls, levels[l] + 1)

    seg = np.searchsorted(np.asarray(segment_bounds, dtype=np.int64),
                          np.arange(num_lumps), side="right")
    if pad_fn is not None:
        prp, cp = pad_fn(below, widths)
    else:
        prp, cp = below, widths
    order = np.lexsort((np.arange(num_lumps), cp, prp, levels, seg))

    # span renumbering: spans follow their lumps, preserving in-lump order
    new_span_order = np.concatenate(
        [np.arange(lump_to_span[o], lump_to_span[o + 1]) for o in order]) \
        if num_lumps else np.empty(0, np.int64)
    span_old_to_new = inverse_permutation(new_span_order)
    return order, span_old_to_new


def _bottom_permutation(settings: "Settings", ss: SparseStructure,
                        ss_bottom: SparseStructure, given_elim_end: int,
                        n_params: int) -> np.ndarray:
    """Ordering of the bottom (post-given-elim) system.

    Default is AMD (reference behavior, Solver.cpp:659). But when a given
    sparse elimination range dwarfs the bottom system AND its columns are
    LOCAL in user order (each eliminated block touches a narrow band of
    bottom rows — BA landmarks seeing a camera-trajectory window), AMD
    would scramble that band structure and with it the chunk locality the
    planned backend's dense updates depend on; reverse Cuthill-McKee
    preserves it at a modest fill cost on the (comparatively tiny) bottom
    factor. The within-range member sort + outlier routing downstream
    complete the picture.
    """
    if settings.backend == BackendType.PLANNED and given_elim_end > 0 \
            and given_elim_end >= 4 * ss_bottom.order:
        # median user-order spread of the elim columns' bottom rows
        rows = ss.expanded_rows()
        cols = ss.inds
        sel = (cols < given_elim_end) & (rows >= given_elim_end)
        if np.any(sel):
            r = rows[sel] - given_elim_end
            c = cols[sel]
            o = np.argsort(c, kind="stable")
            r, c = r[o], c[o]
            uniq, start_idx = np.unique(c, return_index=True)
            mx = np.maximum.reduceat(r, start_idx)
            mn = np.minimum.reduceat(r, start_idx)
            med = float(np.median(mx - mn)) if len(uniq) else 0.0
            if med <= ss_bottom.order / 8:
                # keep locality: the user's order already has it (that is
                # what the median-spread test established), so identity is
                # the natural candidate; RCM can beat it when the user
                # order is banded-but-sloppy. Pick by measured bandwidth.
                nb = ss_bottom.order
                er = ss_bottom.expanded_rows()
                ec = ss_bottom.inds

                def p90_bw(perm):
                    inv = np.empty(nb, np.int64)
                    inv[perm] = np.arange(nb)
                    return float(np.percentile(np.abs(inv[er] - inv[ec]),
                                               90)) if len(er) else 0.0

                ident = np.arange(nb, dtype=np.int64)
                rcm = ss_bottom.rcm_permutation()
                return ident if p90_bw(ident) <= p90_bw(rcm) else rcm
    return ss_bottom.fill_reducing_permutation()


def _pad_fn_for(settings: "Settings"):
    """Padded bucket storage for the planned backend; the reference
    backend keeps the packed layout."""
    if settings.backend == BackendType.PLANNED:
        from .ops.planned_backend import storage_pad
        return storage_pad
    return None


def _batched_factor_cost(et, pad_fn) -> float:
    """Modeled factor time of a merged tree under the BATCHED execution
    regime the planned backend actually runs: same-shape lumps of a level
    execute as ONE XLA op, levels are sequential, and each sequential op
    carries a dispatch/schedule overhead. The per-node polynomial the merge
    loop minimizes cannot express this (its constant terms charge per NODE;
    batching charges per BUCKET) — this evaluator re-prices a candidate
    tree post-merge:

      cost = sum_buckets [ ops(bucket) * C_DISPATCH + flops(bucket)/rate ]
           + num_levels * LEVEL_OPS * C_DISPATCH

    Constants come from computation_model.batched_regime_default
    (chained small-op overhead and effective f32-highest matmul rates at
    the panel shapes the backend emits; carried over unmeasured on the
    current GPU target). Used only to SELECT between merge candidates
    (see create_solver), never to drive the merge loop itself, so
    ranking fidelity is what matters, not absolute accuracy."""
    from .computation_model import batched_regime_default as brp
    from .utils import cum_sum_vec as _csv

    nl = len(et.lump_start) - 1
    if nl == 0:
        return 0.0
    widths = et.lump_start[1:] - et.lump_start[:-1]
    span_sizes = np.empty(len(et.param_size), dtype=np.int64)
    span_sizes[et.perm_inverse] = et.param_size
    rp_sizes = span_sizes[et.row_param]
    sums = np.concatenate([[0], np.cumsum(rp_sizes)])
    col_rows = sums[et.col_start[1:]] - sums[et.col_start[:-1]]
    below = col_rows - widths

    counts = et.lump_to_span[1:] - et.lump_to_span[:-1]
    span_to_lump = np.repeat(np.arange(nl, dtype=np.int64), counts)
    levels = np.zeros(nl, dtype=np.int64)
    for a in range(nl):
        tl = span_to_lump[et.row_param[et.col_start[a]:et.col_start[a + 1]]]
        tl = np.unique(tl[tl > a])
        if len(tl):
            np.maximum.at(levels, tl, levels[a] + 1)

    if pad_fn is not None:
        prp, pcp = pad_fn(below, widths)
    else:
        prp, pcp = below, widths

    t = float(levels.max() + 1) * brp.level_ops * brp.dispatch_overhead
    buckets = {}
    for a in range(nl):
        key = (int(levels[a]), int(pcp[a]), int(prp[a]))
        buckets[key] = buckets.get(key, 0) + 1
    for (_, s, r), B in buckets.items():
        # op counts per route; wide panels are still priced as 256-wide
        # block steps (a route since replaced by one cholesky) so that
        # merge plans stay as they were until the model is refit
        if s <= 8:
            ops = 3.0 * s          # unrolled tiny-panel chol/inverse
        elif s <= 256:
            ops = brp.bucket_ops   # native cholesky + trsm + read/write
        else:
            ops = brp.block_step_ops * ((s + 255) // 256)
        flops = B * (s ** 3 / 3.0 + s * s * r + s * r * r)
        # narrow panels underuse the matmul units: utilization modeled
        # as min(1, s/sat_width) (see BatchedRegimeParams provenance)
        util = min(1.0, max(s, 1) / brp.matmul_sat_width)
        t += ops * brp.dispatch_overhead + flops / (brp.matmul_rate * util)
    return t


def create_solver(settings: Settings, param_sizes, ss: SparseStructure,
                  sparse_elim_ranges: Sequence[int] = (),
                  elim_last_ids: Sequence[int] = ()) -> Solver:
    param_sizes = np.asarray(param_sizes, dtype=np.int64)
    sparse_elim_ranges = list(sparse_elim_ranges)
    elim_last = set(int(i) for i in elim_last_ids)
    assert settings.add_fill_policy == AddFillPolicy.COMPLETE or not elim_last
    assert len(sparse_elim_ranges) != 1
    given_elim_end = sparse_elim_ranges[-1] if sparse_elim_ranges else 0
    if sparse_elim_ranges:
        assert is_strictly_increasing(sparse_elim_ranges)
        for i in elim_last:
            assert i >= given_elim_end

    if settings.add_fill_policy != AddFillPolicy.NONE:
        for e in range(len(sparse_elim_ranges) - 1):
            ss = ss.add_independent_elimination_fill(
                sparse_elim_ranges[e], sparse_elim_ranges[e + 1])

    if settings.add_fill_policy in (AddFillPolicy.NONE,
                                    AddFillPolicy.FOR_GIVEN_ELIMS):
        n = len(param_sizes)
        span_start = cum_sum_vec(param_sizes)
        lump_to_span = np.arange(n + 1, dtype=np.int64)
        permutation = np.arange(n, dtype=np.int64)
        sst = ss.transpose()  # CSC columns of the lower half
        skel = CoalescedBlockMatrixSkel(span_start, lump_to_span,
                                        sst.ptrs, sst.inds,
                                        pad_fn=_pad_fn_for(settings))
        cfut = 0 if settings.add_fill_policy == AddFillPolicy.NONE \
            else given_elim_end
        return Solver(skel, sparse_elim_ranges, permutation,
                      settings.backend, cfut,
                      matmul_precision=settings.matmul_precision,
                      update_precision=settings.update_precision)

    ss_bottom = ss.extract_right_bottom(given_elim_end)
    perm = _bottom_permutation(settings, ss, ss_bottom, given_elim_end,
                               len(param_sizes))
    no_cross_points = []
    if elim_last:
        parts = ([], [])
        for p in perm:
            parts[int((p + given_elim_end) in elim_last)].append(int(p))
        no_cross_points.append(len(parts[0]))
        perm = np.array(parts[0] + parts[1], dtype=np.int64)
    inv_perm = inverse_permutation(perm)
    sorted_ss_bottom = ss_bottom.symmetric_permutation(inv_perm,
                                                      lower_half=True)
    sorted_bottom_param_size = np.empty(len(param_sizes) - given_elim_end,
                                        dtype=np.int64)
    sorted_bottom_param_size[inv_perm] = param_sizes[given_elim_end:]

    comp_model = settings.computation_model
    et = EliminationTree(sorted_bottom_param_size, sorted_ss_bottom,
                         comp_model)
    et.build_tree()
    et.process_tree(settings.find_sparse_elimination_ranges, no_cross_points,
                    settings.add_fill_policy == AddFillPolicy.FOR_AUTO_ELIMS)

    # Op-overhead-bound regime handling (PLANNED backend): when the bottom
    # system merges down to a handful of lumps, per-XLA-op launch/schedule
    # overhead — not flops — dominates the factor and especially the solve
    # (each lump level is a sequential op chain). The per-node polynomial
    # model cannot express this (its constant terms charge per NODE, while
    # batched execution charges per BUCKET), so in that regime we generate
    # alternative merge CANDIDATES by scaling the model's constant terms
    # (constants represent dispatch overhead; scaling asks "what if each
    # node carried the whole chain's overhead") and SELECT by the
    # batched-regime cost evaluator (_batched_factor_cost). The candidates
    # re-run only the merge phase — the symbolic fill from build_tree is
    # reused (et.remerge), so the expensive part of the analysis is not
    # repeated. Applies to user-provided models too: candidate generation
    # scales WHATEVER model is in effect. flat1000 goes from 32 lumps /
    # 3 levels to 2 lumps / 2 levels; grid/meridian/BA-scale problems
    # keep >100 lumps and never enter this path.
    n_bottom_lumps = len(et.lump_to_span) - 1
    n_auto_elim = (et.sparse_elim_ranges[-1] if et.sparse_elim_ranges
                   else 0)
    if (settings.backend == BackendType.PLANNED
            and n_auto_elim == 0 and 2 < n_bottom_lumps <= 64):
        from .computation_model import scale_constant_terms
        find_elims = settings.find_sparse_elimination_ranges
        only_elims = settings.add_fill_policy == AddFillPolicy.FOR_AUTO_ELIMS
        pad_fn = _pad_fn_for(settings)
        base = et.comp_model
        et.compute_aggregate_struct(only_elims)
        best = et.capture_merge_state()
        best_cost = _batched_factor_cost(et, pad_fn)
        for scale in (8.0, 64.0):
            et.remerge(scale_constant_terms(base, scale), find_elims,
                       no_cross_points, only_elims)
            if (len(et.lump_to_span) - 1 >= len(best["lump_to_span"]) - 1
                    or et.sparse_elim_ranges):
                continue  # not a coarser candidate
            et.compute_aggregate_struct(only_elims)
            cost = _batched_factor_cost(et, pad_fn)
            if cost < best_cost:
                best, best_cost = et.capture_merge_state(), cost
        et.restore_merge_state(best)
    else:
        et.compute_aggregate_struct(
            settings.add_fill_policy == AddFillPolicy.FOR_AUTO_ELIMS)

    et_total_inv_perm = compose_permutations(et.perm_inverse, inv_perm)
    full_inv_perm = np.concatenate([
        np.arange(given_elim_end, dtype=np.int64),
        given_elim_end + et_total_inv_perm])

    # Order each given sparse-elim range by padded panel SHAPE first, then
    # by its members' connected rows' positions in the FINAL ordering (any
    # order within an independent range is a valid elimination order with
    # identical fill). The shape-major key makes every (padded rows,
    # padded width) class one consecutive run of lumps — and hence of
    # panel STORAGE — so the planned backend's batched panel reads become
    # reshapes of contiguous slices instead of per-panel gathers. The
    # locality minor key keeps
    # same-neighborhood members adjacent WITHIN a shape class (BA:
    # landmarks sorted by camera) — and since buckets group by shape, the
    # chunked dense update sees the exact same member order as a pure
    # locality sort. The reference's CPU/GPU sparse elimination is
    # insensitive to all of this (per-row chains / atomics,
    # MatOpsCuda.cu:309); batched XLA execution is not.
    if sparse_elim_ranges:
        sst_cols = ss.transpose()  # lower-half columns: rows >= col
        col_of = np.repeat(np.arange(len(param_sizes), dtype=np.int64),
                           sst_cols.ptrs[1:] - sst_cols.ptrs[:-1])
        pad_fn = _pad_fn_for(settings)
        for e in range(len(sparse_elim_ranges) - 1):
            a, b = sparse_elim_ranges[e], sparse_elim_ranges[e + 1]
            sel = (col_of >= a) & (col_of < b) & (sst_cols.inds > col_of)
            cols = col_of[sel] - a
            vals = full_inv_perm[sst_cols.inds[sel]]
            keys = np.full(b - a, np.int64(1) << 60)
            if len(cols):
                uniq, start_idx = np.unique(cols, return_index=True)
                keys[uniq] = np.minimum.reduceat(vals, start_idx)
            if pad_fn is not None:
                # per-member below rows = total size of connected rows
                # (independent range: no internal edges, no fill lands in
                # these columns, no merging — matches the skeleton's
                # storage_pad input exactly)
                rows_tot = np.bincount(
                    cols, weights=param_sizes[sst_cols.inds[sel]],
                    minlength=b - a).astype(np.int64)
                prp, cp = pad_fn(rows_tot, param_sizes[a:b])
                order = np.lexsort((keys, prp, cp))
            else:
                order = np.argsort(keys, kind="stable")
            full_inv_perm[a:b] = a + inverse_permutation(order)

    full_span_start = np.zeros(len(param_sizes), dtype=np.int64)
    full_span_start[full_inv_perm] = param_sizes
    full_span_start = cum_sum_vec(full_span_start)

    full_lump_to_span = np.concatenate([
        np.arange(given_elim_end, dtype=np.int64),
        given_elim_end + et.lump_to_span])
    assert len(full_span_start) - 1 == full_lump_to_span[-1]

    sorted_sst = ss.symmetric_permutation(full_inv_perm,
                                          lower_half=True).transpose()
    elim_end_data_ptr = int(sorted_sst.ptrs[given_elim_end])
    full_col_start = np.concatenate([
        sorted_sst.ptrs[:given_elim_end],
        elim_end_data_ptr + et.col_start])
    full_row_param = np.concatenate([
        sorted_sst.inds[:elim_end_data_ptr],
        given_elim_end + et.row_param])
    assert len(full_col_start) == len(full_lump_to_span)
    assert len(full_row_param) == full_col_start[-1]

    full_ranges = list(sparse_elim_ranges)
    if et.sparse_elim_ranges:
        skip = 1 if sparse_elim_ranges else 0
        full_ranges += [given_elim_end + r
                        for r in et.sparse_elim_ranges[skip:]]
    if len(full_ranges) == 1:
        full_ranges = []
    full_elim_end = full_ranges[-1] if full_ranges else 0

    if settings.level_reorder:
        # optional: reorder lumps to (segment, level, shape) so
        # planned-backend buckets become contiguous storage slices
        span_sizes = full_span_start[1:] - full_span_start[:-1]
        segment_bounds = sorted(set(
            list(full_ranges[1:]) +
            ([len(param_sizes) - len(elim_last)] if elim_last else [])))
        lump_order, span_old_to_new = _level_shape_reorder(
            span_sizes, full_lump_to_span, full_col_start, full_row_param,
            segment_bounds, _pad_fn_for(settings))
        counts = (full_lump_to_span[1:] - full_lump_to_span[:-1])[lump_order]
        full_lump_to_span = cum_sum_vec(counts)
        new_span_sizes = np.empty_like(span_sizes)
        new_span_sizes[span_old_to_new] = span_sizes
        full_span_start = cum_sum_vec(new_span_sizes)
        col_lens_old = full_col_start[1:] - full_col_start[:-1]
        col_lens = col_lens_old[lump_order]
        new_col_start = cum_sum_vec(col_lens)
        new_row_param = np.empty_like(full_row_param)
        old_col_start = full_col_start
        for k, o in enumerate(lump_order):
            rows = span_old_to_new[
                full_row_param[old_col_start[o]:old_col_start[o + 1]]]
            rows.sort()
            new_row_param[new_col_start[k]:new_col_start[k + 1]] = rows
        full_col_start = new_col_start
        full_row_param = new_row_param
        full_inv_perm = span_old_to_new[full_inv_perm]

    skel = CoalescedBlockMatrixSkel(full_span_start, full_lump_to_span,
                                    full_col_start, full_row_param,
                                    pad_fn=_pad_fn_for(settings))

    cfut = (full_elim_end
            if settings.add_fill_policy == AddFillPolicy.FOR_AUTO_ELIMS
            else len(param_sizes))
    return Solver(skel, full_ranges, full_inv_perm, settings.backend, cfut,
                  matmul_precision=settings.matmul_precision,
                  update_precision=settings.update_precision)
