"""Preconditioners for PCG on the (partially factored) bottom-right corner.

Functional counterparts of the reference Preconditioner.h:15-206,
rebuilt batched: Jacobi gathers all span diagonal blocks of the corner
into same-size batches and runs ONE batched Cholesky / triangular solve
(the reference loops spans serially); Gauss-Seidel reuses the solver's
pseudo-factor and partial solves; the lower-precision preconditioner runs
the whole corner factorization in float32 (the counterpart of the
reference's double->float trick) with escalating damping until finite.

All preconditioners follow the same protocol:
  init(mat_data)  -> precomputes from matrix numeric data
  apply(v)        -> returns M^-1 v (identity outside the corner)
"""

from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np


class IdentityPrecond:
    def __init__(self, solver, span_index: int):
        pass

    def init(self, data):
        pass

    def apply(self, v):
        return v


class BlockJacobiPrecond:
    """Per-span diagonal block inverse via batched Cholesky."""

    def __init__(self, solver, span_index: int):
        self.solver = solver
        sk = solver.skel
        span_size = sk.span_start[1:] - sk.span_start[:-1]
        buckets: Dict[int, List[int]] = {}
        for s in range(span_index, sk.num_spans):
            buckets.setdefault(int(span_size[s]), []).append(s)
        from ..accessor import CoalescedAccessor
        acc = CoalescedAccessor(sk)
        self.buckets = []
        for size, spans in sorted(buckets.items()):
            offs, strides = acc.diag_block_offset(np.array(spans))
            offs = np.atleast_1d(offs)
            strides = np.atleast_1d(strides)
            gidx = offs[:, None, None] + \
                np.arange(size)[None, :, None] * strides[:, None, None] + \
                np.arange(size)[None, None, :]
            vec = sk.span_start[np.array(spans)][:, None] + \
                np.arange(size)[None, :]
            self.buckets.append((size, jnp.asarray(gidx), jnp.asarray(vec)))
        self._ls = None

    def init(self, data):
        data = jnp.asarray(data)
        ls = []
        for size, gidx, vec in self.buckets:
            blocks = data[gidx]
            blocks = jnp.tril(blocks) + \
                jnp.swapaxes(jnp.tril(blocks, -1), -1, -2)
            ls.append(jax.lax.linalg.cholesky(blocks,
                                              symmetrize_input=False))
        self._ls = ls

    def apply(self, v):
        v = jnp.asarray(v)
        vec1d = v.ndim == 1
        if vec1d:
            v = v[:, None]
        out = v
        for (size, gidx, vec), L in zip(self.buckets, self._ls):
            x = v[vec]  # (B, size, k)
            x = jax.lax.linalg.triangular_solve(L, x, left_side=True,
                                                lower=True)
            x = jax.lax.linalg.triangular_solve(L, x, left_side=True,
                                                lower=True, transpose_a=True)
            out = out.at[vec].set(x)
        return out[:, 0] if vec1d else out


class BlockGaussSeidelPrecond:
    """Pseudo-factor of the corner (per-span diag Cholesky + column
    normalization) used as a forward/backward Gauss-Seidel sweep."""

    def __init__(self, solver, span_index: int):
        self.solver = solver
        self.span_index = span_index
        self._pseudo = None

    def init(self, data):
        self._pseudo = self.solver.pseudo_factor_from(jnp.asarray(data),
                                                      self.span_index)

    def apply(self, v):
        s = self.span_index
        v = self.solver.solve_l_from(self._pseudo, s, v)
        return self.solver.solve_lt_from(self._pseudo, s, v)


class LowerPrecSolvePrecond:
    """Factor the corner in float32 (escalating damping until finite) and
    use f32 solves as the preconditioner for an f64 outer solve."""

    def __init__(self, solver, span_index: int, max_tries: int = 12):
        self.solver = solver
        self.span_index = span_index
        self.max_tries = max_tries
        self._factor = None

    def init(self, data):
        data32 = jnp.asarray(data, jnp.float32)
        sk = self.solver.skel
        damp_idx = jnp.asarray(sk.damp_indices())
        beta = 0.0
        for i in range(self.max_tries):
            trial = data32 if beta == 0.0 else \
                data32.at[damp_idx].mul(1.0 + beta)
            f = self.solver.factor_from(trial, self.span_index)
            if bool(jnp.all(jnp.isfinite(f))):
                self._factor = f
                return
            beta = 1e-4 * (4.0 ** i)
        raise RuntimeError("LowerPrecSolvePrecond: factorization stayed "
                           "non-finite under escalating damping")

    def apply(self, v):
        v = jnp.asarray(v)
        v32 = v.astype(jnp.float32)
        s = self.span_index
        v32 = self.solver.solve_l_from(self._factor, s, v32)
        v32 = self.solver.solve_lt_from(self._factor, s, v32)
        return v32.astype(v.dtype)
