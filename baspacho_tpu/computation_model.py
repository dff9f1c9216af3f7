"""Polynomial timing models for the fundamental factor operations.

Drives the supernode-merge heuristic: merging two elimination-tree nodes is
accepted when the modelled time of the merged node's ops is below the sum
for the separate nodes. Functional counterpart of the reference
ComputationModel (/root/reference/baspacho/baspacho/ComputationModel.{h,cpp})
with the same model forms:

  potrf: t ~ a + b n + c n^2 + d n^3
  trsm : t ~ a + b n + c n^2 + (d + e n + f n^2) k
  syge : symmetrized gemm/syrk model in u=m+n, v=mn:
         t ~ a + b u + c v + (d + e u + f v) k
  asmbl: t ~ a + b br + c bc + d br bc

The shipped default constants are hand-set for the planned backend
(batched XLA ops over bucketed supernodes); tools/fit_computation_model.py
fits replacements on the device. A CPU (XLA-on-host) model is included
for the test path. Coefficients are in seconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ComputationModel:
    potrf_params: np.ndarray  # (4,)
    trsm_params: np.ndarray   # (6,)
    syge_params: np.ndarray   # (6,)
    asmbl_params: np.ndarray  # (4,)

    def __post_init__(self):
        self.potrf_params = np.asarray(self.potrf_params, dtype=np.float64)
        self.trsm_params = np.asarray(self.trsm_params, dtype=np.float64)
        self.syge_params = np.asarray(self.syge_params, dtype=np.float64)
        self.asmbl_params = np.asarray(self.asmbl_params, dtype=np.float64)

    # --- point estimates -------------------------------------------------
    def potrf_est(self, n: float) -> float:
        p = self.potrf_params
        return p[0] + n * (p[1] + n * (p[2] + n * p[3]))

    def trsm_est(self, n: float, k: float) -> float:
        p = self.trsm_params
        return p[0] + n * (p[1] + n * p[2]) + k * (p[3] + n * (p[4] + n * p[5]))

    def syge_est(self, m: float, n: float, k: float) -> float:
        p = self.syge_params
        u, v = m + n, m * n
        return p[0] + u * p[1] + v * p[2] + k * (p[3] + u * p[4] + v * p[5])

    def asmbl_est(self, br: float, bc: float) -> float:
        p = self.asmbl_params
        return p[0] + br * p[1] + bc * p[2] + br * bc * p[3]

    # --- linear-in-k forms used by the merge loop ------------------------
    def syge_lin_est(self, m: float, n: float) -> np.ndarray:
        """Cost of the syge update against rows (m, n) as (const, per-k)."""
        p = self.syge_params
        u, v = m + n, m * n
        return np.array([p[0] + u * p[1] + v * p[2],
                         p[3] + u * p[4] + v * p[5]])

    def asmbl_lin_est(self, br: float) -> np.ndarray:
        p = self.asmbl_params
        return np.array([p[0] + br * p[1], p[2] + br * p[3]])

    # --- design-matrix rows (for least-squares fitting) ------------------
    @staticmethod
    def d_potrf(n):
        n = np.asarray(n, dtype=np.float64)
        return np.stack([np.ones_like(n), n, n * n, n * n * n], axis=-1)

    @staticmethod
    def d_trsm(n, k):
        n = np.asarray(n, dtype=np.float64)
        k = np.asarray(k, dtype=np.float64)
        return np.stack([np.ones_like(n), n, n * n, k, k * n, k * n * n],
                        axis=-1)

    @staticmethod
    def d_syge(m, n, k):
        m = np.asarray(m, dtype=np.float64)
        n = np.asarray(n, dtype=np.float64)
        k = np.asarray(k, dtype=np.float64)
        u, v = m + n, m * n
        return np.stack([np.ones_like(u), u, v, k, k * u, k * v], axis=-1)

    @staticmethod
    def d_asmbl(br, bc):
        br = np.asarray(br, dtype=np.float64)
        bc = np.asarray(bc, dtype=np.float64)
        return np.stack([np.ones_like(br), br, bc, br * bc], axis=-1)


# Default model for the planned (batched XLA) numeric backend. The shape
# encodes what the merge heuristic must know: op *launch* overhead
# dominates until supernodes are large (matmul units idle on tiny blocks),
# so constants are relatively large and cubic terms relatively small —
# pushing the heuristic to merge more aggressively than a CPU model would.
#
# Provenance: hand-estimated for an earlier accelerator target (a
# ~2e13 flop/s f32 matmul rate, ~2-8 us per-op overhead) and sanity-
# anchored against whole-factor times there — NOT a per-op fit, and
# carried over unmeasured on the current GPU target. Changing them
# changes plans, which is a measured performance change: fit a
# replacement on the card with tools/fit_computation_model.py
# (Solver.profile_ops -> stats.fit_computation_model). Because same-shape
# supernodes execute as one batched XLA op, a per-node polynomial
# under-prices small supernodes in well-batched regimes; create_solver
# therefore generates coarser merge candidates (scale_constant_terms) in
# the op-overhead-bound regime (<=64 bottom lumps) and selects by the
# batched-regime evaluator below (BatchedRegimeParams).
model_default = ComputationModel(
    potrf_params=[6.0e-06, 2.0e-09, 5.0e-10, 6.5e-12],
    trsm_params=[7.0e-06, 1.0e-08, 1.5e-10, 3.0e-08, 1.2e-09, 1.6e-11],
    syge_params=[8.0e-06, 2.0e-08, 8.0e-11, 2.0e-08, 5.0e-10, 8.0e-12],
    asmbl_params=[4.0e-06, 5.0e-08, 3.0e-07, 2.5e-08],
)

def scale_constant_terms(model: ComputationModel,
                         scale: float) -> ComputationModel:
    """Scale only the CONSTANT terms of a model. The constants represent
    per-op dispatch/launch overhead; in the batched regime a node shares
    its dispatch with every same-shape node of its level, so scaled
    constants answer "what if each node carried its whole chain's
    overhead" — used by create_solver to GENERATE coarser merge
    candidates, which are then selected by the honest batched-regime
    evaluator (solver._batched_factor_cost)."""
    return ComputationModel(
        potrf_params=model.potrf_params * [scale, 1, 1, 1],
        trsm_params=model.trsm_params * [scale, 1, 1, 1, 1, 1],
        syge_params=model.syge_params * [scale, 1, 1, 1, 1, 1],
        asmbl_params=model.asmbl_params * [scale, 1, 1, 1])


@dataclass
class BatchedRegimeParams:
    """Constants for the batched-regime cost evaluator
    (solver._batched_factor_cost): per-op overhead, matmul rate and the
    panel width where matmul utilization saturates."""
    dispatch_overhead: float  # s per sequential XLA op inside a program
    matmul_rate: float        # flop/s, f32-highest, large panels
    matmul_sat_width: float   # panel width where matmul rate saturates
    bucket_ops: float         # XLA ops per factor bucket (cp <= 256)
    block_step_ops: float     # XLA ops per 256-block step (wide panels)
    level_ops: float          # XLA ops per level's update/assembly


# Carried over unmeasured on the current GPU target from an earlier
# accelerator's chained-op timings (per-op slope ~55 us, f32 matmul
# ~29 Tflop/s saturating at width 1024, ~6 ops per bucket). They only
# RANK merge candidates; refitting them is a measured performance change.
batched_regime_default = BatchedRegimeParams(
    dispatch_overhead=5.5e-05,
    matmul_rate=2.9e13,
    matmul_sat_width=1024.0,
    bucket_ops=6.0,
    block_step_ops=6.0,
    level_ops=12.0,
)


# Model for the host (CPU XLA) path used in tests.
model_cpu_default = ComputationModel(
    potrf_params=[2.0e-06, 1.0e-09, 1.2e-09, 3.0e-11],
    trsm_params=[2.0e-06, 5.0e-09, 1.0e-10, 1.0e-08, 8.0e-10, 6.0e-11],
    syge_params=[3.0e-06, 1.0e-08, 5.0e-11, 1.0e-08, 4.0e-10, 3.5e-11],
    asmbl_params=[1.0e-06, 2.0e-08, 1.0e-07, 1.5e-08],
)
