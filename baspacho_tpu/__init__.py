"""baspacho_tpu — batched supernodal sparse Cholesky in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
facebookresearch/baspacho: host-side symbolic analysis emits static block
plans; numeric factor/solve run as shape-static jitted programs over flat
device buffers, with batching as a vmapped leading axis and multi-device
scaling via jax.sharding.
"""

def _tune_malloc():
    """Route large allocations through the reusable heap instead of
    per-allocation mmap/munmap. Symbolic analysis at BAL scale churns
    through GBs of large numpy temporaries; glibc munmaps each on free,
    so every one pays first-touch page faults again — and under
    sandboxed/virtualized kernels a fault costs ~100x bare metal
    (on a sandboxed VM, first touch of a fresh 76 MB buffer took ~6 s,
    reused heap memory ~60 ms)."""
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 256 << 20)
    except Exception:
        pass


_tune_malloc()

from .sparse_structure import SparseStructure
from .block_matrix import CoalescedBlockMatrixSkel
from .accessor import CoalescedAccessor, PermutedCoalescedAccessor
from .computation_model import ComputationModel
from .solver import (
    AddFillPolicy,
    BackendType,
    Settings,
    Solver,
    create_solver,
)
from .utils import (
    cum_sum_vec,
    inverse_permutation,
    compose_permutations,
    left_permute,
)

__all__ = [
    "SparseStructure",
    "CoalescedBlockMatrixSkel",
    "CoalescedAccessor",
    "PermutedCoalescedAccessor",
    "ComputationModel",
    "AddFillPolicy",
    "BackendType",
    "Settings",
    "Solver",
    "create_solver",
    "cum_sum_vec",
    "inverse_permutation",
    "compose_permutations",
    "left_permute",
]
