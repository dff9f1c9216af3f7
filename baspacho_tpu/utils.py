"""Small host-side helpers shared across the symbolic layer.

Mirrors the role of the reference's utility layer (see
/root/reference/baspacho/baspacho/Utils.{h,cpp}), re-expressed with NumPy
idioms: permutation algebra, cumulative offsets, and the per-op timing
stats (`OpStat`) used for profiling and computation-model fitting.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


def cum_sum_vec(sizes) -> np.ndarray:
    """[s0, s1, ..., sn] -> exclusive prefix sums [0, s0, s0+s1, ...].

    Input of length n produces output of length n+1 (offsets-with-end form).
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    out = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=out[1:])
    return out


def inverse_permutation(perm) -> np.ndarray:
    """inv[perm[i]] = i."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    return inv


def compose_permutations(v, w) -> np.ndarray:
    """retv[i] = v[w[i]] (matches reference Utils.cpp:70-78 semantics)."""
    v = np.asarray(v, dtype=np.int64)
    w = np.asarray(w, dtype=np.int64)
    assert len(v) == len(w)
    return v[w]


def left_permute(perm, values) -> np.ndarray:
    """out[perm[i]] = values[i]."""
    perm = np.asarray(perm, dtype=np.int64)
    values = np.asarray(values)
    out = np.empty_like(values)
    out[perm] = values
    return out


def is_strictly_increasing(v) -> bool:
    v = np.asarray(v)
    return len(v) < 2 or bool(np.all(v[1:] > v[:-1]))


@dataclass
class OpStat:
    """Accumulating timer for one category of numeric op.

    Counterpart of the reference's RAII `OpStat` (Utils.h:49-121): tracks
    number of runs, total/max/last times, and an optional callback that
    receives (time, *args) — used by the bench tool to dump per-op CSVs
    for computation-model fitting.
    """

    enabled: bool = False
    num_runs: int = 0
    total_time: float = 0.0
    max_time: float = 0.0
    last_time: float = 0.0
    callback: Optional[Callable] = None

    def reset(self) -> None:
        self.num_runs = 0
        self.total_time = 0.0
        self.max_time = 0.0
        self.last_time = 0.0

    def record(self, seconds: float, *args) -> None:
        self.num_runs += 1
        self.last_time = seconds
        self.total_time += seconds
        self.max_time = max(self.max_time, seconds)
        if self.callback is not None:
            self.callback(seconds, *args)

    class _Timer:
        def __init__(self, stat: "OpStat", args: tuple):
            self.stat = stat
            self.args = args
            self.t0 = 0.0

        def __enter__(self):
            if self.stat.enabled:
                self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if self.stat.enabled:
                self.stat.record(time.perf_counter() - self.t0, *self.args)
            return False

    def instance(self, *args) -> "_Timer":
        return OpStat._Timer(self, args)

    def __str__(self) -> str:
        if self.num_runs == 0:
            return "no runs"
        avg = self.total_time / self.num_runs
        return (
            f"#runs: {self.num_runs}, tot: {self.total_time * 1e3:.3f}ms, "
            f"avg: {avg * 1e3:.3f}ms, max: {self.max_time * 1e3:.3f}ms, "
            f"last: {self.last_time * 1e3:.3f}ms"
        )


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is used as it is and no other
    path is set. Otherwise the cache lives at the fixed
    `<checkout>/.jax_cache`, so that every run from one checkout finds
    the programs of the runs before it."""
    import os

    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    # cache every program: the planned backend's compiles are seconds to
    # minutes each, and even small ones repeat across runs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def with_matmul_precision(fn, precision: str = "highest"):
    """Wrap `fn` so it traces under jax.default_matmul_precision(...).

    A float32 dot at default precision may run at reduced precision (TF32
    on the GPU's tensor cores, ~10-bit mantissa); all library numeric ops
    trace at highest precision to honor the reference's float accuracy
    contract (see Solver._get)."""
    import functools

    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(precision):
            return fn(*args, **kwargs)

    return wrapped
