"""CPU-side checks of the GPU entry points: chip_smoke.py refuses to run
without a GPU (there is no CPU fallback), and the persistent compile
cache lands where enable_compile_cache says."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On a CPU-only platform, and in a directory holding nothing of the
    repo but the script, chip_smoke.py exits non-zero and prints no
    result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=_cpu_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")


def test_compile_cache_default_path():
    """Without JAX_COMPILATION_CACHE_DIR the cache is the fixed
    <checkout>/.jax_cache (a moving path would never hit)."""
    import jax

    from baspacho_tpu.utils import enable_compile_cache

    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes")}
    env = os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    try:
        path = enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert enable_compile_cache() == path  # stable across calls
    finally:
        if env is not None:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env
        for k, v in saved.items():
            jax.config.update(k, v)


def test_compile_cache_env_dir_receives_entries(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land in that
    directory and nowhere else."""
    cache = tmp_path / "cache"
    env = _cpu_env()
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from baspacho_tpu.utils import enable_compile_cache\n"
        "p = enable_compile_cache()\n"
        "import jax, jax.numpy as jnp\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(7)).block_until_ready()\n"
        "print(p)\n" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == str(cache)
    assert cache.is_dir() and any(cache.iterdir())
