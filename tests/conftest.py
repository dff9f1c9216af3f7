"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64.

The suite validates numerics (float64 oracles need the CPU) and
multi-device sharding (8 virtual devices, as
__graft_entry__.dryrun_multichip uses). On-card behavior is exercised by
chip_smoke.py, bench.py and the `gpu`-marked slice
(tests/test_gpu_device.py), which a run selects with `-m gpu`: that run
keeps the ambient platform so JAX finds the card.
"""

import os
import sys


def _gpu_mode(argv) -> bool:
    """True iff the run selects the on-card slice (`-m gpu`)."""
    for i, a in enumerate(argv):
        if a == "-m" and i + 1 < len(argv) and argv[i + 1].strip() == "gpu":
            return True
        if a in ("-mgpu", "-m=gpu"):
            return True
    return False


if not _gpu_mode(sys.argv):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: on-card accuracy tests; skip without a GPU "
        "(run: python -m pytest -m gpu tests/test_gpu_device.py)")
