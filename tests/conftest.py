"""Test configuration: CPU backend with 8 virtual devices, float64.

Multi-device behavior is exercised on a simulated 8-device CPU mesh
(SURVEY §4 item 4) — the replacement for the reference's "just run
mpirun -np 8" verification strategy.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
