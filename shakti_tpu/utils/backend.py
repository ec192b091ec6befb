"""Device helpers for the entry points: the persistent XLA compilation
cache, and the GPU gate that every timing script passes before it measures.

Large-mesh compiles take minutes, and the reference's PETSc stack has no
compile step at all; the cache removes the cost from every run after the
first.  The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set,
and otherwise the fixed ``<checkout>/.jax_cache`` (git-ignored).  The path
is part of what a later run looks up, so it never depends on a temporary
name, a process id or the time.
"""

from __future__ import annotations

import os

# Published HBM bandwidth per card, GB/s, keyed by jax device_kind (NVIDIA
# H100 data sheet: SXM5 80 GB HBM3 3.35 TB/s, PCIe 80 GB HBM2e 2.0 TB/s).
# A device missing here is an error in the scripts that divide by it.
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0, "NVIDIA H100 PCIe": 2000.0}

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory :func:`enable_compile_cache` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return that directory.  Call before the first compilation."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def nvidia_smi() -> str:
    """Name and power limit of the local GPUs, one line per card, exactly
    as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them.  Run it before JAX opens the card; raises when the tool
    is missing or fails."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(count: int = 1):
    """The first JAX device, or SystemExit when it is not a GPU or there
    are fewer than ``count`` devices: timings and checks taken on any
    other backend must never pass for GPU results (no CPU fallback)."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(f"error: this needs an NVIDIA GPU; JAX found "
                         f"'{dev.platform}'")
    if len(devices) < count:
        raise SystemExit(f"error: this needs {count} GPUs, JAX found "
                         f"{len(devices)}")
    return dev
