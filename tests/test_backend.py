"""Device layer: compile-cache location, the GPU gate of chip_smoke.py and
the timing scripts, the operator-format rule, matmul precision, multi-host
initialization, and chip_smoke's phases rehearsed at toy sizes on the CPU.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import setups.setup_slab as slab
from shakti_tpu.utils import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    was = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", was)


def test_compile_cache_follows_env(tmp_path, monkeypatch, restore_cache_dir):
    cdir = str(tmp_path / "jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cdir)
    assert backend.enable_compile_cache() == cdir
    assert jax.config.jax_compilation_cache_dir == cdir
    assert os.path.isdir(cdir)


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch,
                                                      restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert backend.enable_compile_cache() == want
    assert backend.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    # another process, another working directory: the same path
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = subprocess.run(
        [sys.executable, "-c",
         "from shakti_tpu.utils.backend import compile_cache_dir;"
         "print(compile_cache_dir())"],
        cwd="/", env=dict(env, PYTHONPATH=ROOT), capture_output=True,
        text=True, check=True)
    assert out.stdout.strip() == want


def test_chip_smoke_refuses_cpu_device():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        backend.require_gpu()
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        backend.require_gpu(4)


def test_chip_smoke_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("phase", ["main_path", "precision", "goldens",
                                   "formats", "determinism", "adjoint",
                                   "sharded"])
def test_chip_smoke_phase_at_toy_size(phase, tmp_path, monkeypatch,
                                      restore_cache_dir):
    """Each chip_smoke phase runs and passes its own checks on the CPU at
    a toy size (the card runs them at 12,270 nodes)."""
    monkeypatch.delenv("SHAKTI_MESH_DIR", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    run = {
        "main_path": lambda: chip_smoke.phase_main_path(
            str(tmp_path), mesh_dir=None, days=1, resume_days=2,
            nt_per_day=4),
        "precision": lambda: chip_smoke.phase_precision(nx=8, n_steps=4),
        "goldens": chip_smoke.phase_goldens,
        "formats": lambda: chip_smoke.phase_formats(nx=8, window=4, reps=3),
        "determinism": lambda: chip_smoke.phase_determinism(mesh_dir=None,
                                                            n_steps=4),
        "adjoint": lambda: chip_smoke.phase_adjoint(nx=8, n_steps=3),
        "sharded": lambda: chip_smoke.phase_sharded(4, mesh_dir=None,
                                                    n_steps=2),
    }[phase]
    out = run()
    assert out and all(v is None or np.all(np.isfinite(v))
                       for v in _leaves(out))
    if phase == "main_path":
        assert out["steps"] == 4 and out["resume_steps"] == 4


def _leaves(d):
    for v in d.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif not isinstance(v, str):
            yield v


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke test on the card (python -m pytest -m gpu on a GPU
    host); skips where nvidia-smi finds no GPU."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this host")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    assert '"ok": true' in r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("fmt", ["ell", "bell", "bcsr"])
def test_every_dot_in_the_step_is_highest_precision(fmt):
    """No float32 contraction of the production step may run at reduced
    (TF32) precision: every dot_general carries HIGHEST."""
    from shakti_tpu.solve.timestep import make_step_fn

    md = slab.initialize(nx=12, ny=12, days=1.0, nt_per_day=24)
    md.dtype = jnp.float32
    md.operator = fmt
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    text = jax.jit(step).lower(state, jnp.float32(3600.0)).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, "no dot_general in the lowered step"
    low = [ln for ln in dots
           if "precision = [HIGHEST, HIGHEST]" not in ln]
    assert not low, low[:3]


@pytest.mark.parametrize("backend_name", ["cpu", "gpu"])
def test_auto_operator_is_ell_on_every_backend(backend_name, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend_name)
    md = slab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    assert md.operator == "auto"
    mesh, *_ = md.freeze()
    assert mesh.ell_cols is not None
    assert mesh.bell_nbr is None and mesh.bcsr_brow is None
    assert md.node_iperm is None


def test_init_multihost_raises_when_initialize_fails(monkeypatch):
    from shakti_tpu.utils import multihost

    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="unreachable"):
        multihost.init_multihost("localhost:1", num_processes=2,
                                 process_id=0)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="unreachable"):
        multihost.init_multihost()
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    assert multihost.init_multihost() == (1, 0, True)
