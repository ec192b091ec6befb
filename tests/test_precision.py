"""Precision regression guard: the float32 path (the production mode)
must track float64 through a transient (SURVEY §7 hard part 1 — this is the
framework's central numerical risk; ad-hoc studies measured ~1e-5–1e-4
relative over hundreds of steps)."""

import jax
import jax.numpy as jnp
import numpy as np

import setups.setup_slab as slab
from shakti_tpu.solve.timestep import make_step_fn, run_window


def run(dtype, n=120):
    md = slab.initialize(nx=12, ny=12, days=10.0, nt_per_day=6, moulin_Q=0.5)
    md.dtype = dtype
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = jnp.full(n, 3600.0, dtype)
    s, d = jax.jit(lambda a, b: run_window(step, a, b))(state, dts)
    assert bool(np.asarray(d["converged"]).all())
    return s


def test_f32_tracks_f64():
    s64 = run(jnp.float64)
    s32 = run(jnp.float32)
    for field, tol in (("N", 2e-3), ("b", 1e-3)):
        a = np.asarray(getattr(s32, field), np.float64)
        r = np.asarray(getattr(s64, field), np.float64)
        err = np.linalg.norm(a - r) / np.linalg.norm(r)
        assert err < tol, (field, err)


def test_f32_tracks_f64_on_benchmark_catchment():
    """Same guard on the committed Cook_E2-equivalent basin mesh — the
    headline-benchmark mesh (irregular boundary, jittered unstructured
    interior, rougher element quality than the rectangle cases)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import build_bench_model

    def run(dtype, n=96):
        md = build_bench_model()
        md.dtype = dtype
        mesh, static, state, cfg = md.freeze()
        step = make_step_fn(mesh, static, md.params, cfg)
        dts = jnp.full(n, 3600.0, dtype)
        s, d = jax.jit(lambda a, b: run_window(step, a, b))(state, dts)
        assert bool(np.asarray(d["converged"]).all())
        return s

    s64 = run(jnp.float64)
    s32 = run(jnp.float32)
    for field, tol in (("N", 2e-3), ("b", 2e-3)):
        a = np.asarray(getattr(s32, field), np.float64)
        r = np.asarray(getattr(s64, field), np.float64)
        err = np.linalg.norm(a - r) / np.linalg.norm(r)
        assert err < tol, (field, err)
