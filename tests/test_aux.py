"""Auxiliary subsystems: ensembles, adaptive dt, polygon meshing, profiling."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import setups.setup_slab as slab
from shakti_tpu.parallel.ensemble import (make_ensemble_runner,
                                          perturbed_ensemble)
from shakti_tpu.solve.timestep import make_step_fn, timestep_sizes
from shakti_tpu.utils.profiling import Timer, time_fn


def test_ensemble_vmap_matches_member_runs():
    md = slab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    mesh, static, state, cfg = md.freeze()
    ens = perturbed_ensemble(state, 3, b_scale=2e-4, seed=1)
    runner = make_ensemble_runner(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:3]
    out, diags = runner(ens, dts)
    assert out.N.shape == (3,) + state.N.shape
    assert bool(np.asarray(diags["converged"]).all())

    # member 1 run alone must match its slot in the batch
    single = jax.tree_util.tree_map(lambda x: x[1], ens)
    step = make_step_fn(mesh, static, md.params, cfg)
    from shakti_tpu.solve.timestep import run_window
    s1, _ = jax.jit(lambda s, d: run_window(step, s, d))(single, dts)
    np.testing.assert_allclose(np.asarray(out.N[1]), np.asarray(s1.N),
                               rtol=1e-10)


def test_ensemble_runs_under_lag_config():
    """The ensemble runner must work when the incoming config has
    lag_operator on (the block-ELL auto config): vmap lowers lax.cond to
    select (both branches execute), so make_ensemble_step_fn forces the
    plain path and members carry no lag tuple — previously the runner
    failed at trace time with a scan-carry pytree mismatch."""
    md = slab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    md.solver = dataclasses.replace(md.solver, lag_operator=True,
                                    adaptive_dt_levels=0)
    mesh, static, state, cfg = md.freeze()
    assert state.lag_op is not None          # single-run path keeps the carry
    ens = perturbed_ensemble(state, 2, b_scale=2e-4, seed=1)
    assert ens.lag_op is None                # ensemble path drops it
    runner = make_ensemble_runner(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:2]
    out, diags = runner(ens, dts)
    assert bool(np.asarray(diags["converged"]).all())


def test_adaptive_dt_halving_control_flow():
    """Unit test of the dt-halving retry wiring with a stub step that
    succeeds only below a dt threshold."""
    from shakti_tpu.solve.timestep import with_dt_halving

    def base(state, dt):
        ok = dt < 1000.0
        diag = {"newton_iters": jnp.asarray(1), "rnorm": dt,
                "rnorm0": dt, "converged": ok, "cg_iters": jnp.asarray(1)}
        return state + dt, diag

    one = with_dt_halving(base, 0)
    two = with_dt_halving(one, 1)

    # dt below threshold: taken directly
    s, d = jax.jit(one)(jnp.asarray(0.0), jnp.asarray(800.0))
    assert bool(d["converged"]) and float(s) == 800.0
    # dt needing one halving: two sub-steps of dt/2
    s, d = jax.jit(one)(jnp.asarray(0.0), jnp.asarray(1500.0))
    assert bool(d["converged"]) and float(s) == 1500.0
    assert int(d["newton_iters"]) == 2
    # dt needing two halvings
    s, d = jax.jit(two)(jnp.asarray(0.0), jnp.asarray(3000.0))
    assert bool(d["converged"]) and float(s) == 3000.0
    assert int(d["newton_iters"]) == 4
    # beyond the available levels: reported unconverged
    s, d = jax.jit(one)(jnp.asarray(0.0), jnp.asarray(5000.0))
    assert not bool(d["converged"])


def test_adaptive_dt_deepens_convergence():
    """Integration: with a crippled Newton budget, halving levels drive the
    final step residual orders of magnitude lower."""
    md = slab.initialize(nx=10, ny=10, days=1.0, nt_per_day=4)
    mesh, static, state, cfg = md.freeze()

    def final_rnorm(levels):
        hard = dataclasses.replace(cfg, max_iter=3, stall_patience=50,
                                   stall_rtol=1e-30, inc_rtol=0.0,
                                   extrapolate_guess=False,
                                   adaptive_dt_levels=levels)
        step = jax.jit(make_step_fn(mesh, static, md.params, hard))
        _, d = step(state, jnp.asarray(1080.0, md.dtype))
        return float(np.asarray(d["rnorm"]))

    r0, r1 = final_rnorm(0), final_rnorm(1)
    assert r1 < 1e-3 * r0


def test_polygon_mesh_quality():
    from shakti_tpu.mesh.generate import polygon_mesh
    from shakti_tpu.mesh.mesh import cell_geometry
    from shakti_tpu.mesh import geometry as geo
    th = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    r = 5e3 * (1 + 0.25 * np.sin(3 * th))
    outline = np.column_stack([r * np.cos(th), r * np.sin(th)])
    nodes, cells = polygon_mesh(outline, resolution=500.0)
    assert nodes.shape[0] > 200
    area, _ = cell_geometry(nodes, cells)
    assert np.abs(area).min() > 0
    # total area close to polygon area
    x, y = outline[:, 0], outline[:, 1]
    poly_area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    assert abs(np.abs(area).sum() - poly_area) / poly_area < 0.05
    # every centroid inside
    cent = nodes[cells].mean(axis=1)
    assert geo.points_in_polygon(cent, outline).all()
    # mesh is solvable end-to-end
    from shakti_tpu.api.model import ModelSetup
    md = ModelSetup(nodes, cells)
    md.z_b = 0.01 * md.x
    md.z_s = md.z_b + 800.0
    md.G = np.full(md.x.size, 0.05)
    md.N_bdry = 1e5
    md.OutflowBoundary = lambda p: p[:, 0] < nodes[:, 0].min() + 600.0
    md.storage_on = False
    md.N_init = np.full(md.x.size, md.N_bdry)
    md.b_init = np.full(md.x.size, 1e-3)
    md.timesteps = np.linspace(0, 4 * 3600.0, 4)
    md.nt_save = 2
    from shakti_tpu.api.run import solve
    out = solve(md, progress=False)
    assert np.isfinite(out["history"]["N"]).all()


def test_profiling_utils():
    f = jax.jit(lambda x: x * 2.0)
    x = jnp.ones(128)
    ms = time_fn(f, x, iters=3)
    assert ms >= 0.0
    with Timer() as t:
        y = f(x)
        t.stop(y)
    assert t.ms >= 0.0


def test_seasonal_forcing():
    """Seasonal inputs modulation: amp=0 must match the unforced path
    exactly; amp>0 must imprint a seasonal signal on the solution."""
    import setups.setup_lake as sl
    from shakti_tpu.api.run import solve

    md0 = sl.initialize(nx=14, ny=14, days=365.0, nt_per_day=1)
    out0 = solve(md0, progress=False)

    md1 = sl.initialize(nx=14, ny=14, days=365.0, nt_per_day=1)
    md1.seasonal_inputs = (0.0, 3.154e7, 0.0)    # amp 0: identical
    out1 = solve(md1, progress=False)
    np.testing.assert_array_equal(out0["history"]["N"], out1["history"]["N"])

    md2 = sl.initialize(nx=14, ny=14, days=365.0, nt_per_day=1)
    md2.seasonal_inputs = (1.0, 3.154e7, 0.0)    # strong annual cycle
    out2 = solve(md2, progress=False)
    dN = np.abs(out2["history"]["N"] - out0["history"]["N"]).max(axis=1)
    assert dN.max() > 1.0        # the forcing visibly changes the solution
    # and the difference oscillates over the year (not monotone drift)
    assert dN[len(dN) // 2] > dN[-1] * 0.1


def test_checkpoint_mesh_fingerprint(tmp_path):
    """Resuming into a results dir written for a different mesh must fail
    loudly, not silently misassign nodal state (shape match is not enough)."""
    import pytest
    from shakti_tpu.io import checkpoint as ckpt
    from shakti_tpu.solve.timestep import State

    n = 16
    st = State(N=jnp.ones(n), b=jnp.full(n, 1e-3), q=jnp.zeros((n, 2)),
               melt=jnp.zeros(n), N_prev=jnp.ones(n))
    nodes_a = np.random.default_rng(0).random((n, 2))
    nodes_b = nodes_a + 1.0          # same shape, different mesh
    fp_a = ckpt.mesh_fingerprint(nodes_a)
    fp_b = ckpt.mesh_fingerprint(nodes_b)
    assert fp_a != fp_b

    ckpt.save_state(str(tmp_path), st, 5, 1, fingerprint=fp_a)
    out = ckpt.load_state(str(tmp_path), fingerprint=fp_a)
    assert out is not None and out[1] == 5 and out[2] == 1
    with pytest.raises(ValueError, match="different mesh"):
        ckpt.load_state(str(tmp_path), fingerprint=fp_b)


def test_dt_halving_rescues_rough_b_cold_start():
    """dt-halving with the REAL solver: the reference's own cold start
    (unclamped noisy b_init, setup_cooke2.py:66 — ~46% of nodes get b<0,
    the degenerate limit documented in VALIDATION.md) makes step 0 stall
    at levels=0 and converge with one halving level — the basis for the
    ModelSetup default adaptive_dt_levels=1."""
    from shakti_tpu.api.model import ModelSetup
    from shakti_tpu.mesh.generate import rectangle_mesh

    L = 100e3
    nodes, cells = rectangle_mesh(12, 12, L, L, jitter=0.2, seed=3)
    md = ModelSetup(nodes, cells)
    md.z_b = -400.0 + 0.004 * md.x + 0.002 * md.y
    md.z_s = md.z_b + 1500.0 - 0.006 * md.x
    md.G = np.full(md.x.size, 0.055)
    md.N_bdry = 3.7e5
    md.OutflowBoundary = lambda p: p[:, 0] < 1e-3
    rng = np.random.default_rng(0)
    md.b_init = 0.001 + rng.normal(scale=0.005, size=md.x.size)  # unclamped
    md.N_init = np.full(md.x.size, md.N_bdry)
    md.timesteps = np.linspace(0, 21600, 7)
    mesh, static, state, cfg = md.freeze()
    assert cfg.adaptive_dt_levels == 1          # the ModelSetup default
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)

    plain = dataclasses.replace(cfg, adaptive_dt_levels=0)
    s0, d0 = jax.jit(make_step_fn(mesh, static, md.params, plain))(
        state, dts[0])
    assert not bool(np.asarray(d0["converged"]))   # genuinely hard step

    s1, d1 = jax.jit(make_step_fn(mesh, static, md.params, cfg))(
        state, dts[0])
    assert bool(np.asarray(d1["converged"]))
    # the retry really ran two half-steps' worth of Newton work
    assert int(np.asarray(d1["newton_iters"])) > int(np.asarray(d0["newton_iters"])) // 2
    assert np.isfinite(np.asarray(s1.N)).all()
