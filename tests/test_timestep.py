"""Transient integration tests on the tilted-slab case: physical sanity,
clamp semantics, determinism (SURVEY §4 consequence items 3, 5)."""

import jax
import jax.numpy as jnp
import numpy as np

import setups.setup_slab as slab
from shakti_tpu.solve.timestep import run_window, timestep_sizes, make_step_fn


def run_slab(n_steps=30, **kw):
    md = slab.initialize(nx=16, ny=16, days=5.0, nt_per_day=6, **kw)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:n_steps]
    state, diags = jax.jit(lambda s, d: run_window(step, s, d))(state, dts)
    return md, state, diags


def test_slab_transient_converges_and_is_physical():
    md, state, diags = run_slab()
    assert bool(np.asarray(diags["converged"]).all())
    # Newton should take only a few iterations (mildly nonlinear problem,
    # matching the reference's typical 2-5, SURVEY §0)
    assert float(np.asarray(diags["newton_iters"]).mean()) < 10
    N = np.asarray(state.N)
    b = np.asarray(state.b)
    q = np.asarray(state.q)
    assert np.all(np.isfinite(N)) and np.all(np.isfinite(b)) and np.all(np.isfinite(q))
    # gap height respects the clamp (reference solvers.py:194-197)
    assert b.min() >= md.b_min - 1e-15
    # effective pressure stays positive on this geometry and honors the BC
    dmask = np.zeros(md.x.size, dtype=bool)
    dmask[md.dirichlet_nodes()] = True
    np.testing.assert_allclose(N[dmask], md.N_bdry, rtol=1e-12)
    # pressure builds inland of the outflow boundary (magnitudes bounded;
    # N may dip negative near the moulin — water pressure above overburden)
    assert N.max() > md.N_bdry
    assert np.abs(N).max() < 1e8


def test_first_step_dt_quirk():
    # dt_0 = 0.1 |t1 - t0| (reference solvers.py:81-82,174-176)
    t = np.array([0.0, 100.0, 200.0, 350.0])
    dts = np.asarray(timestep_sizes(t))
    np.testing.assert_allclose(dts, [10.0, 100.0, 100.0, 150.0])


def test_determinism():
    _, s1, _ = run_slab(n_steps=10)
    _, s2, _ = run_slab(n_steps=10)
    np.testing.assert_array_equal(np.asarray(s1.N), np.asarray(s2.N))
    np.testing.assert_array_equal(np.asarray(s1.b), np.asarray(s2.b))


def test_steady_state_boundary_layer_structure():
    """Quantitative physical validation in the spirit of the reference's
    far-field check (solution-plots.ipynb cell-13): on a moulin-free slab the
    steady N field forms a boundary layer rising monotonically from the
    outflow Dirichlet value to an interior creep/melt equilibrium plateau of
    O(0.5 MPa)."""
    md = slab.initialize(nx=16, ny=16, days=60.0, nt_per_day=6, moulin_Q=0.0)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:200]
    state, diags = jax.jit(lambda s, d: run_window(step, s, d))(state, dts)
    assert bool(np.asarray(diags["converged"]).all())
    N = np.asarray(state.N).reshape(17, 17)
    col = N.mean(axis=0)               # columns ordered by x
    assert np.isclose(col[0], md.N_bdry, rtol=1e-10)   # BC column
    assert np.all(np.diff(col[:5]) > 0)                # monotone boundary layer
    assert 2e5 < col[6:].mean() < 3e6                  # physical plateau


def test_scan_chunks_equal_single_steps():
    """Stepping via one scan must equal stepping one-by-one (pure function)."""
    md = slab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:4]
    s_scan, _ = jax.jit(lambda s, d: run_window(step, s, d))(state, dts)
    s_loop = state
    jstep = jax.jit(step)
    for k in range(4):
        s_loop, _ = jstep(s_loop, dts[k])
    np.testing.assert_allclose(np.asarray(s_scan.N), np.asarray(s_loop.N), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(s_scan.b), np.asarray(s_loop.b), rtol=1e-12)


def test_lagged_operator_matches_plain_newton():
    """cfg.lag_operator reuses the previous step's folded operator + coarse
    inverse on iteration 0; the exact-residual convergence test makes it an
    inexact-Newton variant, so trajectories must agree to solver tolerance
    (measured 1.7e-10 over 30 steps; asserted with headroom).  Exercises the
    block-ELL format."""
    import dataclasses

    from shakti_tpu.solve.newton import zero_lag

    md = slab.initialize(nx=16, ny=16, days=2.0, nt_per_day=6)
    md.operator = "bell"
    mesh, static, state, cfg = md.freeze()
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:12]

    out = {}
    for lag in (False, True):
        c = dataclasses.replace(cfg, lag_operator=lag, adaptive_dt_levels=0)
        s0 = state if not lag else dataclasses.replace(
            state, lag_op=zero_lag(mesh, md.dtype, c))
        step = make_step_fn(mesh, static, md.params, c)
        s, d = jax.jit(lambda a, b: run_window(step, a, b))(s0, dts)
        assert bool(np.asarray(d["converged"]).all())
        out[lag] = s
        if lag:
            # the carry is live: ok flag set, age bounded by the refresh
            # cap, values finite and nonzero
            ok, age, vals, a_diag, A_inv, floor, fage = s.lag_op
            assert bool(np.asarray(ok))
            assert int(np.asarray(age)) <= c.lag_max_age + 1
            assert float(np.abs(np.asarray(vals)).max()) > 0

    np.testing.assert_allclose(np.asarray(out[True].N),
                               np.asarray(out[False].N), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(out[True].b),
                               np.asarray(out[False].b), rtol=1e-7)


def test_lag_floor_probe_age_bounded(monkeypatch):
    """SHAKTI_LAG_FLOOR=1 carries the sensitivity-floor probe with its own
    age (carry slot 6): a mid-solve operator rebuild resets the OPERATOR
    age but must not extend the probe's lifetime, so the observed probe
    age never exceeds lag_max_age + 1 and the trajectory stays close to
    the per-step-probe path (the floor only shifts tolerances)."""
    import dataclasses

    from shakti_tpu.solve.newton import zero_lag

    md = slab.initialize(nx=16, ny=16, days=2.0, nt_per_day=6)
    md.operator = "bell"
    mesh, static, state, cfg = md.freeze()
    c = dataclasses.replace(cfg, lag_operator=True, adaptive_dt_levels=0)
    s0 = dataclasses.replace(state, lag_op=zero_lag(mesh, md.dtype, c))
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:12]

    def run(flag):
        monkeypatch.setenv("SHAKTI_LAG_FLOOR", flag)
        jstep = jax.jit(make_step_fn(mesh, static, md.params, c))
        s, ages = s0, []
        for dt in dts:              # stepwise so every carry is observable
            s, d = jstep(s, dt)
            assert bool(np.asarray(d["converged"]).all())
            ages.append(int(np.asarray(s.lag_op[6])))
        return s, ages

    s_on, ages = run("1")
    s_off, _ = run("0")
    assert max(ages) <= c.lag_max_age + 1
    assert float(np.asarray(s_on.lag_op[5])) > 0   # carried floor is live
    np.testing.assert_allclose(np.asarray(s_on.N), np.asarray(s_off.N),
                               rtol=1e-5)


def test_lag_operator_auto_resolution():
    """NewtonConfig.lag_operator=None resolves at freeze: True exactly for
    block-ELL meshes (the bell regime), False elsewhere; explicit
    settings pass through untouched."""
    import dataclasses

    md = slab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    assert md.solver.lag_operator is None
    md.operator = "bell"
    mesh, static, state, cfg = md.freeze()
    assert cfg.lag_operator is True
    assert state.lag_op is not None

    md2 = slab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    md2.operator = "ell"
    _, _, state2, cfg2 = md2.freeze()
    assert cfg2.lag_operator is False
    assert state2.lag_op is None

    md3 = slab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    md3.operator = "bell"
    md3.solver = dataclasses.replace(md3.solver, lag_operator=False)
    _, _, _, cfg3 = md3.freeze()
    assert cfg3.lag_operator is False
