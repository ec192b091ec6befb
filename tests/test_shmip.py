"""SHMIP suite A physical-structure checks (de Fleurian et al. 2018).

Full steady-state profile comparison is a long-horizon (multi-year,
sub-hourly) run better done on the GPU; here we verify the robust early-time
physics on a coarse mesh: convergence, boundary condition, and the
monotone response of the water sheet to recharge over 4 decades of input.
"""

import jax
import numpy as np

import setups.setup_shmip as shmip
from shakti_tpu.solve.timestep import make_step_fn, run_window, timestep_sizes


def run_case(case, days=180.0, nt_per_day=4):
    md = shmip.initialize(case, nx=50, ny=10, days=days, nt_per_day=nt_per_day)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)
    s, d = jax.jit(lambda a, b: run_window(step, a, b))(state, dts)
    assert bool(np.asarray(d["converged"]).all()), case
    return md, s


def test_shmip_suite_a_structure():
    results = {c: run_case(c) for c in ("A1", "A3", "A5")}

    b_mean = {c: float(np.asarray(s.b).mean()) for c, (md, s) in results.items()}
    # more recharge -> thicker water sheet (monotone over 4 decades of input)
    assert b_mean["A1"] < b_mean["A3"] < b_mean["A5"], b_mean

    for c, (md, s) in results.items():
        N = np.asarray(s.N)
        assert np.isfinite(N).all()
        # margin Dirichlet honored
        dmask = np.zeros(md.x.size, dtype=bool)
        dmask[md.dirichlet_nodes()] = True
        np.testing.assert_allclose(N[dmask], md.N_bdry, rtol=1e-6)
        # interior effective pressure within glaciologically sane bounds
        band = (md.x > 20e3) & (md.x < 80e3)
        assert -1e6 < N[band].mean() < 5e6, (c, N[band].mean())

    # surface function matches the SHMIP definition at the margin and divide
    assert abs(shmip.surface(0.0) - 1.0) < 1e-9
    assert 1400.0 < shmip.surface(100e3) < 1900.0


def test_shmip_a1_matches_independent_1d_oracle():
    """Quantitative SHMIP anchor: at low input (A1) the 2D transient
    converges to the y-uniform steady branch, which the independent scipy
    shooting oracle (oracle/shmip_oracle.py) solves with a completely
    different discretization.  Measured: relN ~ 4e-4 after 2 years
    (see SHMIP.md); asserted with 10x headroom."""
    from oracle.shmip_oracle import steady_profile

    md = shmip.initialize("A1", nx=60, ny=12, days=365 * 2, nt_per_day=4)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)
    state, d = jax.jit(lambda s, t: run_window(step, s, t))(state, dts)
    assert bool(np.asarray(d["converged"]).all())

    p = steady_profile("A1")
    x = md.x
    win = (x > 30e3) & (x < 90e3)
    No = np.interp(x, p["x"], p["N"])
    bo = np.interp(x, p["x"], p["b"])
    N2, b2 = np.asarray(state.N), np.asarray(state.b)
    relN = np.linalg.norm(N2[win] - No[win]) / np.linalg.norm(No[win])
    relb = np.linalg.norm(b2[win] - bo[win]) / np.linalg.norm(bo[win])
    assert relN < 5e-3, relN
    assert relb < 2e-2, relb

    # exact global mass conservation at the steady state: reaction-force
    # boundary discharge == independently quadratured interior production,
    # and both match the oracle's margin discharge
    from shakti_tpu.solve import diagnostics as diag
    Q_out = diag.boundary_discharge(mesh, static, state, md.params)
    Q_src = diag.water_production(mesh, static, state, md.params)
    assert abs(Q_out - Q_src) / Q_src < 0.02, (Q_out, Q_src)
    # the near-margin zone equilibrates over centuries (closure rate A N^3
    # with N ~ 10 kPa), so its dissipation melt — hence total discharge —
    # keeps creeping toward the oracle value for a long time (0.52 vs 0.469
    # at 10 years, SHMIP.md); assert the physical scale, not convergence
    Q_oracle = -p["q_margin"] * 20e3
    assert abs(Q_out - Q_oracle) / Q_oracle < 0.15, (Q_out, Q_oracle)


def test_shmip_b_setup_conserves_total_input():
    """Suite B setup: n equal moulins lump the A5-equivalent 90 m^3/s onto
    nodes (plus the A1 background) — the total integrated input must be
    exact regardless of moulin count/positions."""
    import setups.setup_shmip as shmip
    from shakti_tpu.mesh.mesh import cell_geometry

    for case, n_m in (("B1", 1), ("B3", 20)):
        md = shmip.initialize(case, nx=40, ny=8, days=1.0)
        sa, _ = cell_geometry(md.nodes, md.cells)
        node_area = np.zeros(md.x.size)
        np.add.at(node_area, md.cells.reshape(-1), np.repeat(np.abs(sa), 3))
        total = float((md.inputs * node_area / 3.0).sum())
        expect = shmip.B_TOTAL_M3S + shmip.CASES_A["A1"] * 100e3 * 20e3
        assert abs(total - expect) / expect < 1e-6, (case, total, expect)


def test_shmip_c_setup_diurnal_forcing():
    """Suite C setup: B5 moulins + diurnal seasonal_inputs with the SHMIP
    relative amplitude; the forcing pytree carries the per-step scale."""
    import setups.setup_shmip as shmip
    from shakti_tpu.solve.timestep import make_forcing

    md = shmip.initialize("C3", nx=40, ny=8, days=2.0, nt_per_day=24)
    assert md.seasonal_inputs == (1.0, shmip.DAY_S, 0.0)
    f = make_forcing(md.timesteps, dtype=md.dtype,
                     seasonal=md.seasonal_inputs)
    s = np.asarray(f["inputs_scale"])
    assert s.min() >= 0.0 and abs(s.max() - 2.0) < 0.05
    # one full diurnal period per day of steps
    assert abs(s[:24].argmax() - 6) <= 1      # peak ~1/4 into the day


def test_shmip_unknown_case_raises():
    import pytest
    import setups.setup_shmip as shmip
    with pytest.raises(ValueError, match="unknown SHMIP case"):
        shmip.initialize("Z9")


def test_shmip_d_degree_day_forcing():
    """Suite D setup: the degree-day forcing arrays follow the published
    model — zero melt mid-winter, positive sea-level melt mid-summer,
    melt shut off above the seasonal snowline (lapse), and the warmer
    offset strictly increasing the summer melt."""
    import setups.setup_shmip as shmip
    from shakti_tpu.solve.timestep import make_forcing

    md = shmip.initialize("D3", nx=40, ny=8, days=365.0, nt_per_day=1)
    assert md.degree_day == {"dT": 0.0}
    f = make_forcing(md.timesteps, dtype=md.dtype, degree_day=md.degree_day)
    a = np.asarray(f["melt_a"], dtype=np.float64)
    b = np.asarray(f["melt_b"], dtype=np.float64)
    ddf = 0.01 / 86400.0
    # mid-winter (t=0): T = -21 C -> no melt anywhere
    assert a[0] < 0.0
    # mid-summer (t ~ half year): T = +11 C -> sea-level melt 0.11 m/day
    mid = len(a) // 2
    assert abs(a[mid] - ddf * 11.0) / (ddf * 11.0) < 0.01
    # snowline at z = T/lapse ~ 1467 m mid-summer
    z_line = a[mid] / b[mid]
    assert 1300.0 < z_line < 1600.0
    # warmer offset -> strictly larger summer melt
    f5 = make_forcing(md.timesteps, dtype=md.dtype, degree_day={"dT": 4.0})
    assert float(np.asarray(f5["melt_a"])[mid]) > float(a[mid])
    # and the melt actually reaches the step: a 3-day mid-summer run with
    # the D5 forcing draws down N vs the unforced (winter-branch) run
    md3 = shmip.initialize("D5", nx=40, ny=8, days=3.0, nt_per_day=24)
    mesh, static, state, cfg = md3.freeze()
    from shakti_tpu.solve.timestep import make_step_fn, run_window
    step = make_step_fn(mesh, static, md3.params, cfg)
    f_on = make_forcing(md3.timesteps, dtype=md3.dtype,
                        degree_day={"dT": 4.0, "t_amp": 16.0})  # summer phase
    f_off = make_forcing(md3.timesteps, dtype=md3.dtype)
    s_on, d_on = jax.jit(lambda s, f: run_window(step, s, f))(state, f_on)
    s_off, d_off = jax.jit(lambda s, f: run_window(step, s, f))(state, f_off)
    assert bool(np.asarray(d_on["converged"]).all())
    assert not np.allclose(np.asarray(s_on.b), np.asarray(s_off.b))
    assert float(np.asarray(s_on.b).mean()) > float(np.asarray(s_off.b).mean())


def test_shmip_valley_geometry():
    """Suite E valley: the glacier footprint is para-independent (the bed
    reaches the fixed surface at the same wall position for every para),
    the overdeepening deepens monotonically with decreasing para, and the
    footprint mesh is usable."""
    import setups.setup_shmip as shmip

    x = np.linspace(100.0, 5800.0, 20)
    w = shmip.valley_half_width(x)
    s = shmip.valley_surface(x)
    for para in (0.05, 0.0, -0.5):
        bed_wall = shmip.valley_bed(x, w, para)
        np.testing.assert_allclose(bed_wall, s, rtol=1e-9)
    # center-line bed strictly deepens with decreasing para mid-glacier
    beds = [shmip.valley_bed(3000.0, 0.0, p) for p in (0.05, 0.0, -0.5, -0.7)]
    assert np.all(np.diff(beds) < 0.0), beds
    # E2..E5 carve a genuine overdeepening (local bed minimum below the
    # terminus level); E1 does not
    xs = np.linspace(0.0, 6000.0, 200)
    assert shmip.valley_bed(xs, 0.0, -0.5).min() < -100.0
    assert shmip.valley_bed(xs, 0.0, 0.05).min() >= 0.0
    md = shmip.initialize("E1", days=1.0, nt_per_day=24, resolution=150.0)
    assert md.x.size > 200
    assert md.z_s.min() >= md.z_b.min()
    assert len(md.dirichlet_nodes()) >= 2      # terminus outflow nodes
    # gap-cap contract: min(ice column, VALLEY_B_CAP), floored — the
    # regularization that keeps every valley case integrable (SHMIP.md)
    cap = np.asarray(md.b_cap)
    H = np.maximum(md.z_s - md.z_b, 0.0)
    assert cap.max() <= shmip.VALLEY_B_CAP + 1e-12
    assert np.all(cap <= np.maximum(H, 1e-3) + 1e-12)
    assert cap.min() >= 1e-3


def test_shmip_f_valley_seasonal_runs():
    """Suite F: a short winter-phase run on the valley with the seasonal
    degree-day forcing converges (melt is off mid-winter, so this also
    pins the valley cold-start robustness at hourly steps)."""
    import setups.setup_shmip as shmip
    from shakti_tpu.solve.timestep import make_forcing, make_step_fn, run_window

    md = shmip.initialize("F3", days=2.0, nt_per_day=24, resolution=150.0)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    f = make_forcing(md.timesteps, dtype=md.dtype, degree_day=md.degree_day)
    s, d = jax.jit(lambda a, b: run_window(step, a, b))(state, f)
    assert bool(np.asarray(d["converged"]).all())
    assert np.isfinite(np.asarray(s.N)).all()


def test_shmip_artifact_cache_and_rendering():
    """Integrity of the committed SHMIP artifact pipeline: the results
    cache (scripts/shmip_results.json) must hold every suite the artifact
    claims, with mass budgets closed, and build_md must render all suite
    tables from the cache alone (SHMIP.md is regenerated from it)."""
    import importlib.util
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "shmip_validate", os.path.join(root, "scripts", "shmip_validate.py"))
    sv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sv)

    out = json.load(open(sv.CACHE))
    # suite A transients + all six steady (suite S) cases
    for c in ("A1", "A3", "A5"):
        assert c in out and out[c]["yearly"], c
    for c in ("A1", "A2", "A3", "A4", "A5", "A6"):
        s = out["S_" + c]
        assert s["imbalance"] < 1e-3, (c, s["imbalance"])
        assert s["Q_out"] > 0.0
    # steady route and transient route land on the same A1 state
    relN_tr = out["A1"]["yearly"][-1]["relN_win"]
    relN_st = out["S_A1"]["relN_win"]
    assert abs(relN_tr - relN_st) < 5e-5, (relN_tr, relN_st)
    assert out["S_A1"]["converged"]
    # monotone-response verdicts recorded by suites C/D; suite F honestly
    # records a non-monotone verdict (cold-end saturation — the bench
    # valley's sea-level terminus keeps a melt season at dT=-4 K) while
    # its warm branch F3->F5 must still grow
    assert out["C_amplitude_monotonic"] is True
    assert out["D_amplitude_monotonic"] is True
    f_amp = [out[c]["N_amp_MPa"] for c in ("F3", "F4", "F5")]
    assert f_amp[0] < f_amp[1] < f_amp[2], f_amp
    # rendering: every suite table present, one row per case
    md_text = "\n".join(sv.build_md(out))
    for sec in ("## Suite A", "## Suite S", "## Suite B", "## Suite C",
                "## Suite D", "## Suite E", "## Suite F"):
        assert sec in md_text, sec
    # Suite-S verdicts: derive the expected row from the cache's own
    # verdict field so artifact improvements can't strand this pin
    # (r4 regression: verdicts flipped no->polished, test went red).
    for c in ("A1", "A2", "A3", "A4", "A5", "A6"):
        s = out["S_" + c]
        verdict = s.get("verdict", "steady" if s["converged"] else "no")
        assert f"\n| {c} | {verdict} " in md_text, (c, verdict)
