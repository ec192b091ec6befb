"""API/IO protocol tests: results directory layout, history cadence,
checkpoint/resume equivalence, pre-existing-directory abort
(reference solvers.py:57-238 behavior)."""

import os

import numpy as np
import pytest

import setups.setup_slab as slab
from shakti_tpu.api.run import solve, ConvergenceError


def make_md(tmp_path, name="run1", **kw):
    md = slab.initialize(nx=8, ny=8, days=5.0, nt_per_day=4,
                         results_name=str(tmp_path / name), **kw)
    return md


def test_results_layout_and_history_cadence(tmp_path):
    md = make_md(tmp_path)
    # make the last step a save step so the final row equals the final state
    md.timesteps = md.timesteps[: 4 * md.nt_save + 1]
    out = solve(md, progress=False)
    rdir = str(md.results_name)
    nt = md.timesteps.size
    n_saves = -(-nt // md.nt_save)
    for f in ("t.npy", "nodes_x.npy", "nodes_y.npy",
              "N.npy", "b.npy", "qx.npy", "qy.npy", "log.csv"):
        assert os.path.exists(os.path.join(rdir, f)), f
    N_hist = np.load(os.path.join(rdir, "N.npy"))
    assert N_hist.shape == (n_saves, md.x.size)
    assert np.load(os.path.join(rdir, "t.npy")).shape == (n_saves,)
    # provenance copy of the setup file (reference solvers.py:123-125)
    assert os.path.exists(os.path.join(rdir, "setup_slab.py"))
    # history rows populated (first row saved after step 0)
    assert np.abs(N_hist).max() > 0
    np.testing.assert_allclose(N_hist[-1], np.asarray(out["state"].N))


def test_existing_results_dir_aborts(tmp_path):
    md = make_md(tmp_path, name="dup")
    os.makedirs(md.results_name)
    with pytest.raises(FileExistsError):
        solve(md, progress=False)


def test_checkpoint_resume_bit_exact(tmp_path):
    # full run in one go
    md_full = make_md(tmp_path, name="full")
    out_full = solve(md_full, progress=False)

    # same run interrupted at the mid checkpoint, then resumed
    md_a = make_md(tmp_path, name="split")
    md_a.nt_check = 2 * md_a.nt_save   # checkpoint more often
    nt = md_a.timesteps.size
    md_a.timesteps = md_a.timesteps[: nt // 2 + 1]
    solve(md_a, progress=False)

    md_b = make_md(tmp_path, name="split2")
    md_b.results_name = md_a.results_name
    md_b.nt_check = 2 * md_b.nt_save
    out_b = solve(md_b, resume=True, progress=False)

    np.testing.assert_array_equal(np.asarray(out_full["state"].N),
                                  np.asarray(out_b["state"].N))
    np.testing.assert_array_equal(np.asarray(out_full["state"].b),
                                  np.asarray(out_b["state"].b))
    np.testing.assert_array_equal(out_full["history"]["N"], out_b["history"]["N"])


def test_checkpoint_resume_bit_exact_lag_operator(tmp_path):
    """With cfg.lag_operator the carried operator tuple is persisted in the
    checkpoint (io/checkpoint.py), so a resumed run replays the SAME
    Newton iteration path — bit-exact against the uninterrupted run."""
    import dataclasses

    def lag_md(name):
        md = make_md(tmp_path, name=name)
        md.solver = dataclasses.replace(md.solver, lag_operator=True,
                                        adaptive_dt_levels=0)
        return md

    md_full = lag_md("lag_full")
    out_full = solve(md_full, progress=False)
    assert out_full["state"].lag_op is not None

    md_a = lag_md("lag_split")
    md_a.nt_check = 2 * md_a.nt_save
    nt = md_a.timesteps.size
    md_a.timesteps = md_a.timesteps[: nt // 2 + 1]
    solve(md_a, progress=False)

    md_b = lag_md("lag_split2")
    md_b.results_name = md_a.results_name
    md_b.nt_check = 2 * md_b.nt_save
    out_b = solve(md_b, resume=True, progress=False)

    np.testing.assert_array_equal(np.asarray(out_full["state"].N),
                                  np.asarray(out_b["state"].N))
    np.testing.assert_array_equal(np.asarray(out_full["state"].b),
                                  np.asarray(out_b["state"].b))
    np.testing.assert_array_equal(out_full["history"]["N"],
                                  out_b["history"]["N"])
    # the carry itself round-tripped: same validity/age as the full run
    la, lb = out_full["state"].lag_op, out_b["state"].lag_op
    assert bool(np.asarray(la[0])) == bool(np.asarray(lb[0]))
    np.testing.assert_array_equal(np.asarray(la[2]), np.asarray(lb[2]))


def test_in_memory_run_without_results_dir():
    md = slab.initialize(nx=8, ny=8, days=0.5, nt_per_day=4)
    assert md.results_name is None
    out = solve(md, progress=False)
    assert out["history"]["N"].shape[0] == -(-md.timesteps.size // md.nt_save)


def test_compile_cache_populated_and_run_unchanged(tmp_path, monkeypatch):
    """enable_compile_cache writes XLA executables to the directory
    JAX_COMPILATION_CACHE_DIR names and does not perturb results
    (utils/backend.py)."""
    import jax

    from shakti_tpu.utils.backend import enable_compile_cache

    md = slab.initialize(nx=8, ny=8, days=0.5, nt_per_day=4)
    ref = solve(md, progress=False)
    cdir = str(tmp_path / "xla_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cdir)
    was = jax.config.jax_compilation_cache_dir
    got = enable_compile_cache()
    try:
        assert got == cdir and os.path.isdir(cdir)
        # same problem again: results must be byte-identical with the
        # cache enabled (the executable is what's cached, not the math)
        md2 = slab.initialize(nx=8, ny=8, days=0.5, nt_per_day=4)
        out = solve(md2, progress=False)
        np.testing.assert_array_equal(np.asarray(out["state"].N),
                                      np.asarray(ref["state"].N))
        # a shape not yet in the in-process jit cache forces a fresh
        # XLA compile, which must land entries in the directory
        md3 = slab.initialize(nx=9, ny=8, days=0.5, nt_per_day=4)
        solve(md3, progress=False)
        assert os.listdir(cdir), "no cache entries written"
    finally:
        jax.config.update("jax_compilation_cache_dir", was)


def test_nonconvergence_raises():
    md = slab.initialize(nx=8, ny=8, days=0.5, nt_per_day=4)
    from shakti_tpu.solve.newton import NewtonConfig
    md.solver = NewtonConfig(max_iter=0)   # force failure
    with pytest.raises(ConvergenceError):
        solve(md, progress=False)


def test_validation_errors():
    import numpy as np
    from shakti_tpu.api.model import ModelSetup
    from shakti_tpu.mesh.generate import rectangle_mesh

    nodes, cells = rectangle_mesh(4, 4, 1.0, 1.0)
    md = ModelSetup(nodes, cells)
    md.OutflowBoundary = lambda p: p[:, 0] < 1e-9
    # timesteps are a run-layer concern: the transient driver demands
    # them, freeze() no longer does (steady solves have none at all)
    with pytest.raises(ValueError, match="timesteps"):
        solve(md, progress=False)
    md.freeze()
    md.timesteps = np.linspace(0, 10.0, 4)
    md.OutflowBoundary = None
    with pytest.raises(ValueError, match="OutflowBoundary"):
        md.freeze()
    md.outflow_on = False
    md.z_b = np.zeros(3)        # wrong length
    with pytest.raises(ValueError, match="z_b"):
        md.freeze()


def test_to_user_order_roundtrip():
    import numpy as np
    import setups.setup_slab as sl
    md = sl.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    md.operator = "bell"        # forces renumbering
    mesh, static, state, cfg = md.freeze()
    assert md.node_iperm is not None
    # solver-order nodes mapped back must equal the original coordinates
    np.testing.assert_allclose(md.to_user_order(np.asarray(mesh.nodes)),
                               md.nodes)


def test_bicgstab_path():
    import dataclasses
    import numpy as np
    import setups.setup_slab as sl
    from shakti_tpu.api.run import solve
    md = sl.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    md.solver = dataclasses.replace(md.solver, krylov="bicgstab")
    out = solve(md, progress=False)
    assert np.isfinite(out["history"]["N"]).all()


def test_msh_v22_reader(tmp_path):
    from shakti_tpu.mesh.msh_io import read_msh
    txt = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
3
1 15 2 0 1 1
2 2 2 0 1 1 2 3
3 2 2 0 1 1 3 4
$EndElements
"""
    p = tmp_path / "v22.msh"
    p.write_text(txt)
    nodes, cells = read_msh(str(p))
    assert nodes.shape == (4, 2)
    np.testing.assert_array_equal(cells, [[0, 1, 2], [0, 2, 3]])


def test_group_windows_partition():
    """_group_windows must cover _save_windows exactly, in order, cutting
    groups at checkpoint boundaries and around irregular windows so the
    grouped device calls checkpoint with the correct end-of-group state."""
    from shakti_tpu.api.run import _ck_due, _group_windows, _save_windows

    for nt, nt_save, nt_check, max_g, start in [
            (101, 4, 16, 8, 0), (97, 24, 1200, 25, 0), (50, 4, 8, 64, 9),
            (10, 1, 5, 3, 0), (25, 24, 48, 4, 0),
            # misaligned cadences: nt_check not a multiple of nt_save
            (101, 4, 10, 8, 0), (120, 24, 30, 25, 0), (60, 8, 3, 4, 5)]:
        ws = list(_save_windows(nt, nt_save, start))
        grps = list(_group_windows(ws, nt_check, max_g))
        assert [w for g in grps for w in g] == ws
        for g in grps:
            assert len(g) <= max_g
            # all windows in a multi-window group are equal-length saves
            if len(g) > 1:
                assert all(w[2] and w[1] == g[0][1] for w in g)
            # checkpoint boundaries only at the last window of a group
            for w in g[:-1]:
                assert not _ck_due(w[0], w[0] + w[1] - 1, nt_check)


def test_grouped_run_matches_singleton(tmp_path, monkeypatch):
    """The grouped device-call path (scan over save windows, one pull per
    group) must reproduce the per-window path exactly."""
    md1 = make_md(tmp_path, name="grp_auto")
    out1 = solve(md1, progress=False)

    monkeypatch.setenv("SHAKTI_RUN_GROUP", "1")
    md2 = make_md(tmp_path, name="grp_one")
    out2 = solve(md2, progress=False)

    np.testing.assert_array_equal(np.asarray(out1["state"].N),
                                  np.asarray(out2["state"].N))
    np.testing.assert_array_equal(np.asarray(out1["state"].b),
                                  np.asarray(out2["state"].b))
    for k in ("N", "b", "qx", "qy"):
        np.testing.assert_array_equal(out1["history"][k], out2["history"][k])
    assert out1["newton_iters_total"] == out2["newton_iters_total"]
    assert out1["cg_iters_total"] == out2["cg_iters_total"]
    # log.csv diagnostics identical row-for-row
    log1 = open(os.path.join(str(md1.results_name), "log.csv")).read()
    log2 = open(os.path.join(str(md2.results_name), "log.csv")).read()
    assert log1.splitlines()[1:] == log2.splitlines()[1:]


def test_rolling_checkpoints_fire_on_misaligned_cadence(tmp_path, monkeypatch):
    """nt_check that is not a multiple of nt_save must still produce rolling
    checkpoints at the first save past each nt_check boundary (previously
    the write fired only when a save step landed exactly on a multiple of
    nt_check — e.g. nt_save=24, nt_check=25 silently checkpointed every
    600 steps instead of ~25)."""
    from shakti_tpu.api import run as run_mod

    calls = []
    real = run_mod.ckpt.save_state

    def spy(rdir, state, next_step, next_row, **kw):
        calls.append((next_step, kw.get("include_lag", True)))
        return real(rdir, state, next_step, next_row, **kw)

    monkeypatch.setattr(run_mod.ckpt, "save_state", spy)
    md = make_md(tmp_path, name="ckpt_misaligned")
    md.nt_save = 4
    md.nt_check = 6                      # nt = 20: steps 0..19
    solve(md, progress=False)
    rolling = [s for s, lag in calls if not lag]
    # windows [0], [1-4], [5-8], [9-12], [13-16], [17-19 non-save];
    # boundaries at steps 0, 6, 12 fall inside windows ending 0, 8, 12
    # (the step-18 boundary lands in the final non-save window, covered
    # by the end-of-run checkpoint).  The old exact-multiple rule only
    # fired at step 0 here.
    assert rolling == [1, 9, 13]
    # final full checkpoint still written once, with the carry included
    assert [s for s, lag in calls if lag] == [20]


def test_cli_steady_writes_artifacts(tmp_path, capsys, monkeypatch, request):
    """CLI `--steady` end-to-end: a wrapper setup file through
    cli.main() must solve the steady state and write steady.npz +
    steady_info.json to <results_name>_steady/ (cli.py:89-113)."""
    import jax

    from shakti_tpu.cli import main

    # the CLI turns the persistent compile cache on: keep it in tmp_path
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    was = jax.config.jax_compilation_cache_dir
    request.addfinalizer(
        lambda: jax.config.update("jax_compilation_cache_dir", was))

    wrapper = tmp_path / "wrap_steady.py"
    wrapper.write_text(
        "import setups.setup_slab as slab\n"
        "def initialize():\n"
        f"    return slab.initialize(nx=10, ny=10, days=2.0, nt_per_day=4,\n"
        f"                           results_name={str(tmp_path / 'sres')!r})\n"
    )
    rc = main([str(wrapper), "--steady", "--steady-tol", "2e-2", "--quiet"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "steady state in" in out and "mass budget" in out
    rdir = tmp_path / "sres_steady"
    import json

    z = np.load(rdir / "steady.npz")
    assert set(z.files) >= {"N", "b", "qx", "qy"}
    assert np.isfinite(z["N"]).all() and (z["b"] > 0).all()
    info = json.loads((rdir / "steady_info.json").read_text())
    assert info["converged"] and info["rate"] < 2e-2
    assert abs(info["Q_out"] - info["Q_src"]) <= 1e-2 * abs(info["Q_src"])
