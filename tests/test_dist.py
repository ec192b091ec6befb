"""Node-sharded SPMD (halo exchange) tests on 8 simulated devices:
the distributed solver must match the single-device solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import setups.setup_slab as slab
from shakti_tpu.parallel import halo as H
from shakti_tpu.parallel.dist import gather_state, make_distributed_runner
from shakti_tpu.parallel.shard import make_device_mesh
from shakti_tpu.solve.timestep import make_step_fn, run_window, timestep_sizes


def test_halo_plan_covers_all_cells_and_nodes():
    md = slab.initialize(nx=12, ny=12)
    plan = H.build_halo(md.x.size, md.cells, 8)
    assert plan["cell_valid"].sum() == md.cells.shape[0]
    assert plan["sizes"].sum() == md.x.size
    # every local cell index is within [0, L)
    assert plan["local_cells"].min() >= 0
    assert plan["local_cells"].max() < plan["L"]


def test_localize_globalize_roundtrip():
    md = slab.initialize(nx=10, ny=10)
    plan = H.build_halo(md.x.size, md.cells, 4)
    rng = np.random.default_rng(0)
    f = rng.normal(size=(md.x.size, 2))
    loc = H.localize_nodal(plan, f)
    glob = H.globalize_nodal(plan, loc)
    np.testing.assert_array_equal(glob, f)


def test_halo_push_and_accumulate_semantics():
    """Exercise push/accumulate inside shard_map against a numpy oracle."""
    from shakti_tpu.parallel.shard import shard_map
    from jax.sharding import PartitionSpec as P

    md = slab.initialize(nx=9, ny=7)
    n = md.x.size
    Pn = 4
    plan = H.build_halo(n, md.cells, Pn)
    jmesh = make_device_mesh(Pn)
    rng = np.random.default_rng(1)
    f = rng.normal(size=n)

    loc = H.localize_nodal(plan, f).reshape(-1)

    def body(x, send_idx, send_valid, recv_slot, owned_mask):
        h = H.Halo(send_idx=send_idx, send_valid=send_valid,
                   recv_slot=recv_slot, owned_mask=owned_mask, axis="x")
        return h.accumulate(x)

    sm = shard_map(body, mesh=jmesh,
                   in_specs=(P("x"),) * 5, out_specs=P("x"))
    Hs = plan["send_idx"].shape[-1]
    out = sm(jnp.asarray(loc),
             jnp.asarray(plan["send_idx"].reshape(-1, Hs)),
             jnp.asarray(plan["send_valid"].reshape(-1, Hs)),
             jnp.asarray(plan["recv_slot"].reshape(-1, Hs)),
             jnp.asarray(plan["owned_mask"].reshape(-1)))

    # oracle: owner value = sum of all copies (owned + every ghost copy)
    expected_owner = f.copy()
    for p in range(Pn):
        gl = np.where(plan["g2l"][p] >= plan["omax"])[0]
        for gnode in gl:
            expected_owner[gnode] += f[gnode]   # each ghost copy adds its value
    got = H.globalize_nodal(plan, np.asarray(out).reshape(Pn, plan["L"]))
    np.testing.assert_allclose(got, expected_owner, rtol=1e-12)

    # and ghosts were refreshed to the accumulated owner values
    out_l = np.asarray(out).reshape(Pn, plan["L"])
    for p in range(Pn):
        gl = np.where(plan["g2l"][p] >= plan["omax"])[0]
        np.testing.assert_allclose(out_l[p, plan["g2l"][p][gl]],
                                   expected_owner[gl], rtol=1e-12)

    # the overlapped variant (accumulate_split, comm/compute overlap) must
    # be bit-identical to the plain accumulate
    omax = int(plan["omax"])

    def body_split(x, send_idx, send_valid, recv_slot, owned_mask):
        h = H.Halo(send_idx=send_idx, send_valid=send_valid,
                   recv_slot=recv_slot, owned_mask=owned_mask, axis="x",
                   omax=omax)
        return h.accumulate_split(x[:omax], x[omax:])

    sm2 = shard_map(body_split, mesh=jmesh,
                    in_specs=(P("x"),) * 5, out_specs=P("x"))
    out2 = sm2(jnp.asarray(loc),
               jnp.asarray(plan["send_idx"].reshape(-1, Hs)),
               jnp.asarray(plan["send_valid"].reshape(-1, Hs)),
               jnp.asarray(plan["recv_slot"].reshape(-1, Hs)),
               jnp.asarray(plan["owned_mask"].reshape(-1)))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out2))


@pytest.mark.parametrize("ndev", [2, 8])
def test_distributed_run_matches_single_device(ndev):
    md = slab.initialize(nx=12, ny=12, days=2.0, nt_per_day=4)
    mesh, static, state, cfg0 = md.freeze()
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:6]

    # single-device golden with the SAME solver config the dist path uses
    import dataclasses
    cfg = dataclasses.replace(cfg0, precond="jacobi")
    step1 = make_step_fn(mesh, static, md.params, cfg)
    s1, d1 = jax.jit(lambda s, d: run_window(step1, s, d))(state, dts)
    assert bool(np.asarray(d1["converged"]).all())

    jmesh = make_device_mesh(ndev)
    runner, st0, plan = make_distributed_runner(md, jmesh)
    s2_stacked, d2 = runner(st0, dts)
    assert bool(np.asarray(d2["converged"]).all())
    s2 = gather_state(plan, s2_stacked)

    np.testing.assert_allclose(np.asarray(s1.N), np.asarray(s2.N), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(s1.b), np.asarray(s2.b), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(s1.q), np.asarray(s2.q),
                               rtol=1e-6, atol=1e-18)


@pytest.mark.parametrize("fmt", ["bell", "bcsr"])
def test_distributed_block_operator_matches_single_device(fmt):
    """Per-shard block-ELL / block-CSR operators (the dense-block SpMV
    formats) must reproduce the single-device trajectory through
    the halo path: fold per shard, matvec + halo accumulate per iteration."""
    md = slab.initialize(nx=16, ny=16, days=2.0, nt_per_day=4)
    mesh, static, state, cfg0 = md.freeze()
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:5]
    step1 = make_step_fn(mesh, static, md.params, cfg0)
    s1, d1 = jax.jit(lambda s, d: run_window(step1, s, d))(state, dts)
    assert bool(np.asarray(d1["converged"]).all())

    md2 = slab.initialize(nx=16, ny=16, days=2.0, nt_per_day=4)
    md2.operator = fmt            # force the block format per shard
    md2.distributed = True
    jmesh = make_device_mesh(4)
    runner, st0, plan = make_distributed_runner(md2, jmesh)
    assert plan["op_meta"]["format"] == fmt
    s2, d2 = runner(st0, dts)
    assert bool(np.asarray(d2["converged"]).all())
    g = gather_state(plan, s2)
    N1 = md.to_user_order(np.asarray(s1.N))
    N2 = np.asarray(g.N)[md2.node_iperm]
    np.testing.assert_allclose(N1, N2, rtol=1e-8)
    b2 = np.asarray(g.b)[md2.node_iperm]
    np.testing.assert_allclose(md.to_user_order(np.asarray(s1.b)), b2,
                               rtol=1e-8)


def test_distributed_solve_protocol_matches_single(tmp_path):
    """md.distributed=True runs the full IO protocol on 8 devices and must
    produce the same results files as the single-device path."""
    import os
    import dataclasses
    from shakti_tpu.api.run import solve

    def build(name):
        md = slab.initialize(nx=10, ny=10, days=2.0, nt_per_day=4,
                             results_name=str(tmp_path / name))
        # the dist path forces jacobi; use it on both sides for comparison
        md.solver = dataclasses.replace(md.solver, precond="jacobi")
        return md

    md1 = build("single")
    out1 = solve(md1, progress=False)

    md2 = build("dist")
    md2.distributed = True
    out2 = solve(md2, progress=False)

    np.testing.assert_allclose(out1["history"]["N"], out2["history"]["N"],
                               rtol=1e-8)
    np.testing.assert_allclose(out1["history"]["b"], out2["history"]["b"],
                               rtol=1e-8)
    for f in ("N.npy", "checkpoint.npz", "log.csv"):
        assert os.path.exists(os.path.join(str(tmp_path / "dist"), f))


def test_distributed_grouped_dispatch(tmp_path, monkeypatch):
    """Grouped dispatch on the dist path (the dist twin of api/run.py's
    run_group, replacing the reference's per-save rank-0 gather funnel,
    solvers.py:205-215): the packed owned-row group pulls must be
    BIT-identical to the per-window gather path and cut host round trips
    by >=10x."""
    import dataclasses
    from shakti_tpu.api.run import solve

    def build(name):
        md = slab.initialize(nx=8, ny=8, days=20.0, nt_per_day=2,
                             results_name=str(tmp_path / name))
        md.solver = dataclasses.replace(md.solver, precond="jacobi")
        md.nt_save = 2
        md.nt_check = 10_000        # no checkpoint cuts inside the horizon
        md.distributed = True
        return md

    monkeypatch.setenv("SHAKTI_RUN_GROUP", "1")     # per-window gathers
    out1 = solve(build("win"), progress=False)
    monkeypatch.delenv("SHAKTI_RUN_GROUP")
    out2 = solve(build("grp"), progress=False)

    for k in ("N", "b", "qx", "qy"):
        np.testing.assert_array_equal(np.asarray(out1["history"][k]),
                                      np.asarray(out2["history"][k]))
    assert out2["host_pulls"] * 10 <= out1["host_pulls"], (
        out2["host_pulls"], out1["host_pulls"])


def test_distributed_resume(tmp_path):
    """Checkpoint/resume across the distributed path."""
    import dataclasses
    from shakti_tpu.api.run import solve

    def build(name):
        md = slab.initialize(nx=8, ny=8, days=5.0, nt_per_day=4,
                             results_name=str(tmp_path / name))
        md.solver = dataclasses.replace(md.solver, precond="jacobi")
        md.nt_check = md.nt_save
        md.distributed = True
        return md

    md_full = build("full")
    out_full = solve(md_full, progress=False)

    md_a = build("split")
    md_a.timesteps = md_a.timesteps[: md_a.timesteps.size // 2 + 1]
    solve(md_a, progress=False)
    md_b = build("split_resume")
    md_b.results_name = md_a.results_name
    out_b = solve(md_b, resume=True, progress=False)

    np.testing.assert_allclose(np.asarray(out_full["state"].N),
                               np.asarray(out_b["state"].N), rtol=1e-8)


def test_distributed_with_seasonal_forcing(tmp_path):
    """Forcing dicts (dt + inputs_scale) must flow through the shard_map
    runner identically to the single-device path."""
    import dataclasses
    import setups.setup_lake as sl
    from shakti_tpu.api.run import solve

    def build(name, dist):
        md = sl.initialize(nx=12, ny=12, days=10.0, nt_per_day=2,
                           results_name=str(tmp_path / name))
        md.solver = dataclasses.replace(md.solver, precond="jacobi")
        md.seasonal_inputs = (1.0, 3.154e7, 0.0)
        md.distributed = dist
        return md

    out1 = solve(build("single", False), progress=False)
    out2 = solve(build("dist", True), progress=False)
    np.testing.assert_allclose(out1["history"]["N"], out2["history"]["N"],
                               rtol=1e-8)


def test_distributed_two_level_preconditioner():
    """The distributed two-level PC (precond.make_global_two_level: one
    psum'd global Galerkin coarse, dense inverse replicated) must agree
    with the single-device and jacobi solves and never cost iterations.
    Measured effect (Cook_E2-like configuration, 8 shards): 42% CG
    reduction vs jacobi (1007 vs 1733 over 4 cold-start steps, ~2x on the
    later steps); the slab case shows ~none because its early error modes
    are LOCAL (transmissivity contrast), which is why this asserts
    correctness + no-harm rather than a speedup factor (the 10M artifact,
    scripts/dist_scale.py, records the at-scale behavior)."""
    import dataclasses

    from shakti_tpu.parallel.dist import gather_state, make_distributed_runner

    def build():
        md = slab.initialize(nx=48, ny=48, days=0.5, nt_per_day=4)
        # smooth initial gap: the default noisy cold start has b~0 nodes
        # whose N is locally solver-dependent (the degenerate limit,
        # VALIDATION.md) — ill-posed for cross-solver equality assertions.
        # dt-halving must be OFF for the same reason: if one solver's step
        # lands at the convergence edge and retries as two half-steps, the
        # trajectories differ at O(dt) — legitimately, but not comparably.
        md.b_init = np.full(md.x.size, 0.01)
        md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0)
        return md

    def run(precond):
        md = build()
        md.solver = dataclasses.replace(md.solver, precond=precond)
        md.distributed = True
        runner, state, plan = make_distributed_runner(md)
        assert plan["L"] >= 32         # the local coarse really activates
        dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:2]
        s, d = runner(state, dts)
        assert bool(np.asarray(d["converged"]).all()), precond
        # gather_state returns SOLVER-order (RCB) arrays; map back to the
        # setup's user node order for cross-path comparisons
        g = gather_state(plan, s)
        N_user = np.asarray(g.N)[md.node_iperm]
        return md, N_user, int(np.asarray(d["cg_iters"]).sum())

    md, N_tl, cg_tl = run("two_level")
    _, N_j, cg_j = run("jacobi")
    # same solution either way
    np.testing.assert_allclose(N_tl, N_j, rtol=1e-7)
    # the coarse level must never cost Krylov iterations
    assert cg_tl <= 1.05 * cg_j, (cg_tl, cg_j)

    # matches the single-device two_level path
    md1 = build()
    mesh, static, state1, cfg1 = md1.freeze()
    step = make_step_fn(mesh, static, md1.params, cfg1)
    dts = timestep_sizes(md1.timesteps, dtype=md1.dtype)[:2]
    s1, d1 = jax.jit(lambda a, b: run_window(step, a, b))(state1, dts)
    N1_user = md1.to_user_order(np.asarray(s1.N))
    np.testing.assert_allclose(N_tl, N1_user, rtol=1e-8)


def test_distributed_per_device_memory_scales():
    """Weak-scaling memory contract of the halo path (VERDICT r1 item 3):
    per-device compiled footprint (XLA memory_analysis temp size) at P=8
    must be a small fraction of the P=1 footprint — the working set really
    divides across devices instead of replicating."""
    md_args = dict(nx=64, ny=64, days=1.0, nt_per_day=4)

    def temp_bytes(n_dev):
        import dataclasses
        md = slab.initialize(**md_args)
        # jacobi isolates the sharding contract: the two-level PC carries
        # a REPLICATED global coarse inverse (m x m) that doesn't shrink
        # with P — negligible at production scale (2.4 MB vs 1.9 GB/device
        # at 10M dof) but dominant at this toy size
        md.solver = dataclasses.replace(md.solver, precond="jacobi")
        md.distributed = True
        jmesh = make_device_mesh(n_dev)
        runner, state, plan = make_distributed_runner(md, jmesh)
        dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:2]
        mem = runner.lower(state, dts).compile().memory_analysis()
        return int(mem.temp_size_in_bytes), plan["L"]

    t8, L8 = temp_bytes(8)
    t1, L1 = temp_bytes(1)
    # halo ghosts + padding keep L8 a bit above L1/8, but the per-device
    # working set must shrink by at least 4x with 8-way sharding
    assert L8 < 0.25 * L1, (L8, L1)
    assert t8 < 0.3 * t1, (t8, t1)
