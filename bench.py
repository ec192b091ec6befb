"""Headline benchmark: time per transient step at reference scale.

Reference baseline (BASELINE.md): the Cook_E2 production run — 12,268 nodes /
24,101 triangles at 2 km resolution, 87,600 hourly steps — averaged
52.9 ms/step on 8 MPI ranks (notebooks/example.ipynb cell-4: 77.17 min wall).

This benchmark reproduces that problem shape (12,321 nodes / 24,200 cells at
2 km spacing, lake storage + outflow BC + hourly steps) and measures the
steady-state per-step wall time of the fused XLA timestep on the available
GPU, saves amortized at the reference's cadence (every 24 steps).  Exits
non-zero when JAX finds no GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "platform",
"device_kind", "gpu"}; "gpu" is the card's name and power limit as
nvidia-smi reports them.
"""

import json
import sys
import time

import numpy as np

BASELINE_MS_PER_STEP = 52.9   # reference: 4630.2 s / 87,600 steps on 8 ranks


def build_bench_model():
    import os

    import jax.numpy as jnp

    from shakti_tpu.api.model import ModelSetup
    from shakti_tpu.mesh.generate import rectangle_mesh

    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets", "cooke2_synth")
    use_basin = (os.environ.get("SHAKTI_BENCH_MESH", "1") != "0"
                 and os.path.exists(os.path.join(assets, "Cook_E2_mesh.msh")))
    if use_basin:
        # committed Cook_E2-equivalent catchment mesh (scripts/
        # make_cooke2_mesh.py): 12,270 nodes / 23,990 unstructured
        # triangles at 2 km — same node count and connectivity character
        # as the reference's gmsh production mesh (12,268 / 24,101)
        from shakti_tpu.mesh.msh_io import read_msh
        nodes, cells = read_msh(os.path.join(assets, "Cook_E2_mesh.msh"))
        lake_outline = np.load(os.path.join(assets, "lake.npy"))
        lx = nodes[:, 0].max() - nodes[:, 0].min()
    else:
        # 110x110 quads -> 12,321 nodes / 24,200 triangles at 2 km spacing
        nx = ny = 110
        h = 2000.0
        lx = ly = nx * h
        nodes, cells = rectangle_mesh(nx, ny, lx, ly, jitter=0.25, seed=0)
        th = np.linspace(0, 2 * np.pi, 128, endpoint=False)
        lake_outline = np.column_stack([lx / 2 + 12e3 * np.cos(th),
                                        ly / 2 + 12e3 * np.sin(th)])
    md = ModelSetup(nodes, cells)

    # Cook_E2-like configuration (reference setups/setup_cooke2.py):
    # gentle bed slope, ~1 km ice, lake with storage term, outflow
    # Dirichlet at the low-potential edge, hourly steps.
    x0 = md.x.min()
    md.z_b = 0.005 * (md.x - x0) - 100.0
    md.z_s = md.z_b + 1000.0 + 0.002 * (md.x - x0 - lx / 2)
    md.G = np.full(md.x.size, 0.06)
    md.N_bdry = 3.7e5                      # setup_cooke2.py:29
    md.OutflowBoundary = lambda p: p[:, 0] < x0 + (1e-6 if not use_basin
                                                   else 0.02 * lx)
    md.set_lake_bdry(lake_outline)
    md.storage_on = True
    rng = np.random.default_rng(0)
    md.b_init = np.maximum(0.001 + rng.normal(scale=0.0005, size=md.x.size), 1e-5)
    md.N_init = np.full(md.x.size, md.N_bdry)
    days = int(os.environ.get("SHAKTI_BENCH_DAYS", "80"))  # hourly steps
    md.timesteps = np.linspace(0, 3.154e7 / 365 * days, days * 24)
    md.nt_save = 24
    # lean solver config: no dt-halving retry branch — it never triggers in
    # the timed steady-state windows and would ~double the compile.
    # lag_operator: reuse the previous step's folded operator + coarse-PC
    # inverse on iteration 0 (solve/newton.py); at the bench's steady state
    # the stale-operator iteration still converges in 1 Newton/step, so the
    # Jacobian/fold/coarse-inv kernels drop out of the step entirely
    # (override with SHAKTI_LAG_OPERATOR=0 for A/B runs).
    import os
    from shakti_tpu.solve.newton import NewtonConfig
    lag = os.environ.get("SHAKTI_LAG_OPERATOR", "1") == "1"
    md.solver = NewtonConfig(lag_operator=lag)
    # A/B knobs (default untouched): operator format / block size
    opf = os.environ.get("SHAKTI_BENCH_OPERATOR")
    if opf:
        md.operator = opf
    blk = os.environ.get("SHAKTI_BENCH_BLOCK")
    if blk:
        md.operator_block = int(blk)
    return md


def main():
    import os

    from shakti_tpu.utils.backend import (enable_compile_cache, nvidia_smi,
                                          require_gpu)
    gpu = nvidia_smi()
    dev = require_gpu()
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from shakti_tpu.solve.timestep import make_step_fn, run_window, timestep_sizes

    md = build_bench_model()
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)

    win = int(md.nt_save)

    # history snapshot: N/b/q concatenated on-device into one row per save
    # window (the reference's analogue cost is its daily .npy writes,
    # included in its 52.9 ms/step)
    pack = jax.jit(lambda s: jnp.concatenate(
        [s.N, s.b, s.q[:, 0], s.q[:, 1]]))

    # the production run loop (api/run.py solve): ONE device call covers a
    # group of save windows, accumulating the daily history rows on device,
    # and ONE device->host pull materializes the group's rows — each
    # dispatch and transfer is a host round trip, and the per-window
    # chatter of the naive loop would otherwise add to the all-inclusive
    # step time.  Group size mirrors the flagship's
    # checkpoint cadence (nt_check 1200 steps = 50 windows; memory-capped
    # the same way — see api/run.py).
    group_b = int(os.environ.get("SHAKTI_BENCH_GROUP", "25"))
    # warmup consumes one full group; cap so at least one timed group fits
    group_b = max(1, min(group_b, (dts.shape[0] // win) // 2))

    def gbody(s, d):
        s, diag = run_window(step, s, d)
        # converged flag + newton/cg sums ride the same row (small exact
        # ints in f32) so a group is ONE dispatch + ONE pull, total
        extra = jnp.stack([diag["converged"].all().astype(s.N.dtype),
                           diag["newton_iters"].sum().astype(s.N.dtype),
                           diag["cg_iters"].sum().astype(s.N.dtype)])
        return s, jnp.concatenate([pack(s), extra])

    grouped = jax.jit(lambda s, d: jax.lax.scan(gbody, s, d))

    # warmup: compile + settle transients (first steps take extra Newton
    # iters); one warmup group of the timed shape
    state, rows = grouped(state, dts[:group_b * win].reshape(group_b, win))
    np.asarray(rows[-1])
    i = group_b * win
    n_timed = 0
    newton_sum = cg_sum = 0.0
    t0 = time.time()
    conv_all = True
    snap = None
    while i + group_b * win <= dts.shape[0]:
        state, rows = grouped(
            state, dts[i:i + group_b * win].reshape(group_b, win))
        # the group's history rows in one device->host transfer, exactly
        # like the production save path
        flat = np.asarray(rows)
        n = (flat.shape[1] - 3) // 4
        snap = (flat[-1, :n], flat[-1, n:2 * n],
                flat[-1, 2 * n:3 * n], flat[-1, 3 * n:4 * n])
        conv_all &= bool((flat[:, -3] > 0).all())
        newton_sum += float(flat[:, -2].sum())
        cg_sum += float(flat[:, -1].sum())
        n_timed += group_b
        i += group_b * win
    t1 = time.time()

    conv = conv_all
    steps_timed = n_timed * win
    if steps_timed == 0:
        print("# ERROR: no timed groups (horizon too short for group size)",
              file=sys.stderr)
        return 2
    ms_per_step = (t1 - t0) / steps_timed * 1e3
    diag_means = {"newton": newton_sum / max(steps_timed, 1),
                  "cg": cg_sum / max(steps_timed, 1)}

    result = {
        "metric": "ms_per_step_cooke2_scale_12k_dof",
        "value": round(ms_per_step, 4),
        "unit": "ms/step",
        "vs_baseline": round(BASELINE_MS_PER_STEP / ms_per_step, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "gpu": gpu,
    }
    print(json.dumps(result))
    print(f"# device={dev.platform}:{dev.device_kind} dtype={np.dtype(md.dtype).name} "
          f"nodes={mesh.n_nodes} cells={mesh.n_cells} steps_timed={steps_timed} "
          f"converged={conv} newton_mean={diag_means['newton']:.2f} "
          f"cg_mean={diag_means['cg']:.1f} "
          f"dof_steps_per_s={mesh.n_nodes / ms_per_step * 1e3:.3g}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
