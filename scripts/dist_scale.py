"""10M-dof distributed execution on an 8-device virtual CPU mesh.

Runs a few transient steps of a 10M-node problem through the node-sharded
SPMD halo path (parallel/dist.py) on 8 virtual CPU devices (the same
program runs unchanged on several GPUs), with the working-set reductions
that make 10M per-device-memory-feasible: quadrature degree 2 (halves
the per-cell precompute) and f32 state.

Records CPU wall times (not device speed), solver counters, the
per-device compiled memory footprint (XLA memory_analysis), and the
per-device payload bytes.

    python scripts/dist_scale.py [--dof 10e6] [--devices 8] [--steps 2]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dof", type=float, default=10e6)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--dt", type=float, default=3600.0)
    args = ap.parse_args()

    # self-provision the virtual device mesh BEFORE first jax use
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) >= args.devices, jax.devices()
    from shakti_tpu.utils.backend import enable_compile_cache
    cc = enable_compile_cache()
    print(f"# compilation cache: {cc}", file=sys.stderr, flush=True)

    from shakti_tpu.api.model import ModelSetup
    from shakti_tpu.mesh.generate import rectangle_mesh
    from shakti_tpu.parallel.dist import make_distributed_runner
    from shakti_tpu.solve.newton import NewtonConfig
    from shakti_tpu.solve.timestep import timestep_sizes

    nx = int(round(np.sqrt(args.dof))) - 1
    n_target = (nx + 1) ** 2
    h = 2000.0
    t0 = time.time()
    nodes, cells = rectangle_mesh(nx, nx, nx * h, nx * h)
    t_mesh = time.time() - t0
    print(f"# mesh: {n_target:,} nodes / {cells.shape[0]:,} cells "
          f"({t_mesh:.0f}s)", file=sys.stderr, flush=True)

    md = ModelSetup(nodes, cells)
    md.distributed = True
    # working-set reductions for the 10M regime: quad degree 2 precompute
    # (3 points instead of 6); extrapolated guesses stay on.
    # SHAKTI_MG_OMEGA / SHAKTI_MG_AGG override the multilevel-PC knobs
    # for tuning sweeps (scripts/dist_scale_1M*.json records).
    _d = NewtonConfig()
    md.solver = NewtonConfig(
        quad_degree=2,
        mg_omega=float(os.environ.get("SHAKTI_MG_OMEGA", _d.mg_omega)),
        mg_agg=int(os.environ.get("SHAKTI_MG_AGG", _d.mg_agg)),
        mg_smoother=os.environ.get("SHAKTI_MG_SMOOTHER", _d.mg_smoother),
        mg_cheb_deg=int(os.environ.get("SHAKTI_MG_CHEB_DEG", _d.mg_cheb_deg)),
        mg_cheb_frac=float(os.environ.get("SHAKTI_MG_CHEB_FRAC",
                                          _d.mg_cheb_frac)),
        mg_cycle=os.environ.get("SHAKTI_MG_CYCLE", _d.mg_cycle),
        mg_smooth_p=float(os.environ.get("SHAKTI_MG_SMOOTHP",
                                         _d.mg_smooth_p)))
    md.z_b = 0.002 * md.x - 100.0
    md.z_s = md.z_b + 1200.0 + 0.001 * (md.x - nx * h / 2)
    md.G = np.full(md.x.size, 0.06, dtype=np.float32)
    md.N_bdry = 3.7e5
    md.OutflowBoundary = lambda p: p[:, 0] < 1e-6
    md.b_init = np.full(md.x.size, 0.01, dtype=np.float32)
    md.N_init = np.full(md.x.size, md.N_bdry, dtype=np.float32)
    md.timesteps = np.linspace(0.0, args.dt * (args.steps + 1),
                               args.steps + 2)

    t0 = time.time()
    runner, state, plan = make_distributed_runner(md)
    t_freeze = time.time() - t0
    print(f"# freeze+partition: {t_freeze:.0f}s  L={plan['L']:,}/device",
          file=sys.stderr, flush=True)

    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:args.steps]

    # per-device compiled memory footprint
    t0 = time.time()
    lowered = runner.lower(state, dts)
    compiled = lowered.compile()
    t_compile = time.time() - t0
    mem = compiled.memory_analysis()
    mem_info = {}
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes"):
        v = getattr(mem, k, None)
        if v is not None:
            mem_info[k] = int(v)
    print(f"# compile: {t_compile:.0f}s  per-device mem: "
          + json.dumps(mem_info), file=sys.stderr, flush=True)

    t0 = time.time()
    state, diags = compiled(state, dts)
    jax.block_until_ready(state.N)
    t_run = time.time() - t0
    conv = bool(np.asarray(diags["converged"]).all())
    newton = np.asarray(diags["newton_iters"]).tolist()
    cg = np.asarray(diags["cg_iters"]).tolist()

    result = {
        "metric": "dist_steps_10M",
        "n_nodes": n_target,
        "devices": args.devices,
        "L_per_device": int(plan["L"]),
        "steps": args.steps,
        "s_per_step": round(t_run / args.steps, 2),
        "dof_steps_per_s": round(n_target * args.steps / t_run, 1),
        "converged": conv,
        "newton_iters": newton,
        "cg_iters": cg,
        "t_mesh_s": round(t_mesh, 1),
        "t_freeze_s": round(t_freeze, 1),
        "t_compile_s": round(t_compile, 1),
        "per_device_memory": mem_info,
        "platform": jax.devices()[0].platform,
    }
    print(json.dumps(result))
    tag = (f"{round(n_target / 1e6)}M" if n_target >= 1e6
           else f"{round(n_target / 1e3)}k")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       f"dist_scale_{tag}.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0 if conv else 1


if __name__ == "__main__":
    sys.exit(main())
