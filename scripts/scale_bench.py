"""Large-mesh single-GPU scaling benchmark.

    python scripts/scale_bench.py [nx] [steps]

Builds an nx*nx-quad jittered mesh at 2 km spacing (nx=1000 -> 1M nodes,
nx=3163 -> 10M nodes), runs a short transient, and prints one JSON line
with ms/step and dof*steps/s, the device kind and the card's name and
power limit.  Exits non-zero when JAX finds no GPU.
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402


def main(nx: int = 1000, steps: int = 12, op: str = "auto",
         lag: str = "0", pc: str = "two_level"):
    from shakti_tpu.utils.backend import (enable_compile_cache, nvidia_smi,
                                          require_gpu)
    gpu = nvidia_smi()
    dev = require_gpu()
    enable_compile_cache()

    import jax

    from shakti_tpu.api.model import ModelSetup
    from shakti_tpu.mesh.generate import rectangle_mesh
    from shakti_tpu.solve.timestep import (make_step_fn, run_window,
                                           timestep_sizes)

    t0 = time.time()
    h = 2000.0
    nodes, cells = rectangle_mesh(nx, nx, nx * h, nx * h, jitter=0.25, seed=0)
    md = ModelSetup(nodes, cells)
    # lean solver config: skip the dt-halving retry branch (compile cost at
    # scale; steady-state throughput is unaffected either way).  lag='1'
    # carries the folded operator + coarse inverse across steps — at 1M dof
    # this trades ~2x operator-values memory for skipping the fold/PC build
    # on reuse steps.
    from shakti_tpu.solve.newton import NewtonConfig
    # pc: 'two_level' (default) or 'mg' (the multilevel V-cycle)
    md.solver = NewtonConfig(lag_operator=(str(lag) == "1"), precond=pc)
    md.z_b = 0.002 * md.x - 100.0
    md.z_s = md.z_b + 1200.0 + 0.001 * (md.x - nx * h / 2)
    md.G = np.full(md.x.size, 0.06)
    md.N_bdry = 3.7e5
    md.OutflowBoundary = lambda p: p[:, 0] < 1e-6
    rng = np.random.default_rng(0)
    md.b_init = np.maximum(0.001 + rng.normal(scale=5e-4, size=md.x.size), 1e-5)
    md.N_init = np.full(md.x.size, md.N_bdry)
    md.storage_on = False
    md.operator = op
    md.timesteps = np.linspace(0, 4 * steps * 3600.0, 4 * steps)
    md.nt_save = 2 * steps
    mesh, static, state, cfg = md.freeze()
    print(f"# freeze {time.time() - t0:.0f}s n={mesh.n_nodes} "
          f"op={md.operator}",
          file=sys.stderr, flush=True)

    step = make_step_fn(mesh, static, md.params, cfg)
    runner = jax.jit(lambda s, d: run_window(step, s, d))
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)
    t0 = time.time()
    state, diag = runner(state, dts[:steps])
    jax.block_until_ready(state)
    print(f"# compile+first window {time.time() - t0:.0f}s",
          file=sys.stderr, flush=True)

    t0 = time.time()
    state, diag = runner(state, dts[steps:2 * steps])
    jax.block_until_ready(state)
    ms = (time.time() - t0) / steps * 1e3
    out = {
        "metric": f"ms_per_step_{mesh.n_nodes}_dof",
        "value": round(ms, 2),
        "unit": "ms/step",
        "dof_steps_per_s": round(mesh.n_nodes / ms * 1e3),
        "converged": bool(np.asarray(diag["converged"]).all()),
        "newton_mean": round(float(np.asarray(diag["newton_iters"]).mean()), 2),
        "cg_mean": round(float(np.asarray(diag["cg_iters"]).mean()), 1),
        "lag_operator": md.solver.lag_operator,
        "precond": pc,
        "device_kind": dev.device_kind,
        "gpu": gpu,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    args = [int(a) if a.isdigit() else a for a in sys.argv[1:]]
    sys.exit(main(*args))
