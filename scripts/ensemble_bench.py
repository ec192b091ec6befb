"""Ensemble-throughput benchmark: vmapped members on one GPU.

The fused step at reference scale (12k dof) is expected to be
launch-bound — per-kernel fixed cost dominates, the arithmetic is tiny.
That makes batched ensembles (parallel/ensemble.py — a parallel axis the
reference's MPI stack does not have) nearly free: `vmap` widens every
kernel by the member axis instead of multiplying the kernel count, so M
perturbed trajectories should cost far less than M single runs.  This
script measures that claim honestly: steady-state ms/step for
M in {1, 2, 4, 8, 16} members and the resulting member-throughput
amplification vs M sequential single runs.

Measurement discipline: one process, jit-scanned windows with ONE pull
per window, warmup group excluded, device named in the output.  Exits
non-zero when JAX finds no GPU; SHAKTI_FORCE_CPU=1 runs a CPU rehearsal,
whose output then says "cpu".

    python scripts/ensemble_bench.py
    SHAKTI_ENS_MEMBERS=1,4 SHAKTI_ENS_DAYS=10 ... # smoke-test knobs

Prints one JSON line.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time

import numpy as np


def main():
    import jax

    from shakti_tpu.utils.backend import (enable_compile_cache, nvidia_smi,
                                          require_gpu)
    if os.environ.get("SHAKTI_FORCE_CPU") == "1":
        jax.config.update("jax_platforms", "cpu")
        dev, gpu = jax.devices()[0], None
    else:
        gpu = nvidia_smi()
        dev = require_gpu()
    enable_compile_cache()

    from bench import build_bench_model
    from shakti_tpu.parallel.ensemble import (make_ensemble_runner,
                                              perturbed_ensemble)
    from shakti_tpu.solve.timestep import (make_step_fn, run_window,
                                           timestep_sizes)

    days = int(os.environ.get("SHAKTI_ENS_DAYS", "40"))
    os.environ["SHAKTI_BENCH_DAYS"] = str(days)
    md = build_bench_model()
    mesh, static, state0, cfg = md.freeze()
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)
    win = int(md.nt_save)
    n_win = dts.shape[0] // win
    members = [int(m) for m in os.environ.get(
        "SHAKTI_ENS_MEMBERS", "1,2,4,8,16").split(",")]

    rows = []
    for M in members:
        if M == 1:
            step = make_step_fn(mesh, static, md.params, cfg)
            runner = jax.jit(lambda s, d: run_window(step, s, d))
            st = state0
        else:
            runner = make_ensemble_runner(mesh, static, md.params, cfg)
            st = perturbed_ensemble(state0, M, b_scale=5e-4, seed=0)

        # warmup: compile + settle the cold-start transient (2 windows)
        for j in range(2):
            st, diag = runner(st, dts[j * win:(j + 1) * win])
        jax.block_until_ready(st.N)
        t0 = time.time()
        timed = 0
        conv = True
        for j in range(2, n_win):
            st, diag = runner(st, dts[j * win:(j + 1) * win])
            # one small pull per window, like the production save path
            conv &= bool(np.asarray(diag["converged"]).all())
            timed += win
        jax.block_until_ready(st.N)
        ms = (time.time() - t0) / max(timed, 1) * 1e3
        rows.append({"members": M, "ms_per_step": round(ms, 3),
                     "ms_per_member_step": round(ms / M, 3),
                     "converged": conv})
        print(f"# M={M}: {ms:.2f} ms/step = {ms / M:.2f} ms/member-step",
              file=sys.stderr)

    # amplification is only meaningful against a true single-run baseline
    # (SHAKTI_ENS_MEMBERS may omit M=1, e.g. smoke tests)
    base = next((r["ms_per_step"] for r in rows if r["members"] == 1), None)
    for r in rows:
        r["throughput_vs_sequential"] = (round(
            base * r["members"] / r["ms_per_step"], 2)
            if base is not None else None)
    out = {
        "metric": "ensemble_throughput_cooke2_scale",
        "n_nodes": int(mesh.n_nodes),
        "platform": dev.platform,
        "device": f"{dev.platform}:{dev.device_kind}",
        "gpu": gpu,
        "steps_timed_per_M": (n_win - 2) * win,
        "rows": rows,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
