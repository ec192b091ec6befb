"""Adjoint cost at bench scale: forward vs forward+backward per-step time.

Measures, on the headline benchmark problem (bench.py's Cook_E2-equivalent
catchment, 12.3k nodes, f32, hourly steps), the wall cost of reverse-mode
differentiating a multi-day transient through the IFT custom VJP
(solve/implicit.py):

    forward      jit(run_window) over T steps, differentiable config
    grad         jit(value_and_grad(L))  with  L = mean(N_T),
                 control = the per-step inputs_scale vector (T,)
    grad_remat   same, with jax.checkpoint(step): O(1) stored states —
                 the long-horizon memory mode (re-runs each forward step
                 once during the backward sweep)

Each adjoint step is one extra Krylov solve on the transposed operator +
one residual VJP, so the expected fwd+bwd : fwd ratio is ~2-3x.  Prints
one JSON line with the device kind and the card's name and power limit.

Exits non-zero when JAX finds no GPU; SHAKTI_ADJ_ALLOW_CPU=1 allows a CPU
rehearsal, whose output then says "cpu".
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("SHAKTI_BENCH_DAYS", "16")   # dts horizon (builder):
#                                    >= (SETTLE + STEPS) / 24 = 13 days
os.environ["SHAKTI_LAG_OPERATOR"] = "0"            # differentiable => no lag

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

STEPS = int(os.environ.get("SHAKTI_ADJ_STEPS", "72"))   # 3 days hourly
REPS = int(os.environ.get("SHAKTI_ADJ_REPS", "3"))


def main():
    from shakti_tpu.utils.backend import (enable_compile_cache, nvidia_smi,
                                          require_gpu)
    if os.environ.get("SHAKTI_ADJ_ALLOW_CPU") == "1":
        dev, gpu = jax.devices()[0], None
    else:
        gpu = nvidia_smi()
        dev = require_gpu()
    enable_compile_cache()

    from bench import build_bench_model
    from shakti_tpu.solve.timestep import (make_step_fn, run_window,
                                           timestep_sizes)

    md = build_bench_model()
    md.solver = dataclasses.replace(md.solver, lag_operator=False,
                                    differentiable=True,
                                    adaptive_dt_levels=0)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts_all = timestep_sizes(md.timesteps, dtype=md.dtype)
    dts = dts_all[:STEPS]

    # settle the violent cold-start transients OUTSIDE the timed region so
    # both directions time steady-state Newton counts (1-2 iters/step)
    n_settle = int(os.environ.get("SHAKTI_ADJ_SETTLE", "240"))
    settle = jax.jit(lambda s: run_window(step, s, dts_all[:n_settle])[0])
    state = jax.block_until_ready(settle(state))

    # control = the initial marching state (the bench model's static inputs
    # are zero, so a forcing-scale control would carry a trivially zero
    # cotangent) — differentiating w.r.t. state.b exercises the full
    # state-to-state adjoint chain b0 -> pre -> N* -> b1 -> ... every step
    fwd = jax.jit(lambda s: run_window(step, s, dts)[0].N)

    def loss(s):
        return jnp.mean(fwd(s)) / 1e5

    grad = jax.jit(jax.value_and_grad(loss))

    step_r = jax.checkpoint(step)
    fwd_r = lambda s: run_window(step_r, s, dts)[0].N
    grad_r = jax.jit(jax.value_and_grad(lambda s: jnp.mean(fwd_r(s)) / 1e5))

    def timeit(fn, *a):
        out = jax.block_until_ready(fn(*a))       # compile + warm
        best = np.inf
        for _ in range(REPS):
            t0 = time.time()
            out = jax.block_until_ready(fn(*a))
            best = min(best, time.time() - t0)
        return best / STEPS * 1e3, out

    ms_fwd, _ = timeit(fwd, state)
    ms_grad, (val, g) = timeit(grad, state)
    ms_grad_r, (val_r, g_r) = timeit(grad_r, state)
    # sanity: remat must not change the value or the gradient
    np.testing.assert_allclose(np.asarray(val_r), np.asarray(val), rtol=1e-6)
    # norm-based: near-zero entries carry f32 recompute roundoff (~1e-5
    # abs) where elementwise relative comparison is meaningless
    gdiff = float(jnp.linalg.norm(g_r.b - g.b) / jnp.linalg.norm(g.b))
    assert gdiff <= 1e-3, f"remat gradient deviates: rel L2 {gdiff:.2e}"
    gnorm = float(jnp.linalg.norm(g.b))
    assert gnorm > 0.0, "zero gradient — the adjoint chain is broken"

    result = {
        "metric": "adjoint_ms_per_step_cooke2_scale",
        "platform": f"{dev.platform}:{dev.device_kind}",
        "gpu": gpu,
        "n_nodes": int(mesh.n_nodes),
        "steps": STEPS,
        "forward_ms_per_step": round(ms_fwd, 3),
        "grad_ms_per_step": round(ms_grad, 3),
        "grad_remat_ms_per_step": round(ms_grad_r, 3),
        "bwd_over_fwd": round(ms_grad / ms_fwd - 1.0, 2),
        "grad_norm": gnorm,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
