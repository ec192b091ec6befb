"""Same-process bench repeat spread: the noise floor of bench.py.

Runs the exact bench timing loop (same model, same grouped-dispatch
program) as repeated passes in one process and reports the pass-to-pass
spread, so an A/B difference can be compared with it.  Exits non-zero when
JAX finds no GPU.  Prints one JSON line with every pass, the device kind
and the card's name and power limit:

    python scripts/bench_ab.py [n_passes]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    from shakti_tpu.utils.backend import (enable_compile_cache, nvidia_smi,
                                          require_gpu)
    gpu = nvidia_smi()
    dev = require_gpu()
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from shakti_tpu.solve.timestep import (make_step_fn, run_window,
                                           timestep_sizes)

    n_passes = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    # enough horizon for warmup + n_passes x 2 groups of 25 windows
    os.environ.setdefault("SHAKTI_BENCH_DAYS", str((n_passes * 2 + 2) * 25))
    from bench import BASELINE_MS_PER_STEP, build_bench_model

    md = build_bench_model()
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)
    win = int(md.nt_save)
    group = 25

    pack = jax.jit(lambda s: jnp.concatenate(
        [s.N, s.b, s.q[:, 0], s.q[:, 1]]))

    def gbody(s, d):
        s, diag = run_window(step, s, d)
        extra = jnp.stack([diag["converged"].all().astype(s.N.dtype),
                           diag["newton_iters"].sum().astype(s.N.dtype),
                           diag["cg_iters"].sum().astype(s.N.dtype)])
        return s, jnp.concatenate([pack(s), extra])

    grouped = jax.jit(lambda s, d: jax.lax.scan(gbody, s, d))

    i = 0

    def run_group():
        nonlocal i, state
        state, rows = grouped(state, dts[i:i + group * win]
                              .reshape(group, win))
        flat = np.asarray(rows)          # the production-style packed pull
        i += group * win
        return flat

    run_group()                          # warmup: compile + settle
    run_group()
    passes = []
    while len(passes) < n_passes and i + 2 * group * win <= dts.shape[0]:
        t0 = time.time()
        f1 = run_group()
        f2 = run_group()
        ms = (time.time() - t0) / (2 * group * win) * 1e3
        conv = bool((f1[:, -3] > 0).all() and (f2[:, -3] > 0).all())
        passes.append({"ms_per_step": round(ms, 4), "converged": conv})
        print(f"pass {len(passes)}: {ms:.4f} ms/step conv={conv}",
              file=sys.stderr, flush=True)
    vals = np.array([p["ms_per_step"] for p in passes])
    res = {
        "device": f"{dev.platform}:{dev.device_kind}",
        "gpu": gpu,
        "steps_per_pass": 2 * group * win,
        "passes": passes,
        "mean_ms": float(vals.mean()),
        "spread_ms": float(vals.max() - vals.min()),
        "vs_baseline_mean": BASELINE_MS_PER_STEP / float(vals.mean()),
    }
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
