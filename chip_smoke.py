"""On-card smoke test: the main path, every operator format and the
multi-device path, run on NVIDIA GPUs and checked against the repo's own
references.

    python chip_smoke.py               # phases 0-6 on one GPU
    python chip_smoke.py --four-cards  # node- and cell-sharded runs on 4 GPUs

Phases (one process, in order; any failure exits non-zero before the
last line):

  0. device: JAX must see a GPU (no CPU fallback);
  1. the Cook_E2 experiment through ``shakti_tpu.cli.main`` on the
     committed 12,270-node catchment mesh, f32, 3 days of hourly steps,
     with a results directory, then ``--resume`` to a 4-day horizon, and
     the steady device-loop time of the same model;
  2. f32 vs f64 on the card, and f64 on the card vs f64 on the host CPU,
     on the 12,270-node bench model (96 hourly steps);
  3. the slab and lake golden cases in f64 against tests/goldens;
  4. every selectable operator format (ell, bell, bcsr): folded matvec vs
     element matvec in f64, one converged f32 window, and the XLA matvec
     time;
  5. determinism: the first Cook_E2 day marched twice;
  6. one reverse-mode gradient through the implicit solves vs central
     finite differences.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; every number
printed before it sits below the card's name and power limit.  The phase
functions take the mesh size as an argument so the CPU tests can run them
at toy sizes; the script itself runs only on GPUs.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
COOKE2_MESH_DIR = os.path.join(ROOT, "assets", "cooke2_synth")

# Tolerances, each with its reason:
# f32 vs f64 relative L2 over 96 steps — the tests/test_precision.py guard
# on the same mesh.
TOL_F32_F64 = 2e-3
# f64 on the card vs f64 on the host CPU: both runs converge Newton to
# rtol 1e-9 and CG to 1e-8, but their sums run in another order (GPU
# reductions, atomics in segment_sum), so they agree to solver tolerance
# amplified by the cold-start transient, not to the last bit.
TOL_GPU_CPU_F64 = 1e-6
# golden cases: the tests/test_goldens.py bound (max-scaled absolute).
TOL_GOLDEN = 1e-7
# folded vs element matvec in f64: the same products summed in another
# order.
TOL_MATVEC_F64 = 1e-12
# two f32 runs that differ only in atomic summation order can differ no
# more than f32 differs from f64.
TOL_RERUN_F32 = TOL_F32_F64
# adjoint vs central finite difference (f64, tight solves).
TOL_ADJOINT_FD = 1e-4
# sharded vs single-device run, f64: the solves converge to rtol 1e-9 on
# another decomposition (and, node-sharded, another preconditioner).
TOL_SHARDED = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def x64(on: bool):
    """Temporarily switch jax_enable_x64 (f64 phases inside the f32
    production process)."""
    import jax

    was = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def bench_model(nx: int | None = None):
    """The 12,270-node bench model (bench.build_bench_model) at full width,
    or an nx-by-nx slab for rehearsals."""
    if nx is None:
        from bench import build_bench_model
        return build_bench_model()
    import setups.setup_slab as slab
    return slab.initialize(nx=nx, ny=nx, days=8.0, nt_per_day=24)


def window_runner(md):
    """(run, state0, dts): md frozen, ``run(state, dts_window)`` one jitted
    run_window, dts the per-step sizes of md's whole schedule."""
    import jax

    from shakti_tpu.solve.timestep import (make_step_fn, run_window,
                                           timestep_sizes)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    run = jax.jit(lambda a, b: run_window(step, a, b))
    return run, state, timestep_sizes(md.timesteps, dtype=md.dtype)


def to_host(tree):
    import jax
    import numpy as np

    return jax.tree_util.tree_map(np.asarray, tree)


def march(md, n_steps: int, device=None):
    """Freeze ``md`` and march ``n_steps`` hourly-schedule steps in one
    jitted window on ``device``; returns (state, diags) on the host."""
    import jax

    with jax.default_device(device or jax.devices()[0]):
        run, state, dts = window_runner(md)
        s, d = to_host(run(state, dts[:n_steps]))
    check(bool(d["converged"].all()), "a step did not converge")
    return s, d


# ---------------------------------------------------------------- phase 1
def phase_main_path(out_dir: str, mesh_dir: str | None = COOKE2_MESH_DIR,
                    days: int = 3, resume_days: int = 4,
                    nt_per_day: int = 24) -> dict:
    """Cook_E2 through the CLI with a results directory, then ``--resume``
    from its checkpoint to a longer horizon, then the steady device-loop
    time of the same model (its second day, timed after the first day
    compiled and ran).  ``mesh_dir=None`` uses the setup's synthetic
    2,601-node catchment."""
    import jax
    import numpy as np

    import setups.setup_cooke2 as cooke2
    from shakti_tpu import cli

    if mesh_dir is not None:
        os.environ["SHAKTI_MESH_DIR"] = mesh_dir
    rdir = os.path.join(out_dir, "Cook_E2_smoke")

    def wrapper(d):
        path = os.path.join(out_dir, f"smoke_cooke2_{d}d.py")
        with open(path, "w") as f:
            f.write("import setups.setup_cooke2 as cooke2\n\n\n"
                    "def initialize():\n"
                    f"    return cooke2.initialize(days={d}, "
                    f"nt_per_day={nt_per_day}, results_name={rdir!r})\n")
        return path

    compile_s = [0.0]

    def on_event(name, secs, **_):
        if name in ("/jax/core/compile/backend_compile_duration",
                    "/jax/core/compile/jaxpr_to_mlir_module_duration",
                    "/jax/compilation_cache/cache_retrieval_time_sec"):
            compile_s[0] += secs

    jax.monitoring.register_event_duration_secs_listener(on_event)
    try:
        with x64(False):
            t0 = time.perf_counter()
            check(cli.main([wrapper(days), "--quiet"]) == 0, "CLI run failed")
            # the whole CLI call (setup, f64 bootstrap, run loop, IO) and
            # the compile time inside it, measured over the same interval
            cli_s = time.perf_counter() - t0
            first_compile = compile_s[0]
            check(first_compile <= cli_s, "compile outside the CLI call")
            meta = json.load(open(os.path.join(rdir, "run_meta.json")))
            for k in ("t", "nodes_x", "nodes_y", "N", "b", "qx", "qy"):
                check(os.path.exists(os.path.join(rdir, f"{k}.npy")),
                      f"missing {k}.npy")
            for k in ("log.csv", "checkpoint.npz", "run_meta.json"):
                check(os.path.exists(os.path.join(rdir, k)), f"missing {k}")
            with open(os.path.join(rdir, "log.csv")) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) > 0, "empty log.csv")
            N = np.load(os.path.join(rdir, "N.npy"))
            b = np.load(os.path.join(rdir, "b.npy"))
            check(np.isfinite(N).all() and np.isfinite(b).all(),
                  "non-finite N or b history")
            check(meta["dtype"] == "float32", f"dtype {meta['dtype']}")

            check(cli.main([wrapper(resume_days), "--resume", "--quiet"])
                  == 0, "CLI resume failed")
            meta2 = json.load(open(os.path.join(rdir, "run_meta.json")))
            n_steps = days * nt_per_day
            check(meta2["resumed_from"] == n_steps,
                  f"resumed from {meta2['resumed_from']}, not {n_steps}")
            check(meta2["steps"] == (resume_days - days) * nt_per_day,
                  f"resume ran {meta2['steps']} steps")
            N2 = np.load(os.path.join(rdir, "N.npy"))
            check(N2.shape[0] == resume_days          # one row per day
                  and np.isfinite(N2).all() and (N2[-1] != 0).any(),
                  "resumed history incomplete")
        with x64(False):
            run, state, dts = window_runner(cooke2.initialize(
                days=resume_days, nt_per_day=nt_per_day, results_name=None))
            state, _ = run(state, dts[:nt_per_day])
            jax.block_until_ready(state)
            t0 = time.perf_counter()
            state, d = run(state, dts[nt_per_day:2 * nt_per_day])
            jax.block_until_ready(state)
            loop_ms = 1e3 * (time.perf_counter() - t0) / nt_per_day
            check(bool(np.asarray(d["converged"]).all()),
                  "timed window did not converge")
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)

    steps = meta["steps"]
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "n_nodes": meta["n_nodes"], "steps": steps,
        "cli_s": cli_s,
        "run_loop_wall_s": meta["wall_s"],
        "compile_s": first_compile,
        "ms_per_step_all_in": 1e3 * cli_s / steps,
        "ms_per_step_net_of_compile": 1e3 * (cli_s - first_compile) / steps,
        "device_loop_ms_per_step": loop_ms,
        "newton_per_step": float(np.mean([float(r["newton_mean"])
                                          for r in rows])),
        "cg_per_step": float(np.mean([float(r["cg_mean"]) for r in rows])),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "resume_steps": meta2["steps"],
    }


# ---------------------------------------------------------------- phase 2
def phase_precision(nx: int | None = None, n_steps: int = 96) -> dict:
    """f32 vs f64 on the card, and f64 card vs f64 host CPU."""
    import jax
    import jax.numpy as jnp

    out = {}
    with x64(True):
        runs = {}
        for name, dtype, dev in (("f32", jnp.float32, None),
                                 ("f64", jnp.float64, None),
                                 ("f64_cpu", jnp.float64,
                                  jax.devices("cpu")[0])):
            md = bench_model(nx)
            md.dtype = dtype
            runs[name], _ = march(md, n_steps, dev)
        for f in ("N", "b"):
            e = rel_l2(getattr(runs["f32"], f), getattr(runs["f64"], f))
            out[f"f32_vs_f64_{f}"] = e
            check(e < TOL_F32_F64, f"f32 vs f64 {f}: {e:.3e}")
            e = rel_l2(getattr(runs["f64"], f), getattr(runs["f64_cpu"], f))
            out[f"f64_gpu_vs_cpu_{f}"] = e
            check(e < TOL_GPU_CPU_F64, f"f64 gpu vs cpu {f}: {e:.3e}")
    return out


# ---------------------------------------------------------------- phase 3
def phase_goldens() -> dict:
    """Slab and lake golden cases in f64 against tests/goldens."""
    import importlib.util

    import numpy as np

    # by path: an installed package named ``tests`` would shadow the
    # repo's namespace package
    spec = importlib.util.spec_from_file_location(
        "golden_cases", os.path.join(ROOT, "tests", "golden_cases.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    out = {}
    with x64(True):
        for case in (cases.slab_case, cases.lake_case):
            md, n, fname = case()
            s, _ = march(md, n)
            z = np.load(os.path.join(ROOT, "tests", "goldens", fname))
            worst = 0.0
            for k in ("N", "b", "q", "melt"):
                ref = z[k]
                scale = np.abs(ref).max() or 1.0
                worst = max(worst, float(np.abs(
                    np.asarray(getattr(s, k)) - ref).max() / scale))
            out[fname] = worst
            check(worst <= TOL_GOLDEN, f"golden {fname}: {worst:.3e}")
    return out


# ---------------------------------------------------------------- phase 4
def _operator_at_state(md):
    """(mesh, static, vals, J_c, dirichlet) for md's frozen initial state."""
    import jax
    import jax.numpy as jnp

    from shakti_tpu.physics import residual as res
    mesh, static, state, cfg = md.freeze()
    dt = jnp.asarray(3600.0, md.dtype)

    @jax.jit
    def build(st):
        pre = res.precompute_step(mesh, st.N, st.b, st.q, st.melt, static,
                                  dt, md.params, cfg.quad_degree)
        J_c = res.element_jacobian(st.N, pre, mesh, md.params)
        return J_c, res.fold_operator_values(J_c, mesh)

    J_c, vals = build(state)
    return mesh, static, vals, J_c, static.dirichlet


def median_ms(fn, *args, reps: int = 200) -> float:
    """Median wall time of ``fn(*args)`` to completion, after a warm-up."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def loop_us(matvec, vals, x, k: int = 200) -> float:
    """Per-matvec device time inside one jitted loop of ``k`` dependent
    matvecs (no per-call dispatch), in microseconds."""
    import jax

    def body(_, y):
        return x + 1e-30 * matvec(vals, y)

    run = jax.jit(lambda n: jax.lax.fori_loop(0, n, body, x),
                  static_argnums=0)
    lo, hi = median_ms(run, 1, reps=20), median_ms(run, k + 1, reps=20)
    return 1e3 * (hi - lo) / k


def operator_bytes(mesh, vals) -> int:
    """Bytes one matvec must move at least: the values and their index
    arrays once, x read and y written once."""
    idx = [a for a in (mesh.ell_cols, mesh.bell_nbr, mesh.bcsr_brow,
                       mesh.bcsr_bcol) if a is not None]
    n = mesh.n_nodes
    return int(vals.nbytes + sum(a.nbytes for a in idx)
               + 2 * n * vals.dtype.itemsize)


def phase_formats(nx: int | None = None, window: int = 24,
                  reps: int = 200) -> dict:
    """Every selectable operator format: folded vs element matvec in f64,
    one converged f32 window, and the f32 XLA matvec time — per call from
    the host (median, dispatch included) and per matvec inside a jitted
    loop, with the bandwidth the latter implies."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from shakti_tpu.physics import residual as res
    from shakti_tpu.utils.backend import HBM_PEAK_GBPS
    out = {}
    kind = jax.devices()[0].device_kind
    for fmt in ("ell", "bell", "bcsr"):
        r = {}
        with x64(True):
            md = bench_model(nx)
            md.dtype = jnp.float64
            md.operator = fmt
            if fmt == "bell":
                md.operator_block = 128
            mesh, _, vals, J_c, dirichlet = _operator_at_state(md)
            x = jnp.asarray(np.random.default_rng(0).normal(
                size=mesh.n_nodes))
            y_fold = jax.jit(res.operator_from_values(vals, mesh,
                                                      dirichlet))(x)
            y_elem = jax.jit(res.make_matvec(J_c, mesh, dirichlet))(x)
            r["matvec_f64_rel_err"] = rel_l2(y_fold, y_elem)
            check(r["matvec_f64_rel_err"] < TOL_MATVEC_F64,
                  f"{fmt} folded matvec: {r['matvec_f64_rel_err']:.3e}")
        with x64(False):
            md = bench_model(nx)
            md.operator = fmt
            if fmt == "bell":
                md.operator_block = 128
            _, d = march(md, window)
            r["window_newton_mean"] = float(d["newton_iters"].mean())
            r["window_cg_mean"] = float(d["cg_iters"].mean())
            mesh, _, vals, _, dirichlet = _operator_at_state(md)
            mv = jax.jit(lambda v, x: res.operator_from_values(
                v, mesh, dirichlet)(x))
            x = jnp.ones(mesh.n_nodes, vals.dtype)
            r["matvec_call_ms"] = median_ms(mv, vals, x, reps=reps)
            r["matvec_in_loop_us"] = loop_us(mv, vals, x)
            r["matvec_bytes"] = operator_bytes(mesh, vals)
            r["matvec_GBps"] = (r["matvec_bytes"] / 1e3
                                / r["matvec_in_loop_us"])
            if kind in HBM_PEAK_GBPS:
                r["matvec_pct_hbm_peak"] = (100 * r["matvec_GBps"]
                                            / HBM_PEAK_GBPS[kind])
        out[fmt] = r
    return out


# ---------------------------------------------------------------- phase 5
def phase_determinism(mesh_dir: str | None = COOKE2_MESH_DIR,
                      n_steps: int = 24) -> dict:
    """Phase 1's first day (Cook_E2, f32, default solver) marched twice
    from the same state."""
    import setups.setup_cooke2 as cooke2

    if mesh_dir is not None:
        os.environ["SHAKTI_MESH_DIR"] = mesh_dir
    with x64(False):
        run, state, dts = window_runner(
            cooke2.initialize(days=1, results_name=None))
        a, da = to_host(run(state, dts[:n_steps]))
        b, db = to_host(run(state, dts[:n_steps]))
    check(bool(da["converged"].all() and db["converged"].all()),
          "a step did not converge")
    out = {f"rerun_rel_{f}": rel_l2(getattr(a, f), getattr(b, f))
           for f in ("N", "b")}
    for k, v in out.items():
        check(v < TOL_RERUN_F32, f"{k}: {v:.3e}")
    return out


# ---------------------------------------------------------------- phase 6
def phase_adjoint(nx: int | None = None, n_steps: int = 5) -> dict:
    """d(mean final N)/d(inputs_scale) through ``n_steps`` implicit solves
    (IFT custom VJP) vs a central finite difference, f64."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from shakti_tpu.solve.timestep import (make_step_fn, run_window,
                                           timestep_sizes)
    with x64(True):
        md = bench_model(nx)
        md.dtype = jnp.float64
        md.inputs = np.full(md.x.size, 1e-8)     # meltwater the gradient sees
        md.solver = dataclasses.replace(
            md.solver, differentiable=True, lag_operator=False,
            adaptive_dt_levels=0, rtol=1e-12, atol=1e-13, lin_rtol=1e-12)
        mesh, static, state, cfg = md.freeze()
        step = make_step_fn(mesh, static, md.params, cfg)
        dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:n_steps]

        @jax.jit
        def loss(scale):
            forcing = {"dt": dts, "inputs_scale": jnp.full_like(dts, scale)}
            s, _ = run_window(step, state, forcing)
            return jnp.mean(s.N)

        s0 = jnp.asarray(1.0, jnp.float64)
        g = float(jax.grad(loss)(s0))
        h = 1e-5
        fd = float((loss(s0 + h) - loss(s0 - h)) / (2 * h))
    err = abs(g - fd) / abs(fd)
    check(fd != 0.0 and err <= TOL_ADJOINT_FD,
          f"adjoint {g:.6e} vs fd {fd:.6e} (rel {err:.2e})")
    return {"grad": g, "fd": fd, "rel_err": err}


# ------------------------------------------------------------- four cards
def phase_sharded(n_devices: int = 4, mesh_dir: str | None = COOKE2_MESH_DIR,
                  n_steps: int = 6) -> dict:
    """Node-sharded runner (default dist format, mg preconditioner) and
    cell-sharded step on ``n_devices``, each against the single-device run
    of the same model, f64."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import setups.setup_cooke2 as cooke2
    from shakti_tpu.parallel.dist import (gather_state,
                                          make_distributed_runner)
    from shakti_tpu.parallel.shard import (make_device_mesh,
                                           make_parallel_runner)
    from shakti_tpu.solve.timestep import timestep_sizes

    if mesh_dir is not None:
        os.environ["SHAKTI_MESH_DIR"] = mesh_dir
    jmesh = make_device_mesh(n_devices)
    check(jmesh.devices.size == n_devices, "device mesh size")

    def model(precond):
        md = cooke2.initialize(days=1, results_name=None)
        md.dtype = jnp.float64
        md.solver = dataclasses.replace(md.solver, precond=precond)
        return md

    out = {}
    with x64(True):
        # node-sharded (halo) path vs single device, mg preconditioner
        md1 = model("mg")
        s1, _ = march(md1, n_steps)
        N1, b1 = md1.to_user_order(s1.N), md1.to_user_order(s1.b)
        md2 = model("mg")
        md2.distributed = True
        runner, st0, plan = make_distributed_runner(md2, jmesh)
        check(plan["P"] == n_devices, f"halo plan has {plan['P']} shards")
        check(plan["mg_plan"] is not None, "mg hierarchy not built")
        dts = timestep_sizes(md2.timesteps, dtype=md2.dtype)[:n_steps]
        s2, d2 = runner(st0, dts)
        check(len(s2.N.sharding.device_set) == n_devices,
              "node-sharded state is not spread over the devices")
        check(bool(np.asarray(d2["converged"]).all()), "dist not converged")
        g = gather_state(plan, s2)
        out["node_sharded_format"] = plan["op_meta"]["format"]
        for f, ref in (("N", N1), ("b", b1)):
            e = rel_l2(np.asarray(getattr(g, f))[md2.node_iperm], ref)
            out[f"node_sharded_rel_{f}"] = e
            check(e < TOL_SHARDED, f"node-sharded {f}: {e:.3e}")

        # cell-sharded (replicated-node psum) path vs single device
        md3 = model("two_level")
        s3, _ = march(md3, n_steps)
        mesh, static, state, cfg = md3.freeze()
        prun = make_parallel_runner(mesh, static, md3.params, cfg, jmesh)
        s4, d4 = prun(state, timestep_sizes(md3.timesteps,
                                            dtype=md3.dtype)[:n_steps])
        check(bool(np.asarray(d4["converged"]).all()), "cell-sharded failed")
        for f in ("N", "b"):
            e = rel_l2(getattr(s4, f), getattr(s3, f))
            out[f"cell_sharded_rel_{f}"] = e
            check(e < TOL_SHARDED, f"cell-sharded {f}: {e:.3e}")
    return out


def _report(name: str, t0: float, res: dict) -> None:
    log(f"phase {name}: ok in {time.time() - t0:.1f} s")
    for k, v in res.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                log(f"  {k}.{kk} = {vv}")
        else:
            log(f"  {k} = {v}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the node- and cell-sharded paths on 4 "
                         "GPUs and their single-device comparison")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    from shakti_tpu.utils.backend import (enable_compile_cache, nvidia_smi,
                                          require_gpu)
    gpu = nvidia_smi()                 # before JAX opens the card
    import jax

    dev = require_gpu(count)           # phase 0: no CPU fallback
    cache = enable_compile_cache()
    log(f"gpu (nvidia-smi name, power.limit): {gpu}")
    log(f"jax {jax.__version__}, device_kind {dev.device_kind}, "
        f"devices {len(jax.devices())}, compile cache {cache}")
    log("every number below: " + gpu.replace("\n", " | "))

    if args.four_cards:
        t0 = time.time()
        _report("sharded (4 cards)", t0, phase_sharded(count))
    else:
        out_dir = os.path.join(ROOT, "results", "chip_smoke")
        os.makedirs(out_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            for name, fn in (
                    ("1 main path (cli.main, Cook_E2 12,270 nodes)",
                     lambda: phase_main_path(tmp)),
                    ("2 f32/f64 and gpu/cpu", phase_precision),
                    ("3 goldens", phase_goldens),
                    ("4 operator formats", phase_formats),
                    ("5 determinism", phase_determinism),
                    ("6 adjoint", phase_adjoint)):
                t0 = time.time()
                _report(name, t0, fn())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
