"""HBM roofline of the large-mesh (BCSR-regime) timestep.

For every phase of the 1M-dof single-GPU step this script pairs

  * a MEASURED per-iteration time (the phase body runs inside a
    `lax.scan` whose carry THREADS the phase output back into its input,
    so XLA can neither hoist the work out of the loop nor DCE the big
    intermediate), with
  * an ANALYTIC bytes-moved model (reads + writes of every HBM-resident
    array the phase touches, assuming perfect producer/consumer fusion
    of everything smaller — i.e. a LOWER bound on traffic, hence an
    upper bound on achieved bandwidth),

and reports achieved GB/s against the card's published HBM peak
(shakti_tpu.utils.backend.HBM_PEAK_GBPS; an unlisted device is an error).
Phases far below peak are bound by something other than bandwidth
(launches, atomics, gather latency) — those are the optimization targets;
phases near peak are done.

Usage (exits non-zero when JAX finds no GPU; --allow-cpu runs a CPU
rehearsal, whose output says "cpu" and carries no peak share):

    python scripts/roofline.py [nx] [--allow-cpu] [--full] [--phases a,b]
        [--out PATH]

nx=1000 -> 1M nodes.  --full additionally times the complete fused step.
Writes PATH (default results/roofline.json) after every phase, so an
interrupted run keeps the phases already measured.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
       else os.path.join(ROOT, "results", "roofline.json"))


def build_model(nx: int):
    """The scale_bench 1M-dof slab configuration (scripts/scale_bench.py)."""
    from shakti_tpu.api.model import ModelSetup
    from shakti_tpu.mesh.generate import rectangle_mesh
    from shakti_tpu.solve.newton import NewtonConfig

    h = 2000.0
    nodes, cells = rectangle_mesh(nx, nx, nx * h, nx * h, jitter=0.25, seed=0)
    md = ModelSetup(nodes, cells)
    md.solver = NewtonConfig(lag_operator=False, precond="two_level")
    md.z_b = 0.002 * md.x - 100.0
    md.z_s = md.z_b + 1200.0 + 0.001 * (md.x - nx * h / 2)
    md.G = np.full(md.x.size, 0.06)
    md.N_bdry = 3.7e5
    md.OutflowBoundary = lambda p: p[:, 0] < 1e-6
    rng = np.random.default_rng(0)
    md.b_init = np.maximum(0.001 + rng.normal(scale=5e-4, size=md.x.size),
                           1e-5)
    md.N_init = np.full(md.x.size, md.N_bdry)
    md.storage_on = False
    md.operator = "bcsr"        # the format this roofline models
    md.timesteps = np.linspace(0, 48 * 3600.0, 48)
    md.nt_save = 48
    return md


def main():
    from shakti_tpu.utils.backend import (HBM_PEAK_GBPS,
                                          enable_compile_cache, nvidia_smi,
                                          require_gpu)
    allow_cpu = "--allow-cpu" in sys.argv
    if allow_cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
        dev, gpu, peak = jax.devices()[0], None, None
    else:
        gpu = nvidia_smi()
        dev = require_gpu()
        if dev.device_kind not in HBM_PEAK_GBPS:
            raise SystemExit(f"error: no published HBM peak for "
                             f"'{dev.device_kind}'; add it to "
                             "shakti_tpu/utils/backend.HBM_PEAK_GBPS")
        peak = HBM_PEAK_GBPS[dev.device_kind]
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    do_full = "--full" in sys.argv
    args = [a for a in sys.argv[1:] if a.isdigit()]
    nx = int(args[0]) if args else 1000
    # --phases a,b,c: measure only the named phases (merging onto the
    # existing output file), so a change re-measures only what it touched
    only = None
    if "--phases" in sys.argv:
        only = set(sys.argv[sys.argv.index("--phases") + 1].split(","))
    want = lambda name: only is None or name in only

    from shakti_tpu.physics import residual as res
    from shakti_tpu.solve import krylov
    from shakti_tpu.solve.newton import diag_floor_extra
    from shakti_tpu.solve.precond import (coarse_from_values,
                                          coarse_inverse,
                                          two_level_from_inverse,
                                          vals_coarse_ok)
    from shakti_tpu.solve.timestep import make_step_fn, run_window

    t0 = time.time()
    md = build_model(nx)
    mesh, static, state, cfg = md.freeze()
    p = md.params
    n = int(mesh.n_nodes)
    c = int(mesh.n_cells)
    nq = 6 if cfg.quad_degree >= 4 else cfg.quad_degree + 1
    KI = int(mesh.inc_map.shape[1]) if mesh.inc_map is not None else 0
    print(f"# freeze {time.time() - t0:.0f}s n={n} c={c} "
          f"op={'bcsr' if mesh.bcsr_brow is not None else 'bell'}",
          file=sys.stderr, flush=True)
    if mesh.bcsr_brow is None:
        print(json.dumps({"error": "mesh not in BCSR regime; use nx>=450"}))
        return 8
    B = int(mesh.bcsr_B)
    nnzb = int(mesh.bcsr_brow.shape[0])
    NB = int(mesh.bcsr_NB)
    blk = cfg.coarse_block
    m = -(-n // blk)
    f4 = 4  # f32/int32 itemsize

    # ---------------- analytic bytes model (documented lower bounds) -----
    pre_fields = 9 * c * nq * f4          # Tq,b_q,mdiff,G,inputs,storage,Nn (7) + q_q (2)
    geom = (c * 3 * 2 + c + c * 3) * f4   # grads + area + cells
    inc = (n * KI * 2 + n) * f4           # inc_map + inc_mask + out write
    MB = 1.0 / 1e6
    model = {
        "matvec": (nnzb * B * B + 2 * nnzb * B + NB * B + 2 * nnzb) * f4,
        "pc_apply": (4 * n + m * m) * f4,
        # cg iter: matvec + pc + ~5 vector reads/writes x n + 2 dots
        "cg_iter": (nnzb * B * B + 2 * nnzb * B + NB * B) * f4 + (14 * n) * f4
                   + m * m * f4,
        "residual_1": n * f4 + c * 3 * f4 + pre_fields + geom + inc,
        "residual_multi3": n * 3 * f4 + c * 9 * f4 + pre_fields + geom
                           + 3 * inc,
        # primal + 3 tangent passes share the gathered/frozen data one
        # read each in the fused ideal; J write dominates
        "element_jacobian": n * f4 + pre_fields + geom + c * 9 * f4,
        # fold: read J + 2 index maps, write the padded values buffer
        # (zero-init counted once — XLA fuses init+scatter at best)
        "fold": (9 * c * 3) * f4 + nnzb * B * B * f4,
        "coarse_inverse": (9 * c * 3) * f4 + m * m * f4,
        # stream the folded values once + free-mask row gathers + m^2 out
        "coarse_from_vals": (nnzb * B * B + 2 * nnzb * B) * f4 + m * m * f4,
        # 5-field fused gather + quad-point products + outputs
        "precompute": n * 5 * f4 + c * 15 * f4 + 6 * c * nq * f4 + geom,
    }

    results = {"device": f"{dev.platform}:{dev.device_kind}",
               "gpu": gpu, "hbm_peak_GBps": peak, "n_nodes": n, "n_cells": c,
               "B": B, "nnzb": nnzb, "coarse_m": m,
               "vals_MB": round(nnzb * B * B * f4 * MB, 1),
               "true_nnz_MB": round(9 * c * f4 * MB, 1),
               "phases": {}}

    def flush():
        os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)

    def record(name, ms, note=""):
        by = model.get(name)
        ent = {"ms": round(ms, 3)}
        if by is not None and ms > 0:
            gbps = by / 1e9 / (ms / 1e3)
            ent.update(model_MB=round(by * MB, 1),
                       achieved_GBps=round(gbps, 1))
            if peak is not None:
                ent.update(pct_peak=round(100 * gbps / peak, 1),
                           sol_ms=round(by / 1e9 / peak * 1e3, 3))
        if note:
            ent["note"] = note
        results["phases"][name] = ent

        def _f(v):      # None-safe field formatting (ms <= 0, or no peak)
            return "-" if v is None else v
        print(f"{name:22s} {ms:9.3f} ms  {_f(ent.get('model_MB')):>8} MB  "
              f"{_f(ent.get('achieved_GBps')):>7} GB/s  "
              f"{_f(ent.get('pct_peak')):>5}% peak  {note}",
              file=sys.stderr, flush=True)
        flush()

    def scan_time(body, carry0, k_lo=2, k_hi=10):
        """Per-iteration ms from the k_hi-vs-k_lo scan difference: carry
        feedback defeats hoisting/DCE; the subtraction removes dispatch
        and per-call fixed costs."""
        def run(k):
            f = jax.jit(lambda c0: jax.lax.scan(
                lambda cc, _: (body(cc), None), c0, xs=None, length=k)[0])
            out = f(carry0)
            jax.block_until_ready(out)            # compile + warm
            best = np.inf
            for _ in range(3):
                t0 = time.perf_counter()
                out = f(carry0)
                jax.block_until_ready(out)
                best = min(best, time.perf_counter() - t0)
            return best
        return (run(k_hi) - run(k_lo)) / (k_hi - k_lo) * 1e3

    # settle one short window so the state is physical (2 steps)
    step = make_step_fn(mesh, static, p, cfg)
    dts = jnp.full((2,), 3600.0, mesh.nodes.dtype)
    # skip the full-step program unless --full: at 1M its compile takes
    # far longer than the phase programs below.
    dt = jnp.asarray(3600.0, mesh.nodes.dtype)
    pre = jax.jit(lambda st: res.precompute_step(
        mesh, st.N, st.b, st.q, st.melt, static, dt, p,
        cfg.quad_degree))(state)
    jax.block_until_ready(pre)
    N0 = state.N
    dirichlet = static.dirichlet
    if only is not None and os.path.exists(OUT):
        # merge: keep same-scale phases not being re-measured
        try:
            with open(OUT) as f:
                prior = json.load(f)
            if prior.get("n_nodes") == n:
                results["phases"].update(prior.get("phases", {}))
        except Exception:
            pass

    # ---- precompute: carry the pre pytree itself (forces materialization)
    def body_pre(pr):
        return res.precompute_step(
            mesh, state.N, state.b * (1.0 + 1e-30 * pr.Tq[0, 0]),
            state.q, state.melt, static, dt, p, cfg.quad_degree)
    if want("precompute"):
        record("precompute", scan_time(body_pre, pre))

    # ---- residual assemblies ----
    # pre rides the scan CARRY in these phases (and is an ARG of the
    # one-shot jits): as a closure constant its ~500 MB of quad-point
    # fields would be baked into every phase program
    r0 = jax.jit(lambda N, pr: res.assemble_residual(N, pr, mesh, p))(
        N0, pre)
    jax.block_until_ready(r0)
    if want("residual_1"):
        record("residual_1", scan_time(
            lambda c: (res.assemble_residual(N0 + 1e-30 * c[0], c[1],
                                             mesh, p), c[1]), (r0, pre)))

    if want("residual_multi3"):
        r3 = jax.jit(lambda N, pr: res.assemble_residual_multi(
            jnp.stack([N, N * (1 + 1e-7), N * (1 - 1e-7)], axis=1),
            pr, mesh, p))(N0, pre)
        jax.block_until_ready(r3)
        record("residual_multi3", scan_time(
            lambda c: (res.assemble_residual_multi(
                jnp.stack([N0 + 1e-30 * c[0][:, 0], N0 * (1 + 1e-7),
                           N0 * (1 - 1e-7)], axis=1), c[1], mesh, p),
                c[1]), (r3, pre)))

    # ---- element Jacobian (carry J: materialized every iteration) ----
    J0 = jax.jit(lambda N, pr: res.element_jacobian(N, pr, mesh, p))(
        N0, pre)
    jax.block_until_ready(J0)
    if want("element_jacobian"):
        record("element_jacobian", scan_time(
            lambda c: (res.element_jacobian(N0 + 1e-30 * c[0][0, 0, 0],
                                            c[1], mesh, p), c[1]),
            (J0, pre)))

    need_vals = only is None or (only & {"fold", "coarse_from_vals",
                                         "matvec", "pc_apply", "cg_iter"})
    if need_vals:
        # ---- fold (the scatter-add under test; carry vals) ----
        vals0 = jax.jit(lambda J: res.fold_operator_values(J, mesh))(J0)
        jax.block_until_ready(vals0)
        if want("fold"):
            record("fold", scan_time(
                lambda v: res.fold_operator_values(
                    J0 * (1.0 + 1e-30 * v[0, 0, 0]), mesh), vals0))

    # ---- coarse inverse (two-level PC build) ----
    need_ainv = only is None or (only & {"coarse_inverse",
                                         "coarse_from_vals", "pc_apply",
                                         "cg_iter"})
    if need_ainv:
        Ainv0 = jax.jit(lambda J: coarse_inverse(J, mesh, dirichlet,
                                                 blk))(J0)
        jax.block_until_ready(Ainv0)
        if want("coarse_inverse"):
            record("coarse_inverse", scan_time(
                lambda A: coarse_inverse(J0 * (1.0 + 1e-30 * A[0, 0]),
                                         mesh, dirichlet, blk),
                Ainv0, k_lo=2, k_hi=6))

    # ---- coarse inverse rebuilt from folded values (scatter-free path)
    if want("coarse_from_vals") and vals_coarse_ok(mesh, blk):
        def cfv_body(cv):
            v, A = cv
            return (v, coarse_from_values(v * (1.0 + 1e-30 * A[0, 0]),
                                          mesh, dirichlet, blk))
        record("coarse_from_vals",
               scan_time(cfv_body, (vals0, Ainv0), k_lo=2, k_hi=6))

    if only is None or (only & {"matvec", "pc_apply", "cg_iter"}):
        a_diag = jax.jit(
            lambda v: res.operator_diag_from_values(v, mesh))(vals0)
        extra = jax.jit(lambda ad: diag_floor_extra(
            ad, dirichlet, mesh, cfg.diag_floor_rel))(a_diag)
        a_diag = a_diag + extra
        jax.block_until_ready(a_diag)

        # ---- operator matvec ----
        # vals0 rides the scan CARRY, not the closure, so the ~1.1 GB
        # values array is not baked into the program as a constant.  The
        # fixed-cost subtraction in scan_time removes the arg-transfer
        # difference.
        def mv_body(cv):
            v, x = cv
            y = res.operator_from_values(v, mesh, dirichlet)(x) + extra * x
            return (v, y / jnp.linalg.norm(y))
        if want("matvec"):
            record("matvec", scan_time(mv_body, (vals0, r0),
                                       k_lo=2, k_hi=18))

        # ---- preconditioner apply ----
        minv = two_level_from_inverse(Ainv0, a_diag, dirichlet, blk, n)
        if want("pc_apply"):
            record("pc_apply", scan_time(
                lambda x: (lambda y: y / jnp.linalg.norm(y))(minv(x)), r0,
                k_lo=2, k_hi=18))

        # ---- CG per iteration (forced iters, fixed operator) ----
        def cg_k(k):
            def run_cg(v, r):
                mv = res.operator_from_values(v, mesh, dirichlet)
                return krylov.pcg(lambda x: mv(x) + extra * x, r, minv,
                                  rtol=0.0, atol=0.0, maxiter=k)[0]
            f = jax.jit(run_cg)     # vals as ARG (not a 1.1 GB constant)
            out = f(vals0, r0)
            jax.block_until_ready(out)
            best = np.inf
            for _ in range(3):
                t0 = time.perf_counter()
                out = f(vals0, r0)
                jax.block_until_ready(out)
                best = min(best, time.perf_counter() - t0)
            return best
        if want("cg_iter"):
            record("cg_iter", (cg_k(12) - cg_k(2)) / 10 * 1e3)

    # ---- full fused step (optional: big compile) ----
    if do_full:
        runner = jax.jit(lambda s, d: run_window(step, s, d))
        t0 = time.time()
        s1, diag = runner(state, jnp.full((4,), 3600.0, mesh.nodes.dtype))
        jax.block_until_ready(s1)
        print(f"# full-step compile+4 steps {time.time() - t0:.0f}s",
              file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        s2, diag = runner(s1, jnp.full((4,), 3600.0, mesh.nodes.dtype))
        jax.block_until_ready(s2)
        ms = (time.perf_counter() - t0) / 4 * 1e3
        record("full_step", ms,
               note=f"newton_mean="
                    f"{float(np.asarray(diag['newton_iters']).mean()):.2f} "
                    f"cg_mean="
                    f"{float(np.asarray(diag['cg_iters']).mean()):.1f}")

    # ---- derived budget: what the phase model predicts a step costs ----
    ph = results["phases"]
    nm, cgm = 2.0, 6.0        # typical warm-run Newton/CG counts at 1M
    if do_full and "full_step" in ph:
        note = ph["full_step"]["note"]
        nm = float(note.split("newton_mean=")[1].split()[0])
        cgm = float(note.split("cg_mean=")[1].split()[0])
    needed = ("precompute", "residual_multi3", "element_jacobian", "fold",
              "residual_1", "cg_iter")
    if all(k in ph for k in needed) and (
            "coarse_from_vals" in ph or "coarse_inverse" in ph):
        coarse = ph.get("coarse_from_vals", ph.get("coarse_inverse"))
        budget = (ph["precompute"]["ms"] + ph["residual_multi3"]["ms"]
                  + nm * (ph["element_jacobian"]["ms"] + ph["fold"]["ms"]
                          + coarse["ms"]
                          + ph["residual_1"]["ms"])
                  + cgm * ph["cg_iter"]["ms"])
        results["derived"] = {
            "newton_mean_assumed": nm, "cg_mean_assumed": cgm,
            "solver_budget_ms": round(budget, 1),
            "note": "budget excludes the explicit-update tail and launch "
                    "gaps",
        }
    flush()
    print(json.dumps({"roofline": OUT,
                      "solver_budget_ms": results.get("derived", {}).get(
                          "solver_budget_ms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
