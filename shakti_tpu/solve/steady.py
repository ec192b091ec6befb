"""Direct steady-state solver: pseudo-transient continuation (PTC).

The reference has no steady-state capability — equilibria are found by
marching the transient for years of hourly steps (reference
notebooks/example.ipynb; the SHMIP tuning runs in scripts/shmip_validate.py
do the same).  This module finds them directly, reusing the fused timestep
as the PTC iteration:

  * the gap evolution runs SEMI-IMPLICITLY (``make_step_fn(...,
    b_update="semi_implicit")``): the creep-closure term — linear in b —
    is treated backward-Euler, so the closure decay mode is
    unconditionally stable and the pseudo-timestep is not bound by the
    closure timescale (A N^3 ~ hours at channel pressures);
  * dt adapts by switched-evolution relaxation (SER): dt grows as the
    steady-state residual falls (dt_{k+1} = dt_k * rate_{k-1}/rate_k,
    clipped), shrinks on rejected steps;
  * remaining explicit physics bounds dt: the melt-opening feedback
    (m ~ b^3 at fixed head gradient => d(db/dt)/db ~ +2 m/(rho_i b),
    the channelization instability) is only stabilized through the
    N-solve's head response, so dt is additionally capped at
    ``stab_safety / max(3 m / (rho_i b))`` each step;
  * a step is rejected (state reverted, dt shrunk) when its Newton solve
    fails, produces non-finite values, or moves b by more than
    ``max_rel_change`` in relative L2 — the oscillation guard for dt
    beyond the coupled stability limit;
  * convergence is certified in-graph: the relative state drift per
    reference time, rate = max(||dN||/||N||, ||db||/||b||) * t_ref/dt,
    must fall below ``tol`` on an accepted step.  With t_ref = 1 year and
    tol = 1e-3 the accepted state moves less than 0.1% per year — the
    same "has it stopped changing" judgement the reference user makes by
    eyeballing year-over-year transients, made quantitative.

The whole driver is one ``lax.while_loop`` under jit: a steady solve is a
single device program, like a transient window.  Works on the
single-device mesh path; the node-sharded halo path supplies its psum'd
norms through ``mesh`` (reductions and the dt cap are then globally
consistent across shards).

Why the dt cap is GLOBAL (measured on the slab case, 30x30, f64): the
pseudo-dt is bound by the fastest dissipation-active node (the
channelization feedback near moulins/channels), while the slow tail is
far-field closure relaxation with a ~1000x longer timescale — the obvious
accelerations do NOT survive contact with the coupled system:

  * uncapped SER dt -> sustained limit cycle (rate stalls ~1/yr; the
    frozen-N melt feedback amplification (1+3c dt)/(1+c dt) -> 3 at large
    dt and the N-response no longer damps it);
  * per-node local time stepping (each node at its own stability bound,
    the gap update being a nodal ODE) -> collective oscillation: every
    dissipation-active node then sits at amplification ~1.8 and they
    couple through the N-solve (rate stalls ~2-5/yr);
  * a two-tier split (uniform cap on dissipation-active nodes, local
    equilibrium jumps in the far field) -> the large far-field jumps push
    the state out of the N-solve's Newton basin (unrecoverable rejection);
  * Aitken extrapolation of the outer fixed point -> consecutive diffs
    only ~0.77-correlated (the slow "mode" rotates), ~3% net gain.

The capped march converges monotonically; with the default tol (1e-2/yr
drift) it needs a few hundred pseudo-steps of ~2 Newton iterations each —
on the slab case that is ~200x fewer steps than hourly transient marching
to the same drift (the reference's only route).  ``dt_b`` per-node
stepping support remains in solve/timestep.py for future work; this
driver intentionally does not use it.

Two further mechanisms, both forced by the SHMIP suite-A cases (measured
on A1, the lowest-input case, 60x12 f64):

  * **N-pinned boundary nodes are excluded from the drift certificate**
    (``drift_mask``): where the Dirichlet value pins N near zero (SHMIP's
    margin: ~9 kPa), creep closure A b N^n nearly vanishes and the gap
    has no reachable equilibrium — its balance point m/(rho_i A N^n) is
    tens of meters away on a multi-millennial timescale (A1: b* ~ 49 m,
    1/(A N^3) ~ 19,000 yr), far outside the sheet model's validity.  The
    margin gap drifts LINEARLY through any finite march — the transient
    route has the identical property, which is why the reference's own
    validation only ever judges window metrics (SHMIP.md suite A).
    Measured: 99.99996% of A1's non-converging drift norm lived on its 13
    Dirichlet nodes.  Their residual drift is reported honestly as
    ``rate_b_bdry``.
  * **An adaptive stability cap for the staggered b<->N coupling**: the
    N-solve is quasi-static, so at large dt the PTC step tends to the
    staggered fixed-point iteration b <- balance(N), N <- solve(b), whose
    spectral radius exceeds 1 when N is very sensitive to b (A1: b ~ mm,
    transmissivity ~ b^3).  The signature is a limit cycle — period-2
    (consecutive accepted dN anticorrelated) or long-period (A1:
    consecutive 500-step increments correlate at -0.98) — with the rate
    stalled while SER hovers dt AT the instability boundary forever
    (memoryless feedback cannot move off a marginal cycle).  dt acts as
    under-relaxation, so the cure is a persistent cap
    dt <= kappa / max(A |N|^n) over certificate nodes, with kappa found
    EMPIRICALLY in-graph by two windowed detectors (body comment):
    period-2 counts over a fast window, geometric-mean-rate stalls over
    a slow window; both fire only when dt was roughly flat across their
    window (hover signature — cold-start equilibration grows dt ~4x/step
    and must not tighten: measured death spirals otherwise), and a
    detection pins kappa to half the hovering dt.  Stall-tightens are
    probationary (revert + exponential backoff unless the next window's
    rate actually improves): a stall alone cannot distinguish a cycle
    from a genuinely slow transient, whose rate is dt-independent —
    un-probed, A3 tightened itself to kappa_min while simply being
    10 years from equilibrium.  A fixed kappa cannot work: the coupling
    gain depends on the mesh and regime (A1 pins near kappa ~ 0.03; the
    slab is stable at kappa = 1 with dt 7.7e5 s, converging in 199 PTC
    steps).  High-melt SHMIP cases (A3/A5) keep genuinely persistent
    channelization dynamics — their certified rate plateaus at
    ~0.3-3/yr; the transient route shows the same physics (suite-A
    year-over-year window metrics still moving at year 10-12), so the
    honest artifact reports the plateau (``strict=False``), not a
    certificate.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from shakti_tpu.fem.ops import vdot

YEAR = 3.1536e7     # 365-day year [s], the default rate-reference time


def steady_solve(step_fn, state0, *, params, dt0=3600.0, dt_max=1e9,
                 tol=1e-2, t_ref=YEAR, max_steps=2000, growth_cap=4.0,
                 shrink=0.25, max_rel_change=0.5, stab_safety=2.0,
                 drift_mask=None, kappa0=1.0, kappa_min=1e-3,
                 osc_corr=-0.5, osc_M=20, stall_M=200, imp_eps=0.02,
                 mesh=None, carry_in=None, return_carry=False):
    """March ``step_fn`` to steady state with adaptive pseudo-timesteps.

    ``step_fn`` should be built with ``b_update="semi_implicit"`` (an
    explicit-closure step caps useful dt at the closure timescale) and
    WITHOUT the dt-halving wrapper (``adaptive_dt_levels=0`` — rejection
    handles failed steps here).  ``state0.lag_op`` must be None
    (``lag_operator=False``): rejected steps would revert the carry.

    ``params``: the PhysicalParams — rho_i for the melt-opening dt cap
    and (A, n) for the adaptive b<->N coupling cap (module docstring).
    ``drift_mask``: optional (n,) bool/float, 1 where a node counts toward
    the drift certificate, the max_rel_change guard, and the dt caps.
    Pass ``~dirichlet`` for meshes whose Dirichlet value pins N near zero
    (the SHMIP margin — no reachable gap equilibrium there); excluded
    nodes' residual gap drift is reported as ``rate_b_bdry``.

    Returns ``(state, info)`` with info scalars still on device:
    ``converged`` (rate < tol on an accepted step), ``steps`` (total
    attempts), ``accepted``, ``rejected``, ``rate`` / ``rate_N`` /
    ``rate_b`` (final drift per t_ref over certificate nodes),
    ``rate_b_bdry`` (drift of mask-excluded nodes; 0 when none),
    ``kappa`` (final coupling-cap multiplier), ``dt`` (final
    pseudo-timestep), ``t_pseudo`` (accumulated pseudo-time),
    ``newton_total`` / ``cg_total``.

    Segmented marching (checkpoint/resume of hours-long solves,
    api/steady.py): ``carry_in`` re-enters the march with the full loop
    carry of an earlier call (the carry pytree round-trips through
    ``np.savez`` exactly, so a resumed march replays the uninterrupted
    iterate sequence bit-for-bit); ``return_carry=True`` appends that
    carry as a third return value.  The carry's ``k_end`` entry is the
    attempt index the loop pauses at — raise it (up to ``max_steps``)
    before re-entering.  Both default off; the single-shot path is
    unchanged.
    """
    if state0.lag_op is not None:
        raise ValueError("steady_solve requires lag_operator=False "
                         "(State.lag_op must be None)")
    sharded = mesh is not None and mesh.halo is not None
    pamax = ((lambda x: jax.lax.pmax(x, mesh.halo.axis)) if sharded
             else (lambda x: x))
    pall = ((lambda x: jax.lax.pmin(x.astype(jnp.int32),
                                    mesh.halo.axis) > 0) if sharded
            else (lambda x: x))
    dtype = state0.N.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    f = lambda v: jnp.asarray(v, dtype)
    i32 = lambda v: jnp.asarray(v, jnp.int32)

    # certificate mask (1 = counts), excluded mask (1 = mask-excluded and
    # owned); halo.norm/dot re-apply the owned mask under sharding, so the
    # ghost handling composes either way
    act = None if drift_mask is None else jnp.asarray(drift_mask, dtype)
    if sharded and act is not None:
        act = act * mesh.halo.owned_mask
    exc = None if act is None else (
        (mesh.halo.owned_mask if sharded else f(1.0)) - act)

    def mnorm(x, m=None):
        x = x if m is None else x * m
        return mesh.halo.norm(x) if sharded else jnp.linalg.norm(x)

    def mdot(a, b):
        return mesh.halo.dot(a, b) if sharded else vdot(a, b)

    def rates(old, new, dt):
        rN = mnorm(new.N - old.N, act) / jnp.maximum(mnorm(old.N, act), tiny)
        rb = mnorm(new.b - old.b, act) / jnp.maximum(mnorm(old.b, act), tiny)
        per_ref = f(t_ref) / dt
        rbx = f(0.0)
        if exc is not None:
            rbx = (mnorm(new.b - old.b, exc)
                   / jnp.maximum(mnorm(old.b, exc), tiny)) * per_ref
        return rN * per_ref, rb * per_ref, rb, rbx

    def dt_cap(state, kappa):
        """Two stability bounds on the pseudo-timestep (module docstring):
        (1) the explicit melt-opening feedback — the frozen-N gap ODE
        grows like +3 m/(rho_i b) where melt opens and only the N-coupling
        damps it; (2) the staggered b<->N coupling — dt under-relaxes the
        large-dt fixed-point iteration, unstable beyond ~kappa/(A |N|^n),
        with kappa adapted by the oscillation detector in ``body``.
        Certificate-excluded nodes (and, sharded, ghost/dead slots) must
        not bind the GLOBAL dt: each node contributes once, through its
        owning shard, and only if masked in."""
        lam = 3.0 * jnp.maximum(state.melt, 0.0) / (params.rho_i *
                                                    jnp.maximum(state.b, tiny))
        lam2 = params.A * jnp.abs(state.N) ** params.n
        m = act if act is not None else (
            mesh.halo.owned_mask if sharded else None)
        if m is not None:
            lam, lam2 = lam * m, lam2 * m
        cap1 = f(stab_safety) / jnp.maximum(pamax(jnp.max(lam)), tiny)
        cap2 = kappa / jnp.maximum(pamax(jnp.max(lam2)), tiny)
        return jnp.minimum(cap1, cap2), cap2

    def cond(c):
        return (~c["done"]) & (c["k"] < c["k_end"])

    def body(c):
        state, dt, kappa = c["state"], c["dt"], c["kappa"]
        new_state, d = step_fn(state, dt)
        finite = pall(jnp.all(jnp.isfinite(new_state.N))
                      & jnp.all(jnp.isfinite(new_state.b)))
        rate_N, rate_b, rel_b, rate_bx = rates(state, new_state, dt)
        accept = d["converged"] & finite & (rel_b <= max_rel_change)
        rate = jnp.maximum(rate_N, rate_b)
        sel = lambda a, b: jnp.where(accept, a, b)
        out_state = jax.tree_util.tree_map(sel, new_state, state)
        done = accept & (rate < tol)
        # oscillation detector: correlation of consecutive ACCEPTED state
        # increments; a persistent negative value while unconverged is the
        # period-2 signature of the staggered-coupling instability
        dN = new_state.N - state.N
        ndN = mnorm(dN, act)
        corr = mdot(dN if act is None else dN * act, c["dN_prev"]) \
            / jnp.maximum(ndN * c["ndN_prev"], tiny)
        cap_all, cap2 = dt_cap(out_state, kappa)
        # SER is memoryless, so it equilibrates dt AT the instability
        # boundary and hovers there in a sustained marginal cycle
        # (measured on A1: dt pinned at 1.4e5 s, rate cycling 7-120/yr,
        # forever) — possibly far BELOW the kappa cap, so "dt near the
        # cap" can never be the detector gate.  Instead both detectors
        # run on windows of accepted steps and fire only when dt was
        # ROUGHLY FLAT across the window (hover signature; during
        # cold-start equilibration SER grows dt ~4x/step, which gates the
        # detectors off and prevents the measured kappa death spirals).
        # A detection then PINS the coupling cap at half the hovering dt:
        # kappa <- dt/2 * max(A|N|^n) expressed in kappa units.
        #   * fast window (osc_M): counts period-2 signatures — per-step
        #     increment correlation < osc_corr;
        #   * slow window (stall_M): long-period cycles defeat the
        #     per-step detector (measured on A1: consecutive 500-step
        #     increments correlate at -0.98 while per-step correlations
        #     stay mild) — fire when the window's geometric-mean rate
        #     stops improving.  Block AVERAGES, not a running min: a
        #     cycle's dips each beat a min tracker and reset it forever
        #     (measured: A1 stuck at kappa 0.25, rate 7.4/yr, 40k steps).
        # kappa only ever tightens — a relax rule re-destabilized A1
        # every few hundred steps (measured); each tightening resets the
        # windows and the improvement baseline (a baseline carried across
        # tightenings mis-reads post-tightening damping as stall).
        acc_i = accept.astype(jnp.int32)
        cneg = c["cneg"] + (accept & (corr < osc_corr)).astype(jnp.int32)
        cw = c["cw"] + acc_i
        fast_done = cw >= osc_M
        dt_flat_f = dt <= f(2.0) * c["dt_fmark"]
        osc = fast_done & (cneg >= osc_M // 2) & (rate >= tol) \
            & dt_flat_f & accept
        ssum = c["ssum"] + jnp.where(accept,
                                     jnp.log(jnp.maximum(rate, tiny)),
                                     f(0.0))
        sw = c["sw"] + acc_i
        slow_done = (sw >= stall_M) & accept
        avg = ssum / jnp.maximum(sw, 1).astype(dtype)
        # A slow-window stall cannot by itself distinguish a limit cycle
        # (tightening damps it — the rate then collapses) from a genuinely
        # slow transient (the rate is dt-INDEPENDENT, so tightening only
        # wastes pseudo-time; un-probed, the stall rule halves dt every
        # 2 windows straight to kappa_min — measured on A3, whose
        # equilibration simply takes ~10 years).  So stall-tightens are
        # PROBATIONARY: if the window after a stall-tighten did not
        # improve the geometric-mean rate by 5*imp_eps, the tightening is
        # REVERTED and further stall attempts back off exponentially
        # (osc-tightens stay unconditional — a half-window of period-2
        # increments is not produced by smooth marching).
        on_probe = c["pend"] > 0
        helped = avg < c["pre_avg"] - f(5.0 * imp_eps)
        revert = slow_done & on_probe & (~helped)
        stalled = slow_done & (~on_probe) & (c["skip"] <= 0) \
            & (avg > c["prev_avg"] - f(imp_eps)) \
            & (rate >= tol) & (dt <= f(2.0) * c["dt_smark"])
        tighten = osc | stalled
        lam2max = kappa / cap2          # max active coupling rate
        kappa_pin = jnp.maximum(f(0.5) * dt * lam2max, f(kappa_min))
        kappa_new = jnp.where(tighten, jnp.minimum(kappa, kappa_pin),
                              jnp.where(revert, c["kappa_saved"], kappa))
        cap_new = jnp.minimum(cap_all, cap2 * kappa_new / kappa)
        # SER: grow dt as the drift rate falls, shrink when it rises;
        # hard-shrink on rejection; always respect the stability caps
        ser = jnp.clip(c["rate"] / jnp.maximum(rate, tiny),
                       f(shrink), f(growth_cap))
        dt_acc = jnp.minimum(jnp.minimum(dt * ser, f(dt_max)), cap_new)
        dt_new = jnp.where(accept, dt_acc, jnp.maximum(dt * f(shrink),
                                                       f(1e-6) * f(dt0)))
        return {
            "state": out_state,
            "dt": dt_new,
            "kappa": kappa_new,
            # window bookkeeping (rationale in the detector comment above)
            "cw": jnp.where(tighten | fast_done, i32(0), cw),
            "cneg": jnp.where(tighten | fast_done, i32(0), cneg),
            "dt_fmark": jnp.where(tighten | fast_done, dt_new,
                                  c["dt_fmark"]),
            "sw": jnp.where(tighten | slow_done, i32(0), sw),
            "ssum": jnp.where(tighten | slow_done, f(0.0), ssum),
            "prev_avg": jnp.where(tighten, f(jnp.inf),
                                  jnp.where(slow_done, avg,
                                            c["prev_avg"])),
            "dt_smark": jnp.where(tighten | slow_done, dt_new,
                                  c["dt_smark"]),
            # stall probation: pend=1 while a stall-tighten awaits its
            # next-window evaluation; osc fires clear it (kappa moved —
            # the saved baseline is stale); failed probes exponentially
            # back off further stall attempts via skip/wait
            "pend": jnp.where(stalled, i32(1),
                              jnp.where(osc | slow_done, i32(0),
                                        c["pend"])),
            "pre_avg": jnp.where(stalled, avg, c["pre_avg"]),
            "kappa_saved": jnp.where(stalled, kappa, c["kappa_saved"]),
            "skip": jnp.where(revert, c["wait"],
                              jnp.where(slow_done,
                                        jnp.maximum(c["skip"] - 1, i32(0)),
                                        c["skip"])),
            "wait": jnp.where(revert,
                              jnp.minimum(c["wait"] * 2 + 1, i32(32)),
                              jnp.where((slow_done & on_probe & helped)
                                        | osc, i32(0), c["wait"])),
            "dN_prev": jnp.where(accept, dN, c["dN_prev"]),
            "ndN_prev": jnp.where(accept, ndN, c["ndN_prev"]),
            "rate": jnp.where(accept, rate, c["rate"]),
            "rate_N": jnp.where(accept, rate_N, c["rate_N"]),
            "rate_b": jnp.where(accept, rate_b, c["rate_b"]),
            "rate_b_bdry": jnp.where(accept, rate_bx, c["rate_b_bdry"]),
            "t_pseudo": c["t_pseudo"] + jnp.where(accept, dt, f(0.0)),
            "k": c["k"] + 1,
            "accepted": c["accepted"] + accept.astype(jnp.int32),
            "rejected": c["rejected"] + (~accept).astype(jnp.int32),
            "newton_total": c["newton_total"] + d["newton_iters"],
            "cg_total": c["cg_total"] + d["cg_iters"],
            "done": done,
            "k_end": c["k_end"],
        }

    init = steady_carry_init(state0, dt0=dt0, kappa0=kappa0,
                             max_steps=max_steps)
    out = jax.lax.while_loop(cond, body,
                             init if carry_in is None else carry_in)
    info = steady_info_from_carry(out)
    if return_carry:
        return out["state"], info, out
    return out["state"], info


def steady_carry_init(state0, *, dt0, kappa0=1.0, max_steps=2000):
    """The PTC while-loop's initial carry (shared by :func:`steady_solve`
    and the segmented checkpoint/resume driver in api/steady.py, which
    needs the carry's pytree structure to round-trip it through npz)."""
    dtype = state0.N.dtype
    f = lambda v: jnp.asarray(v, dtype)
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    return {
        "k_end": i32(max_steps),
        "state": state0, "dt": f(dt0), "kappa": f(kappa0),
        "cw": i32(0), "cneg": i32(0), "dt_fmark": f(dt0),
        "sw": i32(0), "ssum": f(0.0), "prev_avg": f(jnp.inf),
        "dt_smark": f(dt0),
        "pend": i32(0), "pre_avg": f(jnp.inf), "kappa_saved": f(kappa0),
        "skip": i32(0), "wait": i32(0),
        "dN_prev": jnp.zeros_like(state0.N), "ndN_prev": f(0.0),
        "rate": f(jnp.inf), "rate_N": f(jnp.inf), "rate_b": f(jnp.inf),
        "rate_b_bdry": f(0.0),
        "t_pseudo": f(0.0), "k": i32(0),
        "accepted": i32(0), "rejected": i32(0),
        "newton_total": i32(0), "cg_total": i32(0),
        "done": jnp.asarray(False),
    }


def steady_info_from_carry(out):
    """The user-facing info dict of :func:`steady_solve`, from a carry."""
    info = {k: out[k] for k in ("done", "k", "accepted", "rejected", "rate",
                                "rate_N", "rate_b", "rate_b_bdry", "kappa",
                                "dt", "t_pseudo", "newton_total",
                                "cg_total")}
    info["converged"] = info.pop("done")
    info["steps"] = info.pop("k")
    return info


def cycle_certify(step_fn, state0, *, params, dt, tol=1e-2, t_ref=YEAR,
                  window=400, max_attempts=None, shrink=0.25,
                  max_rel_change=0.5, drift_mask=None, mesh=None):
    """Certify a PTC plateau as a statistically-stationary limit cycle.

    High-melt regimes keep genuinely persistent channelization dynamics
    (module docstring: SHMIP A3/A5 plateau at ~0.3-3/yr; the transient
    route's own year-over-year metrics still move at year 10-12), so the
    pointwise drift certificate can NEVER fire there.  The conclusive
    statement for such a regime is a CYCLE certificate: the orbit's
    centroid has stopped moving even though the state has not.  March two
    consecutive windows of ``window`` ACCEPTED steps from the plateau at
    its final pseudo-timestep (no SER — the plateau march was stable
    there; rejections shrink dt and it regrows toward the input value),
    accumulate each window's time-mean state, and certify when the two
    window means agree to ``tol`` per ``t_ref`` of pseudo-time:

        cycle_rate = max_f ||mean2_f - mean1_f|| / ||mean1_f||
                     * t_ref / T_window   < tol      (f in {N, b})

    A window shorter than the cycle period leaves consecutive means
    different and honestly fails the certificate (raise ``window``); a
    slow true transient fails it the same way.  Accumulation is centered
    on the entry state (sums of N_k - N0), so the variance subtraction is
    computed on amplitude-scale numbers — safe in f32.

    Returns ``(mean_state, info)``: mean_state is the window-2 time-mean
    (the scientifically meaningful output of a cycling regime — the
    reference has no analogue); info scalars (still on device):
    ``certified``, ``cycle_rate``, ``amp_N`` / ``amp_b`` (relative RMS
    deviation of window 2 around its mean — the cycle amplitude),
    ``steps`` / ``accepted`` / ``rejected``, ``t_window`` (pseudo-time of
    window 2), ``newton_total`` / ``cg_total``.  Works on the halo path
    via ``mesh`` like :func:`steady_solve` (psum'd norms).
    """
    if max_attempts is None:
        max_attempts = 4 * window
    sharded = mesh is not None and mesh.halo is not None
    pall = ((lambda x: jax.lax.pmin(x.astype(jnp.int32),
                                    mesh.halo.axis) > 0) if sharded
            else (lambda x: x))
    dtype = state0.N.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    f = lambda v: jnp.asarray(v, dtype)
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    act = None if drift_mask is None else jnp.asarray(drift_mask, dtype)
    if sharded and act is not None:
        act = act * mesh.halo.owned_mask

    def mnorm(x, m=None):
        x = x if m is None else x * m
        return mesh.halo.norm(x) if sharded else jnp.linalg.norm(x)

    N0, b0 = state0.N, state0.b
    q0, melt0 = state0.q, state0.melt
    zeros = lambda a: jnp.zeros_like(a)

    def body(c):
        state = c["state"]
        new_state, d = step_fn(state, c["dt"])
        finite = pall(jnp.all(jnp.isfinite(new_state.N))
                      & jnp.all(jnp.isfinite(new_state.b)))
        rel_b = mnorm(new_state.b - state.b, act) \
            / jnp.maximum(mnorm(state.b, act), tiny)
        accept = d["converged"] & finite & (rel_b <= max_rel_change)
        sel = lambda a, b: jnp.where(accept, a, b)
        out_state = jax.tree_util.tree_map(sel, new_state, state)
        add = lambda s, v: s + jnp.where(accept, v, zeros(v))
        # centered accumulators (around the ENTRY state, f32-safe)
        sN = add(c["sN"], out_state.N - N0)
        sb = add(c["sb"], out_state.b - b0)
        sq = add(c["sq"], out_state.q - q0)
        sm = add(c["sm"], out_state.melt - melt0)
        s2N = c["s2N"] + jnp.where(accept,
                                   mnorm(out_state.N - N0, act) ** 2, f(0.0))
        s2b = c["s2b"] + jnp.where(accept,
                                   mnorm(out_state.b - b0, act) ** 2, f(0.0))
        n = c["n"] + accept.astype(jnp.int32)
        tw = c["tw"] + jnp.where(accept, c["dt"], f(0.0))
        win_done = n >= window
        K = jnp.maximum(n, 1).astype(dtype)
        # on rejection shrink; otherwise regrow toward the plateau dt
        dt_new = jnp.where(accept,
                           jnp.minimum(c["dt"] * f(1.2), f(dt)),
                           c["dt"] * f(shrink))
        phase_new = c["phase"] + win_done.astype(jnp.int32)
        keep1 = win_done & (c["phase"] == 0)
        sel1 = lambda m1, s: jnp.where(keep1, s / K, m1)
        return {
            "state": out_state, "dt": dt_new, "phase": phase_new,
            "n": jnp.where(win_done, i32(0), n),
            "tw": jnp.where(win_done, f(0.0), tw),
            "t1": jnp.where(keep1, tw, c["t1"]),
            "sN": jnp.where(win_done, zeros(sN), sN),
            "sb": jnp.where(win_done, zeros(sb), sb),
            "sq": jnp.where(win_done, zeros(sq), sq),
            "sm": jnp.where(win_done, zeros(sm), sm),
            "s2N": jnp.where(win_done, f(0.0), s2N),
            "s2b": jnp.where(win_done, f(0.0), s2b),
            "m1N": sel1(c["m1N"], sN), "m1b": sel1(c["m1b"], sb),
            "m2N": jnp.where(win_done, sN / K, c["m2N"]),
            "m2b": jnp.where(win_done, sb / K, c["m2b"]),
            "m2q": jnp.where(win_done, sq / K, c["m2q"]),
            "m2m": jnp.where(win_done, sm / K, c["m2m"]),
            "v2N": jnp.where(win_done, s2N / K, c["v2N"]),
            "v2b": jnp.where(win_done, s2b / K, c["v2b"]),
            "t2": jnp.where(win_done, tw, c["t2"]),
            "k": c["k"] + 1,
            "accepted": c["accepted"] + accept.astype(jnp.int32),
            "rejected": c["rejected"] + (~accept).astype(jnp.int32),
            "newton_total": c["newton_total"] + d["newton_iters"],
            "cg_total": c["cg_total"] + d["cg_iters"],
        }

    init = {
        "state": state0, "dt": f(dt), "phase": i32(0),
        "n": i32(0), "tw": f(0.0), "t1": f(0.0),
        "sN": zeros(N0), "sb": zeros(b0), "sq": zeros(q0),
        "sm": zeros(melt0),
        "s2N": f(0.0), "s2b": f(0.0),
        "m1N": zeros(N0), "m1b": zeros(b0),
        "m2N": zeros(N0), "m2b": zeros(b0), "m2q": zeros(q0),
        "m2m": zeros(melt0),
        "v2N": f(0.0), "v2b": f(0.0), "t2": f(0.0),
        "k": i32(0), "accepted": i32(0), "rejected": i32(0),
        "newton_total": i32(0), "cg_total": i32(0),
    }
    out = jax.lax.while_loop(
        lambda c: (c["phase"] < 2) & (c["k"] < max_attempts), body, init)

    # window means (offsets restored), drift of the orbit centroid
    mean_state = dataclasses.replace(
        state0, N=N0 + out["m2N"], b=b0 + out["m2b"], q=q0 + out["m2q"],
        melt=melt0 + out["m2m"],
        N_prev=(None if state0.N_prev is None else N0 + out["m2N"]))
    nrm = lambda x, off: jnp.maximum(mnorm(x + off, act)
                                     if act is not None
                                     else mnorm(x + off), tiny)
    t2 = jnp.maximum(out["t2"], tiny)
    dN = mnorm(out["m2N"] - out["m1N"], act) / nrm(out["m1N"], N0)
    db = mnorm(out["m2b"] - out["m1b"], act) / nrm(out["m1b"], b0)
    cycle_rate = jnp.maximum(dN, db) * f(t_ref) / t2
    # relative RMS amplitude of window 2 around its mean:
    # Var = E||x - x0||^2 - ||mean - x0||^2  (centered, f32-safe)
    ampN = jnp.sqrt(jnp.maximum(
        out["v2N"] - mnorm(out["m2N"], act) ** 2, f(0.0))) / nrm(out["m2N"], N0)
    ampb = jnp.sqrt(jnp.maximum(
        out["v2b"] - mnorm(out["m2b"], act) ** 2, f(0.0))) / nrm(out["m2b"], b0)
    done = out["phase"] >= 2
    info = {
        "certified": done & (cycle_rate < tol),
        "cycle_rate": cycle_rate, "amp_N": ampN, "amp_b": ampb,
        "t_window": out["t2"], "steps": out["k"],
        "accepted": out["accepted"], "rejected": out["rejected"],
        "newton_total": out["newton_total"], "cg_total": out["cg_total"],
    }
    return mean_state, info


def make_steady_step(mesh, static, params, cfg):
    """The PTC iteration: the fused timestep with the semi-implicit gap
    update, no dt-halving wrapper, no operator carry, and no guess
    extrapolation (2N - N_prev assumes uniform dt; under SER's
    order-of-magnitude dt swings the previous solution is the better
    Newton start, as in the reference, solvers.py:48)."""
    from shakti_tpu.solve.timestep import make_step_fn
    cfg = dataclasses.replace(cfg, adaptive_dt_levels=0, lag_operator=False,
                              extrapolate_guess=False)
    return make_step_fn(mesh, static, params, cfg,
                        b_update="semi_implicit"), cfg
