"""The fused SHAKTI timestep and time-integration loop.

One timestep (reference solvers.py:168-229) becomes ONE pure function:

    1. Newton-solve the nonlinear elliptic equation for N
       (reference :179, with b, q, melt_n frozen),
    2. q    <- water-flux law evaluated at nodes        (reference :186),
    3. melt <- melt-rate expression at nodes            (reference :189),
    4. b    <- forward-Euler gap evolution              (reference :192),
    5. clamp b >= b_min                                 (reference :194-197),
    6. N_n  <- N                                        (reference :227-229).

The whole step — Newton loop, Krylov iterations, explicit updates — is one
XLA program; `lax.scan` then runs `nt_save` steps per device launch with the
save-snapshot emitted as a scan output.  This removes every per-step
host/MPI round-trip the reference pays (SURVEY §3.3: ~dozens of collectives
per step).

Explicit-update semantics and sequencing mirror the reference exactly:
q is updated first (using old Re), melt next (using NEW q), then b (using
new q AND new melt in its melt term, old b elsewhere), because DOLFINx
Expression objects referenced the live Function storage
(reference solvers.py:143-165,185-192).  Cell-discontinuous quantities
(grad h, the melt-regularization divergence) are brought to nodes by
deterministic area-weighted averaging (fem/ops.py) instead of DOLFINx's
cell-visit-order rule — the one documented numerical divergence (O(h)).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from shakti_tpu.fem import ops
from shakti_tpu.params import PhysicalParams
from shakti_tpu.physics import constitutive as law
from shakti_tpu.physics import residual as res
from shakti_tpu.solve.newton import NewtonConfig, newton_solve


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class State:
    """Time-marching state (all nodal): the reference's Functions
    N, b, q, melt_n (solvers.py:128-156).  N doubles as N_n at step entry."""

    N: Any      # (n,) effective pressure [Pa]
    b: Any      # (n,) hydraulic gap height [m]
    q: Any      # (n, 2) water flux [m^2/s]
    melt: Any   # (n,) lagged melt rate [kg/(m^2 s)]
    N_prev: Any = None  # (n,) N one step earlier (Newton guess extrapolation)
    # carried operator (ok, vals, a_diag, A_inv) for modified-Newton reuse;
    # None unless cfg.lag_operator (seeded by api/model.freeze or
    # solve.newton.zero_lag)
    lag_op: Any = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StaticFields:
    """Time-independent nodal forcing + boundary data
    (the reference's model_setup Functions, model_setup.py:43-53)."""

    z_b: Any        # (n,) bed elevation [m]
    z_s: Any        # (n,) surface elevation [m]
    G: Any          # (n,) geothermal heat flux [W/m^2]
    inputs: Any     # (n,) moulin/distributed input [m/s]
    storage: Any    # (n,) lake indicator (0 when storage_on=False)
    gb0: Any        # (c, 2) background head gradient per cell
    dirichlet: Any  # (n,) bool outflow-Dirichlet mask (empty if outflow_on=False)
    N_bdry: Any     # scalar Dirichlet value [Pa]
    b_min: Any      # scalar gap-height floor [m]
    # optional (n,) upper bound on b (None = unbounded, the reference
    # semantics).  Physical regularization for domains that pinch to zero
    # ice thickness (e.g. the SHMIP valley terminus/head): where the
    # Dirichlet N is pinned at a ~1 m overburden, closure cannot balance
    # the concentrated dissipation melt and b grows without bound past the
    # ice thickness itself — capping b at the local ice column keeps the
    # gap physical and the run bounded (see ModelSetup.b_cap).
    b_max: Any = None


def make_static_fields(mesh, z_b, z_s, G, inputs, storage, dirichlet_mask,
                       N_bdry, b_min, params: PhysicalParams,
                       b_max=None) -> StaticFields:
    dtype = mesh.nodes.dtype
    as_f = lambda x: jnp.asarray(x, dtype=dtype)
    gb0 = law.background_head_gradient(
        ops.cell_grad(mesh, as_f(z_b)), ops.cell_grad(mesh, as_f(z_s)), params)
    return StaticFields(
        z_b=as_f(z_b), z_s=as_f(z_s), G=as_f(G), inputs=as_f(inputs),
        storage=as_f(storage), gb0=gb0,
        dirichlet=jnp.asarray(dirichlet_mask, dtype=bool),
        N_bdry=as_f(N_bdry), b_min=as_f(b_min),
        b_max=None if b_max is None else as_f(b_max),
    )


def make_step_fn(mesh, static: StaticFields, params: PhysicalParams,
                 cfg: NewtonConfig, b_update: str = "explicit"):
    """Returns step(state, dt) -> (state, diagnostics).

    The explicit-update data movement is fused: all nodal->corner gathers
    are stacked into single gathers and the cell->node averages into single
    segment-sums (each gather/scatter kernel pays a fixed launch cost, so
    at small meshes op count — not element count — dominates this phase).

    ``b_update``: gap-evolution scheme.  "explicit" (default) is the
    reference's forward Euler (solvers.py:162,192).  "semi_implicit"
    treats the creep-closure term — linear in b — backward-Euler:
    b_new = (b + dt m/rho_i) / (1 + dt C/b), unconditionally stable for
    the closure mode and identical to explicit to O(dt^2); used by the
    pseudo-transient steady-state driver (solve/steady.py) to march with
    dt far beyond the closure timescale.
    """
    if b_update not in ("explicit", "semi_implicit"):
        raise ValueError(f"b_update must be 'explicit' or 'semi_implicit', "
                         f"got {b_update!r}")

    p = params
    # static forcing at quadrature points: computed once here, closed over
    sq = res.static_quad_fields(mesh, static, cfg.quad_degree,
                                mesh.nodes.dtype)

    implicit_solve = None
    if cfg.differentiable:
        # IFT custom-VJP wrapper around the Newton solve: makes step (and
        # any run_window scan over it) reverse-mode differentiable.  See
        # solve/implicit.py; the forward trajectory is identical.
        if cfg.lag_operator:
            raise ValueError("differentiable=True requires lag_operator="
                             "False (the operator carry is stateful)")
        from shakti_tpu.solve.implicit import make_implicit_solver
        implicit_solve = make_implicit_solver(mesh, static.dirichlet,
                                              static.N_bdry, params, cfg)

    def step(state: State, forcing):
        # ``forcing`` is a plain dt scalar, or a dict with 'dt' and optional
        # per-step scalars ('inputs_scale' for seasonal/meltwater forcing,
        # 'melt_a'/'melt_b' for elevation-band degree-day melt — capabilities
        # the reference lacks: its inputs are static Functions,
        # model_setup.py:47).
        if isinstance(forcing, dict):
            dt = forcing["dt"]
            scale = forcing.get("inputs_scale")
            melt_a = forcing.get("melt_a")
            # optional per-NODE pseudo-timestep for the gap update (local
            # time stepping, steady-state driver only): the b-evolution is
            # a nodal ODE, so marching each node at its own stable dt
            # changes the path but not the fixed point.  Transient runs
            # never set this.
            dt_b = forcing.get("dt_b")
        else:
            dt, scale, melt_a, dt_b = forcing, None, None, None
        dt_b = dt if dt_b is None else dt_b
        inputs_q = sq["inputs_q"]
        if scale is not None:
            inputs_q = inputs_q * scale
        if melt_a is not None:
            # degree-day surface melt routed to the bed: at surface elevation
            # z the melt rate is max(0, A(t) - B z) with A = DDF * T_0(t) and
            # B = DDF * lapse (SHMIP suites D/F forcing model,
            # de Fleurian et al. 2018 §3.1.4); added to the static inputs
            inputs_q = inputs_q + jnp.maximum(
                0.0, melt_a - forcing["melt_b"] * sq["zs_q"])
        sq_t = dict(sq, inputs_q=inputs_q) if inputs_q is not sq["inputs_q"] \
            else sq
        # ---- 1. implicit solve for N (b, q, melt frozen; N_n = state.N) ----
        pre = res.precompute_step(mesh, state.N, state.b, state.q, state.melt,
                                  static, dt, p, cfg.quad_degree, sq=sq_t)
        # Newton initial guess: linear extrapolation in time when enabled
        # (measured ~10x smaller initial residuals mid-run vs the
        # reference's previous-step guess, solvers.py:48); N_n in the lake
        # storage term stays the true previous-step N.
        if cfg.extrapolate_guess and state.N_prev is not None:
            guess = 2.0 * state.N - state.N_prev
        else:
            guess = state.N
        if implicit_solve is not None:
            N, stats = implicit_solve(guess, state.N, pre)
        else:
            N, stats = newton_solve(guess, pre, mesh, static.dirichlet,
                                    static.N_bdry, p, cfg, N_ref=state.N,
                                    lag=state.lag_op
                                    if cfg.lag_operator else None)
        if cfg.lag_operator:
            ok, age, vals, a_diag, A_inv, floor, fage = stats.pop("lag")
            # one step older per step: both the operator age and the
            # sensitivity-floor probe age (gated separately in newton_solve)
            lag_out = (ok, age + 1, vals, a_diag, A_inv, floor, fage + 1)
        else:
            lag_out = state.lag_op             # pass-through (scan carry
            #                                    structure must be stable)

        # ---- fused corner gather of [N, b, melt] + cellwise gradients ----
        st = jnp.stack([N, state.b, state.melt], axis=1)         # (n, 3)
        sc = ops.gather_cells(mesh, st)                          # (c, 3, 3)
        dev = sc - jnp.mean(sc, axis=1, keepdims=True)
        g = jnp.sum(dev[:, :, :, None] * mesh.grads[:, :, None, :],
                    axis=1)                                      # (c, 3, 2)
        grad_h_c = static.gb0 - g[:, 0] / (p.rho_w * p.g)        # (c, 2)
        grad_b_c, grad_m_c = g[:, 1], g[:, 2]
        b_cell, melt_cell = sc[:, :, 1], sc[:, :, 2]

        # mdiff with OLD melt (reference melt_n_expr, solvers.py:165,189)
        mdiff_old_ci = law.melt_regularization(
            b_cell, melt_cell, grad_b_c[:, None, :], grad_m_c[:, None, :])

        # ---- fused cell->node averaging: [grad_h (2), mdiff_old (1)] ----
        pack = jnp.concatenate(
            [jnp.broadcast_to(grad_h_c[:, None, :], grad_h_c.shape[:1] + (3, 2)),
             mdiff_old_ci[:, :, None]], axis=-1)                 # (c, 3, 3)
        avg = ops.cellnodal_to_node_avg(mesh, pack)              # (n, 3)
        grad_h_n, mdiff_old_n = avg[:, :2], avg[:, 2]

        # ---- 2. q update: Re from OLD q (reference q_expr, solvers.py:186)
        Re = law.reynolds(state.q, p)
        q = law.water_flux(state.b, grad_h_n, Re, p)

        # ---- 3. melt update: NEW q, OLD b, OLD melt in the regularization
        m0 = law.melt_opening(q, grad_h_n, static.G, p)
        melt = m0 + mdiff_old_n

        # ---- 4. b update: forward Euler with NEW q and NEW melt in the
        #         regularization, OLD b elsewhere (reference b_expr, :162,192)
        melt_cell_new = ops.gather_cells(mesh, melt)             # (c, 3)
        m_dev = melt_cell_new - jnp.mean(melt_cell_new, axis=1, keepdims=True)
        grad_m_new = jnp.sum(m_dev[:, :, None] * mesh.grads, axis=1)
        mdiff_new_ci = law.melt_regularization(
            b_cell, melt_cell_new, grad_b_c[:, None, :], grad_m_new[:, None, :])
        melt_for_b = m0 + ops.cellnodal_to_node_avg(mesh, mdiff_new_ci)
        if b_update == "semi_implicit":
            # only the DECAY part of the closure rate goes implicit: where
            # N < 0 the rate is negative (creep opening) and an implicit
            # treatment would cross the 1 + dt*rate = 0 pole; that part
            # stays explicit (it is bounded by the |N| physics anyway)
            crate = law.closure_rate(N, p)
            b = ((state.b + dt_b * (melt_for_b / p.rho_i
                                    - jnp.minimum(crate, 0.0) * state.b))
                 / (1.0 + dt_b * jnp.maximum(crate, 0.0)))
        else:
            b = state.b + dt_b * (melt_for_b / p.rho_i
                                  - law.closure(state.b, N, p))

        # ---- 5. clamp (reference solvers.py:194-197) ----
        b = jnp.maximum(b, static.b_min)
        if static.b_max is not None:
            # optional ice-thickness cap (see StaticFields.b_max)
            b = jnp.minimum(b, static.b_max)

        new_state = State(N=N, b=b, q=q, melt=melt, N_prev=state.N,
                          lag_op=lag_out)
        diag = {
            "newton_iters": stats["iters"],
            "rnorm": stats["rnorm"],
            "rnorm0": stats["rnorm0"],
            "converged": stats["converged"],
            "cg_iters": stats["cg_iters"],
        }
        return new_state, diag

    out = step
    for lvl in range(cfg.adaptive_dt_levels):
        out = with_dt_halving(out, lvl)
    return out


def with_dt_halving(base, level: int = 0, accept_rtol: float = 1e-4):
    """Wrap a step function with one dt-halving retry level: a failed step
    is redone as two half-dt sub-steps (in-graph lax.cond; SURVEY §5 —
    replaces the reference's assert-abort with graceful dt fallback).
    Stack levels for repeated halving.  ``forcing`` may be a plain dt
    scalar or the run layer's forcing dict (only its 'dt' entry is halved).

    Composite acceptance: both sub-steps certifying convergence, OR the
    final sub-step certifying AND the final residual sitting deeply below
    the step's initial scale (``accept_rtol``, the stall-acceptance
    criterion of solve/newton.py).  The second clause matters for
    degenerate cold starts (nodes with b ~ 0 make Jacobian rows near-null,
    see VALIDATION.md): the first half-step's own certificate can fail on
    the irreducible rows while its best iterate is good enough that the
    second half-step then converges to machine level — measured on the
    reference's unclamped noisy b_init (setup_cooke2.py:66): step-0
    residual 11 -> 2e-11 with one halving, while the strict AND still
    reported failure."""

    def halve(forcing):
        if isinstance(forcing, dict):
            return dict(forcing, dt=0.5 * forcing["dt"])
        return 0.5 * forcing

    def stepped(state, forcing):
        s1, d1 = base(state, forcing)

        def retry(_):
            half = halve(forcing)
            sa, da = base(state, half)
            sb, db = base(sa, half)
            tiny = jnp.asarray(jnp.finfo(db["rnorm"].dtype).tiny,
                               db["rnorm"].dtype)
            deep = db["rnorm"] <= accept_rtol * jnp.maximum(da["rnorm0"], tiny)
            diag = {
                "newton_iters": da["newton_iters"] + db["newton_iters"],
                "rnorm": db["rnorm"],
                "rnorm0": da["rnorm0"],
                "converged": db["converged"] & (da["converged"] | deep),
                "cg_iters": da["cg_iters"] + db["cg_iters"],
            }
            return sb, diag

        return jax.lax.cond(d1["converged"], lambda _: (s1, d1), retry, None)

    return stepped


def make_runner(params: PhysicalParams, cfg: NewtonConfig):
    """jit-compiled (mesh, static, state, forcing) -> (state, diags) with
    mesh/static as jit ARGUMENTS instead of closures.

    Tradeoff: closures embed the mesh as jaxpr constants, which XLA folds
    and optimizes aggressively; as runtime arguments the same program's
    peak liveness GROWS (constants are deduped/folded where inputs are
    not).  The framework therefore uses closures by
    default (make_step_fn); this variant exists for workflows that swap
    meshes under one compilation and accept the memory cost.
    """

    @jax.jit
    def runner(mesh, static, state, forcing):
        step = make_step_fn(mesh, static, params, cfg)
        return run_window(step, state, forcing)

    return runner


def run_window(step_fn, state: State, dts):
    """Scan `len(dts)` steps; returns (state, stacked diagnostics)."""
    def body(s, dt):
        s, diag = step_fn(s, dt)
        return s, diag
    return jax.lax.scan(body, state, dts)


def timestep_sizes(timesteps, dtype=None):
    """Per-step dt array reproducing the reference's first-step quirk:
    dt_0 = 0.1 |t_1 - t_0|, then dt_i = |t_i - t_{i-1}|
    (reference solvers.py:81-82,174-176)."""
    import numpy as np
    t = np.asarray(timesteps, dtype=np.float64)
    dts = np.empty(t.shape[0])
    dts[0] = 0.1 * abs(t[1] - t[0])
    dts[1:] = np.abs(np.diff(t))
    return jnp.asarray(dts, dtype=dtype)


def make_forcing(timesteps, dtype=None, seasonal=None, degree_day=None):
    """Per-step forcing pytree for run_window.

    ``seasonal`` = (amplitude, period_s, phase) modulates the meltwater
    input field per step: inputs * max(0, 1 + A sin(2 pi t/T + phase))
    (BASELINE configs[1] 'seasonal melt forcing'; the reference's inputs
    are time-independent).

    ``degree_day`` = dict(dT, ddf, lapse, t_mean, t_amp, period) adds an
    elevation-band melt max(0, DDF (t_mean + t_amp cos(2 pi t/T) + dT
    - lapse z_s)) to the inputs per step — the SHMIP suite-D/F seasonal
    runoff model (de Fleurian et al. 2018 §3.1.4; defaults are the
    published constants: DDF 0.01 m/(K day), lapse 0.0075 K/m, sea-level
    temperature -5 - 16 cos(2 pi t/yr) degC + case offset dT).
    """
    import numpy as np
    f = {"dt": timestep_sizes(timesteps, dtype)}
    t64 = np.asarray(timesteps, dtype=np.float64)
    if seasonal is not None:
        amp, period, phase = seasonal
        t = jnp.asarray(t64, dtype=dtype)
        f["inputs_scale"] = jnp.maximum(
            0.0, 1.0 + amp * jnp.sin(2.0 * jnp.pi * t / period + phase))
    if degree_day is not None:
        dd = dict(degree_day)
        ddf = dd.get("ddf", 0.01 / 86400.0)
        lapse = dd.get("lapse", 0.0075)
        period = dd.get("period", 3.154e7)
        temp = (dd.get("t_mean", -5.0)
                + dd.get("t_amp", -16.0) * np.cos(2.0 * np.pi * t64 / period)
                + dd.get("dT", 0.0))
        f["melt_a"] = jnp.asarray(ddf * temp, dtype=dtype)
        f["melt_b"] = jnp.full(t64.shape, ddf * lapse, dtype=dtype)
    return f
