"""Damped Newton solver for the nonlinear effective-pressure equation.

Replaces `dolfinx.nls.petsc.NewtonSolver` + `NonlinearProblem`
(reference solvers.py:51-54) with a jit-compiled Newton loop under
`lax.while_loop`:

  * residual/Jacobian from physics/residual.py (AD element blocks),
  * inner linear solve = matrix-free PCG/BiCGStab (solve/krylov.py),
  * DOLFINx-compatible convergence test: ||r|| < atol  or
    ||r|| <= rtol * ||r0||   (DOLFINx defaults rtol=1e-9, atol=1e-10,
    criterion "residual", relaxation 1.0 — mirrored in NewtonConfig),
  * divergence -> `converged=False` flag returned in-graph; the API layer
    raises, matching the reference's `assert (converged)`
    (reference solvers.py:179-180) but without crashing mid-scan.

Dirichlet conditions are enforced by projecting the initial guess onto the
boundary values and eliminating constrained rows/cols symmetrically
(physics/residual.make_matvec), which reproduces the reference's
dirichletbc/apply-lifting behavior after its first iteration.
"""

from __future__ import annotations

import dataclasses


import jax
import jax.numpy as jnp

from shakti_tpu.fem.ops import vdot
from shakti_tpu.physics import residual as res
from shakti_tpu.solve import krylov
from shakti_tpu.solve.precond import make_preconditioner


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Static (hashable) solver configuration."""

    rtol: float = 1e-9          # relative residual tolerance (DOLFINx default)
    atol: float = 1e-10         # absolute residual tolerance (DOLFINx default)
    max_iter: int = 50          # DOLFINx default max_it
    relaxation: float = 1.0     # update damping (DOLFINx relaxation_parameter)
    lin_rtol: float = 1e-8      # Krylov relative tolerance
    lin_maxiter: int = 2000     # Krylov iteration cap
    krylov: str = "cg"          # 'cg' or 'bicgstab'
    quad_degree: int = 4        # quadrature rule (see fem/p1.py)
    # 'jacobi' / 'two_level' (solve/precond.py) / 'mg' (solve/mg.py — the
    # weak-scaling multilevel V-cycle; the distributed runner auto-selects
    # it for meshes past the two-level dense-coarse cap)
    precond: str = "two_level"
    # Multilevel-PC knobs (solve/mg.py).  Tuned on the 1M-dof 8-shard cold
    # start (total CG over 3 steps, identical Newton counts):
    # omega 0.67/0.8/0.9/1.0 -> 1225/1128/1090/1492; agg 16/8/4/2 at
    # omega 0.9 -> 1090/948/710/596.  agg=4 is the default (agg=2 buys
    # 16% more but doubles the level count — kernel-launch overhead — and
    # the replicated level-1 storage).
    mg_omega: float = 0.9       # damped-Jacobi smoothing weight (V-cycle)
    mg_agg: int = 4             # aggregation factor per multilevel level
    mg_coarse_cap: int = 1536   # dense-coarse size cap for the hierarchy
    # V-cycle smoother: "cheb" (degree-mg_cheb_deg Chebyshev on
    # [mg_cheb_frac*lmax, lmax] with a free Gershgorin lmax bound,
    # 2*mg_cheb_deg fine matvecs per apply) or "jacobi" (one damped
    # omega-sweep, 2 fine matvecs per apply) — see solve/mg.py.  Swept on
    # the same 1M cold start (total CG / CPU wall s per step): jacobi 710/77;
    # cheb d2 frac .35/.25/.15/.10/.05 -> 635/605/568/548/535, wall
    # 69.5/71.6/66.0/61.1/61.8; d3 frac .25 -> 536 CG but 99 s (the extra
    # matvecs outrun the iteration cut).  d2/f0.10 is the default: -23%
    # CG and -21% wall vs tuned jacobi, flat below f0.10.  Caveat: each
    # PC apply trades coarse-hierarchy visits + psums + launches (fewer
    # iterations) for 2 extra fine matvecs (more HBM traffic); on the GPU
    # re-A/B with SHAKTI_MG_SMOOTHER if fine-matvec bandwidth dominates.
    mg_smoother: str = "cheb"
    mg_cheb_deg: int = 2
    mg_cheb_frac: float = 0.10
    # "v" or "w": W-cycle = symmetric double correction at every coarse
    # level (2B - BAB, still a fixed SPD operator — CG-safe); the plain-
    # aggregation depth fix, at geometric extra replicated-compute cost
    # and ~2x-per-level kernel count.  See solve/mg.py:make_multilevel.
    mg_cycle: str = "v"
    # > 0 smooths the fine-level transfer operators (hybrid smoothed
    # aggregation, classical weight 4/3) at +2 fine matvecs per apply;
    # 0 = tentative (piecewise-constant) transfers.  See
    # solve/mg.py:make_multilevel for the trade and measurements.
    mg_smooth_p: float = 0.0
    # Aggregate size for the two-level coarse grid.  None = auto: resolved
    # at api/model.freeze (single-chip: cap the dense coarse problem at
    # ~1.5k dofs) or parallel/dist.build_distributed (per-shard sizing);
    # an explicit int is always taken literally.
    coarse_block: int | None = None
    # Jacobian diagonal floor (relative to the max diagonal): where the gap
    # height is clamped at b_min and closure is negligible, the N-equation
    # degenerates (near-zero matrix row — N locally undetermined) and both
    # Krylov and Jacobi blow up on the ~1e-11-scale rows.  Flooring the
    # operator diagonal regularizes those nodes (their update -> 0, which is
    # the physical choice); the residual stays exact, so the converged
    # solution is unbiased (inexact-Newton argument).
    diag_floor_rel: float = 1e-10
    # multiplier on the residual-sensitivity floor used as absolute tolerance
    # (accuracy/cost knob: larger = earlier exits near steady state)
    floor_mult: float = 1.0
    # Failure fallback (SURVEY §5 failure-detection row): number of in-graph
    # dt-halving levels when a step's Newton solve does not converge — each
    # level retries the step as two half-dt sub-steps (lax.cond branch; the
    # reference simply aborts via assert, solvers.py:179-180).  0 disables.
    adaptive_dt_levels: int = 0
    # Stagnation handling: when the residual stops improving, exit and accept
    # the solve if the residual fell by at least 1/stall_rtol relative to the
    # start.  Two distinct regimes hit this: (a) the floating-point residual
    # floor (dominant in f32), and (b) genuine Newton limit cycles in
    # collapsed-sheet (b = b_min) regions, where the N-equation degenerates —
    # measured: even exact-LU plain Newton (the reference's configuration)
    # cycles at ~1e-5 relative there, so demanding 1e-9 would abort runs the
    # physics has already converged.  The best iterate seen is returned.
    stall_rtol: float = 1e-4    # acceptance threshold on ||r||/||r0|| at stall
    stall_factor: float = 0.9   # progress = rnorm < factor * best rnorm so far
    stall_patience: int = 4     # iterations without progress before exiting
    # Lazy backtracking line search: the full Newton step is taken whenever
    # it sufficiently reduces the residual (the common case — zero extra
    # cost); otherwise the step is halved up to ls_backtracks times.  The
    # reference's PETSc NewtonSolver runs undamped and occasionally relies
    # on small dt for stability; damping makes large-dt and rough-b regimes
    # robust.  0 disables (plain Newton).
    ls_backtracks: int = 4
    # Newton initial guess by linear time extrapolation, 2N - N_prev
    # (the reference starts from the previous solution, solvers.py:48;
    # extrapolation starts ~10x closer mid-run at zero cost).
    extrapolate_guess: bool = True
    # Lagged (modified-Newton) operator: iteration 0 of each step reuses the
    # previous step's folded operator values + coarse-preconditioner inverse
    # (carried in State.lag_op); iterations >= 1 rebuild fresh.  The
    # convergence test always uses the EXACT assembled residual, so a stale
    # operator can only cost extra iterations, never accuracy (inexact-
    # Newton argument).  Near steady state with guess extrapolation the
    # common step is a single iteration, so the Jacobian assembly, the
    # element->row fold, and the coarse-inverse build drop out of the
    # per-step cost entirely.  Requires a foldable operator format
    # (bell/bcsr/ell); the caller must seed State.lag_op (api/model.freeze).
    # Scale caveat: the carry and a freshly-built operator are live at the
    # same time inside the rebuild branch, so peak HBM grows by one
    # operator-values array (BCSR values ~GB at 1M dof); use for the bell
    # regime (<= ~200k nodes) or where device memory is ample.  None =
    # auto: api/model.freeze resolves it to True exactly for block-ELL
    # meshes and False elsewhere.
    lag_operator: bool | None = None
    # Carry age cap: when every step converges in the single reused
    # iteration, the carry would otherwise NEVER refresh (measured: the
    # step-1 cold-start operator reused 300 steps later turned 3.8 CG
    # iters/step into 67.8 on the 12k bench).  A step whose carry is older
    # than this skips the reuse iteration and rebuilds, refreshing the
    # carry — so 1 step in (lag_max_age+1) pays full build cost.
    lag_max_age: int = 8
    # Increment criterion: accept when the Newton update becomes negligible,
    # ||dN|| <= inc_rtol * ||N||.  The residual norm in f32 floors at
    # evaluation noise (eps * |N| propagated through the form) long before
    # the update stops improving N, so near steady state the increment is
    # the reliable signal (DOLFINx's 'incremental' criterion, made the
    # primary test for f32).  0 disables.
    inc_rtol: float = 0.0
    # Differentiable mode: route the implicit N-solve through the
    # implicit-function-theorem custom VJP (solve/implicit.py) so whole
    # transients are reverse-mode differentiable (calibration/inversion —
    # a capability the reference's PETSc stack lacks entirely).  One extra
    # adjoint Krylov solve per step on the backward pass; forward cost and
    # trajectories are unchanged.  Works on single-device meshes AND the
    # node-sharded distributed halo path (the adjoint halo-accumulates the
    # per-shard cotangent and masks the residual VJP to owned rows — see
    # solve/implicit.py).  Incompatible with lag_operator (stateful
    # operator carry; set it to False explicitly).
    differentiable: bool = False

    def for_dtype(self, dtype) -> "NewtonConfig":
        """Loosen tolerances to what the dtype can resolve (f32 in
        production)."""
        if jnp.dtype(dtype) == jnp.float32:
            return dataclasses.replace(
                self,
                rtol=max(self.rtol, 2e-5),
                atol=max(self.atol, 0.0),
                lin_rtol=max(self.lin_rtol, 1e-6),
                stall_rtol=max(self.stall_rtol, 3e-3),
                stall_patience=max(self.stall_patience, 3),
                inc_rtol=max(self.inc_rtol, 1e-6),
            )
        return self


def diag_floor_extra(a_diag, dirichlet, mesh, rel):
    """Degenerate-row diagonal floor (see NewtonConfig.diag_floor_rel):
    the per-row increment that lifts near-zero (collapsed-sheet) operator
    rows to ``rel * max|diag|``.  The max is pmax'd over the mesh axis in
    node-sharded SPMD mode so every shard floors identically.

    Single source of truth shared by the forward Newton operator (below)
    and the adjoint operator in solve/implicit.py — the IFT adjoint is the
    exact transpose only while both apply the identical floor."""
    dmax = jnp.max(jnp.where(dirichlet, 0.0, jnp.abs(a_diag)))
    if mesh.halo is not None:
        dmax = jax.lax.pmax(dmax, mesh.halo.axis)
    return jnp.where(dirichlet, 0.0,
                     jnp.maximum(0.0, rel * dmax - a_diag))


def zero_lag(mesh, dirichlet_dtype, cfg: NewtonConfig):
    """Invalid-but-shape-correct lag_op carry (ok=False, ages=0, zero
    values/floor) for seeding State.lag_op before the first step
    (see cfg.lag_operator).  Slots: (ok, age, vals, a_diag, A_inv,
    floor, floor_age) — floor_age tracks the sensitivity-floor probe's
    own staleness separately from the operator's (the operator age
    resets on every mid-solve rebuild, which must not silently extend
    the probe's lifetime; see the SHAKTI_LAG_FLOOR gate)."""
    from shakti_tpu.physics import residual as res
    dtype = dirichlet_dtype
    vals = jnp.zeros(res.operator_values_shape(mesh), dtype)
    a_diag = jnp.zeros((mesh.n_nodes,), dtype)
    if cfg.coarse_block is None:
        cfg = dataclasses.replace(cfg, coarse_block=64)
    if cfg.precond == "two_level" and mesh.paxis is None and mesh.halo is None:
        m = -(-mesh.n_nodes // cfg.coarse_block)
        A_inv = jnp.zeros((m, m), dtype)
    else:
        A_inv = None
    return (jnp.asarray(False), jnp.asarray(0, jnp.int32), vals, a_diag,
            A_inv, jnp.asarray(0.0, dtype), jnp.asarray(0, jnp.int32))


def newton_solve(N_init, pre, mesh, dirichlet, dirichlet_value, params,
                 cfg: NewtonConfig, N_ref=None, lag=None):
    """Solve F(N) = 0 for effective pressure.

    ``N_init`` is the starting iterate (possibly a time-extrapolated guess);
    ``N_ref`` the trusted previous solution (defaults to N_init).  The
    nothing-to-solve early exit is decided — and its value returned — at
    N_ref only: an extrapolated guess may wander along the near-null
    (collapsed-sheet) directions with sub-floor residuals, so it is never
    accepted without at least one regularized Newton iteration.

    ``lag``: carried operator (ok, age, vals, a_diag, A_inv, floor,
    floor_age) when cfg.lag_operator (see there); the updated carry is
    returned in stats["lag"].

    Returns (N, stats) with stats = dict(iters, rnorm0, rnorm, converged,
    cg_iters[, lag]).  Fully traceable; call under jit/scan.
    """
    if cfg.coarse_block is None:
        # direct callers (tests/scripts) may skip freeze's auto-resolution
        cfg = dataclasses.replace(cfg, coarse_block=64)
    lin_solve = krylov.get_solver(cfg.krylov)
    # reductions: ghost-masked + psum'd in node-sharded SPMD mode
    if mesh.halo is not None:
        dot, norm = mesh.halo.dot, mesh.halo.norm
    else:
        dot, norm = vdot, jnp.linalg.norm

    def resid(N):
        r = res.assemble_residual(N, pre, mesh, params)
        return jnp.where(dirichlet, 0.0, r)

    N0 = jnp.where(dirichlet, dirichlet_value, N_init)
    Nr = N0 if N_ref is None else jnp.where(dirichlet, dirichlet_value, N_ref)
    tiny = jnp.asarray(jnp.finfo(N0.dtype).tiny, N0.dtype)
    eps = jnp.asarray(jnp.finfo(N0.dtype).eps, N0.dtype)
    use_two_level = (cfg.precond == "two_level" and mesh.paxis is None
                     and mesh.halo is None)
    lag_on = bool(cfg.lag_operator)
    if lag_on and lag is None:
        lag = zero_lag(mesh, N0.dtype, cfg)
    # Sensitivity-floor probe: residual norms below
    # ||r(N + eps|N|) - r(N)|| cannot be meaningfully reduced by any
    # representable N update (the dominant convergence floor in f32, where
    # N ~ 1e6 Pa has ~0.1 Pa resolution).
    sign = jnp.where(jnp.arange(N0.shape[0]) % 2 == 0, 1.0, -1.0).astype(N0.dtype)
    import os as _os
    lag_floor = lag_on and _os.environ.get("SHAKTI_LAG_FLOOR", "0") == "1"
    if lag_floor:
        # the floor evolves slowly: carry it with the operator and only
        # re-assemble the probe on carry-invalid/stale steps (lax.cond —
        # top-level, NOT inside the while loops, see make_body).  The
        # common steady-state step then assembles 2 residual columns
        # instead of 3, at the price of the cond's extra kernel launches;
        # off by default until a GPU A/B shows a win.
        cols = res.assemble_residual_multi(
            jnp.stack([Nr, N0], axis=1), pre, mesh, params)
        cols = jnp.where(dirichlet[:, None], 0.0, cols)
        r_ref = cols[:, 0]
        r0 = cols[:, 1]
        carry_ok = lag[0] & (lag[1] <= cfg.lag_max_age)

        def fresh_floor(_):
            rp = res.assemble_residual(Nr + eps * jnp.abs(Nr) * sign, pre,
                                       mesh, params)
            rp = jnp.where(dirichlet, 0.0, rp)
            return norm(rp - r_ref)

        # the floor is gated on its OWN age (lag[6]), not the operator's:
        # mid-solve rebuilds reset the operator age with the floor still
        # carried, so gating on lag[1] alone would let the probe go stale
        # without bound across rebuild chains
        floor_ok = carry_ok & (lag[6] <= cfg.lag_max_age)
        floor_b = jax.lax.cond(floor_ok, lambda _: lag[5], fresh_floor, None)
        floor_age_this = jnp.where(floor_ok, lag[6],
                                   jnp.asarray(0, jnp.int32))
    else:
        # one batched assembly evaluates the trusted-state residual, the
        # guess residual AND the probe
        cols = res.assemble_residual_multi(
            jnp.stack([Nr, N0, Nr + eps * jnp.abs(Nr) * sign], axis=1),
            pre, mesh, params)
        cols = jnp.where(dirichlet[:, None], 0.0, cols)
        r_ref = cols[:, 0]
        r0 = cols[:, 1]
        floor_b = norm(cols[:, 2] - r_ref)
        floor_age_this = jnp.asarray(0, jnp.int32)   # probed this step
    rnorm_ref = norm(r_ref)
    rnorm0 = norm(r0)
    atol_eff = jnp.maximum(jnp.asarray(cfg.atol, N0.dtype),
                           cfg.floor_mult * floor_b)
    # nothing to solve: the TRUSTED state already sits at the floor
    skip = rnorm_ref <= atol_eff

    # relative tests are anchored at the trusted state's residual scale
    rscale = jnp.maximum(rnorm_ref, tiny)

    def converged_fn(rnorm):
        return (rnorm < atol_eff) | (rnorm <= cfg.rtol * rscale)

    def build_op(N, stale_vals=None):
        from shakti_tpu.solve import precond as pc
        J_c = res.element_jacobian(N, pre, mesh, params)
        # overwrite the dead carried values in place (out=) so carry +
        # fresh values are not live simultaneously (NewtonConfig.lag_operator
        # scale caveat)
        vals = res.fold_operator_values(J_c, mesh, out=stale_vals)
        a_diag = res.operator_diag_from_values(vals, mesh)
        # prefer the scatter-free vals-based Galerkin coarse build over
        # the element-scatter one (one scatter entry per stored block
        # instead of per element-matrix entry)
        A_inv = ((pc.coarse_from_values(vals, mesh, dirichlet,
                                        cfg.coarse_block)
                  if pc.vals_coarse_ok(mesh, cfg.coarse_block)
                  else pc.coarse_inverse(J_c, mesh, dirichlet,
                                         cfg.coarse_block))
                 if use_two_level else None)
        return (jnp.asarray(True), jnp.asarray(0, jnp.int32), vals, a_diag,
                A_inv, floor_b, floor_age_this)

    def cond(s):
        N, r, rnorm, N_best, rn_best, stall, k, cg_total, bad, done, op = s
        return ((~done) & (k < cfg.max_iter) & (~bad)
                & (stall < cfg.stall_patience))

    def make_body(reuse_op: bool):
      # Two statically-specialized bodies instead of an in-graph lax.cond:
      # a cond inside the while loop would carry the large operator
      # values through both branches; the peeled-loop structure below
      # avoids cond entirely.
      def body(s):
        N, r, rnorm, N_best, rn_best, stall, k, cg_total, bad, done, op = s
        if reuse_op:
            # iteration 0 under cfg.lag_operator: the carried operator
            _, _, vals, a_diag, A_inv, _, _ = op
            matvec0 = res.operator_from_values(vals, mesh, dirichlet)
        elif lag_on:
            # Rebuild at the current iterate and refresh the carry.
            # Attempted fix for the 2x-values peak liveness (carry + fresh
            # simultaneously live): fold into the
            # dead carry via (carry*0).at[map].add(flat) hoping XLA aliases
            # the buffer — measured WORSE (211 vs 141 MB temp at 90k-dof
            # BCSR on the CPU backend: the scatter does not alias and loses
            # segment_sum's efficiency), so the fresh fold stays the
            # default; SHAKTI_LAG_FOLD_REUSE=1 enables the variant for
            # per-backend A/B.  The lag carry remains a <=2x-values-memory
            # feature — use on meshes where HBM allows (NewtonConfig
            # docstring).
            import os as _os
            reuse = _os.environ.get("SHAKTI_LAG_FOLD_REUSE", "0") == "1"
            op = build_op(N, stale_vals=op[2] if reuse else None)
            _, _, vals, a_diag, A_inv, _, _ = op
            matvec0 = res.operator_from_values(vals, mesh, dirichlet)
        else:
            J_c = res.element_jacobian(N, pre, mesh, params)
            if (mesh.bcsr_brow is not None or mesh.bell_nbr is not None
                    or mesh.ell_cols is not None):
                # keep the folded values in scope: the two-level coarse
                # operator rebuilds from them scatter-free (precond.py)
                vals = res.fold_operator_values(J_c, mesh)
                a_diag = res.operator_diag_from_values(vals, mesh)
                matvec0 = res.operator_from_values(vals, mesh, dirichlet)
            else:
                vals = None
                matvec0, a_diag = res.make_operator(J_c, mesh, dirichlet)
        # regularize degenerate (clamped-sheet) rows: see diag_floor_rel
        extra = diag_floor_extra(a_diag, dirichlet, mesh, cfg.diag_floor_rel)
        matvec = lambda x: matvec0(x) + extra * x
        a_diag = a_diag + extra
        if lag_on:
            from shakti_tpu.solve import precond as pc
            tiny_d = jnp.asarray(jnp.finfo(a_diag.dtype).tiny, a_diag.dtype)
            minv = (pc.two_level_from_inverse(
                        A_inv, a_diag, dirichlet, cfg.coarse_block,
                        mesh.n_nodes) if use_two_level
                    else pc.make_jacobi(a_diag, dirichlet, tiny_d))
        else:
            minv = make_preconditioner(cfg.precond, J_c, mesh, dirichlet,
                                       a_diag, cfg.coarse_block,
                                       matvec=matvec, mg_omega=cfg.mg_omega,
                                       mg_smoother=cfg.mg_smoother,
                                       mg_cheb_deg=cfg.mg_cheb_deg,
                                       mg_cheb_frac=cfg.mg_cheb_frac,
                                       mg_cycle=cfg.mg_cycle,
                                       mg_smooth_p=cfg.mg_smooth_p,
                                       vals=vals)
        rhs = r                                             # A dN = F (r == masked F)
        dN, lin_info = lin_solve(matvec, rhs, minv,
                                 rtol=cfg.lin_rtol, atol=0.1 * atol_eff,
                                 maxiter=cfg.lin_maxiter, dot=dot, norm=norm)
        alpha0 = jnp.asarray(cfg.relaxation, N.dtype)
        N_new = N + alpha0 * dN
        r = resid(N_new)
        rnorm_new = norm(r)

        if cfg.ls_backtracks > 0:
            # lazy backtracking: only pay extra residual evaluations when
            # the full step failed to reduce the residual
            def ls_cond(c):
                a, Nc, rc, rnc, tries = c
                insufficient = rnc > (1.0 - 1e-4 * a) * rnorm
                return insufficient & (tries < cfg.ls_backtracks)

            def ls_body(c):
                a, Nc, rc, rnc, tries = c
                a = a * 0.5
                Nc = N + a * dN
                rc = resid(Nc)
                return (a, Nc, rc, norm(rc), tries + 1)

            _, N_new, r, rnorm_new, _ = jax.lax.while_loop(
                ls_cond, ls_body, (alpha0, N_new, r, rnorm_new, 0))
        N = N_new
        bad = ~jnp.isfinite(rnorm_new)
        inc_ok = (cfg.inc_rtol > 0.0) & (
            norm(dN) <= cfg.inc_rtol * norm(N))
        done = converged_fn(rnorm_new) | inc_ok
        # progress = a significant improvement over the best residual so far;
        # anything else (slow crawl, oscillation, floor) counts toward stall
        progress = rnorm_new < cfg.stall_factor * rn_best
        stall = jnp.where(progress, 0, stall + 1)
        better = rnorm_new < rn_best
        N_best = jnp.where(better, N, N_best)
        rn_best = jnp.where(better, rnorm_new, rn_best)
        return (N, r, rnorm_new, N_best, rn_best, stall, k + 1,
                cg_total + lin_info["iters"], bad, done, op)

      return body

    # The guess is never accepted without an iteration (see docstring):
    # initial 'done' is the trusted-state skip only.
    init = (N0, r0, rnorm0, N0, rnorm0, 0, 0, 0, ~jnp.isfinite(rnorm0),
            skip, lag if lag_on else jnp.asarray(False))
    if lag_on:
        # peeled iteration 0 with the carried operator (runs at most once,
        # and only when the carry is valid and young enough), then the
        # standard rebuild loop
        def cond0(s):
            op = s[10]
            return (cond(s) & (s[6] == 0) & op[0]
                    & (op[1] <= cfg.lag_max_age))
        mid = jax.lax.while_loop(cond0, make_body(True), init)
        # the reused-operator iteration must not pre-charge the rebuild
        # loop's stall budget (a carried operator up to lag_max_age old can
        # legitimately fail the progress test); max_iter still counts it
        mid = mid[:5] + (mid[5] * 0,) + mid[6:]
        out = jax.lax.while_loop(cond, make_body(False), mid)
    else:
        out = jax.lax.while_loop(cond, make_body(False), init)
    N, r, rnorm, N_best, rn_best, stall, k, cg_total, bad, done, op_out = out
    # On a clean exit keep the last iterate; on a stalled/cycling exit keep
    # the best iterate seen, and accept it if it made a deep relative
    # reduction (roundoff floor or Newton limit cycle, not divergence).
    # On skip, return the trusted state untouched.
    N_out = jnp.where(skip, Nr, jnp.where(done, N, N_best))
    rn_out = jnp.where(skip, rnorm_ref, jnp.where(done, rnorm, rn_best))
    accepted = skip | done | (rn_out <= cfg.stall_rtol * rscale)
    stats = {
        "iters": k,
        "rnorm0": rnorm0,
        "rnorm": rn_out,
        "converged": accepted & (~bad),
        "cg_iters": cg_total,
    }
    if lag_on:
        # the step's floor always enters the carry (even on reuse-only
        # steps, where build_op never ran): a probe refreshed at step
        # start must not be lost, or every following step would re-probe
        # until the next rebuild
        stats["lag"] = op_out[:5] + (floor_b, floor_age_this)
    return N_out, stats
