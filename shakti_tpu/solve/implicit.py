"""Differentiable implicit solves: reverse-mode AD through Newton via the
implicit-function theorem (a capability the reference stack does not have —
PETSc's NewtonSolver, reference solvers.py:51-63, is not differentiable).

The framework's whole timestep is pure-functional jnp EXCEPT the implicit
N-solve, whose ``lax.while_loop`` Newton/Krylov iterations reverse-mode AD
cannot unroll.  Instead of unrolling, the converged solution is given its
exact mathematical derivative (custom VJP): with

    F(N*, pre) = 0        on free nodes,
    N*          = N_bdry  on Dirichlet nodes,

the implicit-function theorem gives, for a loss cotangent ``ct`` on N*,

    A^T lambda = ct|_free        (A = -J, the forward Krylov operator)
    ct_pre     = (dF/dpre)^T lambda

i.e. ONE adjoint Krylov solve per backward step — same folded row-storage
operator format (ELL/block-ELL/BCSR), symmetric Dirichlet elimination,
degenerate-row diagonal floor, and preconditioner class (cfg.precond:
mg / two-level / jacobi) as the forward iteration (solve/newton.py) —
followed by one VJP of the residual assembly with N held fixed.  The
adjoint operator is exact: the global Jacobian transpose assembles from
the per-element transposed blocks (J^T = sum_c S_c J_c^T S_c^T), so the
small dissipation-convection asymmetry of A is honored rather than
ignored.  Adjoint Krylov non-convergence is warned loudly at runtime;
``SHAKTI_ADJOINT_STRICT=1`` additionally poisons the affected gradient
with NaN.

Gradients flow into everything ``pre`` depends on — the previous state
(b, q, melt, N_n), dt, and the per-step forcing (inputs scale, degree-day
melt) — so whole transients (``run_window`` scans) are differentiable
end-to-end for calibration/inversion workflows (examples/calibrate_melt.py).
Enable with ``NewtonConfig(differentiable=True)``; incompatible with
``lag_operator`` (stateful operator carry).

Distributed (node-sharded halo) adjoint: inside ``shard_map`` the same IFT
algebra runs on the owned/ghost representation with three adaptations —
(1) the incoming cotangent carries per-shard partial contributions at
owned AND ghost slots (every shard's cells read ghost copies of N*), so it
is halo-ACCUMULATED into the globally consistent cotangent before the
adjoint solve; (2) the adjoint Krylov uses the ghost-masked psum'd
dot/norm (like the forward solve); (3) the residual whose VJP produces
``ct_pre`` is masked to OWNED rows — ghost rows duplicate their owner's
equation across shards, and an unmasked VJP would count each interface
constraint once per replica.  The backward halo collectives are the AD
transposes XLA derives from the forward ``all_to_all`` pattern.  Verified
against the single-device adjoint and finite differences on an 8-device
mesh (tests/test_adjoint.py).

Memory: reverse over a T-step ``lax.scan`` stores T forward states; wrap the
step in ``jax.checkpoint`` for long horizons (the example does).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

import numpy as np

from shakti_tpu.fem.ops import vdot
from shakti_tpu.physics import residual as res
from shakti_tpu.solve import krylov
from shakti_tpu.solve.precond import make_preconditioner


def _zero_cotangent(x):
    """Zero cotangent for a custom_vjp primal leaf: zeros for inexact
    dtypes, float0 for integer/bool leaves (jax's convention)."""
    aval = jax.typeof(x)
    if jnp.issubdtype(aval.dtype, jnp.inexact):
        return jnp.zeros(aval.shape, aval.dtype)
    return np.zeros(aval.shape, jax.dtypes.float0)


def make_implicit_solver(mesh, dirichlet, dirichlet_value, params, cfg):
    """Returns solve(N_init, N_ref, pre) -> (N, stats), a drop-in for the
    ``newton_solve`` call in solve/timestep.make_step_fn with an exact
    implicit-function-theorem VJP.

    ``N_init``/``N_ref`` receive zero cotangents: the converged solution
    does not depend on the starting iterate (their only role is iteration
    count), which is precisely what makes the IFT shortcut exact.

    Works on single-device meshes and, inside ``shard_map``, on
    node-sharded halo meshes (see module docstring for the three
    distributed adaptations).
    """
    from shakti_tpu.solve.newton import diag_floor_extra, newton_solve

    distributed = mesh.halo is not None
    if cfg.coarse_block is None:
        # direct callers (tests/scripts) may skip freeze's auto-resolution
        cfg = dataclasses.replace(cfg, coarse_block=64)
    # strict mode: poison gradients with NaN when the adjoint Krylov solve
    # does not converge, instead of only warning — for production
    # calibration/inversion where a silently inaccurate gradient is worse
    # than a loud failure
    strict = os.environ.get("SHAKTI_ADJOINT_STRICT", "0") == "1"

    # mesh / dirichlet / dirichlet_value are explicit custom_vjp ARGUMENTS,
    # not closures: inside shard_map their leaves are tracers, and a
    # custom_vjp fwd/bwd pair must not close over tracers (they would be
    # staged as jaxpr constants — "No constant handler for
    # DynamicJaxprTracer" at lowering).  They ride through the residuals
    # and get zero/float0 cotangents.  cfg/params close fine (python
    # scalars, static).
    def _forward(N_init, N_ref, pre, mesh, dirichlet, dirichlet_value):
        return newton_solve(N_init, pre, mesh, dirichlet, dirichlet_value,
                            params, cfg, N_ref=N_ref)

    solve = jax.custom_vjp(_forward)

    def fwd(N_init, N_ref, pre, mesh, dirichlet, dirichlet_value):
        N, stats = _forward(N_init, N_ref, pre, mesh, dirichlet,
                            dirichlet_value)
        return (N, stats), (N, pre, mesh, dirichlet, dirichlet_value)

    def bwd(saved, ct):
        N, pre, mesh, dirichlet, dirichlet_value = saved
        if distributed:
            dot, norm = mesh.halo.dot, mesh.halo.norm
            owned = mesh.halo.owned_mask
        else:
            dot, norm, owned = vdot, jnp.linalg.norm, None
        ct_N = ct[0]                      # ct[1] = stats cotangents (float0)
        if owned is not None:
            # distributed: the cotangent arrives as per-shard PARTIAL
            # contributions (owned + ghost slots); sum ghost contributions
            # into their owners and refresh ghosts -> the globally
            # consistent cotangent in the owned/ghost representation
            ct_N = mesh.halo.accumulate(ct_N)
        # exact adjoint operator: transpose the element Jacobian blocks
        # (global J^T = sum_c S_c J_c^T S_c^T; in dist mode each shard
        # transposes its local blocks, so the halo accumulate completes the
        # global transpose exactly as it completes the forward operator).
        # Folding the transposed blocks through make_operator gives the
        # adjoint solve the same fast row-storage SpMV (ELL/block-ELL/BCSR)
        # as the forward solve and, in dist mode, the halo-ACCUMULATED
        # diagonal (a shard-partial diagonal would make the Jacobi sweep
        # and the floor inconsistent at interface nodes).
        J_c = res.element_jacobian(N, pre, mesh, params)
        J_t = jnp.swapaxes(J_c, 1, 2)
        A_t0, a_diag = res.make_operator(J_t, mesh, dirichlet)
        # same degenerate-row floor as the forward solve (shared helper —
        # the adjoint is exact only while the two operators match)
        extra = diag_floor_extra(a_diag, dirichlet, mesh, cfg.diag_floor_rel)
        A_t = lambda x: A_t0(x) + extra * x
        a_diag = a_diag + extra
        # same preconditioner class as the forward Newton iteration
        # (newton.py non-lag path): mg / two-level / jacobi per cfg.precond.
        # A Jacobi-only adjoint would silently need thousands of iterations
        # at the halo scales where the forward solve requires the mg PC.
        minv = make_preconditioner(
            cfg.precond, J_t, mesh, dirichlet, a_diag, cfg.coarse_block,
            matvec=A_t, mg_omega=cfg.mg_omega, mg_smoother=cfg.mg_smoother,
            mg_cheb_deg=cfg.mg_cheb_deg, mg_cheb_frac=cfg.mg_cheb_frac,
            mg_cycle=cfg.mg_cycle, mg_smooth_p=cfg.mg_smooth_p)

        rhs = jnp.where(dirichlet, 0.0, ct_N)
        lin_solve = krylov.get_solver(cfg.krylov)
        lam, info = lin_solve(A_t, rhs, minv=minv, rtol=cfg.lin_rtol,
                              maxiter=cfg.lin_maxiter, dot=dot, norm=norm)
        # surface adjoint non-convergence LOUDLY: the forward solve's
        # converged flag reaches the API layer, but bwd has no stats
        # channel — warn through a host callback, and under
        # SHAKTI_ADJOINT_STRICT=1 poison the gradient with NaN so
        # downstream optimizers cannot quietly consume an inaccurate one.
        jax.lax.cond(
            info["converged"], lambda: None,
            lambda: jax.debug.print(
                "shakti_tpu WARNING: adjoint Krylov solve unconverged "
                "(resnorm {r} after {k} iters) — gradients from this "
                "step may be inaccurate; raise NewtonConfig.lin_maxiter "
                "or strengthen cfg.precond", r=info["resnorm"],
                k=info["iters"]))
        if strict:
            lam = jnp.where(info["converged"], lam,
                            jnp.full_like(lam, jnp.nan))
        # A^T lambda = ct  =>  ct_pre = (dF/dpre)^T lambda  (see module doc;
        # lambda vanishes on Dirichlet rows because A acts as identity there
        # and rhs is masked, so the row masking of F is immaterial).
        # Distributed: mask to OWNED rows — every ghost row duplicates its
        # owner's equation on another shard, and the VJP sums over all
        # slots of all shards, so unmasked ghost rows would count each
        # interface constraint once per replica.
        def masked_resid(pr):
            F = res.assemble_residual(N, pr, mesh, params)
            F = jnp.where(dirichlet, 0.0, F)
            return F if owned is None else F * owned

        _, vjp_pre = jax.vjp(masked_resid, pre)
        (ct_pre,) = vjp_pre(lam)
        zero = jnp.zeros_like(N)
        zeros = lambda t: jax.tree_util.tree_map(_zero_cotangent, t)
        return (zero, zero, ct_pre, zeros(mesh), _zero_cotangent(dirichlet),
                _zero_cotangent(dirichlet_value))

    solve.defvjp(fwd, bwd)
    return lambda N_init, N_ref, pre: solve(N_init, N_ref, pre, mesh,
                                            dirichlet, dirichlet_value)
