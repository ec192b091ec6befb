"""Matrix-free Krylov solvers (preconditioned CG and BiCGStab).

Replaces the PETSc KSP layer under the reference's NewtonSolver
(reference solvers.py:51-54, SURVEY §2b "PETSc SNES-ish NewtonSolver + KSP").
Written as pure functions under `lax.while_loop` so the entire Newton-Krylov
timestep compiles into one XLA program: no host round-trips per iteration,
which is where the reference's per-step MPI/host chatter went (SURVEY §3.3).

The operator A = -J is SPD up to a small convection term (see
physics/residual.make_matvec), so PCG is the default; BiCGStab is the
fallback for strongly convective regimes.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp

from shakti_tpu.fem.ops import vdot


def pcg(matvec, b, minv=None, x0=None, *, rtol=1e-8, atol=0.0, maxiter=1000,
        dot=None, norm=None):
    """Preconditioned conjugate gradients.

    Returns (x, info) with info = dict(iters, resnorm, converged).
    ``minv``: diagonal preconditioner inverse (vector), or None.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    # ``minv`` may be a diagonal (vector) or a callable preconditioner apply
    apply_pc = minv if callable(minv) else (
        (lambda r: r) if minv is None else (lambda r: minv * r))
    dot = dot or vdot
    norm = norm or jnp.linalg.norm

    bnorm = norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - matvec(x0)
    z0 = apply_pc(r0)
    p0 = z0
    rz0 = dot(r0, z0)

    def cond(s):
        x, r, p, rz, k = s
        return (norm(r) > tol) & (k < maxiter)

    def body(s):
        x, r, p, rz, k = s
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_pc(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = z + beta * p
        return (x, r, p, rz_new, k + 1)

    x, r, p, rz, k = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    resnorm = norm(r)
    return x, {"iters": k, "resnorm": resnorm, "converged": resnorm <= tol}


def bicgstab(matvec, b, minv=None, x0=None, *, rtol=1e-8, atol=0.0,
             maxiter=1000, dot=None, norm=None):
    """Preconditioned BiCGStab (right-preconditioned with diagonal minv)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    apply_pc = minv if callable(minv) else (
        (lambda r: r) if minv is None else (lambda r: minv * r))
    dot = dot or vdot
    norm = norm or jnp.linalg.norm

    bnorm = norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - matvec(x0)
    rhat = r0

    def cond(s):
        x, r, p, v, rho, alpha, omega, k = s
        return (norm(r) > tol) & (k < maxiter)

    def body(s):
        x, r, p, v, rho, alpha, omega, k = s
        rho_new = dot(rhat, r)
        beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * (
            alpha / jnp.where(omega == 0, 1.0, omega))
        p = r + beta * (p - omega * v)
        phat = apply_pc(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        alpha = rho_new / jnp.where(denom == 0, 1.0, denom)
        s_vec = r - alpha * v
        shat = apply_pc(s_vec)
        t = matvec(shat)
        tt = dot(t, t)
        omega = dot(t, s_vec) / jnp.where(tt == 0, 1.0, tt)
        x = x + alpha * phat + omega * shat
        r = s_vec - omega * t
        return (x, r, p, v, rho_new, alpha, omega, k + 1)

    z = jnp.zeros_like(b)
    one = jnp.asarray(1.0, dtype=b.dtype)
    init = (x0, r0, z, z, one, one, one, 0)
    x, r, *_, k = jax.lax.while_loop(cond, body, init)
    resnorm = norm(r)
    return x, {"iters": k, "resnorm": resnorm, "converged": resnorm <= tol}


SOLVERS = {"cg": pcg, "bicgstab": bicgstab}


def get_solver(name: str):
    return SOLVERS[name]
