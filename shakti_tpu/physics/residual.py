r"""Weak-form residual of the effective-pressure equation.

This module replaces the reference's UFL weak form + FFCx-generated C
assembly kernels + PETSc vector assembly (reference solvers.py:34-51) with a
single fused gather -> elementwise-physics -> segment-sum pipeline.

The weak form being assembled (reference solvers.py:45):

    F_i = \int [ -q_w(N) . grad(phi_i)
                 + ( (1/rho_i - 1/rho_w) m(N) - C(N)
                     - storage (N - N_n)/(rho_w g dt) - inputs ) phi_i ] dx

with, inside the Newton solve (reference solvers.py:28-45):
  * b, q (hence Re) and the lagged melt `melt_n` FROZEN at the previous step,
  * head h(N) linear in N  =>  q_w linear in grad(N),
  * the only genuine nonlinearities in N: the closure N|N|^2 and the
    quadratic dissipation q . grad h(N).

Everything frozen during the solve is precomputed once per timestep into a
:class:`StepPre` pytree (values at quadrature points + cellwise gradients),
so each Newton iteration touches the minimum possible data.  The Jacobian is
never written by hand: element 3x3 blocks come from forward-mode AD
(`jax.jvp`) of the per-cell residual — the JAX-native equivalent of UFL's
``derivative(F, N)`` (reference solvers.py:51).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from shakti_tpu.fem import ops
from shakti_tpu.fem.ops import ein
from shakti_tpu.fem.p1 import quadrature
from shakti_tpu.params import PhysicalParams
from shakti_tpu.physics import constitutive as law


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StepPre:
    """Per-timestep data frozen during the Newton solve for N.

    All *_q arrays are values at quadrature points, shape (n_cells, nq).
    """

    phi: Any        # (nq, 3) shape functions at quad points
    wq: Any         # (nq,) quadrature weights (sum to 1)
    gb0: Any        # (c, 2) background head gradient (from z_b, z_s)
    Tq: Any         # (c, nq) transmissivity |b|^3 g / (12 nu (1 + omega Re))
    q_q: Any        # (c, nq, 2) frozen water flux at quad points
    b_q: Any        # (c, nq) frozen gap height
    mdiff_q: Any    # (c, nq) frozen Warburton melt-regularization term
    G_q: Any        # (c, nq) geothermal flux
    inputs_q: Any   # (c, nq) moulin/distributed input
    storage_q: Any  # (c, nq) lake-storage indicator
    Nn_q: Any       # (c, nq) previous-step N
    dt: Any         # scalar timestep


def static_quad_fields(mesh, static, quad_degree: int, dtype):
    """Quadrature-point values of the time-independent forcing fields —
    computed once at model build, not per step (they were per-step gathers
    in the first cut; each element gather is a kernel of its own)."""
    phi_np, wq_np = quadrature(quad_degree)
    phi = jnp.asarray(phi_np, dtype=dtype)
    wq = jnp.asarray(wq_np, dtype=dtype)
    at_q = lambda f: ops.interpolate_at_quad(phi, ops.gather_cells(mesh, f))
    return {
        "phi": phi, "wq": wq,
        "G_q": at_q(static.G),
        "inputs_q": at_q(static.inputs),
        "storage_q": at_q(static.storage),
        # surface elevation at quad points: consumed by the degree-day
        # elevation-band melt forcing (solve/timestep.step, SHMIP D/F)
        "zs_q": at_q(static.z_s),
    }


def precompute_step(mesh, N_n, b, q, melt_n, static, dt, params: PhysicalParams,
                    quad_degree: int = 4, sq=None) -> StepPre:
    """Build the frozen per-step data (reference freezes these by passing the
    previous-step Functions into the form, solvers.py:28-45).

    One fused corner gather covers all evolving scalar fields (each
    gather pays a fixed launch cost; 4 gathers -> 1).
    """
    dtype = b.dtype
    if sq is None:
        sq = static_quad_fields(mesh, static, quad_degree, dtype)
    phi, wq = sq["phi"], sq["wq"]

    # fused gather: scalars [b, melt_n, N_n] + flux components as columns
    stacked = jnp.stack([b, melt_n, N_n, q[:, 0], q[:, 1]], axis=1)  # (n, 5)
    sc = ops.gather_cells(mesh, stacked)                             # (c, 3, 5)
    sq_q = ops.interpolate_at_quad(phi, sc)                          # (c, nq, 5)
    b_q, melt_q, Nn_q = sq_q[..., 0], sq_q[..., 1], sq_q[..., 2]
    q_q = sq_q[..., 3:5]                                             # (c, nq, 2)

    Re_q = law.reynolds(q_q, params)
    Tq = law.transmissivity(b_q, Re_q, params)

    # cellwise gradients from the same gathered corner values
    sc_dev = sc - jnp.mean(sc, axis=1, keepdims=True)
    grads_sc = jnp.sum(sc_dev[:, :, :, None] * mesh.grads[:, :, None, :],
                       axis=1)                                       # (c, 5, 2)
    grad_b, grad_melt = grads_sc[:, 0], grads_sc[:, 1]
    mdiff_q = law.melt_regularization(
        b_q, melt_q, grad_b[:, None, :], grad_melt[:, None, :])

    return StepPre(
        phi=phi, wq=wq,
        gb0=static.gb0,
        Tq=Tq, q_q=q_q, b_q=b_q, mdiff_q=mdiff_q,
        G_q=sq["G_q"],
        inputs_q=sq["inputs_q"],
        storage_q=sq["storage_q"],
        Nn_q=Nn_q,
        dt=dt,
    )


def corner_residual(N_c, pre: StepPre, mesh, params: PhysicalParams):
    """Element residual contributions F_ci, given corner values N_c (c, 3).

    Each cell depends only on its own 3 corner values, so the assembled
    Jacobian's element blocks are exactly d(corner_residual)/d(N_c).
    """
    p = params
    # All contractions here are explicit broadcast-multiply-sums, NOT
    # einsums: each tiny einsum becomes its own dot kernel with
    # transpose/copy traffic (see fem/ops.py note) — as plain
    # arithmetic the whole element residual fuses into a handful of
    # kernels, with identical-or-better accuracy.
    # mean-center before the gradient contraction (see fem/ops.cell_grad:
    # f32 cancellation control; exact since sum_i grad(phi_i) = 0)
    N_dev = N_c - jnp.mean(N_c, axis=1, keepdims=True)
    grad_N = jnp.sum(N_dev[:, :, None] * mesh.grads, axis=1)    # (c, 2)
    grad_h = pre.gb0 - grad_N / (p.rho_w * p.g)                 # (c, 2)

    # water flux at quad points: q_w = -T grad(h), T frozen
    flux_q = -pre.Tq[:, :, None] * grad_h[:, None, :]           # (c, nq, 2)

    # melt rate: dissipation uses FROZEN q dotted with the unknown's grad(h)
    qdgh = jnp.sum(pre.q_q * grad_h[:, None, :], axis=-1)       # (c, nq)
    m_q = (pre.G_q - p.rho_w * p.g * qdgh) / p.Lh + pre.mdiff_q

    N_q = jnp.sum(pre.phi[None, :, :] * N_c[:, None, :], axis=2)  # (c, nq)
    C_q = law.closure(pre.b_q, N_q, p)
    c_m = 1.0 / p.rho_i - 1.0 / p.rho_w
    lake_q = pre.storage_q * (N_q - pre.Nn_q) / (p.rho_w * p.g * pre.dt)
    src_q = c_m * m_q - C_q - lake_q - pre.inputs_q

    w_cell = mesh.area * mesh.cell_valid                        # (c,)
    # term_flux_ci = -sum_q w_q flux_q[c,q,:] . grads[c,i,:]
    term_flux = -jnp.sum(
        pre.wq[None, :, None, None] * flux_q[:, :, None, :]
        * mesh.grads[:, None, :, :], axis=(1, 3))               # (c, 3)
    # term_src_ci = sum_q w_q src_q[c,q] phi[q,i]
    term_src = jnp.sum(
        (pre.wq[:, None] * pre.phi)[None, :, :] * src_q[:, :, None],
        axis=1)                                                 # (c, 3)
    return w_cell[:, None] * (term_flux + term_src)


def assemble_residual(N, pre: StepPre, mesh, params: PhysicalParams):
    """Global residual vector F(N) (n_nodes,)."""
    N_c = ops.gather_cells(mesh, N)
    return ops.scatter_add_cells(mesh, corner_residual(N_c, pre, mesh, params))


def corner_residual_multi(N_ck, pre: StepPre, mesh,
                          params: PhysicalParams):
    """:func:`corner_residual` hand-batched over a trailing column axis:
    N_ck (c, 3, k) -> (c, 3, k).

    NOT a vmap: vmap over a small trailing batch inserts batch-boundary
    transposes around the corner physics, while the batched gather /
    accumulate building blocks carry extra payload columns at little
    cost per index.  Trailing-dim broadcasts keep every reduction's shape
    and order identical to the single-column code per k-slice, so each
    column is bit-identical to
    :func:`corner_residual` (tests/test_fem.py)."""
    p = params
    N_dev = N_ck - jnp.mean(N_ck, axis=1, keepdims=True)        # (c, 3, k)
    grad_N = jnp.sum(N_dev[:, :, None, :] * mesh.grads[:, :, :, None],
                     axis=1)                                    # (c, 2, k)
    grad_h = pre.gb0[:, :, None] - grad_N / (p.rho_w * p.g)     # (c, 2, k)
    flux_q = -pre.Tq[:, :, None, None] * grad_h[:, None, :, :]  # (c,nq,2,k)
    qdgh = jnp.sum(pre.q_q[:, :, :, None] * grad_h[:, None, :, :],
                   axis=2)                                      # (c, nq, k)
    m_q = ((pre.G_q[:, :, None] - p.rho_w * p.g * qdgh) / p.Lh
           + pre.mdiff_q[:, :, None])
    N_q = jnp.sum(pre.phi[None, :, :, None] * N_ck[:, None, :, :],
                  axis=2)                                       # (c, nq, k)
    C_q = law.closure(pre.b_q[:, :, None], N_q, p)
    c_m = 1.0 / p.rho_i - 1.0 / p.rho_w
    lake_q = (pre.storage_q[:, :, None] * (N_q - pre.Nn_q[:, :, None])
              / (p.rho_w * p.g * pre.dt))
    src_q = c_m * m_q - C_q - lake_q - pre.inputs_q[:, :, None]
    w_cell = mesh.area * mesh.cell_valid
    term_flux = -jnp.sum(
        pre.wq[None, :, None, None, None] * flux_q[:, :, None, :, :]
        * mesh.grads[:, None, :, :, None], axis=(1, 3))         # (c, 3, k)
    term_src = jnp.sum(
        (pre.wq[:, None] * pre.phi)[None, :, :, None]
        * src_q[:, :, None, :], axis=1)                         # (c, 3, k)
    return w_cell[:, None, None] * (term_flux + term_src)


def assemble_residual_multi(Ns, pre: StepPre, mesh, params: PhysicalParams):
    """Residuals for k stacked states at once: (n, k) -> (n, k).

    Same op count as a single assembly (batched shapes) — used to evaluate
    the residual and its roundoff-sensitivity probe in one pass.
    """
    sc = ops.gather_cells(mesh, Ns)                              # (c, 3, k)
    return ops.scatter_add_cells(
        mesh, corner_residual_multi(sc, pre, mesh, params))      # (n, k)


def element_jacobian(N, pre: StepPre, mesh, params: PhysicalParams):
    """Element Jacobian blocks J_cij = dF_ci / dN_cj  (c, 3, 3) via
    forward-mode AD — the replacement for UFL `derivative(F, N)`
    (reference solvers.py:51).

    Uses jax.linearize: one primal evaluation + three cheap tangent passes
    (vs three full jvps, each of which would redo the primal work).
    """
    N_c = ops.gather_cells(mesh, N)
    f = lambda x: corner_residual(x, pre, mesh, params)
    _, f_lin = jax.linearize(f, N_c)
    cols = [f_lin(jnp.zeros_like(N_c).at[:, j].set(1.0)) for j in range(3)]
    return jnp.stack(cols, axis=-1)                             # (c, 3, 3)


def jacobian_diag(J_c, mesh):
    """Assembled Jacobian diagonal from element blocks (for Jacobi PC)."""
    diag_c = jnp.diagonal(J_c, axis1=1, axis2=2)                # (c, 3)
    return ops.scatter_add_cells(mesh, diag_c)


def make_matvec(J_c, mesh, dirichlet):
    """Matrix-free action of A = -J with symmetric Dirichlet elimination.

    The Newton update solves J dN = -F; we hand CG the SPD-dominant operator
    A = -J (see design notes: J = -(stiffness + closure/storage mass) + small
    convection, so -J is symmetric-positive-definite up to the small
    dissipation-convection term).  Constrained rows/cols are eliminated
    symmetrically: A acts as identity on Dirichlet dofs, and inputs are
    zeroed there first (valid because the Newton initial guess is projected
    onto the boundary condition, so the constrained residual is 0 and the
    constrained update is 0 — equivalent to DOLFINx's apply_lifting path,
    reference solvers.py:24,51-54).
    """
    def matvec(x):
        xf = jnp.where(dirichlet, 0.0, x)
        xc = xf[mesh.cells]                                     # (c, 3)
        yc = jnp.sum(J_c * xc[:, None, :], axis=2)
        y = -ops.scatter_add_cells(mesh, yc)
        return jnp.where(dirichlet, x, y)
    return matvec


def operator_values_shape(mesh):
    """Shape of the folded row-storage values array for this mesh's
    operator format (for seeding the lagged-operator carry with zeros)."""
    if mesh.bcsr_brow is not None:
        return (mesh.bcsr_brow.shape[0], mesh.bcsr_B, mesh.bcsr_B)
    if mesh.bell_nbr is not None:
        NB, KB = mesh.bell_nbr.shape
        return (NB, KB, mesh.bell_B, mesh.bell_B)
    if mesh.ell_cols is not None:
        return mesh.ell_cols.shape
    raise ValueError("mesh has no foldable operator structure")


def fold_operator_values(J_c, mesh, out=None):
    """Element blocks -> row-storage values of A = -J in the mesh's
    operator format (BCSR / block-ELL / ELL).  Split from
    :func:`make_operator` so the lagged-operator Newton path
    (solve/newton.py) can carry folded values across timesteps.

    ``out``: a DEAD values buffer of the same format to overwrite (the
    stale carry in the lag rebuild branch) — lets XLA alias it instead of
    keeping carry + fresh values live simultaneously (NewtonConfig.lag_operator
    scale caveat)."""
    # negate the SMALL element blocks (A = -J), not the folded values:
    # an outer negation of the big values array would allocate yet another
    # values-sized buffer in the out= reuse path
    nJ = -J_c
    if mesh.bcsr_brow is not None:
        from shakti_tpu.fem import bcsr as bcsrm
        return bcsrm.bcsr_from_elements(nJ, mesh.bcsr_blk, mesh.bcsr_off,
                                        mesh.bcsr_brow.shape[0], mesh.bcsr_B,
                                        out=out)
    if mesh.bell_nbr is not None:
        from shakti_tpu.fem import bell as bellm
        NB, KB = mesh.bell_nbr.shape
        return bellm.bell_from_elements(nJ, mesh.bell_map, NB, KB,
                                        mesh.bell_B, out=out)
    if mesh.ell_cols is not None:
        from shakti_tpu.fem import ell as ellm
        n, K = mesh.ell_cols.shape
        return ellm.ell_from_elements(nJ, mesh.ell_map, n, K, out=out)
    raise ValueError("mesh has no foldable operator structure")


def operator_diag_from_values(vals, mesh):
    """Assembled diagonal of A from folded row-storage values.

    Shard-local row storage (mesh.halo set) holds only this device's cell
    contributions; the diagonal is completed across partition boundaries
    with one halo accumulate (any format)."""
    if mesh.bcsr_brow is not None:
        from shakti_tpu.fem import bcsr as bcsrm
        a_diag = bcsrm.bcsr_diag(vals, mesh.bcsr_diag_blk, mesh.bcsr_diag_off)
    elif mesh.bell_nbr is not None:
        from shakti_tpu.fem import bell as bellm
        a_diag = bellm.bell_diag(vals, mesh.bell_diag_pos)
    else:
        from shakti_tpu.fem import ell as ellm
        a_diag = ellm.ell_diag(vals, mesh.ell_diag_slot)
    if mesh.halo is not None:
        a_diag = mesh.halo.accumulate(a_diag)
    return a_diag


def operator_from_values(vals, mesh, dirichlet):
    """Matvec of A = -J (symmetric Dirichlet elimination) from folded
    row-storage values."""
    n = mesh.n_nodes
    if mesh.bcsr_brow is not None:
        from shakti_tpu.fem import bcsr as bcsrm

        def matvec(x):
            xf = jnp.where(dirichlet, 0.0, x)
            y = bcsrm.bcsr_matvec(vals, mesh.bcsr_brow, mesh.bcsr_bcol, xf,
                                  n, mesh.bcsr_NB)
            if mesh.halo is not None:
                y = mesh.halo.accumulate(y)
            return jnp.where(dirichlet, x, y)

        return matvec
    if mesh.bell_nbr is not None:
        from shakti_tpu.fem import bell as bellm
        halo = mesh.halo
        if halo is not None and halo.omax is not None:
            # comm/compute overlap: ghost block-rows first, so the return
            # all_to_all only waits on the small boundary piece
            NB, KB, B, _ = vals.shape
            sB = halo.omax // B

            def matvec(x):
                xf = jnp.where(dirichlet, 0.0, x)
                xb = jnp.pad(xf, (0, NB * B - n)).reshape(NB, B)
                from shakti_tpu.fem.ops import ein
                y_hi = ein("nkij,nkj->ni", vals[sB:],
                           xb[mesh.bell_nbr[sB:]]).reshape(-1)
                y_lo = ein("nkij,nkj->ni", vals[:sB],
                           xb[mesh.bell_nbr[:sB]]).reshape(-1)
                y = halo.accumulate_split(y_lo, y_hi[: n - sB * B])
                return jnp.where(dirichlet, x, y)

            return matvec

        def matvec(x):
            xf = jnp.where(dirichlet, 0.0, x)
            y = bellm.bell_matvec(vals, mesh.bell_nbr, xf, n)
            if mesh.halo is not None:
                y = mesh.halo.accumulate(y)
            return jnp.where(dirichlet, x, y)

        return matvec
    from shakti_tpu.fem import ell as ellm
    halo = mesh.halo
    if halo is not None and halo.omax is not None:
        s = halo.omax

        def matvec(x):
            xf = jnp.where(dirichlet, 0.0, x)
            y_hi = ellm.ell_matvec(vals[s:], mesh.ell_cols[s:], xf)
            y_lo = ellm.ell_matvec(vals[:s], mesh.ell_cols[:s], xf)
            y = halo.accumulate_split(y_lo, y_hi)
            return jnp.where(dirichlet, x, y)

        return matvec

    def matvec(x):
        xf = jnp.where(dirichlet, 0.0, x)
        y = ellm.ell_matvec(vals, mesh.ell_cols, xf)
        if mesh.halo is not None:
            y = mesh.halo.accumulate(y)
        return jnp.where(dirichlet, x, y)

    return matvec


def make_operator(J_c, mesh, dirichlet):
    """(matvec, diag) for A = -J with Dirichlet elimination.

    Prefers the scatter-free ELL path (fem/ell.py) when the mesh carries ELL
    structure: the element blocks are folded into row storage once, so every
    Krylov iteration is pure gather work with no scatter-add.
    Shard-local meshes (parallel/shard.py) fall back to the cell-based
    matvec + psum path.
    """
    if (mesh.bcsr_brow is not None or mesh.bell_nbr is not None
            or mesh.ell_cols is not None):
        vals = fold_operator_values(J_c, mesh)
        a_diag = operator_diag_from_values(vals, mesh)
        return operator_from_values(vals, mesh, dirichlet), a_diag

    a_diag = -jacobian_diag(J_c, mesh)
    return make_matvec(J_c, mesh, dirichlet), a_diag
