"""Multilevel (aggregation V-cycle) preconditioner: the weak-scaling PC.

The two-level preconditioner (solve/precond.py) carries a single dense
coarse problem capped at ~1.5k dofs; beyond ~1M dofs its aggregates grow so
large that mid-frequency smooth error modes fall between the Jacobi smoother
and the coarse space, and CG counts explode (measured 2.7k-4.6k iters/step
at 10M dof vs ~6 at 1M — the r2 scaling wall).  This module is the PETSc-MG
role (the reference gets scalable preconditioning for free from PETSc KSP,
reference solvers.py:51-54) built from dense, static-shape pieces:

  * hierarchy = contiguous index-range aggregation of the RCB-localized
    solver ordering (aggregates are spatially compact patches), a factor
    ``agg`` per level, down to a dense coarse problem <= ``cap`` dofs;
  * every level's Galerkin operator A_l = P^T A_{l-1} P is assembled ON
    DEVICE each Newton iteration by one segment-sum through a
    host-precomputed slot map (level 1 straight from the element Jacobian
    blocks — the same trick fem/ell.py uses for the fine operator), so the
    hierarchy tracks the evolving transmissivity field exactly;
  * the apply is a symmetric V(1,1) cycle (damped-Jacobi smoothing, dense
    solve at the bottom) — a fixed SPD linear operator, CG-safe;
  * SPMD (parallel/halo.py meshes): level-1 assembly completes with ONE
    psum (cells are partitioned disjointly) and the whole coarse hierarchy
    is replicated — per V-cycle the only communication is the two fine
    matvecs' halo exchanges and one m1-vector psum in the restriction.

Everything below the fine level is a few hundred KB, so the levels live
happily as closure constants (see solve/timestep.make_runner note on
closures vs args).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MGPlan:
    """Host-precomputed multilevel structure (static sparsity; values are
    re-assembled on device every Newton iteration).

    ``cols/diag_slot/next_map`` are tuples with one entry per intermediate
    ELL level (may be empty: then map9 targets the dense coarse directly
    and the plan degenerates to the two-level method).
    """

    map9: Any        # (9c,) int32: element-Jacobian entry -> level-1 flat slot
    agg_fine: Any    # (n|L,) int32: fine node/local slot -> level-1 aggregate
    cols: Any        # tuple of (m_l, K_l) int32 ELL columns per level
    diag_slot: Any   # tuple of (m_l,) int32 within-row diagonal slots
    next_map: Any    # tuple of (m_l*K_l,) int32 slot -> next-level flat slot
    m_c: int = dataclasses.field(metadata=dict(static=True), default=0)
    agg: int = dataclasses.field(metadata=dict(static=True), default=16)


def _ell_structure(keys: np.ndarray, m: int):
    """Unique (row, col) pair keys (row * m_cols + col encoding done by the
    caller) -> ELL structure.  Returns (uniq_key, cols, diag_slot, K,
    slot_of_uniq) with cols padded by the row's own id (zero-valued slots).
    """
    uniq = np.unique(keys)
    r = (uniq // m).astype(np.int64)
    c = (uniq % m).astype(np.int32)
    deg = np.bincount(r, minlength=m)
    K = max(int(deg.max()) if deg.size else 1, 1)
    row_start = np.concatenate([[0], np.cumsum(deg)])
    slot_k = np.arange(uniq.size) - row_start[r]
    cols = np.broadcast_to(np.arange(m, dtype=np.int32)[:, None],
                           (m, K)).copy()
    cols[r, slot_k] = c
    diag_key = np.arange(m, dtype=np.int64) * (m + 1)
    pos = np.clip(np.searchsorted(uniq, diag_key), 0, uniq.size - 1)
    diag_slot = np.where(uniq[pos] == diag_key, slot_k[pos], 0).astype(np.int32)
    flat_slot = (r * K + slot_k).astype(np.int64)   # flat m*K slot per uniq
    return uniq, cols, diag_slot, K, flat_slot


def build_hierarchy(cells: np.ndarray, n_nodes: int, *, agg: int = 16,
                    cap: int = 1536,
                    node_global: np.ndarray | None = None) -> MGPlan | None:
    """Host-side hierarchy construction.

    ``cells`` index GLOBAL solver-order node ids (for SPMD pass the global
    cell array once — the coarse structure is shared by all shards).
    ``node_global``: per-local-slot global node id for SPMD meshes (used
    only for ``agg_fine``); None = identity (single device).

    Returns None when the mesh is already at/below the dense cap (use the
    plain two-level preconditioner there).
    """
    if n_nodes <= cap:
        return None
    ms = [n_nodes]
    while ms[-1] > cap:
        ms.append(-(-ms[-1] // agg))
    # ms = [n, m1, ..., m_c]; intermediate ELL levels are ms[1:-1]
    m_c = ms[-1]
    n_lvl = len(ms) - 2            # number of ELL levels

    a3 = (cells.astype(np.int64) // agg)                    # (c, 3) level-1
    rows9 = np.broadcast_to(a3[:, :, None], a3.shape + (3,)).reshape(-1)
    cols9 = np.broadcast_to(a3[:, None, :], (a3.shape[0], 3, 3)).reshape(-1)

    cols_t, diag_t, next_t = [], [], []
    if n_lvl == 0:
        map9 = (rows9 * m_c + cols9).astype(np.int32)
    else:
        m1 = ms[1]
        keys = rows9 * m1 + cols9
        uniq, cols_l, diag_l, K, flat_slot = _ell_structure(keys, m1)
        map9 = flat_slot[np.searchsorted(uniq, keys)].astype(np.int32)
        cols_t.append(cols_l)
        diag_t.append(diag_l)
        # successive Galerkin levels: map this level's (m*K,) slots (pads
        # included — they carry zero values, so any real target is fine)
        for l in range(1, n_lvl + 1):
            m, K = cols_t[-1].shape
            m_next = ms[l + 1]
            r_l = np.repeat(np.arange(m, dtype=np.int64), K) // agg
            c_l = cols_t[-1].reshape(-1).astype(np.int64) // agg
            if l == n_lvl:                       # next is the dense coarse
                next_t.append((r_l * m_c + c_l).astype(np.int32))
            else:
                keys = r_l * m_next + c_l
                uniq, cols_l, diag_l, K2, flat_slot = _ell_structure(
                    keys, m_next)
                next_t.append(
                    flat_slot[np.searchsorted(uniq, keys)].astype(np.int32))
                cols_t.append(cols_l)
                diag_t.append(diag_l)

    if node_global is None:
        agg_fine = (np.arange(n_nodes, dtype=np.int64) // agg).astype(np.int32)
    else:
        agg_fine = (np.asarray(node_global, dtype=np.int64)
                    // agg).astype(np.int32)

    return MGPlan(
        map9=jnp.asarray(map9),
        agg_fine=jnp.asarray(agg_fine),
        cols=tuple(jnp.asarray(c) for c in cols_t),
        diag_slot=tuple(jnp.asarray(d) for d in diag_t),
        next_map=tuple(jnp.asarray(nm) for nm in next_t),
        m_c=int(m_c), agg=int(agg),
    )


def assemble_levels(J_c, mesh, dirichlet, plan: MGPlan):
    """Galerkin level operators of A = -J (free rows/cols only) from the
    element Jacobian blocks: one segment-sum per level (+ one psum at level
    1 under SPMD), then the dense coarse inverse."""
    dtype = J_c.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    free = (~dirichlet).astype(dtype)
    wc = free[mesh.cells]                                    # (c, 3)
    w9 = (wc[:, :, None] * wc[:, None, :]).reshape(-1)
    flat = (-J_c).reshape(-1) * w9

    n_lvl = len(plan.cols)
    levels = []
    if n_lvl == 0:
        A_flat = jax.ops.segment_sum(flat, plan.map9,
                                     num_segments=plan.m_c * plan.m_c)
        if mesh.halo is not None:
            A_flat = jax.lax.psum(A_flat, mesh.halo.axis)
    else:
        m1, K1 = plan.cols[0].shape
        v = jax.ops.segment_sum(flat, plan.map9, num_segments=m1 * K1)
        if mesh.halo is not None:
            # cells are disjointly partitioned: one psum completes level 1,
            # everything below is replicated compute
            v = jax.lax.psum(v, mesh.halo.axis)
        for l in range(n_lvl):
            m, K = plan.cols[l].shape
            V = v.reshape(m, K)
            d = V.reshape(-1)[jnp.arange(m) * K + plan.diag_slot[l]]
            levels.append((V, d))
            n_next = (plan.m_c * plan.m_c if l == n_lvl - 1
                      else plan.cols[l + 1].shape[0]
                      * plan.cols[l + 1].shape[1])
            v = jax.ops.segment_sum(V.reshape(-1), plan.next_map[l],
                                    num_segments=n_next)
        A_flat = v
    A_c = A_flat.reshape(plan.m_c, plan.m_c)
    dmean = jnp.mean(jnp.abs(jnp.diag(A_c))) + tiny
    A_c = A_c + (1e-8 * dmean) * jnp.eye(plan.m_c, dtype=dtype)
    A_inv = jnp.linalg.inv(A_c)
    return levels, A_inv


def _make_cheb(matvec, inv_d, lmax, deg: int, frac: float, dtype):
    """Degree-``deg`` Chebyshev polynomial smoother for A x = b on the
    interval [frac*lmax, lmax] of the D^{-1}A spectrum (standard
    three-term semi-iteration recurrence; each step past the first costs
    one matvec).  A fixed polynomial in D^{-1}A, so a symmetric V-cycle
    with the same degree pre and post stays SPD (CG-safe) — no
    omega-tuning, and it targets the whole upper spectral band instead of
    the single point damped Jacobi optimizes.
    """
    lmax = jnp.asarray(lmax, dtype)
    theta = 0.5 * (1.0 + frac) * lmax
    delta = 0.5 * (1.0 - frac) * lmax
    sigma = theta / delta

    def smooth(x, b, from_zero: bool):
        r = b if from_zero else b - matvec(x)
        dv = (inv_d * r) / theta
        x = dv if from_zero else x + dv
        rho = 1.0 / sigma
        for _ in range(deg - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = b - matvec(x)
            dv = rho_new * rho * dv + (2.0 * rho_new / delta) * (inv_d * r)
            x = x + dv
            rho = rho_new
        return x

    return smooth


def make_multilevel(J_c, mesh, dirichlet, a_diag, matvec, *,
                    omega: float = 0.8, smoother: str = "jacobi",
                    cheb_deg: int = 2, cheb_frac: float = 0.25,
                    cycle: str = "v", smooth_p: float = 0.0):
    """Symmetric V(1,1)-cycle preconditioner apply for A = -J.

    ``matvec`` must be the SAME (regularized, Dirichlet-identity) fine
    operator handed to the Krylov solver, and ``a_diag`` its diagonal —
    smoothing with the exact operator keeps M symmetric positive definite.
    Cost per apply: 2 fine matvecs + 2 fine Jacobi sweeps + the (small)
    coarse hierarchy.

    ``smoother="cheb"`` replaces each damped-Jacobi sweep with a
    degree-``cheb_deg`` Chebyshev sweep (2*cheb_deg fine matvecs per
    apply instead of 2).  The spectral upper bound comes free from
    Gershgorin: per-row off-diagonal |.| sums assembled from the element
    Jacobian blocks (a valid upper bound by the triangle inequality even
    where inter-element contributions cancel), divided by the regularized
    diagonal — adding the same positive regularization to numerator and
    denominator only shrinks the ratio, so the bound stays safe.

    ``cycle="w"`` upgrades every coarse-level solve from one recursive
    application to a symmetric double correction, B_W = 2B - B A B
    (equivalently: apply the level cycle, then apply it again to the
    remaining level residual).  This is the standard gamma=2 W-cycle, the
    textbook fix for plain (unsmoothed) aggregation hierarchies whose
    V-cycle convergence degrades with depth (Notay's AGMG lineage uses
    K-cycles for the same reason; the stationary double correction keeps
    the apply a FIXED SPD linear operator, so plain CG stays valid —
    B symmetric with spec(AB) in (0,1] gives spec(A B_W) = l(2-l) in
    (0,1]).  Cost: level l is visited 2^l times, but level sizes shrink
    by agg^l >= 4^l, so the extra work is a geometric tail ~n/2^l of
    REPLICATED small-level compute with zero additional communication —
    the fine-level cost (smoothing matvecs, the one restriction psum) is
    unchanged.  Caveat for launch-bound backends: kernel count per apply
    grows ~2x per level (deep 10M hierarchies: ~6 levels -> ~60 extra
    small-kernel launches), which matters on small meshes where each
    launch costs as much as its work.

    ``smooth_p > 0`` smooths the FINE-level transfer operators (hybrid
    smoothed aggregation): P_s = (I - w_p D^{-1}A) P_t with
    w_p = smooth_p / lmax(D^{-1}A) (Gershgorin bound; the classical SA
    weight is smooth_p = 4/3, Vanek/Mandel/Brezina 1996), and the
    restriction stays the exact transpose P_s^T — so the cycle remains a
    fixed SPD operator and plain CG stays valid.  The coarse hierarchy is
    still Galerkin-assembled from the TENTATIVE (piecewise-constant) P —
    the true SA Galerkin product P_s^T A P_s has distance-2 sparsity and
    would need an on-device sparse triple product per Newton iteration;
    the hybrid keeps the assembly path unchanged and buys the better
    coarse SUBSPACE (range of P_s spans smoothed characteristic vectors)
    at +2 fine matvecs per apply.  Deeper-level transfers stay tentative:
    their level operators already mismatch P_s, and per-level smoothing
    multiplies kernel launches the way the W-cycle does (see caveat
    above).
    """
    from shakti_tpu.fem.ops import ein

    plan: MGPlan = mesh.mg
    halo = mesh.halo
    dtype = a_diag.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    levels, A_inv = assemble_levels(J_c, mesh, dirichlet, plan)
    agg = plan.agg
    w = jnp.asarray(omega, dtype)

    d0 = jnp.where(jnp.abs(a_diag) < tiny, 1.0, a_diag)
    inv_d0 = jnp.where(dirichlet, 0.0, w / d0)
    cheb = smoother == "cheb"
    sp = smooth_p > 0.0
    if cheb or sp:
        # Gershgorin bound for the fine level: lambda_max(D^-1 A) <=
        # 1 + max_i offabs_i / a_ii, offabs from element-block |.| sums
        # (one scatter per Newton operator build — off the Krylov path)
        from shakti_tpu.fem import ops
        free = (~dirichlet).astype(dtype)
        wc = free[mesh.cells]
        aJ = jnp.abs(J_c) * (wc[:, :, None] * wc[:, None, :])
        offabs_c = jnp.sum(aJ, axis=2) - jnp.diagonal(aJ, axis1=1, axis2=2)
        offabs = ops.scatter_add_cells(mesh, offabs_c)
        if halo is not None:
            offabs = halo.accumulate(offabs)
        ratio = jnp.where(dirichlet | (a_diag <= tiny), 1.0,
                          1.0 + offabs / d0)
        lmax0 = jnp.max(ratio)
        if halo is not None:
            lmax0 = jax.lax.pmax(lmax0, halo.axis)
    if cheb:
        smooth0 = _make_cheb(matvec, jnp.where(dirichlet, 0.0, 1.0 / d0),
                             lmax0, cheb_deg, cheb_frac, dtype)
    if halo is not None:
        own = halo.owned_mask

    m1 = plan.cols[0].shape[0] if levels else plan.m_c
    n = a_diag.shape[0]

    if halo is None:
        # single device: aggregates are contiguous index ranges — restrict/
        # prolong are a reshape-sum and a repeat, no gather/scatter
        padf = m1 * agg - n

        def restrict_fine(r):
            return jnp.pad(r, (0, padf)).reshape(m1, agg).sum(axis=1)

        def prolong_fine(xc):
            return jnp.repeat(xc, agg)[:n]
    else:
        def restrict_fine(r):
            rc = jax.ops.segment_sum(r * own, plan.agg_fine,
                                     num_segments=m1)
            return jax.lax.psum(rc, halo.axis)

        def prolong_fine(xc):
            # replicated xc + locally-known aggregate ids: consistent on
            # ghosts by construction, no halo push needed
            return xc[plan.agg_fine]

    if sp:
        # hybrid-SA fine transfers: P_s = (I - w_p D^{-1}A) P_t and its
        # exact transpose (see docstring); w_p from the Gershgorin bound
        w_p = jnp.asarray(smooth_p, dtype) / lmax0
        inv_dp = jnp.where(dirichlet, 0.0, 1.0 / d0)

        def restrict_t(r):              # P_s^T r = P_t^T (I - w_p A D^{-1}) r
            rm = r - w_p * matvec(inv_dp * r)
            return restrict_fine(jnp.where(dirichlet, 0.0, rm))

        def prolong_t(xc):              # P_s xc, zero on Dirichlet rows
            p = jnp.where(dirichlet, 0.0, prolong_fine(xc))
            return p - w_p * (inv_dp * matvec(p))
    else:
        restrict_t = restrict_fine

        def prolong_t(xc):
            return jnp.where(dirichlet, 0.0, prolong_fine(xc))

    def coarse_solve(r):
        return ein("ij,j->i", A_inv, r)

    gamma = 2 if cycle == "w" else 1

    def level_mv(l):
        V, _ = levels[l]
        return lambda x: jnp.sum(V * x[plan.cols[l]], axis=1)

    def solve_level(l, r):
        """gamma-cycle solve at ELL level l (dense coarse at l == len)."""
        if l == len(levels):
            return coarse_solve(r)
        x = level_cycle(l, r)
        if gamma == 2:
            # second stationary correction: B_W = 2B - BAB (see docstring)
            x = x + level_cycle(l, r - level_mv(l)(x))
        return x

    def level_cycle(l, r):
        """V-cycle on intermediate ELL level l (replicated, all small)."""
        V, d = levels[l]
        m, K = plan.cols[l].shape
        d_safe = jnp.where(jnp.abs(d) < tiny, 1.0, d)
        mv = level_mv(l)
        m_next = plan.m_c if l == len(levels) - 1 else plan.cols[l + 1].shape[0]
        pad = m_next * agg - m

        def down(rr):
            rc = jnp.pad(rr, (0, pad)).reshape(m_next, agg).sum(axis=1)
            xc = solve_level(l + 1, rc)
            return jnp.repeat(xc, agg)[:m]

        if cheb:
            # exact Gershgorin from the explicit level values (rowabs
            # includes the diagonal; pad slots carry zero values)
            rowabs = jnp.sum(jnp.abs(V), axis=1)
            lmax_l = jnp.max(jnp.where(d > tiny, rowabs / d_safe, 1.0))
            sm = _make_cheb(mv, jnp.where(jnp.abs(d) < tiny, 0.0, 1.0 / d_safe),
                            lmax_l, cheb_deg, cheb_frac, dtype)
            x = sm(None, r, True)
            x = x + down(r - mv(x))
            return sm(x, r, False)
        inv_d = w / d_safe
        x = inv_d * r
        x = x + down(r - mv(x))
        return x + inv_d * (r - mv(x))

    def apply(r):
        r0 = jnp.where(dirichlet, 0.0, r)
        x = smooth0(None, r0, True) if cheb else inv_d0 * r0
        rr = r0 - matvec(x)
        rc = restrict_t(rr)
        xc = solve_level(0, rc)
        x = x + prolong_t(xc)
        x = (smooth0(x, r0, False) if cheb
             else x + inv_d0 * (r0 - matvec(x)))
        return jnp.where(dirichlet, r, x)

    return apply
