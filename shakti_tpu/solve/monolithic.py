r"""Monolithic coupled steady-state Newton: solve for (N, b) SIMULTANEOUSLY.

Why this exists
---------------
The staggered pseudo-transient driver (solve/steady.py) alternates an
implicit N-solve with a gap update.  In channelized regimes (SHMIP A3-A6)
the staggered coupling carries a period-2 instability whose stability
boundary pins the pseudo-timestep near the physical channelization
timescale: the coupling cap lands at dt ~ 1e3 s while the slowest physical
mode relaxes over years, so the march plateaus at 0.4-3.5 /yr drift and
can NEVER certify (measured; the cycle certificate confirms the plateau is
a slow TRANSIENT — centroid rate == drift rate, amplitude ~1e-4 — not a
limit cycle).  The instability is an artifact of the splitting, not of
the physics: solving the steady system monolithically removes it.

The system being solved is the TRANSIENT STEP'S OWN FIXED POINT
(_exact_residual): the weak-form N-row assembled by the same
physics/residual pipeline the transient Newton uses, with pre built from
the live (N, b) and the transient's exact q/melt data flow — nodal
grad h (cell-average), nodal q with the lagged Re self-consistent (at a
fixed point lagged == current, which closes pointwise at each node
through the stable quadratic root

    |q| (1 + (omega/nu) |q|) = k |grad h|   =>
    |q| = 2 s / (1 + sqrt(1 + 4 (omega/nu) s)),   s = k(b) |grad h_n|

), nodal melt, and the NODAL gap row (the transient's b update frozen).
Exactness here is load-bearing: a first cut solved a cell-consistent
Galerkin system with quad-point-resolved drag instead — it converged to
ITS OWN steady state, but the transient marched 18% away in N within 10
pseudo-hours (the nodal-staggered drag is a materially different model
where |q| is large; measured slab-margin T ratio up to 3.1x).

Unknowns are (N, log b): Newton in log b with an additive per-iteration
decade clamp walks the multi-decade gap landscape that additive-b Newton
cannot (validated independently on the FV column twin,
oracle/shmip_fv2d.steady_column_newton).  The Jacobian is exact and
SPARSITY-COMPRESSED: the residual couples 2-hop node neighbours through
the nodal averages, so a greedy coloring of the 4-hop conflict graph
(~26 colors on the SHMIP mesh) lets 2K tangent passes of jax.linearize
assemble the full dense matrix (bit-identical to jacfwd, measured 42x
faster: 0.08 s vs 3.4 s per iteration at n = 793), which a dense LU
solves exactly.  Globalization: Armijo on the trial point's own free set
down a half-decade alpha ladder, plus pseudo-transient damping (below).

Gap bounds are handled as an ACTIVE SET, semismooth style: a node at
b_min with R_b < 0 (closure exceeds melt opening: the floor binds) or at
b_cap with R_b > 0 has its b-row frozen to the bound — the row drops out
of the residual norm and acts as identity in the operator, and may
re-activate on a later iteration.

Globalization for channelized plateaus: PSEUDO-TRANSIENT damping.  Where
pure Newton's merit turns V-shaped (only tiny step fractions descend —
the coupled direction rebalances b across decades), a rejected pure
iteration drops into PTC mode: the b-row gains a backward-Euler damping
term -(b - b_ref) M / dtau, the damped system is Newton-iterated until
its residual has dropped 20x, then b_ref advances and dtau grows 10x.
Because the b-N coupling is INSIDE each damped solve, dtau is not bound
by the staggered instability: measured on SHMIP A3, dtau grows to
4.8e9 s (the staggered cap: 1.5e3 s) and the 0.39/yr plateau converges
to a certified 3e-4/yr equilibrium in ~3000 iterations.

The Warburton melt-regularization term m_diff (a divergence of lagged
fields in the reference, solvers.py:154-165) is frozen per polish call
and refreshed by the outer driver (:func:`steady_polish`) from the
current iterate — its fixed point is the self-consistent term.

Certification: the converged R_b row IS the pointwise steady defect
db/dt = m/rho_i - C; dividing by the lumped node mass gives db/dt in m/s
and hence a drift rate per year directly comparable to the PTC
certificate tol — but measured from the EQUATIONS, not from a finite
pseudo-step.  The N-row defect is reported as a relative residual
reduction.  tests/test_monolithic.py also marches the reference-exact
transient from the polished state (the independent "has it stopped
moving" oracle, same contract as tests/test_steady.py).

Single-device path only (suite-S scale); the distributed steady runner
keeps the PTC + cycle-certificate route.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from shakti_tpu.fem import ops
from shakti_tpu.fem.p1 import quadrature
from shakti_tpu.params import PhysicalParams
from shakti_tpu.physics import constitutive as law
from shakti_tpu.solve.krylov import bicgstab

YEAR = 3.1536e7


def _frozen_fields(mesh, static, state, params, quad_degree, dtype):
    """Per-polish frozen data: static forcing at quad points + the
    Warburton m_diff evaluated from the entry state (lagged, like the
    reference; refreshed between polish calls by steady_polish)."""
    phi_np, wq_np = quadrature(quad_degree)
    phi = jnp.asarray(phi_np, dtype=dtype)
    wq = jnp.asarray(wq_np, dtype=dtype)
    at_q = lambda f: ops.interpolate_at_quad(phi, ops.gather_cells(mesh, f))

    stacked = jnp.stack([state.b, state.melt], axis=1)        # (n, 2)
    sc = ops.gather_cells(mesh, stacked)                      # (c, 3, 2)
    s_q = ops.interpolate_at_quad(phi, sc)                    # (c, nq, 2)
    grads_sc = jnp.sum(
        (sc - jnp.mean(sc, axis=1, keepdims=True))[:, :, :, None]
        * mesh.grads[:, :, None, :], axis=1)                  # (c, 2, 2)
    mdiff_q = law.melt_regularization(
        s_q[..., 0], s_q[..., 1], grads_sc[:, 0][:, None, :],
        grads_sc[:, 1][:, None, :])

    # the exact transient-fixed-point residual additionally needs the
    # NODAL lagged Warburton term (the transient's mdiff_old_n,
    # solve/timestep.py step 2-3) and the static quad fields for
    # res.precompute_step
    from shakti_tpu.physics import residual as _res
    mdiff_old_n = ops.cellnodal_to_node_avg(
        mesh, law.melt_regularization(
            ops.gather_cells(mesh, state.b),
            ops.gather_cells(mesh, state.melt),
            grads_sc[:, 0][:, None, :], grads_sc[:, 1][:, None, :]))
    return {
        "phi": phi, "wq": wq, "gb0": static.gb0,
        "G_q": at_q(static.G), "inputs_q": at_q(static.inputs),
        "mdiff_q": mdiff_q,
        "mdiff_old_n": mdiff_old_n,
        "melt_entry": state.melt,
        "quad_degree": quad_degree,
        "sq": _res.static_quad_fields(mesh, static, quad_degree, dtype),
    }


def _cell_physics(N_c, b_c, fr, mesh, params: PhysicalParams):
    """Live per-cell physics from corner values: everything the two
    residual rows share.  Returns (q_q, m_q, C_q, N_q, b_q, grad_h)."""
    p = params
    N_dev = N_c - jnp.mean(N_c, axis=1, keepdims=True)
    grad_N = jnp.sum(N_dev[:, :, None] * mesh.grads, axis=1)   # (c, 2)
    grad_h = fr["gb0"] - grad_N / (p.rho_w * p.g)              # (c, 2)
    gh2 = jnp.sum(grad_h * grad_h, axis=-1)
    livg = gh2 > 0
    gh_mag = jnp.where(livg, jnp.sqrt(jnp.where(livg, gh2, 1.0)), 0.0)

    phi = fr["phi"]
    N_q = jnp.sum(phi[None, :, :] * N_c[:, None, :], axis=2)   # (c, nq)
    b_q = jnp.sum(phi[None, :, :] * b_c[:, None, :], axis=2)

    k_q = (jnp.abs(b_q) ** 3) * p.g / (12.0 * p.nu)            # (c, nq)
    a = p.omega / p.nu
    s_q = k_q * gh_mag[:, None]
    qmag = 2.0 * s_q / (1.0 + jnp.sqrt(1.0 + 4.0 * a * s_q))   # resolved |q|
    q_q = -(k_q / (1.0 + a * qmag))[:, :, None] * grad_h[:, None, :]

    diss_q = p.rho_w * p.g * qmag * gh_mag[:, None]            # -rho_w g q.grad h
    m_q = (fr["G_q"] + diss_q) / p.Lh + fr["mdiff_q"]
    C_q = law.closure(b_q, N_q, p)
    return q_q, m_q, C_q, N_q, b_q, grad_h


def _nodal_fields(u, fr, mesh, static, params: PhysicalParams):
    """The transient step's own q/melt data flow, at its fixed point
    (solve/timestep.py step 2-3, reference solvers.py:186-189):

      grad_h_n = node_avg(cellwise grad h(N))
      q_i      = -|b_i|^3 g/(12 nu (1 + omega Re_i)) grad_h_n_i,
                 Re_i = |q_i|/nu  SELF-CONSISTENT (the lagged Re equals
                 the current Re at a fixed point), which closes pointwise
                 at each NODE through the same stable quadratic root as
                 the cell form:  |q| = 2 s/(1 + sqrt(1 + 4 (omega/nu) s)),
                 s = k(b_i) |grad_h_n_i|
      melt_i   = (G_i - rho_w g q_i . grad_h_n_i)/Lh + mdiff_old_n_i

    with mdiff_old_n FROZEN from the entry state (the reference's lagged
    evaluation; refreshed by steady_polish's outer loop).  Returns
    (q (n,2), melt (n,), grad_h_n (n,2))."""
    p = params
    N, b = u[:, 0], _b_of(u, fr)
    N_c = ops.gather_cells(mesh, N)
    N_dev = N_c - jnp.mean(N_c, axis=1, keepdims=True)
    grad_N = jnp.sum(N_dev[:, :, None] * mesh.grads, axis=1)
    grad_h_c = fr["gb0"] - grad_N / (p.rho_w * p.g)
    grad_h_n = ops.cellnodal_to_node_avg(
        mesh, jnp.broadcast_to(grad_h_c[:, None, :],
                               grad_h_c.shape[:1] + (3, 2)))
    gh2 = jnp.sum(grad_h_n * grad_h_n, axis=-1)
    livg = gh2 > 0
    gh_mag = jnp.where(livg, jnp.sqrt(jnp.where(livg, gh2, 1.0)), 0.0)
    k = (jnp.abs(b) ** 3) * p.g / (12.0 * p.nu)
    a = p.omega / p.nu
    s = k * gh_mag
    qmag = 2.0 * s / (1.0 + jnp.sqrt(1.0 + 4.0 * a * s))
    q = -(k / (1.0 + a * qmag))[:, None] * grad_h_n
    melt = (static.G + p.rho_w * p.g * qmag * gh_mag) / p.Lh \
        + fr["mdiff_old_n"]
    return q, melt, grad_h_n


def _exact_residual(u, fr, mesh, static, params: PhysicalParams):
    """The transient step's OWN fixed-point defect — the residual whose
    zero is bit-meaningfully stationary under solve/timestep.step:

      R_N = the transient weak-form residual (physics/residual.py) with
            pre built from the LIVE (N, b, q(u), melt(u)) — exactly what
            a converged transient Newton solve leaves at zero when the
            state no longer moves (the storage term vanishes identically
            at N_n = N);
      R_b = node_mass * (melt_i / rho_i - A b_i N_i |N_i|^2) — the
            transient's NODAL gap update frozen (solvers.py:162,192).

    Design history: the first cut assembled a cell-consistent Galerkin
    system with quad-point-resolved drag instead; it converged to ITS
    OWN steady state, but the transient marched 18% away in N within 10
    hours — the lagged-from-nodal-q staggering is a materially different
    drag model where |q| is large (measured, slab margin: T ratio up to
    3.1x).  Certifying the TRANSIENT's equilibrium requires mirroring
    its exact data flow."""
    from shakti_tpu.physics import residual as _res
    p = params
    N, b = u[:, 0], _b_of(u, fr)
    q, melt, _ = _nodal_fields(u, fr, mesh, static, params)
    # dt only enters the storage term, which is identically zero at
    # N_n = N; melt_n enters only the (frozen-by-entry) mdiff
    pre = _res.precompute_step(mesh, N, b, q, fr["melt_entry"], static,
                               jnp.asarray(1.0, N.dtype), p,
                               quad_degree=fr["quad_degree"], sq=fr["sq"])
    R_N = _res.assemble_residual(N, pre, mesh, p)
    lumped = mesh.node_area / 3.0
    R_b = lumped * (melt / p.rho_i - law.closure(b, N, p))
    return jnp.stack([R_N, R_b], axis=-1)


def _b_of(u_c, fr):
    """Gap corner values from the unknown's second slot: plain b, or
    exp(w) under the log-b parametrization (fr["log_b"]) — the FV column
    twin (oracle/shmip_fv2d.steady_column_newton) showed Newton in log b
    with an additive decade clamp walks the multi-decade gap landscape
    that additive-b Newton cannot."""
    w = u_c[..., 1]
    return jnp.exp(w) if fr.get("log_b") else w


def _corner_residual(u_c, fr, mesh, params: PhysicalParams):
    """Coupled element residual: u_c (c, 3, 2) with [..., 0] = N corner
    values, [..., 1] = b (or log b) corner values -> (c, 3, 2)."""
    p = params
    N_c, b_c = u_c[..., 0], _b_of(u_c, fr)
    q_q, m_q, C_q, N_q, b_q, grad_h = _cell_physics(N_c, b_c, fr, mesh, params)

    wq, phi = fr["wq"], fr["phi"]
    c_m = 1.0 / p.rho_i - 1.0 / p.rho_w
    srcN_q = c_m * m_q - C_q - fr["inputs_q"]
    rb_q = m_q / p.rho_i - C_q                                  # db/dt [m/s]

    w_cell = mesh.area * mesh.cell_valid
    term_flux = -jnp.sum(
        wq[None, :, None, None] * q_q[:, :, None, :]
        * mesh.grads[:, None, :, :], axis=(1, 3))               # (c, 3)
    wphi = (wq[:, None] * phi)[None, :, :]                      # (1, nq, 3)
    term_srcN = jnp.sum(wphi * srcN_q[:, :, None], axis=1)
    term_b = jnp.sum(wphi * rb_q[:, :, None], axis=1)
    R_N = w_cell[:, None] * (term_flux + term_srcN)
    R_b = w_cell[:, None] * term_b
    return jnp.stack([R_N, R_b], axis=-1)                       # (c, 3, 2)


def _element_jacobian6(u, fr, mesh, params):
    """(c, 3, 2, 3, 2) element blocks dR_ci,f / du_cj,g via six tangent
    passes of jax.linearize (the coupled analogue of
    physics/residual.element_jacobian)."""
    u_c = ops.gather_cells(mesh, u)                             # (c, 3, 2)
    f = lambda x: _corner_residual(x, fr, mesh, params)
    _, f_lin = jax.linearize(f, u_c)
    cols = [f_lin(jnp.zeros_like(u_c).at[:, j, g].set(1.0))
            for j in range(3) for g in range(2)]
    J = jnp.stack(cols, axis=-1)                                # (c,3,2,6)
    return J.reshape(J.shape[:3] + (3, 2))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _Masks:
    dirichlet: Any     # (n,) bool: N pinned
    active: Any        # (n,) bool: node participates at all (area > 0)


def _assemble_residual(u, fr, mesh, params, masks, fix_b):
    u_c = ops.gather_cells(mesh, u)
    R = ops.scatter_add_cells(mesh, _corner_residual(u_c, fr, mesh, params))
    RN = jnp.where(masks.dirichlet | ~masks.active, 0.0, R[:, 0])
    Rb = jnp.where(fix_b | ~masks.active, 0.0, R[:, 1])
    return jnp.stack([RN, Rb], axis=-1)


def _make_matvec(J6, mesh, masks, fix_b, rb_scale, extra_diag_b=None):
    """Matrix-free action of the constrained, row-scaled Jacobian.
    Constrained rows (Dirichlet N, bound-fixed or inactive b) act as
    identity with their inputs zeroed first — the symmetric-elimination
    convention of physics/residual.make_matvec.  ``extra_diag_b``: an
    (n,) addition to the (b, b) diagonal (the pseudo-transient damping
    term's Jacobian; applied with the same rb_scale as the row)."""
    freeN = ~(masks.dirichlet | ~masks.active)
    freeb = ~(fix_b | ~masks.active)

    def matvec(x):
        xN = jnp.where(freeN, x[:, 0], 0.0)
        xb = jnp.where(freeb, x[:, 1], 0.0)
        xc = ops.gather_cells(mesh, jnp.stack([xN, xb], axis=-1))
        yc = jnp.sum(J6 * xc[:, None, None, :, :], axis=(3, 4))
        y = ops.scatter_add_cells(mesh, yc)
        yb_raw = y[:, 1]
        if extra_diag_b is not None:
            yb_raw = yb_raw + extra_diag_b * xb
        yN = jnp.where(freeN, y[:, 0], x[:, 0])
        yb = jnp.where(freeb, yb_raw * rb_scale, x[:, 1])
        return jnp.stack([yN, yb], axis=-1)

    return matvec


def _block_jacobi_inv(J6, mesh, masks, fix_b, rb_scale, dtype,
                      extra_diag_b=None):
    """Nodal 2x2 block-Jacobi preconditioner from the assembled diagonal
    blocks (constrained rows/cols replaced by identity)."""
    diag_c = jnp.stack([J6[:, i, :, i, :] for i in range(3)], axis=1)
    D = ops.scatter_add_cells(mesh, diag_c)                     # (n, 2, 2)
    if extra_diag_b is not None:
        D = D.at[:, 1, 1].add(extra_diag_b)
    D = D.at[:, 1, :].multiply(rb_scale)
    freeN = ~(masks.dirichlet | ~masks.active)
    freeb = ~(fix_b | ~masks.active)
    D = jnp.where(freeN[:, None, None],
                  D, jnp.asarray([[1.0, 0.0], [0.0, 0.0]], dtype)
                  + D * jnp.asarray([[0.0, 0.0], [0.0, 1.0]], dtype))
    D = jnp.where(freeb[:, None, None],
                  D, D * jnp.asarray([[1.0, 0.0], [0.0, 0.0]], dtype)
                  + jnp.asarray([[0.0, 0.0], [0.0, 1.0]], dtype))
    det = D[:, 0, 0] * D[:, 1, 1] - D[:, 0, 1] * D[:, 1, 0]
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    safe = jnp.where(jnp.abs(det) > tiny, det, 1.0)
    inv = jnp.stack([
        jnp.stack([D[:, 1, 1], -D[:, 0, 1]], axis=-1),
        jnp.stack([-D[:, 1, 0], D[:, 0, 0]], axis=-1)], axis=1) / safe[:, None, None]

    def apply_pc(r):
        # broadcast-sum, not einsum (fem/ops note: each tiny einsum is its
        # own dot kernel with transpose/copy traffic)
        return jnp.sum(inv * r[:, None, :], axis=2)

    return apply_pc


def _coloring_plan(mesh):
    """Host-side sparse-Jacobian coloring for the exact fixed-point
    residual.  Its sparsity is the mesh's 2-HOP node graph (row i touches
    u_j through the nodal q/melt averages of i's cells, whose corner
    values reach j's cells' gradients); two columns can share a tangent
    seed iff their row supports are disjoint, i.e. they are not 4-hop
    neighbours.  Greedy-colors the 4-hop conflict graph (measured ~40-60
    colors on the SHMIP mesh vs 793 nodes: jacfwd with one tangent per
    (column, field) costs 3.4 s/Newton-iteration at n=793; compressed,
    ~0.2 s).  Returns (seeds (2K, n, 2), pair_i, pair_j, color_of) as
    numpy arrays — computed once at trace time from the concrete mesh.
    """
    import numpy as _np
    import scipy.sparse as _sp

    cells = _np.asarray(mesh.cells)
    valid = _np.asarray(mesh.cell_valid) > 0
    cells = cells[valid]
    n = int(mesh.nodes.shape[0])
    nc = cells.shape[0]
    B = _sp.csr_matrix(
        (_np.ones(3 * nc), (_np.repeat(_np.arange(nc), 3), cells.ravel())),
        shape=(nc, n))
    A1 = ((B.T @ B) > 0)                      # 1-hop (incl self)
    A2 = ((A1 @ A1) > 0).tocsr()              # 2-hop: the Jacobian pattern
    C = ((A2 @ A2.T) > 0).tocsr()             # 4-hop: the conflict graph

    color = _np.full(n, -1, dtype=_np.int64)
    for i in range(n):
        nbr_colors = set(color[C.indices[C.indptr[i]:C.indptr[i + 1]]])
        c = 0
        while c in nbr_colors:
            c += 1
        color[i] = c
    K = int(color.max()) + 1

    seeds = _np.zeros((2 * K, n, 2))
    for g in range(2):
        seeds[color * 2 + g, _np.arange(n), g] = 1.0

    coo = A2.tocoo()
    return seeds, coo.row.astype(_np.int32), coo.col.astype(_np.int32), \
        color.astype(_np.int32), K


def _colored_jacobian(raw_residual, u, plan, dtype):
    """Assemble the dense (n, 2, n, 2) Jacobian from 2K compressed
    tangent passes (see _coloring_plan).  Exact: every column class has
    disjoint row supports by construction."""
    seeds_np, pi, pj, color, K = plan
    seeds = jnp.asarray(seeds_np, dtype)
    _, lin = jax.linearize(raw_residual, u)
    T = jax.vmap(lin)(seeds)                     # (2K, n, 2)
    Tg = T.reshape(K, 2, T.shape[1], 2)          # [color, g, i, f]
    # block[p, f, g] = J[i_p, f, j_p, g] = Tg[color(j_p), g, i_p, f]
    blk = Tg[color[pj], :, pi, :]                # (p, g, f)
    blk = jnp.swapaxes(blk, 1, 2)                # (p, f, g)
    n = u.shape[0]
    A = jnp.zeros((n, 2, n, 2), dtype)
    return A.at[pi, :, pj, :].set(blk)


def _dense_solve_A(A, masks, fix_b, rb_scale, R, dtype,
                   extra_diag_b=None):
    """Exact Newton step by dense LU from an explicitly assembled
    (n, 2, n, 2) Jacobian (colored jvp probing of the exact fixed-point
    residual — the nodal q/melt averaging couples 2-hop neighbours, so
    element-block assembly of a cell-local form does not apply).  Dense
    LU is the default at suite scale: the channelized N-block's
    transmissivity spans ~8 decades and block-Jacobi BiCGStab measured
    2000+ iterations without convergence there — an exact inner solve is
    what lets Newton be Newton.  Constrained rows/cols are eliminated to
    identity.  O((2n)^2) memory: ~20 MB at n = 793 (SHMIP), ~134 MB at
    the dense_max_nodes=2048 cutoff."""
    n = R.shape[0]
    if extra_diag_b is not None:
        ar = jnp.arange(n)
        A = A.at[ar, 1, ar, 1].add(extra_diag_b)
    A = A.at[:, 1, :, :].multiply(rb_scale)
    freeN = ~(masks.dirichlet | ~masks.active)
    freeb = ~(fix_b | ~masks.active)
    free = jnp.stack([freeN, freeb], axis=-1).reshape(-1)
    M = A.reshape(2 * n, 2 * n)
    M = jnp.where(free[:, None] & free[None, :], M, 0.0)
    M = M + jnp.diag(jnp.where(free, 0.0, 1.0).astype(dtype))
    du = jnp.linalg.solve(M, -R.reshape(-1))
    return du.reshape(n, 2), {"iters": jnp.asarray(1, jnp.int32)}


def polish(mesh, static, params: PhysicalParams, state, *,
           quad_degree: int = 4, tol: float = 1e-3, t_ref: float = YEAR,
           max_newton: int = 40, krylov_rtol: float = 1e-8,
           krylov_maxiter: int = 2000, max_b_factor: float = 10.0,
           armijo_cuts: int = 8, n_tol: float = 1e-8,
           pin_b_dirichlet: bool = True, linear: str = "auto",
           dense_max_nodes: int = 2048, log_b: bool = True,
           dtau0: float | None = None, dtau_seed: float | None = 3e5,
           dtau_min: float = 1.0):
    """One monolithic Newton solve for the coupled steady state, from
    ``state`` (typically a PTC plateau).  m_diff is frozen from ``state``.

    Convergence: the gap-row drift rate  ||db/dt|| * t_ref / ||b||  (mass-
    lumped, free rows only) must fall below ``tol``, and the N-row
    residual must fall below ``n_tol`` of its natural scale (the N
    equation is quasi-static: its defect has no drift interpretation, so
    it gets a plain relative-residual certificate against the assembled
    |term| magnitudes).  Returns (state, info) with info all on device:
    converged, rate_b (drift/yr), resN_rel, newton, krylov_total,
    n_fixed (bound-active b rows), backtracks.

    ``pin_b_dirichlet`` (default True) freezes the gap at the N-pinned
    outflow margin to its entry value: with N_bdry ~ 9 kPa the margin gap
    equilibrium b = m/(rho_i A N^3) sits ~5 decades above any transient
    value (closure timescale ~19k yr — the same reason the PTC drift
    certificate excludes those nodes, solve/steady.py), an unreachable
    boundary layer one mesh cell cannot resolve; pinning keeps the
    certificate semantics identical to the PTC route's.

    ``linear``: "direct" (dense LU of the assembled coupled Jacobian),
    "bicgstab" (matrix-free + nodal 2x2 block-Jacobi), or "auto"
    (direct when n_nodes <= dense_max_nodes).
    """
    p = params
    dtype = state.N.dtype
    f = lambda v: jnp.asarray(v, dtype)
    fr = _frozen_fields(mesh, static, state, params, quad_degree, dtype)
    fr["log_b"] = bool(log_b)

    masks = _Masks(dirichlet=static.dirichlet,
                   active=mesh.node_area > 0)
    b_min = static.b_min
    b_cap = static.b_max if static.b_max is not None else f(jnp.inf)
    lumped = jnp.maximum(mesh.node_area / 3.0,
                         jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    if linear == "auto":
        linear = ("direct" if mesh.nodes.shape[0] <= dense_max_nodes
                  else "bicgstab")

    N0 = jnp.where(masks.dirichlet, static.N_bdry, state.N)
    b0 = jnp.clip(state.b, b_min, b_cap)
    # bounds and unknowns in the marching parametrization (w = log b
    # by default; see _b_of)
    tr = (jnp.log if log_b else (lambda x: x))
    itr = (jnp.exp if log_b else (lambda x: x))
    u_lo, u_hi = tr(b_min), tr(b_cap)
    u0 = jnp.stack([N0, tr(b0)], axis=-1)

    def fix_mask(u, R_raw):
        # semismooth active set: floor binds where b at bound and the
        # equation pushes it further out; margin b optionally pinned
        eps_lo = jnp.abs(u_lo) * 1e-12 + 1e-300
        at_lo = u[:, 1] <= u_lo + eps_lo
        at_hi = u[:, 1] >= b_cap * (1.0 - 1e-12) if not log_b \
            else u[:, 1] >= u_hi - 1e-12
        fix = (at_lo & (R_raw[:, 1] < 0)) | (at_hi & (R_raw[:, 1] > 0))
        if pin_b_dirichlet:
            fix = fix | masks.dirichlet
        return fix

    def raw_residual(u):
        return _exact_residual(u, fr, mesh, static, params)

    color_plan = _coloring_plan(mesh) if linear == "direct" else None

    R0_raw = raw_residual(u0)
    fix0 = fix_mask(u0, R0_raw)
    nrm = lambda x: jnp.linalg.norm(x)
    tinyv = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    # row scales from NATURAL term magnitudes (assembled |term| norms),
    # NOT the entry residual ratio: entering from a converged PTC state
    # (or a converged continuation neighbor) the entry b-residual is
    # ~machine-zero and a residual-ratio scale of ~1e12 makes the merit
    # reject every Newton step (measured on the FV column twin); and a
    # residual-relative N certificate is unreachable when polishing an
    # already-steady state (entry residual ~ roundoff)
    def _nat_scales(u):
        u_c = ops.gather_cells(mesh, u)
        N_c, b_c = u_c[..., 0], _b_of(u_c, fr)
        q_q, m_q, C_q, _, _, _ = _cell_physics(N_c, b_c, fr, mesh, params)
        wq, phi = fr["wq"], fr["phi"]
        c_m = 1.0 / p.rho_i - 1.0 / p.rho_w
        absrcN = jnp.abs(c_m * m_q) + jnp.abs(C_q) + jnp.abs(fr["inputs_q"])
        absrcb = jnp.abs(m_q) / p.rho_i + jnp.abs(C_q)
        w_cell = mesh.area * mesh.cell_valid
        tf = jnp.sum(jnp.abs(
            wq[None, :, None, None] * q_q[:, :, None, :]
            * mesh.grads[:, None, :, :]), axis=(1, 3))
        wphi = (wq[:, None] * phi)[None]
        ts = jnp.sum(wphi * absrcN[:, :, None], axis=1)
        tb = jnp.sum(wphi * absrcb[:, :, None], axis=1)
        S = ops.scatter_add_cells(
            mesh, jnp.stack([w_cell[:, None] * (tf + ts),
                             w_cell[:, None] * tb], axis=-1))
        sN = nrm(jnp.where(masks.dirichlet | ~masks.active, 0.0, S[:, 0]))
        sb = nrm(jnp.where(fix0 | ~masks.active, 0.0, S[:, 1]))
        return jnp.maximum(sN, tinyv), jnp.maximum(sb, tinyv)

    n_scale0, b_scale0 = _nat_scales(u0)
    rb_scale = n_scale0 / b_scale0

    def rates(u, R_raw, fix_b):
        """(rate_b drift/yr, resN_rel): the certificate quantities."""
        dbdt = jnp.where(fix_b | ~masks.active, 0.0, R_raw[:, 1]) / lumped
        bn = jnp.maximum(nrm(jnp.where(masks.active, itr(u[:, 1]), 0.0)),
                         tinyv)
        rate_b = nrm(dbdt) * f(t_ref) / bn
        rN = nrm(jnp.where(masks.dirichlet | ~masks.active, 0.0,
                           R_raw[:, 0]))
        return rate_b, rN / n_scale0

    def damped_parts(u, fix_b, b_ref, inv_dtau):
        """Row-scaled damped residual: the b row carries the backward-
        Euler pseudo-transient term -(b - b_ref) M / dtau (inv_dtau = 0
        recovers pure Newton).  The damping makes each Newton solve an
        IMPLICIT coupled pseudo-step — unlike the staggered PTC, the
        b-N coupling is inside the solve, so dtau is not bound by the
        staggered instability and SER can grow it to infinity."""
        R_raw = raw_residual(u)
        Rb_d = R_raw[:, 1] - (itr(u[:, 1]) - b_ref) * lumped * inv_dtau
        RN = jnp.where(masks.dirichlet | ~masks.active, 0.0, R_raw[:, 0])
        Rb = jnp.where(fix_b | ~masks.active, 0.0, Rb_d) * rb_scale
        return jnp.stack([RN, Rb], axis=-1), R_raw

    def scaled_norm(u, b_ref, inv_dtau):
        """Merit: the row-scaled DAMPED residual over the TRIAL POINT'S
        OWN free set.  Recomputing the active set here is what lets the
        line search credit steps that land nodes on the gap floor — with
        the entry set frozen, a floor-bound node's unsatisfiable negative
        defect stays in the norm and the projected Newton direction
        stops descending (measured stall on SHMIP A1: the margin-adjacent
        column wants b below b_min; complementarity IS satisfaction)."""
        R_raw = raw_residual(u)
        fix_b = fix_mask(u, R_raw)
        Rb_d = R_raw[:, 1] - (itr(u[:, 1]) - b_ref) * lumped * inv_dtau
        RN = jnp.where(masks.dirichlet | ~masks.active, 0.0, R_raw[:, 0])
        Rb = jnp.where(fix_b | ~masks.active, 0.0, Rb_d) * rb_scale
        return jnp.sqrt(nrm(RN) ** 2 + nrm(Rb) ** 2), R_raw

    inf = jnp.asarray(jnp.inf, dtype)

    def body(c):
        u = c["u"]
        inv_dtau = 1.0 / c["dtau"]
        R, R_raw = damped_parts(u, fix_mask(u, raw_residual(u)),
                                c["b_ref"], inv_dtau)
        fix_b = fix_mask(u, R_raw)

        # damping Jacobian: d/dw of -(b - b_ref) M / dtau
        dbdw = itr(u[:, 1]) if log_b else jnp.ones_like(u[:, 1])
        extra = -lumped * inv_dtau * dbdw
        if linear == "direct":
            A = _colored_jacobian(raw_residual, u, color_plan, dtype)
            du, kinfo = _dense_solve_A(A, masks, fix_b, rb_scale,
                                       R, dtype, extra_diag_b=extra)
        else:
            # large-mesh fallback: inexact Newton — the EXACT residual
            # with the cell-local approximate operator (the two differ by
            # the nodal-averaging smoothing of q/melt; spectrally close)
            J6 = _element_jacobian6(u, fr, mesh, params)
            mv = _make_matvec(J6, mesh, masks, fix_b, rb_scale,
                              extra_diag_b=extra)
            pc = _block_jacobi_inv(J6, mesh, masks, fix_b, rb_scale,
                                   dtype, extra_diag_b=extra)
            du, kinfo = bicgstab(mv, -R, minv=pc, rtol=krylov_rtol,
                                 maxiter=krylov_maxiter)

        # Armijo backtracking with the elementwise trust region on b
        # (additive Newton across decades of a b^3 coefficient is
        # meaningless; cap the per-iteration move at max_b_factor)
        norm_old, _ = scaled_norm(u, c["b_ref"], inv_dtau)

        def try_alpha(carry, alpha):
            best_u, best_norm, done = carry
            N_new = jnp.where(masks.dirichlet, static.N_bdry,
                              u[:, 0] + alpha * du[:, 0])
            b_new = u[:, 1] + alpha * du[:, 1]
            if log_b:
                lim = f(jnp.log(max_b_factor))
                b_new = jnp.clip(b_new, u[:, 1] - lim, u[:, 1] + lim)
            else:
                b_new = jnp.clip(b_new, u[:, 1] / f(max_b_factor),
                                 u[:, 1] * f(max_b_factor))
            b_new = jnp.clip(b_new, u_lo, u_hi)
            u_new = jnp.stack([N_new, b_new], axis=-1)
            norm_new, _ = scaled_norm(u_new, c["b_ref"], inv_dtau)
            ok = (norm_new < (1.0 - f(1e-4) * alpha) * norm_old) \
                & jnp.isfinite(norm_new) & ~done
            best_u = jnp.where(ok, u_new, best_u)
            best_norm = jnp.where(ok, norm_new, best_norm)
            return (best_u, best_norm, done | ok), ok

        # half-decade ladder down to ~10^-(cuts-1)/2: the coupled
        # direction's merit is V-shaped near strong b-N rebalancing —
        # only small fractions descend (measured: SHMIP A1 needed
        # alpha ~ 4e-3; a 0.5^k ladder of the same length bottoms out
        # at 8e-3 and stalls)
        alphas = f(10.0) ** (-jnp.arange(armijo_cuts, dtype=dtype) / 2.0)
        (u_new, norm_new, accepted), oks = jax.lax.scan(
            try_alpha, (u, norm_old, jnp.asarray(False)), alphas)

        R_new_raw = raw_residual(u_new)
        fix_new = fix_mask(u_new, R_new_raw)
        rate_b, resN = rates(u_new, R_new_raw, fix_new)
        conv = (rate_b < tol) & (resN < f(n_tol))

        # pseudo-transient step control: keep Newton-iterating the SAME
        # damped system (b_ref, dtau fixed) until its residual has
        # dropped 20x from the pseudo-step entry — only then advance
        # b_ref and grow dtau 10x (one-Newton-per-step SER measured
        # 165/200 iterations backtracking: growing dtau before the damped
        # system is solved just feeds the line search a system it can't
        # descend).  On line-search failure shrink dtau 5x, keep b_ref.
        # dtau = inf IS pure Newton; it only becomes finite through the
        # failure branch (seeded at dtau_seed).
        step_done = accepted & (norm_new < f(0.05) * c["step_norm0"])
        seed = inf if dtau_seed is None else f(dtau_seed)
        dtau_new = jnp.where(
            step_done, jnp.minimum(c["dtau"] * f(10.0), inf),
            jnp.where(accepted, c["dtau"],
                      jnp.where(jnp.isinf(c["dtau"]), seed,
                                jnp.maximum(c["dtau"] * f(0.2),
                                            f(dtau_min)))))
        b_ref_new = jnp.where(step_done, itr(u_new[:, 1]), c["b_ref"])
        # the damped system changed whenever dtau or b_ref moved: reset
        # the pseudo-step entry norm to the NEW system's norm at u_new
        norm_reset, _ = scaled_norm(u_new, b_ref_new, 1.0 / dtau_new)
        step_norm0_new = jnp.where(step_done | ~accepted, norm_reset,
                                   c["step_norm0"])
        stalled = ~accepted & (
            (jnp.isinf(c["dtau"]) & (seed == inf))
            | (~jnp.isinf(c["dtau"]) & (c["dtau"] <= f(dtau_min))))
        return {
            "u": u_new,
            "b_ref": b_ref_new,
            "dtau": dtau_new,
            "step_norm0": step_norm0_new,
            "t_pseudo": c["t_pseudo"]
                        + jnp.where(step_done & ~jnp.isinf(c["dtau"]),
                                    c["dtau"], f(0.0)),
            "steps_done": c["steps_done"] + step_done.astype(jnp.int32),
            "k": c["k"] + 1,
            "converged": conv & accepted,
            "stalled": stalled,
            "rate_b": rate_b, "resN": resN,
            "krylov_total": c["krylov_total"] + kinfo["iters"],
            "backtracks": c["backtracks"]
                          + jnp.sum(~oks[:1]).astype(jnp.int32),
            "n_fixed": jnp.sum(fix_new).astype(jnp.int32),
        }

    rate_b0, resN0 = rates(u0, R0_raw, fix0)
    dtau_init = inf if dtau0 is None else f(dtau0)
    norm00, _ = scaled_norm(u0, itr(u0[:, 1]), 1.0 / dtau_init)
    init = {"u": u0, "b_ref": itr(u0[:, 1]),
            "dtau": dtau_init,
            "step_norm0": norm00,
            "t_pseudo": f(0.0),
            "steps_done": jnp.asarray(0, jnp.int32),
            "k": jnp.asarray(0, jnp.int32),
            "converged": (rate_b0 < tol) & (resN0 < f(n_tol)),
            "stalled": jnp.asarray(False),
            "rate_b": rate_b0, "resN": resN0,
            "krylov_total": jnp.asarray(0, jnp.int32),
            "backtracks": jnp.asarray(0, jnp.int32),
            "n_fixed": jnp.sum(fix0).astype(jnp.int32)}
    out = jax.lax.while_loop(
        lambda c: ~c["converged"] & ~c["stalled"] & (c["k"] < max_newton),
        body, init)

    u = out["u"]
    # self-consistent nodal q and melt from the TRANSIENT's own update
    # rules at the fixed point (the exact residual's data flow)
    q_node, m_node, _ = _nodal_fields(u, fr, mesh, static, params)

    new_state = dataclasses.replace(
        state, N=u[:, 0], b=itr(u[:, 1]), q=q_node, melt=m_node,
        N_prev=(None if state.N_prev is None else u[:, 0]))
    info = {"converged": out["converged"], "rate_b": out["rate_b"],
            "resN_rel": out["resN"], "newton": out["k"],
            "dtau": out["dtau"], "t_pseudo": out["t_pseudo"],
            "steps_done": out["steps_done"],
            "krylov_total": out["krylov_total"],
            "backtracks": out["backtracks"], "n_fixed": out["n_fixed"],
            "stalled": out["stalled"]}
    return new_state, info


def steady_polish(mesh, static, params: PhysicalParams, state0, *,
                  tol: float = 1e-3, t_ref: float = YEAR,
                  refreshes: int = 3, max_newton: int = 400,
                  max_newton_total: int = 6000, jit: bool = True,
                  patience: int = 3, max_wall_s: float = float("inf"),
                  checkpoint: str | None = None,
                  **polish_kw):
    """Outer driver: repeat :func:`polish` in SEGMENTS of ``max_newton``
    iterations, refreshing the frozen Warburton m_diff (and the nodal
    melt it is built from) from the current iterate between segments.

    Segments do double duty.  (1) m_diff refresh: converged segments
    repeat until the refresh is a fixed point (up to ``refreshes``
    times).  (2) RESTART globalization for hard channelized solves: a
    segment boundary resets the pseudo-transient dtau (a long damped
    march can grind dtau onto its floor — measured on SHMIP A3: one
    continuous 3000-iteration run stalled at 2.9/yr while 400-iteration
    restarts kept the drift decaying geometrically) and re-freezes
    m_diff from the CURRENT state, which is also more physical than
    carrying the entry state's regularization across pseudo-years of
    implicit marching.  Unconverged segments keep restarting while the
    drift rate improves, within ``max_newton_total`` iterations.

    Host-level loop (a handful of device calls); each segment is one
    jitted program.  Returns (state, info) — info adds segment count and
    the final inter-segment relative state change.

    ``patience`` bounds consecutive non-improving segments (default 3).
    Wandering attractors need far more: on SHMIP A3 the defect decayed to
    0.017/yr by pseudo-year 25, then channel-rearrangement excursions
    recurred at 0.06-0.35/yr for 21 consecutive segments before the march
    exited the wandering phase and CONVERGED to a true fixed point at
    pseudo-year ~1920 (rate 2.9e-7/yr) — measured, 35-segment march on
    the 60x12 suite mesh.
    ``max_wall_s`` bounds the total host wall clock (segment granularity);
    the trajectory sampled so far still feeds the stationarity verdict.

    ``checkpoint``: path of an ``.npz`` written after EVERY segment with
    the complete host-loop state (iterate, dtau carry, counters, patience
    bookkeeping, the wander trajectory, and the wall budget spent) — a
    killed multi-hour march (SHMIP A4: 5,073 s single-shot) resumes at
    its last segment boundary and replays the remaining segments exactly
    as the uninterrupted run would have (the loop state round-trips
    through npz bit-for-bit).  The file is removed on successful return.
    """
    run = lambda st: polish(mesh, static, params, st, tol=tol,
                            t_ref=t_ref, max_newton=max_newton,
                            **polish_kw)
    # restart segments re-enter the pseudo-transient march at the dtau
    # the previous segment reached (a pure-Newton re-entry takes one
    # whiplash step from a mid-march state — measured on A3: the drift
    # jumped 0.18 -> 0.56/yr at a restart)
    kw2 = dict(polish_kw)
    kw2.pop("dtau0", None)
    run_cont = lambda st, d0: polish(mesh, static, params, st, tol=tol,
                                     t_ref=t_ref, max_newton=max_newton,
                                     dtau0=d0, **kw2)
    if jit:
        run = jax.jit(run)
        run_cont = jax.jit(run_cont)

    import os as _os
    import numpy as np
    import time as _time
    t_start = _time.time()
    state = state0
    newton = krylov = 0
    info = None
    dstate = float("inf")
    refreshed = 0
    best_rate = np.inf
    stale = 0
    seg = 0
    dtau_carry = None
    spent = 0.0                 # wall seconds from resumed-over runs
    wall_broke = False          # wall-budget exits keep the checkpoint
    # implicit-march trajectory samples (segment-end states + the pseudo-
    # time each segment advanced): if no fixed point is reachable, the
    # centroid stationarity of this trajectory is the conclusive verdict
    # (channelized regimes wander between rearrangement events — measured
    # A3: rate decays 0.39 -> 0.02/yr over ~25 pseudo-years, then 2-5x
    # excursions recur)
    traj = []
    if checkpoint and _os.path.exists(checkpoint):
        ck = np.load(checkpoint, allow_pickle=False)
        import dataclasses as _dc
        cast = lambda k: jnp.asarray(ck[k], state0.N.dtype)
        state = _dc.replace(
            state0, N=cast("N"), b=cast("b"), q=cast("q"),
            melt=cast("melt"),
            N_prev=None if state0.N_prev is None else cast("N_prev"))
        newton, krylov = int(ck["newton"]), int(ck["krylov"])
        seg, refreshed, stale = (int(ck["seg"]), int(ck["refreshed"]),
                                 int(ck["stale"]))
        best_rate, dstate = float(ck["best_rate"]), float(ck["dstate"])
        dtau_carry = (float(ck["dtau_carry"])
                      if np.isfinite(ck["dtau_carry"]) else None)
        spent = float(ck["spent"])
        traj = [(ck["traj_b"][i], ck["traj_N"][i], float(ck["traj_t"][i]))
                for i in range(ck["traj_t"].shape[0])]
        info = {k[5:]: ck[k] for k in ck.files if k.startswith("info_")}

    def _save_ck():
        if not checkpoint:
            return
        q = np.asarray(state.q)
        extra = {"info_" + k: np.asarray(v) for k, v in (info or {}).items()
                 if np.asarray(v).ndim == 0}
        np.savez(checkpoint + ".tmp.npz",
                 N=np.asarray(state.N), b=np.asarray(state.b), q=q,
                 melt=np.asarray(state.melt),
                 N_prev=np.asarray(state.N_prev if state.N_prev is not None
                                   else state.N),
                 newton=np.int64(newton), krylov=np.int64(krylov),
                 seg=np.int64(seg), refreshed=np.int64(refreshed),
                 stale=np.int64(stale), best_rate=np.float64(best_rate),
                 dstate=np.float64(dstate),
                 dtau_carry=np.float64(dtau_carry if dtau_carry is not None
                                       else np.nan),
                 spent=np.float64(spent + _time.time() - t_start),
                 traj_b=np.stack([b for (b, _, _) in traj])
                 if traj else np.zeros((0, state0.N.shape[0])),
                 traj_N=np.stack([N for (_, N, _) in traj])
                 if traj else np.zeros((0, state0.N.shape[0])),
                 traj_t=np.asarray([t for (_, _, t) in traj]),
                 **extra)
        _os.replace(checkpoint + ".tmp.npz", checkpoint)

    while newton < max_newton_total:
        seg += 1
        prev_b = np.asarray(state.b)
        if dtau_carry is None:
            state, info = run(state)
        else:
            state, info = run_cont(state, dtau_carry)
        traj.append((np.asarray(state.b, np.float64),
                     np.asarray(state.N, np.float64),
                     float(np.asarray(info["t_pseudo"]))))
        newton += int(np.asarray(info["newton"]))
        krylov += int(np.asarray(info["krylov_total"]))
        db = np.linalg.norm(np.asarray(state.b) - prev_b)
        dstate = db / max(np.linalg.norm(prev_b), 1e-300)
        rate = float(np.asarray(info["rate_b"]))
        if bool(np.asarray(info["converged"])):
            refreshed += 1
            if refreshed >= max(refreshes, 1) or dstate < 1e-10:
                break
            best_rate = np.inf      # converged segment: refresh and verify
            stale = 0
            _save_ck()
            continue
        # unconverged segment: restart while the drift keeps improving,
        # continuing the march at (half) the reached dtau — the halving
        # absorbs the m_diff refresh shock.  Transient bounces are normal
        # on long channelized marches (channel rearrangement events), so
        # give up only after ``patience`` consecutive segments with no
        # improvement on the best rate seen (measured on A3: the rate decays
        # 0.39 -> 0.02/yr over ~14 pseudo-years with occasional 2-3x
        # upward excursions).
        if rate < 0.9 * best_rate:
            best_rate = rate
            stale = 0
        else:
            stale += 1
            if stale >= max(patience, 1):
                break
        d = float(np.asarray(info["dtau"]))
        dtau_carry = max(min(d, 1e30) * 0.5, 1.0) if np.isfinite(d) else None
        _save_ck()
        if spent + (_time.time() - t_start) > max_wall_s:
            wall_broke = True
            break
    info = {k: np.asarray(v) for k, v in info.items()}
    info["newton"] = newton
    info["krylov_total"] = krylov
    info["refreshes"] = seg
    info["refresh_dstate"] = dstate

    # centroid-stationarity of the implicit march (only meaningful when
    # the fixed point was NOT reached): split the pseudo-time-weighted
    # trajectory into halves; the half-mean drift rate per t_ref is the
    # WANDER RATE of the attractor centroid, and the RMS spread around
    # the overall mean is the wander amplitude.  A small wander rate with
    # a finite amplitude certifies a statistically stationary regime.
    if not bool(np.asarray(info["converged"])) and len(traj) >= 6:
        w = np.asarray([t for (_, _, t) in traj])
        T = w.sum()
        if T > 0:
            cum = np.cumsum(w)
            half = np.searchsorted(cum, T / 2.0) + 1
            half = min(max(half, 1), len(traj) - 1)
            bs = np.stack([b for (b, _, _) in traj])
            Ns = np.stack([N for (_, N, _) in traj])
            wm = lambda X, s: np.average(X[s], axis=0, weights=w[s])
            b1, b2 = wm(bs, slice(0, half)), wm(bs, slice(half, None))
            N1, N2 = wm(Ns, slice(0, half)), wm(Ns, slice(half, None))
            nrm = np.linalg.norm
            rate_w = max(nrm(b2 - b1) / max(nrm(b1), 1e-300),
                         nrm(N2 - N1) / max(nrm(N1), 1e-300))                 * t_ref / (T / 2.0)
            bm, Nm = wm(bs, slice(None)), wm(Ns, slice(None))
            amp_b = np.sqrt(np.average(
                [nrm(b - bm) ** 2 for b in bs], weights=w)) / max(nrm(bm),
                                                                  1e-300)
            amp_N = np.sqrt(np.average(
                [nrm(N - Nm) ** 2 for N in Ns], weights=w)) / max(nrm(Nm),
                                                                  1e-300)
            info["wander_rate"] = rate_w
            info["wander_amp_b"] = float(amp_b)
            info["wander_amp_N"] = float(amp_N)
            info["t_march"] = float(T)
            # the scientifically meaningful output of a stationary
            # wandering regime is the TIME-MEAN state (like the cycle
            # certificate's cycle mean); q/melt recomputed through the
            # transient's own update rules at the mean fields
            dtype = state.N.dtype
            fr2 = _frozen_fields(mesh, static, state, params,
                                 polish_kw.get("quad_degree", 4), dtype)
            fr2["log_b"] = False
            u_mean = jnp.stack([jnp.asarray(Nm, dtype),
                                jnp.asarray(bm, dtype)], axis=-1)
            qm, mm, _ = _nodal_fields(u_mean, fr2, mesh, static, params)
            info["mean_state"] = dataclasses.replace(
                state, N=u_mean[:, 0], b=u_mean[:, 1], q=qm, melt=mm,
                N_prev=(None if state.N_prev is None else u_mean[:, 0]))
    resumable = wall_broke or (newton >= max_newton_total
                               and not bool(np.asarray(info["converged"])))
    if checkpoint and not resumable and _os.path.exists(checkpoint):
        # completed (converged / patience break): the march needs no
        # resume.  Wall- or Newton-budget exhaustion keeps the file so a
        # later call with a fresh budget continues instead of restarting.
        _os.remove(checkpoint)
    return state, info
