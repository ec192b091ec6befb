"""Independent numpy/scipy oracle for the SHAKTI effective-pressure problem.

Purpose (VERDICT round-1 item 2): an implementation of the reference weak
form (reference source/solvers.py:45) that shares NO code with
``shakti_tpu.physics.residual`` / ``shakti_tpu.solve`` — hand-derived
analytic element Jacobians, scipy sparse-LU Newton in float64, plain numpy
assembly loops.  It exists to cross-validate the JAX framework against the
discretization the reference's DOLFINx/PETSc stack solves:

  * ``interp_rule='avg'``       — cell-discontinuous quantities brought to
    nodes by |area|-weighted averaging over incident cells: the framework's
    deliberate, deterministic rule (shakti_tpu/fem/ops.py docstring).
  * ``interp_rule='lastcell'``  — DOLFINx ``Function.interpolate(Expression)``
    semantics: the expression is evaluated cellwise at the interpolation
    points (vertices for P1) and written into the dof vector cell by cell,
    so at a shared node the LAST incident cell in iteration order wins
    (reference solvers.py:143-165,186-192).

Running the same case under both rules quantifies the one documented
numerical divergence between the framework and the reference (SURVEY §7
"hard parts" #2); running the framework against ``avg`` validates everything
else (assembly, Jacobian, Newton, explicit updates, clamp, sequencing) to
solver tolerance.

The PDE being solved each timestep, weak form F(N; frozen b, q, melt_n) = 0
(reference solvers.py:34-45):

    F_i = int [ -q_w(N) . grad(phi_i)
                + ( (1/rho_i - 1/rho_w) m(N) - C(b, N)
                    - storage (N - N_n)/(rho_w g dt) - inputs ) phi_i ] dx

with  q_w = -|b|^3 g grad(h) / (12 nu (1 + omega Re(q))),
      h   = z_b + (rho_i/rho_w)(z_s - z_b) - N/(rho_w g),
      m   = (G - rho_w g q . grad h)/L + div(b melt_n grad b / (1+|grad b|^2)),
      C   = A b N |N|^(n-1),
followed by the explicit updates q -> melt_n -> b -> clamp -> N_n
(reference solvers.py:185-229).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

# physical constants (reference source/params.py:4-11)
G_GRAV = 9.81
RHO_I = 917.0
RHO_W = 1000.0
NU = 1.787e-6
LH = 3.34e5
OMEGA = 1e-3
GLEN_N = 3.0
GLEN_A = 2.24e-24

# triangle quadrature rules in barycentric coordinates, weights sum to 1
# (standard Dunavant tables; degree -> (points (nq,3), weights (nq,)))
_QUADRULES = {
    1: (np.full((1, 3), 1.0 / 3.0), np.array([1.0])),
    2: (np.array([[2 / 3, 1 / 6, 1 / 6],
                  [1 / 6, 2 / 3, 1 / 6],
                  [1 / 6, 1 / 6, 2 / 3]]), np.full(3, 1 / 3)),
    3: (np.array([[1 / 3, 1 / 3, 1 / 3],
                  [0.6, 0.2, 0.2], [0.2, 0.6, 0.2], [0.2, 0.2, 0.6]]),
        np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48])),
    4: (np.array([
        [0.816847572980459, 0.091576213509771, 0.091576213509771],
        [0.091576213509771, 0.816847572980459, 0.091576213509771],
        [0.091576213509771, 0.091576213509771, 0.816847572980459],
        [0.108103018168070, 0.445948490915965, 0.445948490915965],
        [0.445948490915965, 0.108103018168070, 0.445948490915965],
        [0.445948490915965, 0.445948490915965, 0.108103018168070]]),
        np.array([0.109951743655322] * 3 + [0.223381589678011] * 3)),
}


class OracleModel:
    """Problem definition + mesh-dependent precomputation (all float64)."""

    def __init__(self, nodes, cells, *, z_b, z_s, G, inputs, storage,
                 dirichlet_nodes, N_bdry, b_min=1e-5, quad_degree=4,
                 interp_rule="avg"):
        self.nodes = np.asarray(nodes, np.float64)
        self.cells = np.asarray(cells, np.int64)
        n, c = self.nodes.shape[0], self.cells.shape[0]
        self.n, self.c = n, c
        self.z_b = np.asarray(z_b, np.float64)
        self.z_s = np.asarray(z_s, np.float64)
        self.G = np.asarray(G, np.float64)
        self.inputs = np.asarray(inputs, np.float64)
        self.storage = np.asarray(storage, np.float64)
        self.N_bdry = float(N_bdry)
        self.b_min = float(b_min)
        self.dir_mask = np.zeros(n, bool)
        self.dir_mask[np.asarray(dirichlet_nodes, np.int64)] = True
        assert interp_rule in ("avg", "lastcell")
        self.interp_rule = interp_rule

        # --- element geometry ---------------------------------------------
        p = self.nodes[self.cells]                       # (c, 3, 2)
        x, y = p[:, :, 0], p[:, :, 1]
        det = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
               - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))  # signed 2A
        self.area = np.abs(det) / 2.0
        # grad lambda_i = perpendicular of the opposite edge / (2A signed)
        gl = np.empty((c, 3, 2))
        gl[:, 0, 0] = y[:, 1] - y[:, 2]
        gl[:, 0, 1] = x[:, 2] - x[:, 1]
        gl[:, 1, 0] = y[:, 2] - y[:, 0]
        gl[:, 1, 1] = x[:, 0] - x[:, 2]
        gl[:, 2, 0] = y[:, 0] - y[:, 1]
        gl[:, 2, 1] = x[:, 1] - x[:, 0]
        self.gphi = gl / det[:, None, None]              # (c, 3, 2)

        self.qp, self.qw = _QUADRULES[int(quad_degree)]  # (nq,3), (nq,)

        # background head gradient per cell (h at N=0)
        r = RHO_I / RHO_W
        gzb = self.cell_grad(self.z_b)
        gzs = self.cell_grad(self.z_s)
        self.gb0 = gzb + r * (gzs - gzb)                 # (c, 2)

        # node weights for the 'avg' cell->node rule
        self.node_area = np.zeros(n)
        np.add.at(self.node_area, self.cells.reshape(-1),
                  np.repeat(self.area, 3))

        # 'lastcell' rule: the incident cell that writes a node LAST in
        # cell-iteration order = the max cell index containing the node
        last = np.zeros(n, np.int64)
        ci = np.repeat(np.arange(c), 3)
        np.maximum.at(last, self.cells.reshape(-1), ci)
        self.last_cell = last
        # corner slot of each node within its last cell
        eq = self.cells[last] == np.arange(n)[:, None]
        self.last_corner = np.argmax(eq, axis=1)

        # sparsity pattern for the Jacobian (COO indices reused every solve)
        self.J_rows = np.repeat(self.cells, 3, axis=1).reshape(-1)    # i fast?
        self.J_cols = np.tile(self.cells, (1, 3)).reshape(-1)
        # note: rows = cells[:, i] repeated over j; cols = cells[:, j]

    # --- FEM helpers -------------------------------------------------------
    def cell_grad(self, f):
        """Cellwise-constant gradient of a P1 nodal field: (c, 2)."""
        fc = f[self.cells]                               # (c, 3)
        return np.einsum("ci,cid->cd", fc, self.gphi)

    def at_quad(self, f):
        """Nodal field -> values at quadrature points: (c, nq)."""
        fc = f[self.cells]
        return fc @ self.qp.T                            # (c, nq)

    def cell_to_node(self, v_ci):
        """Bring per-(cell, corner) values (c, 3) to nodes under the
        configured rule."""
        if self.interp_rule == "lastcell":
            return v_ci[self.last_cell, self.last_corner]
        s = np.zeros(self.n)
        np.add.at(s, self.cells.reshape(-1),
                  (v_ci * self.area[:, None]).reshape(-1))
        return s / self.node_area

    def cellconst_to_node(self, v_c):
        """Bring cellwise-constant values (c,) or (c, k) to nodes.

        'avg': node value = sum of (area_c * v_c) over incident cells divided
        by the summed incident area — each cell contributes once per node."""
        if self.interp_rule == "lastcell":
            return v_c[self.last_cell]
        s = np.zeros((self.n,) + v_c.shape[1:])
        w = v_c * self.area[:, None] if v_c.ndim == 2 else v_c * self.area
        for i in range(3):
            np.add.at(s, self.cells[:, i], w)
        den = (self.node_area[:, None] if v_c.ndim == 2 else self.node_area)
        return s / den


def _mdiff_pointwise(b_pt, m_pt, gb, gm):
    """Warburton div-term at a point inside a cell:
    div(b m grad b / (1+|grad b|^2)) = grad(b m) . grad b / (1+|grad b|^2)
    with grad b, grad m cellwise-constant (reference constitutive.py:26)."""
    den = 1.0 + np.sum(gb * gb, axis=-1)
    num = np.sum(gb * (m_pt[..., None] * gb + b_pt[..., None] * gm), axis=-1)
    return num / den


class OracleStep:
    """One frozen-coefficient Newton problem + the explicit updates."""

    def __init__(self, om: OracleModel, N_n, b, q, melt_n, dt):
        self.om = om
        self.N_n = N_n
        self.b = b
        self.q = q
        self.melt_n = melt_n
        self.dt = float(dt)

        # frozen coefficient data at quadrature points
        b_q = om.at_quad(b)
        qx_q, qy_q = om.at_quad(q[:, 0]), om.at_quad(q[:, 1])
        Re_q = np.sqrt(qx_q**2 + qy_q**2) / NU
        self.T_q = (np.abs(b_q) ** 3) * G_GRAV / (12 * NU * (1 + OMEGA * Re_q))
        self.qx_q, self.qy_q = qx_q, qy_q
        gb = om.cell_grad(b)
        gm = om.cell_grad(melt_n)
        m_q = om.at_quad(melt_n)
        self.mdiff_q = _mdiff_pointwise(b_q, m_q, gb[:, None, :], gm[:, None, :])
        self.G_q = om.at_quad(om.G)
        self.inputs_q = om.at_quad(om.inputs)
        self.storage_q = om.at_quad(om.storage)
        self.Nn_q = om.at_quad(N_n)
        self.cm = 1.0 / RHO_I - 1.0 / RHO_W

    def _grad_h(self, N):
        return self.om.gb0 - self.om.cell_grad(N) / (RHO_W * G_GRAV)

    def residual(self, N):
        om = self.om
        gh = self._grad_h(N)                              # (c, 2)
        N_q = om.at_quad(N)

        # flux term: -int q_w . grad phi_i = + int T gh . grad phi_i
        Tbar = np.einsum("q,cq->c", om.qw, self.T_q)      # (c,)
        flux_ci = (Tbar * om.area)[:, None] * np.einsum(
            "cd,cid->ci", gh, om.gphi)                    # (c, 3)

        # source terms at quad points
        qdgh = self.qx_q * gh[:, None, 0] + self.qy_q * gh[:, None, 1]
        m_q = (self.G_q - RHO_W * G_GRAV * qdgh) / LH + self.mdiff_q
        C_q = GLEN_A * self.om.at_quad(self.b) * N_q * np.abs(N_q) ** (GLEN_N - 1)
        lake_q = self.storage_q * (N_q - self.Nn_q) / (RHO_W * G_GRAV * self.dt)
        src_q = self.cm * m_q - C_q - lake_q - self.inputs_q

        src_ci = om.area[:, None] * np.einsum("q,cq,qi->ci", om.qw, src_q, om.qp)

        F = np.zeros(om.n)
        np.add.at(F, om.cells.reshape(-1), (flux_ci + src_ci).reshape(-1))
        F[om.dir_mask] = 0.0
        return F

    def jacobian(self, N):
        """Analytic element Jacobian, assembled to CSR (hand-derived — the
        reference gets it from ufl.derivative, solvers.py:51)."""
        om = self.om
        N_q = om.at_quad(N)
        cw = 1.0 / (RHO_W * G_GRAV)

        # d(flux term)/dN_j:  -int T grad phi_j . grad phi_i / (rho_w g)
        Tbar = np.einsum("q,cq->c", om.qw, self.T_q)
        K_ij = np.einsum("cid,cjd->cij", om.gphi, om.gphi)
        J_flux = -(cw * Tbar * om.area)[:, None, None] * K_ij

        # d(melt)/dN_j: cm * int (q . grad phi_j / LH) phi_i
        qgj = (self.qx_q[:, :, None] * om.gphi[:, None, :, 0]
               + self.qy_q[:, :, None] * om.gphi[:, None, :, 1])  # (c,nq,3)
        J_melt = self.cm * cw * RHO_W * G_GRAV / LH * np.einsum(
            "q,cqj,qi,c->cij", om.qw, qgj, om.qp, om.area)

        # d(-closure)/dN_j: -int A b 3 N^2 phi_j phi_i
        dC_q = GLEN_A * om.at_quad(self.b) * GLEN_N * N_q**2
        J_clo = -np.einsum("q,cq,qi,qj,c->cij", om.qw, dC_q, om.qp, om.qp,
                           om.area)

        # d(-lake)/dN_j: -int storage/(rho_w g dt) phi_j phi_i
        J_lake = -np.einsum("q,cq,qi,qj,c->cij", om.qw,
                            self.storage_q / (RHO_W * G_GRAV * self.dt),
                            om.qp, om.qp, om.area)

        Jc = J_flux + J_melt + J_clo + J_lake             # (c, 3, 3)
        J = sp.coo_matrix(
            (Jc.reshape(-1), (om.J_rows, om.J_cols)),
            shape=(om.n, om.n)).tocsr()
        # Dirichlet rows -> identity
        d = om.dir_mask
        mask = sp.diags((~d).astype(np.float64))
        J = mask @ J + sp.diags(d.astype(np.float64))
        return J

    def newton(self, N_guess, rtol=1e-12, atol=1e-300, max_iter=50):
        om = self.om
        N = N_guess.copy()
        N[om.dir_mask] = om.N_bdry
        F = self.residual(N)
        r0 = np.linalg.norm(F)
        for _ in range(max_iter):
            rn = np.linalg.norm(F)
            if rn <= max(rtol * r0, atol) or rn == 0.0:
                return N, True
            J = self.jacobian(N)
            dN = spla.spsolve(J, -F)
            N = N + dN
            F = self.residual(N)
        return N, np.linalg.norm(F) <= 1e-8 * max(r0, 1.0)

    def explicit_updates(self, N):
        """q -> melt -> b -> clamp, with the configured cell->node rule
        (reference solvers.py:185-197)."""
        om = self.om
        gh_c = self._grad_h(N)                            # (c, 2)

        if om.interp_rule == "lastcell":
            gh_n = gh_c[om.last_cell]                     # (n, 2)
        else:
            gh_n = np.stack([om.cellconst_to_node(gh_c[:, 0]),
                             om.cellconst_to_node(gh_c[:, 1])], axis=1)

        # q update: nodal b and Re(old q), grad h by rule (q_expr, :186)
        Re_n = np.sqrt(np.sum(self.q**2, axis=1)) / NU
        coef = -(np.abs(self.b) ** 3) * G_GRAV / (12 * NU * (1 + OMEGA * Re_n))
        q_new = coef[:, None] * gh_n

        # melt update: NEW q, OLD b / OLD melt in the div term (:165, :189)
        gb_c = om.cell_grad(self.b)
        gm_c = om.cell_grad(self.melt_n)
        b_ci = self.b[om.cells]
        m_ci = self.melt_n[om.cells]
        mdiff_old_ci = _mdiff_pointwise(b_ci, m_ci, gb_c[:, None, :],
                                        gm_c[:, None, :])   # (c, 3)
        mdiff_old_n = om.cell_to_node(mdiff_old_ci)
        # (in 'lastcell' mode the q . grad h product uses the last cell's
        #  grad h, exactly as DOLFINx evaluates the expression in-cell)
        m0_n = (om.G - RHO_W * G_GRAV *
                np.sum(q_new * gh_n, axis=1)) / LH
        melt_new = m0_n + mdiff_old_n

        # b update: forward Euler with NEW q and NEW melt in the div term,
        # OLD b elsewhere (b_expr, :162, :192)
        gm_new_c = om.cell_grad(melt_new)
        mn_ci = melt_new[om.cells]
        mdiff_new_ci = _mdiff_pointwise(b_ci, mn_ci, gb_c[:, None, :],
                                        gm_new_c[:, None, :])
        mdiff_new_n = om.cell_to_node(mdiff_new_ci)
        melt_for_b = m0_n + mdiff_new_n
        C_n = GLEN_A * self.b * N * np.abs(N) ** (GLEN_N - 1)
        b_new = self.b + self.dt * (melt_for_b / RHO_I - C_n)
        b_new = np.maximum(b_new, om.b_min)
        return q_new, melt_new, b_new


def run_transient(om: OracleModel, N0, b0, q0, melt0, timesteps,
                  n_steps=None, newton_guess="previous"):
    """March the oracle in time (reference solvers.py:168-229, including the
    first-step dt quirk dt_0 = 0.1 |t_1 - t_0|, solvers.py:81-82,174-176).

    Returns dict of trajectories at every step: N, b, q, melt (lists).
    """
    t = np.asarray(timesteps, np.float64)
    nt = t.size if n_steps is None else min(n_steps, t.size)
    dts = np.empty(nt)
    dts[0] = 0.1 * abs(t[1] - t[0])
    m = min(nt, t.size)
    dts[1:m] = np.abs(np.diff(t))[:m - 1]

    N, b, q, melt = (np.array(N0, np.float64), np.array(b0, np.float64),
                     np.array(q0, np.float64), np.array(melt0, np.float64))
    N_prev = N.copy()
    out = {"N": [], "b": [], "q": [], "melt": [], "converged": []}
    for i in range(nt):
        step = OracleStep(om, N, b, q, melt, dts[i])
        if newton_guess == "extrapolate" and i > 0:
            guess = 2.0 * N - N_prev
        else:
            guess = N                                     # reference :48
        N_prev = N
        N_new, ok = step.newton(guess)
        q, melt, b = step.explicit_updates(N_new)
        N = N_new
        out["N"].append(N.copy())
        out["b"].append(b.copy())
        out["q"].append(q.copy())
        out["melt"].append(melt.copy())
        out["converged"].append(ok)
    return out
