"""Core FEM data-movement primitives: gather, cellwise gradients, scatter-add,
and cell->node averaging.

These four operations replace the whole DOLFINx assembly/interpolation data
path (SURVEY §2b) and are written so that XLA fuses them into the surrounding
elementwise physics:

  - gather_cells:      nodal -> per-cell-corner values        (HBM gather)
  - cell_grad:         nodal -> cellwise-constant P1 gradient (gather + einsum)
  - scatter_add_cells: per-cell-corner -> nodal accumulation  (segment_sum)
  - *_to_node_avg:     cellwise quantities -> nodal values by area-weighted
                       averaging over adjacent cells

The averaging rule is this framework's deterministic replacement for DOLFINx
Expression interpolation of cell-discontinuous quantities (which resolves
shared nodes by cell visit order, reference solvers.py:143-165 + SURVEY §7
"hard parts" #2): we take the |cell-area|-weighted mean over all adjacent
cells.  Documented divergence: agrees with the reference to O(h).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# All FEM contractions are tiny (contracting dims of 2-6) but numerically
# load-bearing: jnp.einsum's default precision may run float32 dots at
# reduced precision (TF32 on the GPU's tensor cores), which destroys the
# Newton solve in float32 (CG returns garbage directions).  Pin every dot
# to full-precision accumulation (tests/test_precision.py checks the
# lowered step).  `ein` is kept for GENUINE matmuls (the block-operator
# matvecs, the coarse-PC apply); the tiny per-cell contractions below are
# written as explicit broadcast-multiply-sum instead — einsum lowers each
# to its own dot kernel wrapped in transpose/copy kernels, and in a
# launch-bound step those kernels dominate.  Plain f32 multiplies + sums
# are exactly as accurate as a HIGHEST-precision dot and fuse into the
# surrounding elementwise physics.
ein = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
# Krylov/Newton inner products, pinned the same way.
vdot = partial(jnp.vdot, precision=jax.lax.Precision.HIGHEST)


def gather_cells(mesh, f):
    """(n_nodes, ...) -> (n_cells, 3, ...): values at each cell's corners."""
    return f[mesh.cells]


def cell_grad(mesh, f):
    """Cellwise-constant gradient of a P1 nodal field.

    f: (n_nodes,) -> (n_cells, 2);  f: (n_nodes, k) -> (n_cells, k, 2).

    Corner values are mean-centered per cell before contracting with the
    basis gradients.  Exact in real arithmetic (sum of P1 basis gradients is
    zero), and essential in f32: fields like N carry absolute values ~1e6
    whose within-cell variation is ~1e2-1e3, so gradients computed from raw
    values lose ~4 digits to cancellation (SURVEY §7 hard part 1).
    """
    fc = f[mesh.cells]                      # (c, 3, ...)
    if f.ndim == 1:
        fc = fc - jnp.mean(fc, axis=1, keepdims=True)
        return jnp.sum(fc[:, :, None] * mesh.grads, axis=1)
    fc = fc - jnp.mean(fc, axis=1, keepdims=True)
    return jnp.sum(fc[:, :, :, None] * mesh.grads[:, :, None, :], axis=1)


def scatter_add_cells(mesh, contrib):
    """Accumulate per-cell-corner contributions into nodal arrays.

    contrib: (n_cells, 3) or (n_cells, 3, k) -> (n_nodes,) / (n_nodes, k).
    Padding cells carry zero contributions by construction (zero area).

    When the mesh carries the node->(cell,corner) incidence map the
    accumulation is a GATHER + masked sum over the (n, KI) incidence
    layout instead of a segment_sum scatter — a scatter-add is its own
    kernel (atomics on the GPU, with run-to-run rounding differences),
    while gathers fuse (same trick as the ELL/block-ELL operator
    matvecs).
    """
    flat = contrib.reshape((-1,) + contrib.shape[2:])
    if mesh.inc_map is not None and mesh.halo is None and mesh.paxis is None:
        if mesh.inc_mask is not None:          # legacy mask-style maps
            mask = mesh.inc_mask.reshape(mesh.inc_mask.shape
                                         + (1,) * (flat.ndim - 1))
            return jnp.sum(mask * flat[mesh.inc_map], axis=1)
        # sentinel-style map: invalid slots index the appended zero row
        zero = jnp.zeros((1,) + flat.shape[1:], flat.dtype)
        ext = jnp.concatenate([flat, zero], axis=0)
        return jnp.sum(ext[mesh.inc_map], axis=1)
    flat_idx = mesh.cells.reshape(-1)
    out = jax.ops.segment_sum(flat, flat_idx, num_segments=mesh.n_nodes)
    if mesh.halo is not None:
        # node-sharded SPMD: complete assembly across partition boundaries
        # (ghost->owner add, then refresh ghost copies)
        return mesh.halo.accumulate(out)
    if mesh.paxis is not None:
        # cross-device ghost accumulate: each shard holds a subset of cells
        # referencing the replicated global node set; summing partial nodal
        # contributions over the mesh axis completes assembly (the
        # collective equivalent of PETSc's ghost-to-owner accumulation,
        # SURVEY §2d).
        out = jax.lax.psum(out, mesh.paxis)
    return out


def cell_to_node_avg(mesh, fc):
    """Area-weighted average of a cellwise-constant quantity at nodes.

    fc: (n_cells,) or (n_cells, k) -> (n_nodes,) / (n_nodes, k).
    """
    w = mesh.area * mesh.cell_valid                        # (c,)
    wf = fc * w if fc.ndim == 1 else fc * w[:, None]
    contrib = jnp.broadcast_to(wf[:, None], (mesh.n_cells, 3) + wf.shape[1:])
    s = scatter_add_cells(mesh, contrib)
    na = mesh.node_area if fc.ndim == 1 else mesh.node_area[:, None]
    # dead slots (zero node area) yield 0, not 0/0 = NaN — same guard as
    # cellnodal_to_node_avg below (NaNs at dead slots poison reverse-mode AD)
    live = na > 0
    return jnp.where(live, s / jnp.where(live, na, 1.0), 0.0)


def cellnodal_to_node_avg(mesh, v):
    """Area-weighted average of per-(cell, corner) values at nodes.

    v: (n_cells, 3) or (n_cells, 3, k) -> (n_nodes,) / (n_nodes, k).
    Used when a quantity is P1-within-cell but discontinuous across cells
    (e.g. the melt-regularization divergence term).
    """
    w = mesh.area * mesh.cell_valid
    wv = v * w[:, None] if v.ndim == 2 else v * w[:, None, None]
    s = scatter_add_cells(mesh, wv)
    na = mesh.node_area if v.ndim == 2 else mesh.node_area[:, None]
    # dead slots (zero node area: halo pad/dump slots, padded nodes) yield
    # 0, not 0/0 = NaN — live-slot values are bit-identical (same division),
    # but NaNs at dead slots poison reverse-mode AD through the step even
    # though no forward consumer reads them
    live = na > 0
    return jnp.where(live, s / jnp.where(live, na, 1.0), 0.0)


def interpolate_at_quad(phi, fc):
    """Evaluate P1 fields at quadrature points from corner values.

    phi: (nq, 3) shape-function table; fc: (c, 3) or (c, 3, k)
    -> (c, nq) or (c, nq, k).
    """
    if fc.ndim == 2:
        return jnp.sum(phi[None, :, :] * fc[:, None, :], axis=2)
    return jnp.sum(phi[None, :, :, None] * fc[:, None, :, :], axis=2)
