"""Device-side mesh representation.

JAX replacement for the DOLFINx C++ mesh/dofmap machinery the
reference leans on (reference model_setup.py:26-31 builds `functionspace`
objects; dofmaps/index maps come from DOLFINx C++).  For P1 elements on
triangles the dof map *is* the cell connectivity, so the whole "function
space" collapses to a frozen pytree of arrays:

  - ``nodes``  (n_nodes, 2)  float   vertex coordinates
  - ``cells``  (n_cells, 3)  int32   vertex indices per triangle
  - derived static geometry: per-cell areas, constant P1 basis gradients,
    and node incidence weights for cell->node averaging.

Everything is static-shaped and lives in HBM; all hot-loop operations on it
are pure gathers/segment-sums that XLA fuses into the timestep program.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Mesh:
    """Frozen triangle-mesh pytree (single-shard view).

    All fields are jnp arrays so a Mesh can be closed over / passed through
    jit, scan and shard_map without re-tracing hazards.
    """

    nodes: Any        # (n_nodes, 2) float: vertex coordinates
    cells: Any        # (n_cells, 3) int32: vertex ids per triangle
    area: Any         # (n_cells,) float: |triangle area|
    grads: Any        # (n_cells, 3, 2) float: constant grad(phi_i) per cell
    node_area: Any    # (n_nodes,) float: sum of adjacent cell areas
    cell_valid: Any   # (n_cells,) float: 1.0 for real cells, 0.0 for padding
    # SPMD: when set, this Mesh is one shard of a cell-partitioned mesh
    # inside shard_map; assembly reductions psum over this named axis
    # (the explicit analogue of DOLFINx's ghost accumulate, SURVEY §2d).
    paxis: str | None = dataclasses.field(default=None,
                                          metadata=dict(static=True))
    # Optional ELL operator structure (fem/ell.py) for scatter-free Krylov
    # matvecs; None on shard-local meshes (those use the cell-based path).
    ell_cols: Any = None        # (n_nodes, K) int32 neighbor ids
    ell_map: Any = None         # (9 * n_cells,) int32 element->slot mapping
    ell_diag_slot: Any = None   # (n_nodes,) int32 diagonal slot per row
    # Optional block-ELL structure (fem/bell.py): dense-block SpMV.
    bell_nbr: Any = None        # (NB, KB) int32 neighbor block ids
    bell_map: Any = None        # (9 * n_cells,) element->flat slot mapping
    bell_diag_pos: Any = None   # (n_nodes,) flat diagonal positions
    bell_B: int | None = dataclasses.field(default=None,
                                           metadata=dict(static=True))
    # Optional block-CSR structure (fem/bcsr.py): the large-mesh SpMV path
    # (no block-row padding; ~40% less HBM traffic on jittered meshes).
    bcsr_brow: Any = None       # (nnzb,) int32 block-row ids (sorted)
    bcsr_bcol: Any = None       # (nnzb,) int32 block-col ids
    bcsr_blk: Any = None        # (9 * n_cells,) int32 element->block id
    bcsr_off: Any = None        # (9 * n_cells,) int32 within-block offset
    bcsr_diag_blk: Any = None   # (n_nodes,) int32 diagonal block ids
    bcsr_diag_off: Any = None   # (n_nodes,) int32 diagonal offsets
    # Optional node->(cell,corner) incidence map: gather-based (scatter-
    # free) assembly and cell->node averaging (fem/ops.py).  inc_map holds
    # flat indices into (n_cells*3,) corner arrays; invalid slots hold the
    # sentinel 3*n_cells (the accumulate gathers from a one-zero-extended
    # array, so no mask is needed).  inc_mask survives only for meshes
    # built by older code (legacy mask semantics in fem/ops.py).
    inc_map: Any = None         # (n_nodes, KI) int32
    inc_mask: Any = None        # legacy (n_nodes, KI) float 1/0, or None
    bcsr_B: int | None = dataclasses.field(default=None,
                                           metadata=dict(static=True))
    bcsr_NB: int | None = dataclasses.field(default=None,
                                            metadata=dict(static=True))
    # Node-sharded SPMD (parallel/halo.py): when set, this Mesh is one
    # device's owned+ghost view; assembly completes via halo.accumulate and
    # reductions via halo.dot/norm.
    halo: Any = None
    # Global coarse-aggregate ids per local slot (halo meshes only): each
    # slot's GLOBAL solver-order node id // block, localized through the
    # halo plan — lets the distributed two-level preconditioner assemble
    # one psum'd global Galerkin coarse operator instead of per-shard
    # block-diagonal ones (precond.make_global_two_level).
    coarse_agg: Any = None          # (L,) int32
    coarse_m: int | None = dataclasses.field(default=None,
                                             metadata=dict(static=True))
    # Multilevel-preconditioner hierarchy (solve/mg.MGPlan) when
    # cfg.precond == 'mg'; built host-side at freeze / build_distributed.
    mg: Any = None

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]


def cell_geometry(nodes: np.ndarray, cells: np.ndarray):
    """Per-cell signed area and constant P1 basis gradients (host-side numpy).

    Replaces Basix/FFCx element tabulation (SURVEY §2b): for P1 triangles the
    basis gradients are constant per cell:
        grad(phi_0) = [y1 - y2, x2 - x1] / (2 A_signed), cyclic in (0,1,2).
    """
    p = nodes[cells]                       # (c, 3, 2)
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    signed_area = 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])   # (c,)
    x, y = p[..., 0], p[..., 1]
    # grad(phi_i) = perp(edge opposite node i) / (2A)
    gx = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1)
    gy = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1)
    grads = np.stack([gx, gy], axis=-1) / (2.0 * signed_area)[:, None, None]
    return signed_area, grads


def build_mesh(nodes: np.ndarray, cells: np.ndarray, dtype=jnp.float64,
               n_cells_pad: int | None = None, build_ell: bool = True,
               operator: str = "ell", bell_block: int = 128) -> Mesh:
    """Construct a device Mesh from raw arrays (host-side preprocessing).

    ``n_cells_pad`` optionally pads the cell list to a fixed size (degenerate
    cells with zero weight) so partitioned shards share one static shape.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int32)
    if cells.size and (cells.min() < 0 or cells.max() >= nodes.shape[0]):
        raise ValueError("cell connectivity references nonexistent nodes")

    signed_area, grads = cell_geometry(nodes, cells)
    if np.any(signed_area == 0.0):
        raise ValueError("mesh contains degenerate (zero-area) cells")
    area = np.abs(signed_area)
    valid = np.ones(cells.shape[0], dtype=np.float64)

    if n_cells_pad is not None and n_cells_pad > cells.shape[0]:
        extra = n_cells_pad - cells.shape[0]
        # Padding cells reference node 0 with zero area/gradients and zero
        # validity weight, so they contribute exactly nothing to assembly.
        cells = np.concatenate([cells, np.zeros((extra, 3), np.int32)])
        area = np.concatenate([area, np.zeros(extra)])
        grads = np.concatenate([grads, np.zeros((extra, 3, 2))])
        valid = np.concatenate([valid, np.zeros(extra)])

    # node_area: sum of |A_c| over cells adjacent to each node -- the weights
    # of the area-weighted cell->node averaging rule (see fem/ops.py).
    node_area = np.zeros(nodes.shape[0])
    np.add.at(node_area, cells.reshape(-1),
              np.repeat(area * valid, 3))
    # guard isolated nodes (possible on padded partitions)
    node_area_safe = np.where(node_area == 0.0, 1.0, node_area)

    # node->(cell,corner) incidence (gather-based assembly, fem/ops.py):
    # CSR-style construction, padded ELL layout.  Padding cells (valid=0,
    # all referencing node 0) are excluded so they cannot inflate KI.
    # Invalid slots hold the SENTINEL index 3*n_cells: the accumulate
    # gathers from a one-zero-extended corner array, so no mask constant
    # is carried at all (the old (n, KI) float mask doubled the closure
    # bytes and its 0*x product could launder an AD NaN).
    # Size gate: the map is ~4*KI bytes/node of closure constants, so it
    # is built only up to SHAKTI_INC_LIMIT nodes (default: the 1M-dof
    # single-device scale); larger meshes keep the scatter-add
    # accumulation and its smaller compiled program.
    build_inc = nodes.shape[0] <= int(
        os.environ.get("SHAKTI_INC_LIMIT", "1200000"))
    n = nodes.shape[0]
    inc_map_np = inc_mask_np = None
    if build_inc:
        real_cells = np.nonzero(valid > 0)[0]
        flat_pos = (real_cells[:, None] * 3
                    + np.arange(3)[None, :]).reshape(-1).astype(np.int64)
        flat_nodes = cells[real_cells].reshape(-1)
        order = np.argsort(flat_nodes, kind="stable")
        counts = np.bincount(flat_nodes, minlength=n)
        KI = int(counts.max()) if counts.size else 0
        inc_map_np = np.full((n, KI), 3 * cells.shape[0], dtype=np.int32)
        rank = np.arange(flat_nodes.size) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        inc_map_np[flat_nodes[order], rank] = flat_pos[order].astype(np.int32)

    if not build_ell:
        operator = "none"
    ell_cols = ell_map = ell_diag_slot = None
    bell_nbr = bell_map = bell_diag_pos = None
    bell_B = None
    if operator in ("ell", "both"):
        from shakti_tpu.fem.ell import build_ell_map
        cols_np, map_np, diag_np = build_ell_map(cells, nodes.shape[0])
        ell_cols = jnp.asarray(cols_np)
        ell_map = jnp.asarray(map_np)
        ell_diag_slot = jnp.asarray(diag_np)
    bcsr_brow = bcsr_bcol = bcsr_blk = bcsr_off = None
    bcsr_diag_blk = bcsr_diag_off = None
    bcsr_B = bcsr_NB = None
    if operator in ("bcsr",):
        from shakti_tpu.fem.bcsr import build_bcsr
        br, bc, blk, off, dblk, doff, NB = build_bcsr(cells, nodes.shape[0],
                                                      bell_block)
        bcsr_brow = jnp.asarray(br)
        bcsr_bcol = jnp.asarray(bc)
        bcsr_blk = jnp.asarray(blk)
        bcsr_off = jnp.asarray(off)
        bcsr_diag_blk = jnp.asarray(dblk)
        bcsr_diag_off = jnp.asarray(doff)
        bcsr_B = bell_block
        bcsr_NB = int(NB)
    if operator in ("bell", "both"):
        from shakti_tpu.fem.bell import build_block_ell
        nbr_np, bmap_np, dpos_np, _ = build_block_ell(cells, nodes.shape[0],
                                                      bell_block)
        bell_nbr = jnp.asarray(nbr_np)
        bell_map = jnp.asarray(bmap_np)
        bell_diag_pos = jnp.asarray(dpos_np)
        bell_B = bell_block

    return Mesh(
        nodes=jnp.asarray(nodes, dtype=dtype),
        cells=jnp.asarray(cells),
        area=jnp.asarray(area, dtype=dtype),
        grads=jnp.asarray(grads, dtype=dtype),
        node_area=jnp.asarray(node_area_safe, dtype=dtype),
        cell_valid=jnp.asarray(valid, dtype=dtype),
        inc_map=None if inc_map_np is None else jnp.asarray(inc_map_np),
        inc_mask=None if inc_mask_np is None
        else jnp.asarray(inc_mask_np, dtype=dtype),
        ell_cols=ell_cols, ell_map=ell_map, ell_diag_slot=ell_diag_slot,
        bell_nbr=bell_nbr, bell_map=bell_map, bell_diag_pos=bell_diag_pos,
        bell_B=bell_B,
        bcsr_brow=bcsr_brow, bcsr_bcol=bcsr_bcol, bcsr_blk=bcsr_blk,
        bcsr_off=bcsr_off, bcsr_diag_blk=bcsr_diag_blk,
        bcsr_diag_off=bcsr_diag_off, bcsr_B=bcsr_B, bcsr_NB=bcsr_NB,
    )
