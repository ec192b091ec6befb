"""Block-CSR operator format: the large-mesh SpMV path.

Block-ELL (fem/bell.py) pads every block-row to the max block degree
KB_max; on jittered meshes that wastes ~40% of the value storage and —
since the SpMV is HBM-bandwidth-bound — ~40% of the matvec time, and it
caps the single-device problem size (vals = NB * KB_max * B^2 * 4 bytes).

Block-CSR stores only the nonzero blocks:

  * vals (nnzb, B, B), bcol (nnzb,), brow (nnzb,) sorted by row;
  * matvec: xg = xb[bcol] (row-granular gather), z = batched matmul,
    y = segment-sum of z over brow — a ROW-granular scatter of 128-lane
    rows, which vectorizes well (unlike element scatters);
  * element Jacobians fold in with one 2-D scatter-add addressed by
    (block id, within-block offset) int32 pairs — flat addressing would
    overflow int32 beyond ~3M nodes, and jax silently canonicalizes int64
    indices to int32 when x64 is off (the production configuration).

Memory at 10M dof with B=16: ~5.8 GB of values — single-device feasible,
where block-ELL at B=128 would need ~80 GB.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from shakti_tpu.fem.ops import ein


def build_bcsr(cells: np.ndarray, n_nodes: int, B: int = 128):
    """Host-side: block sparsity + element->slot mapping.

    Assumes locality-ordered nodes (RCB).  Returns
    (brow (nnzb,), bcol (nnzb,), blk_map (9c,), off_map (9c,),
    diag_blk (n,), diag_off (n,), NB) — all int32.
    """
    NB = -(-n_nodes // B)
    from shakti_tpu import native
    if native.available():
        nat = native.bcsr_build(np.asarray(cells, np.int32), n_nodes, B)
        if nat is not None:
            brow, bcol, blk, off, dblk, doff = nat
            return brow, bcol, blk, off, dblk, doff, NB
    c = cells.shape[0]
    rows = np.broadcast_to(cells[:, :, None], (c, 3, 3)).reshape(-1).astype(np.int64)
    cols = np.broadcast_to(cells[:, None, :], (c, 3, 3)).reshape(-1).astype(np.int64)
    br, bc = rows // B, cols // B

    bkey = br * NB + bc
    uniq = np.unique(bkey)
    brow = (uniq // NB).astype(np.int32)
    bcol = (uniq % NB).astype(np.int32)

    blk_map = np.searchsorted(uniq, bkey).astype(np.int32)
    off_map = ((rows % B) * B + cols % B).astype(np.int32)

    r = np.arange(n_nodes, dtype=np.int64)
    dkey = (r // B) * NB + (r // B)
    diag_blk = np.clip(np.searchsorted(uniq, dkey), 0,
                       uniq.size - 1).astype(np.int32)
    diag_off = ((r % B) * B + r % B).astype(np.int32)
    return brow, bcol, blk_map, off_map, diag_blk, diag_off, NB


def bcsr_from_elements(J_c, blk_map, off_map, nnzb: int, B: int, out=None):
    """Fold element blocks (c, 3, 3) into (nnzb, B, B): one 2-D scatter-add
    (int32-safe at any mesh size).

    ``out``: an existing values buffer to overwrite (the lagged-operator
    rebuild path passes the dead carry so XLA can alias its buffer —
    ``out * 0`` then scatter-add can both run in place, where a fresh
    ``zeros`` forces carry + new values to be live simultaneously)."""
    flat = J_c.reshape(-1)
    if out is not None:
        vals = (out.reshape(nnzb, B * B) * 0).at[blk_map, off_map].add(flat)
    else:
        vals = jnp.zeros((nnzb, B * B), dtype=flat.dtype)
        vals = vals.at[blk_map, off_map].add(flat)
    return vals.reshape(nnzb, B, B)


def bcsr_matvec(vals, brow, bcol, x, n_nodes: int, NB: int):
    """y = A x: row gather + batched matmul + row-granular segment-sum."""
    nnzb, B, _ = vals.shape
    xpad = jnp.pad(x, (0, NB * B - n_nodes)).reshape(NB, B)
    xg = xpad[bcol]                               # (nnzb, B)
    z = ein("kij,kj->ki", vals, xg)               # batched block matmul
    y = jax.ops.segment_sum(z, brow, num_segments=NB,
                            indices_are_sorted=True)
    return y.reshape(-1)[:n_nodes]


def bcsr_diag(vals, diag_blk, diag_off):
    nnzb, B, _ = vals.shape
    return vals.reshape(nnzb, B * B)[diag_blk, diag_off]
