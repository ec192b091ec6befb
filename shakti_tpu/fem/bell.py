"""Block-ELL (BSR-style) operator format: SpMV as batched dense matmuls.

The scalar-ELL matvec (fem/ell.py) gathers one x entry per stored nonzero.
This module restructures the assembled operator so the Krylov matvec
gathers whole row-blocks of x and contracts them with dense blocks:

  * nodes are pre-ordered (RCB, see mesh layer) and chunked into blocks of
    B=128;
  * the sparse operator becomes dense BxB blocks in block-ELL layout:
    vals (NB, KB, B, B) with nbr (NB, KB) neighbor-block ids (pad = self,
    zero values);
  * matvec: gather KB neighbor x-blocks per row-block (row-granular gather,
    512-byte rows) and contract with one batched einsum;
  * element Jacobians fold into vals with ONE segment-sum per Newton
    iteration (host-precomputed flat slot mapping, like fem/ell.py).

Cost model: at 12k dof vals are ~50 MB, mostly zero padding inside the
dense blocks, so the matvec streams ~10x the bytes of scalar ELL; at 10M
dof the same layout streams ~40 GB per matvec.  Either way it is bound by
memory bandwidth.  Which format wins on a given device is a measurement
(the chip smoke test times all three).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from shakti_tpu.fem.ops import ein

BLOCK = 128  # block edge


def build_block_ell(cells: np.ndarray, n_nodes: int, B: int = BLOCK):
    """Host-side: block sparsity + element->slot mapping.

    Assumes nodes are already ordered for locality (RCB; mesh layer).
    Returns (nbr (NB, KB) int32, slot_map (9*c,) int32 flat positions into
    vals (NB, KB, B, B), diag_pos (n_nodes,) int32, KB).
    """
    from shakti_tpu import native
    if native.available():
        nat = native.bell_build(np.asarray(cells, np.int32), n_nodes, B)
        if nat is not None:
            nbr, slot_map, diag_pos, KB = nat
            return nbr, slot_map, diag_pos, KB
    NB = -(-n_nodes // B)
    c = cells.shape[0]
    rows = np.broadcast_to(cells[:, :, None], (c, 3, 3)).reshape(-1).astype(np.int64)
    cols = np.broadcast_to(cells[:, None, :], (c, 3, 3)).reshape(-1).astype(np.int64)
    brow, bcol = rows // B, cols // B

    # unique (brow, bcol) pairs, sorted
    bkey = brow * NB + bcol
    uniq = np.unique(bkey)
    ur, uc = uniq // NB, (uniq % NB).astype(np.int32)
    deg = np.bincount(ur, minlength=NB)
    KB = int(deg.max())
    start = np.concatenate([[0], np.cumsum(deg)])
    kb_of_pair = np.arange(uniq.size) - start[ur]

    nbr = np.broadcast_to(np.arange(NB, dtype=np.int32)[:, None], (NB, KB)).copy()
    nbr[ur, kb_of_pair] = uc

    pos = np.searchsorted(uniq, bkey)
    kb = kb_of_pair[pos]
    slot_map = (((brow * KB + kb) * B + rows % B) * B + cols % B).astype(np.int64)

    r = np.arange(n_nodes, dtype=np.int64)
    br = r // B
    dkey = br * NB + br
    dpos = np.clip(np.searchsorted(uniq, dkey), 0, uniq.size - 1)
    # rows whose diagonal block is absent (isolated nodes) pin to kb 0
    dkb = np.where(uniq[dpos] == dkey, kb_of_pair[dpos], 0)
    diag_pos = (((br * KB + dkb) * B + r % B) * B + r % B).astype(np.int64)
    return nbr, slot_map, diag_pos, KB


def bell_from_elements(J_c, slot_map, NB: int, KB: int, B: int = BLOCK,
                       out=None):
    """Fold element blocks (c, 3, 3) into (NB, KB, B, B): one segment-sum.

    ``out``: dead values buffer to overwrite in place (lagged-operator
    rebuild; see fem/bcsr.bcsr_from_elements)."""
    flat = J_c.reshape(-1)
    if out is not None:
        vals = (out.reshape(-1) * 0).at[slot_map].add(flat)
    else:
        vals = jax.ops.segment_sum(flat, slot_map,
                                   num_segments=NB * KB * B * B)
    return vals.reshape(NB, KB, B, B)


def bell_matvec(vals, nbr, x, n_nodes: int):
    """y = A x: row-block gather + batched block contraction. No scatter."""
    NB, KB, B, _ = vals.shape
    xpad = jnp.pad(x, (0, NB * B - n_nodes))
    xb = xpad.reshape(NB, B)
    xg = xb[nbr]                                  # (NB, KB, B) row gather
    y = ein("nkij,nkj->ni", vals, xg)             # batched block matmul
    return y.reshape(-1)[:n_nodes]


def bell_diag(vals, diag_pos):
    return vals.reshape(-1)[diag_pos]
