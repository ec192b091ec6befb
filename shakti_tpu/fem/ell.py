"""ELL (padded row-sparse) operator format for scatter-free SpMV.

Why this exists (SURVEY §7 hard part 4): a Krylov loop whose matvec ends in
a 72k-index segment-sum pays a scatter-add every iteration (atomics on the
GPU, serialized updates elsewhere).  Gathers, by contrast, vectorize well
and fuse.  This module restructures
the assembled-operator product so that

  * once per Newton iteration: element Jacobian blocks (c, 3, 3) are folded
    into ELL row storage (n, K) by ONE segment-sum (host-precomputed slot
    mapping), and
  * every CG iteration: y_i = sum_k vals[i, k] * x[cols[i, k]] — a single
    gather plus a row reduction.  No scatter anywhere in the hot loop.

K is the max node degree + 1 (~8 for triangular meshes); padding slots point
at the row's own node and receive zero contributions.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp




def build_ell_map(cells: np.ndarray, n_nodes: int):
    """Host-side: build the ELL sparsity and the element->slot mapping.

    Returns (cols (n, K) int32, slot_map (9 * n_cells,) int32, diag_slot
    (n,) int32): ``slot_map[e]`` is the flat n*K position receiving flat
    element-Jacobian entry e (ordering J_c.reshape(-1): (c, i, j) row-major).
    """
    from shakti_tpu import native
    if native.available():
        nat = native.ell_build(np.asarray(cells, np.int32), n_nodes)
        if nat is not None:
            cols, slot_map, diag_slot, _ = nat
            return cols, slot_map, diag_slot
    c = cells.shape[0]
    # rows[c, i, j] = cells[c, i]; cols_e[c, i, j] = cells[c, j]
    rows = np.broadcast_to(cells[:, :, None], (c, 3, 3))
    cols_e = np.broadcast_to(cells[:, None, :], (c, 3, 3))
    flat_rows = rows.reshape(-1).astype(np.int64)
    flat_cols = cols_e.reshape(-1).astype(np.int64)

    # unique (row, col) pairs, lexicographically sorted (fully vectorized —
    # this must scale to 10M-dof meshes)
    key = flat_rows * n_nodes + flat_cols
    uniq_key = np.unique(key)
    uniq_r = uniq_key // n_nodes
    uniq_c = (uniq_key % n_nodes).astype(np.int32)
    deg = np.bincount(uniq_r, minlength=n_nodes)
    K = int(deg.max())

    # slot index of each unique pair = rank within its row segment
    row_start = np.concatenate([[0], np.cumsum(deg)])
    slot_k = np.arange(uniq_key.size) - row_start[uniq_r]

    cols = np.broadcast_to(np.arange(n_nodes, dtype=np.int32)[:, None],
                           (n_nodes, K)).copy()              # pad = self
    cols[uniq_r, slot_k] = uniq_c

    # map every element entry to its flat n*K slot
    pos = np.searchsorted(uniq_key, key)
    slot_map = (flat_rows * K + slot_k[pos]).astype(np.int32)

    diag_key = np.arange(n_nodes, dtype=np.int64) * (n_nodes + 1)
    diag_pos = np.clip(np.searchsorted(uniq_key, diag_key), 0, uniq_key.size - 1)
    # isolated/padded nodes have no (r, r) entry: pin them to slot 0 (value 0),
    # matching the native builder's *it==key check
    diag_slot = np.where(uniq_key[diag_pos] == diag_key,
                         slot_k[diag_pos], 0).astype(np.int32)
    return cols, slot_map, diag_slot


def ell_from_elements(J_c, slot_map, n_nodes: int, K: int, out=None):
    """Fold element blocks (c, 3, 3) into ELL values (n, K): one segment-sum.

    ``out``: dead values buffer to overwrite in place (lagged-operator
    rebuild; see fem/bcsr.bcsr_from_elements)."""
    flat = J_c.reshape(-1)
    if out is not None:
        vals = (out.reshape(-1) * 0).at[slot_map].add(flat)
    else:
        vals = jax.ops.segment_sum(flat, slot_map, num_segments=n_nodes * K)
    return vals.reshape(n_nodes, K)


def ell_matvec(vals, cols, x):
    """y = A x with A in ELL form — gather + row reduction, scatter-free."""
    return jnp.sum(vals * x[cols], axis=1)


def ell_diag(vals, diag_slot):
    n = vals.shape[0]
    return vals.reshape(-1)[jnp.arange(n) * vals.shape[1] + diag_slot]
