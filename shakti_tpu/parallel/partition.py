"""Host-side mesh partitioning: recursive coordinate bisection (RCB).

Replaces the graph partitioner hidden inside the reference's parallel mesh
read (gmshio/ParMETIS, reference setup_cooke2.py:19, SURVEY §2b): a
deterministic geometric partitioner assigning cells to devices with balanced
counts and spatially-compact parts (compact parts minimize the node set each
shard touches, which is what matters for the sharded-assembly collectives).
"""

from __future__ import annotations

import numpy as np


def rcb_partition(points: np.ndarray, n_parts: int) -> np.ndarray:
    """Assign each point (m, 2) to one of ``n_parts`` parts by recursive
    coordinate bisection.  Deterministic; part sizes differ by at most 1."""
    points = np.asarray(points, dtype=np.float64)
    from shakti_tpu import native
    nat = native.rcb_partition(points, n_parts) if native.available() else None
    if nat is not None:
        return nat
    m = points.shape[0]
    part = np.zeros(m, dtype=np.int32)

    def split(idx: np.ndarray, parts: int, base: int):
        if parts == 1 or idx.size == 0:
            part[idx] = base
            return
        p_lo = parts // 2
        # half-up rounding (matches the native llround)
        n_lo = int(np.floor(idx.size * p_lo / parts + 0.5))
        pts = points[idx]
        axis = 0 if (pts[:, 0].max() - pts[:, 0].min()
                     >= pts[:, 1].max() - pts[:, 1].min()) else 1
        order = np.argsort(pts[:, axis], kind="stable")
        split(idx[order[:n_lo]], p_lo, base)
        split(idx[order[n_lo:]], parts - p_lo, base + p_lo)

    split(np.arange(m), n_parts, 0)
    return part


def rcb_order(points: np.ndarray, leaf: int = 32) -> np.ndarray:
    """Spatial ordering by recursive coordinate bisection: a permutation that
    makes spatially-close points contiguous.  Used to renumber mesh nodes so
    fixed-size node blocks (block-ELL operator, fem/bell.py) are compact —
    compact blocks minimize the block-sparsity fill and hence the block SpMV's
    memory traffic."""
    points = np.asarray(points, dtype=np.float64)
    from shakti_tpu import native
    nat = native.rcb_order(points, leaf) if native.available() else None
    if nat is not None:
        return nat
    out = []

    def rec(idx):
        if idx.size <= leaf:
            out.append(idx)
            return
        pts = points[idx]
        axis = 0 if (pts[:, 0].max() - pts[:, 0].min()
                     >= pts[:, 1].max() - pts[:, 1].min()) else 1
        order = np.argsort(pts[:, axis], kind="stable")
        h = idx.size // 2
        rec(idx[order[:h]])
        rec(idx[order[h:]])

    rec(np.arange(points.shape[0]))
    return np.concatenate(out)


def partition_cells(nodes: np.ndarray, cells: np.ndarray, n_parts: int):
    """Partition cells by RCB on centroids.

    Returns (order, counts): ``order`` is a cell permutation grouping cells
    by part (part 0 first), ``counts[p]`` the number of cells in part p.
    """
    centroids = nodes[cells].mean(axis=1)
    part = rcb_partition(centroids, n_parts)
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=n_parts)
    return order, counts


def pad_to_blocks(order: np.ndarray, counts: np.ndarray, pad_cell: int = -1):
    """Pad each part's cell list to the max part size so shards share one
    static shape.  Returns (padded_idx (n_parts, block), valid mask)."""
    n_parts = counts.size
    block = int(counts.max())
    idx = np.full((n_parts, block), 0, dtype=np.int64)
    valid = np.zeros((n_parts, block), dtype=bool)
    off = 0
    for p in range(n_parts):
        c = int(counts[p])
        idx[p, :c] = order[off:off + c]
        valid[p, :c] = True
        off += c
    return idx, valid
