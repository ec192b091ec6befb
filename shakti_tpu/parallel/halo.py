"""Node-sharded domain decomposition with explicit halo exchange.

The scalable multi-chip scheme (parallel v2; v1 in shard.py replicates
nodal state).  Mirrors the reference's owned/ghost dof layout
(DOLFINx index_map + scatter_forward/ghost-accumulate, SURVEY §2b,2d),
re-shaped for SPMD jax:

  * nodes are partitioned into P contiguous chunks of the solver ordering
    (RCB-localized, so chunks are spatially compact);
  * a cell lives on the lowest-ranked device owning one of its nodes; the
    other devices' nodes it references become ghosts there;
  * each device's local index space is [owned | ghosts | 1 dump slot];
  * two collectives, built on one padded `all_to_all` each:
      - ``push``:       owner -> ghost copy (reference scatter_forward),
      - ``accumulate``: ghost -> owner add, then push (reference's
        assembly ghost accumulate);
  * reductions mask ghosts and `psum` over the mesh axis (the Krylov
    dot-product allreduces of SURVEY §2d — scalars only).

Communication volume per exchange: O(partition boundary), padded to the
max across device pairs (static shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from shakti_tpu.fem.ops import vdot


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Halo:
    """Per-device halo-exchange plan (leaves are the LOCAL device's slices
    inside shard_map; built stacked on host by build_halo)."""

    send_idx: Any     # (P, H) int32: local OWNED indices to send to each dest
    send_valid: Any   # (P, H) bool
    recv_slot: Any    # (P, H) int32: local slots receiving from each source
                      #   (pad -> dump slot)
    owned_mask: Any   # (L,) float: 1.0 for owned slots, 0 for ghosts/pad/dump
    axis: str | None = dataclasses.field(default=None,
                                         metadata=dict(static=True))
    # Owned-slot count (max across shards; ghost slots start here in every
    # shard's local numbering).  Enables accumulate_split — the
    # communication/compute-overlapped assembly completion.  None disables.
    omax: int | None = dataclasses.field(default=None,
                                         metadata=dict(static=True))

    @property
    def n_local(self) -> int:
        return self.owned_mask.shape[0]

    # ---------------------------------------------------------- collectives
    def push(self, x):
        """Owner -> ghost copy (reference scatter_forward)."""
        valid = self.send_valid.reshape(
            self.send_valid.shape + (1,) * (x.ndim - 1))
        buf = jnp.where(valid, x[self.send_idx], 0.0)
        recv = jax.lax.all_to_all(buf, self.axis, 0, 0, tiled=True)
        return x.at[self.recv_slot.reshape((-1,))].set(
            recv.reshape((-1,) + x.shape[1:]))

    def accumulate(self, x):
        """Ghost contributions -> owner add, then refresh ghosts (the
        assembly pattern: segment-sum locally, call this, done)."""
        P, H = self.recv_slot.shape
        # gather ghost-slot values to send back to their owners
        buf = x[self.recv_slot.reshape((-1,))].reshape(
            (P, H) + x.shape[1:])
        back = jax.lax.all_to_all(buf, self.axis, 0, 0, tiled=True)
        back = jnp.where(self.send_valid.reshape(
            self.send_valid.shape + (1,) * (x.ndim - 1)), back, 0.0)
        x = x.at[self.send_idx.reshape((-1,))].add(
            back.reshape((-1,) + x.shape[1:]), mode="drop")
        # zero the ghost slots, then push fresh owner values into them
        x = x * self.owned_mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return self.push(x)

    def accumulate_split(self, y_lo, y_hi):
        """accumulate(concat(y_lo, y_hi)), restructured for communication/
        compute overlap: the ghost-return all_to_all depends ONLY on the
        (small) ``y_hi`` piece — rows [split, L) where split = y_lo rows —
        so XLA's latency-hiding scheduler can run it concurrently with the
        (large) owned-row compute producing ``y_lo``.  Requires
        split <= omax (every recv slot lies in the hi piece); bit-identical
        results to the unsplit accumulate.
        """
        split = y_lo.shape[0]
        P, Hn = self.recv_slot.shape
        rs = self.recv_slot.reshape((-1,)) - split     # >= 0: ghosts/dump
        buf = y_hi[rs].reshape((P, Hn) + y_hi.shape[1:])
        back = jax.lax.all_to_all(buf, self.axis, 0, 0, tiled=True)
        back = jnp.where(self.send_valid.reshape(
            self.send_valid.shape + (1,) * (y_hi.ndim - 1)), back, 0.0)
        y = jnp.concatenate([y_lo, y_hi])
        y = y.at[self.send_idx.reshape((-1,))].add(
            back.reshape((-1,) + y.shape[1:]), mode="drop")
        y = y * self.owned_mask.reshape((-1,) + (1,) * (y.ndim - 1))
        return self.push(y)

    # ------------------------------------------------------------ reductions
    def dot(self, a, b):
        m = self.owned_mask.reshape((-1,) + (1,) * (a.ndim - 1))
        local = vdot(a * m, b)
        return jax.lax.psum(local, self.axis)

    def norm(self, a):
        return jnp.sqrt(self.dot(a, a))


def build_halo(n_nodes: int, cells: np.ndarray, n_parts: int):
    """Host-side halo-plan construction from contiguous node chunks.

    Returns a dict with per-device arrays (stacked on axis 0) and sizes:
      owners (P,): chunk sizes; L: local size (owned_max + ghost_max + 1);
      cell_part (c,): device owning each cell;
      local_cells (P, cmax, 3): cells in local numbering (padded);
      cell_valid (P, cmax): validity;
      g2l (P, n_nodes): global->local map per device (or -1);
      send_idx/send_valid/recv_slot: exchange plan;
      local_owned (P,): owned count per device (== chunk size);
      owned_mask (P, L).
    """
    P = n_parts
    chunk = -(-n_nodes // P)
    starts = np.minimum(np.arange(P) * chunk, n_nodes)
    ends = np.minimum(starts + chunk, n_nodes)
    sizes = ends - starts
    owner_of = np.minimum(np.arange(n_nodes) // chunk, P - 1)

    cell_owner = owner_of[cells].min(axis=1)

    # ghosts per device
    ghosts = [[] for _ in range(P)]
    for p in range(P):
        cp = cells[cell_owner == p]
        refs = np.unique(cp)
        gh = refs[(refs < starts[p]) | (refs >= ends[p])]
        ghosts[p] = gh
    gmax = max((g.size for g in ghosts), default=0)
    omax = int(sizes.max())
    L = omax + gmax + 1                      # +1 dump slot

    # local numbering: owned (global - start), ghosts appended in order
    g2l = -np.ones((P, n_nodes), dtype=np.int64)
    for p in range(P):
        g2l[p, starts[p]:ends[p]] = np.arange(sizes[p])
        g2l[p, ghosts[p]] = omax + np.arange(ghosts[p].size)

    # local cells
    cmax = int(np.bincount(cell_owner, minlength=P).max())
    local_cells = np.zeros((P, cmax, 3), dtype=np.int32)
    cell_ids = np.zeros((P, cmax), dtype=np.int64)
    cell_valid = np.zeros((P, cmax), dtype=bool)
    for p in range(P):
        ids = np.where(cell_owner == p)[0]
        local_cells[p, :ids.size] = g2l[p][cells[ids]]
        cell_ids[p, :ids.size] = ids
        cell_valid[p, :ids.size] = True

    # exchange plan: device q sends owned values of nodes that are ghosts
    # on p.  all_to_all semantics: send chunk d of device q's buffer -> becomes
    # chunk q of device d's receive buffer.
    need = [[np.empty(0, np.int64)] * P for _ in range(P)]
    for p in range(P):
        gh = ghosts[p]
        src = owner_of[gh]
        for q in range(P):
            need[p][q] = gh[src == q]        # global ids p needs from q
    H = max((need[p][q].size for p in range(P) for q in range(P)), default=0)
    H = max(H, 1)
    send_idx = np.zeros((P, P, H), dtype=np.int32)
    send_valid = np.zeros((P, P, H), dtype=bool)
    recv_slot = np.full((P, P, H), L - 1, dtype=np.int32)   # pad -> dump
    for q in range(P):
        for p in range(P):
            ids = need[p][q]                 # q sends these to p
            k = ids.size
            send_idx[q, p, :k] = (ids - starts[q])
            send_valid[q, p, :k] = True
            recv_slot[p, q, :k] = g2l[p][ids]

    owned_mask = np.zeros((P, L))
    for p in range(P):
        owned_mask[p, :sizes[p]] = 1.0

    return {
        "P": P, "L": L, "omax": omax, "starts": starts, "sizes": sizes,
        "owner_of": owner_of, "cell_owner": cell_owner, "g2l": g2l,
        "local_cells": local_cells, "cell_ids": cell_ids,
        "cell_valid": cell_valid,
        "send_idx": send_idx, "send_valid": send_valid,
        "recv_slot": recv_slot, "owned_mask": owned_mask,
    }


def localize_nodal(plan: dict, f: np.ndarray):
    """Global nodal array -> stacked local arrays (P, L, ...), ghosts filled."""
    P, L = plan["P"], plan["L"]
    out = np.zeros((P, L) + f.shape[1:], dtype=f.dtype)
    for p in range(P):
        s, e = plan["starts"][p], plan["starts"][p] + plan["sizes"][p]
        out[p, :plan["sizes"][p]] = f[s:e]
        gl = np.where(plan["g2l"][p] >= plan["omax"])[0]
        out[p, plan["g2l"][p][gl]] = f[gl]
    return out


def globalize_nodal(plan: dict, local: np.ndarray):
    """Stacked local arrays (P, L, ...) -> global (n, ...), owned slices."""
    n = plan["owner_of"].shape[0]
    out = np.zeros((n,) + local.shape[2:], dtype=local.dtype)
    for p in range(P := plan["P"]):
        s = plan["starts"][p]
        out[s:s + plan["sizes"][p]] = local[p, :plan["sizes"][p]]
    return out
