"""Node-sharded SPMD runner: the scalable multi-chip execution path.

Builds on parallel/halo.py: nodes live in P contiguous RCB-localized
chunks, each device holds its owned+ghost view, and the unmodified step
function (solve/timestep.py) runs inside `shard_map` — assembly completes
via halo accumulate (two padded all_to_all per assembly) and Newton/Krylov
reductions via ghost-masked psum'd dots.  Communication is O(partition
boundary) per exchange, vs O(n_nodes) psum in the replicated-node scheme
(parallel/shard.py) — this is the weak-scaling path to 10M+ dof pod runs.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from shakti_tpu.mesh.mesh import Mesh
from shakti_tpu.parallel import halo as H
from shakti_tpu.parallel.shard import make_device_mesh, shard_map
from shakti_tpu.solve.timestep import State, StaticFields, make_step_fn, run_window


def _build_shard_operators(plan, op_l: str, Pn: int, L: int):
    """Per-shard assembled-operator structures, padded to uniform shapes
    across shards (shard_map needs one static shape).  Returns
    (stacked host arrays dict, static meta dict)."""
    local_cells = plan["local_cells"]
    cmax9 = local_cells.shape[1] * 9
    if op_l == "ell":
        from shakti_tpu.fem.ell import build_ell_map
        parts = [build_ell_map(local_cells[p], L) for p in range(Pn)]
        K = max(c.shape[1] for c, _, _ in parts)
        cols = np.empty((Pn, L, K), dtype=np.int32)
        smap = np.empty((Pn, cmax9), dtype=np.int32)
        diag = np.empty((Pn, L), dtype=np.int32)
        for p, (c_p, s_p, d_p) in enumerate(parts):
            Kp = c_p.shape[1]
            cols[p] = np.concatenate(
                [c_p, np.broadcast_to(np.arange(L, dtype=np.int32)[:, None],
                                      (L, K - Kp))], axis=1) if Kp < K else c_p
            # re-stride flat slots from row-stride Kp to row-stride K
            smap[p] = (s_p // Kp) * K + s_p % Kp
            diag[p] = d_p
        return ({"cols": cols.reshape(-1, K), "map": smap.reshape(-1),
                 "diag": diag.reshape(-1)}, {"format": "ell", "K": K})
    if op_l == "bell":
        from shakti_tpu.fem.bell import build_block_ell
        B = 128
        NB = -(-L // B)
        parts = [build_block_ell(local_cells[p], L, B) for p in range(Pn)]
        KBm = max(kb for _, _, _, kb in parts)
        if NB * KBm * B * B >= np.iinfo(np.int32).max:
            raise ValueError(
                f"per-shard block-ELL slot space overflows int32 at "
                f"L={L}; use operator='bcsr' (its 2-D addressing is "
                "int32-safe at any size)")
        nbr = np.empty((Pn, NB, KBm), dtype=np.int32)
        smap = np.empty((Pn, cmax9), dtype=np.int32)
        diag = np.empty((Pn, L), dtype=np.int32)
        BB = B * B
        for p, (nbr_p, s_p, d_p, KBp) in enumerate(parts):
            nbr[p] = np.concatenate(
                [nbr_p, np.broadcast_to(
                    np.arange(NB, dtype=np.int32)[:, None],
                    (NB, KBm - KBp))], axis=1) if KBp < KBm else nbr_p
            restride = lambda s: ((s // BB) // KBp * KBm
                                  + (s // BB) % KBp) * BB + s % BB
            smap[p] = restride(s_p)
            diag[p] = restride(d_p)
        return ({"nbr": nbr.reshape(-1, KBm), "map": smap.reshape(-1),
                 "diag": diag.reshape(-1)},
                {"format": "bell", "B": B, "NB": NB, "KB": KBm})
    if op_l == "bcsr":
        from shakti_tpu.fem.bcsr import build_bcsr
        B = 32 if L <= 6_000_000 else 16
        parts = [build_bcsr(local_cells[p], L, B) for p in range(Pn)]
        NB = parts[0][6]
        nnzb = max(p[0].shape[0] for p in parts)
        brow = np.full((Pn, nnzb), NB - 1, dtype=np.int32)
        bcol = np.zeros((Pn, nnzb), dtype=np.int32)
        blk = np.empty((Pn, cmax9), dtype=np.int32)
        off = np.empty((Pn, cmax9), dtype=np.int32)
        dblk = np.empty((Pn, L), dtype=np.int32)
        doff = np.empty((Pn, L), dtype=np.int32)
        for p, (br, bc, bl, of, db, do, _) in enumerate(parts):
            k = br.shape[0]
            brow[p, :k] = br
            bcol[p, :k] = bc
            blk[p], off[p], dblk[p], doff[p] = bl, of, db, do
        return ({"brow": brow.reshape(-1), "bcol": bcol.reshape(-1),
                 "blk": blk.reshape(-1), "off": off.reshape(-1),
                 "dblk": dblk.reshape(-1), "doff": doff.reshape(-1)},
                {"format": "bcsr", "B": B, "NB": NB, "nnzb": nnzb})
    raise ValueError(f"unknown per-shard operator format '{op_l}'")


def build_distributed(md, jmesh, axis: str = "x"):
    """Partition a frozen model into per-device arrays + halo plan.

    Returns (payload, plan, cfg) where payload is a dict of stacked arrays
    (leading axis P*·, shard_map-ready) and plan the host-side halo plan.
    """
    # capture the USER's coarse_block before freeze(): freeze resolves the
    # None 'auto' sentinel to a global-mesh-sized block (api/model.py),
    # which would make the sentinel test below dead at production scale
    user_blk = md.solver.coarse_block
    mesh, static, state, cfg = md.freeze()
    Pn = jmesh.shape[axis]
    n = mesh.n_nodes
    cells_np = np.asarray(mesh.cells)
    plan = H.build_halo(n, cells_np, Pn)
    # per-shard additive two-level preconditioner (precond.py
    # make_local_two_level) when the user kept the two_level default.
    # coarse_block None is the 'auto' sentinel: size the LOCAL aggregates
    # so each shard's dense coarse problem has a few hundred to ~1k dofs;
    # an explicit int is taken literally.  The lagged-operator carry is
    # not supported on the halo path (per-shard operator rebuilds are
    # cheap relative to the all_to_all traffic anyway).
    blk = user_blk
    if blk is None:
        blk = 8
        while plan["L"] // blk > 1024:
            blk *= 2
    cfg = dataclasses.replace(cfg, coarse_block=blk, lag_operator=False)
    # global coarse aggregates (precond.make_global_two_level): GLOBAL
    # solver-order node id // gblk, localized per shard; one psum'd
    # Galerkin coarse operator replaces the per-shard block-diagonal ones
    gblk = 8
    while n // gblk > 1024:
        gblk *= 2
    coarse_m = -(-n // gblk)
    agg_global = (np.arange(n, dtype=np.int64) // gblk).astype(np.int32)
    dtype = np.asarray(mesh.area).dtype

    # multilevel V-cycle hierarchy (solve/mg.py): the weak-scaling PC.
    # Auto-selected over the global two-level once the mesh is large
    # enough that the hierarchy has intermediate ELL levels — exactly the
    # regime where the single dense coarse stops scaling (r2: 2.7k-4.6k
    # CG iters/step at 10M dof).  Structure is GLOBAL (the coarse levels
    # are replicated); map9/agg_fine are localized per shard below.
    import os
    from shakti_tpu.solve.mg import build_hierarchy
    mg_plan = None
    if os.environ.get("SHAKTI_DIST_MG", "1") == "0":
        pass    # measurement hook: force the plain global two-level PC
    elif cfg.precond in ("two_level", "mg"):
        cand = build_hierarchy(cells_np, n, agg=cfg.mg_agg,
                               cap=cfg.mg_coarse_cap)
        if cand is not None and (cfg.precond == "mg" or len(cand.cols) > 0):
            mg_plan = cand
            cfg = dataclasses.replace(cfg, precond="mg")

    cell_ids = plan["cell_ids"]                       # (P, cmax)
    loc = lambda f: H.localize_nodal(plan, np.asarray(f))
    L = plan["L"]

    # global node id per local slot (owned + ghost; dead slots alias node 0
    # with live_mask False).  Stored on the plan as the DIFFERENTIABLE
    # localization map: `f_global[glob_ids.reshape(-1)] * live_mask` is a
    # jnp gather producing the stacked (P*L,) layout, whose AD transpose
    # scatter-ADDS ghost cotangents back into their global dofs — the
    # field-control inversion path (make_distributed_runner control=...).
    glob_ids = np.zeros((Pn, L), dtype=np.int64)
    live = np.zeros((Pn, L), dtype=bool)
    for p in range(Pn):
        s = plan["starts"][p]
        glob_ids[p, :plan["sizes"][p]] = np.arange(s, s + plan["sizes"][p])
        live[p, :plan["sizes"][p]] = True
        gl = np.where(plan["g2l"][p] >= plan["omax"])[0]
        glob_ids[p, plan["g2l"][p][gl]] = gl
        live[p, plan["g2l"][p][gl]] = True
    plan["glob_ids"] = glob_ids
    plan["live_mask"] = live

    # Per-shard assembled-operator format on the local numbering (Krylov
    # matvecs become local gather/matmul work + one halo accumulate,
    # instead of cell gather + element matvec + scatter per iteration).
    # Format follows the single-device auto rule (scalar ELL);
    # md.operator = 'bell' / 'bcsr' selects a blocked format.
    user_op = getattr(md, "operator", "auto")
    op_l = user_op if user_op in ("ell", "bell", "bcsr") else "ell"
    op_payload, op_meta = _build_shard_operators(plan, op_l, Pn, L)

    payload = {
        # cell data, (P*cmax, ...)
        "cells": plan["local_cells"].reshape(-1, 3).astype(np.int32),
        "area": (np.asarray(mesh.area)[cell_ids]
                 * plan["cell_valid"]).reshape(-1).astype(dtype),
        "grads": np.asarray(mesh.grads)[cell_ids].reshape(-1, 3, 2),
        "valid": plan["cell_valid"].reshape(-1).astype(dtype),
        "gb0": np.asarray(static.gb0)[cell_ids].reshape(-1, 2),
        # nodal data, (P*L, ...)
        "nodes": loc(mesh.nodes).reshape(-1, 2),
        "node_area": loc(mesh.node_area).reshape(-1),
        "z_b": loc(static.z_b).reshape(-1),
        "z_s": loc(static.z_s).reshape(-1),
        "G": loc(static.G).reshape(-1),
        "inputs": loc(static.inputs).reshape(-1),
        "storage": loc(static.storage).reshape(-1),
        "dirichlet": loc(np.asarray(static.dirichlet)).reshape(-1),
        "N0": loc(state.N).reshape(-1),
        "Nprev0": loc(state.N_prev if state.N_prev is not None
                      else state.N).reshape(-1),
        "b0": loc(state.b).reshape(-1),
        "q0": loc(state.q).reshape(-1, 2),
        "melt0": loc(state.melt).reshape(-1),
        # per-shard assembled-operator structure (stacked, format-specific)
        "op": op_payload,
        "coarse_agg": loc(agg_global).reshape(-1).astype(np.int32),
        # halo plan, (P*P, H) / (P*L,)
        "send_idx": plan["send_idx"].reshape(-1, plan["send_idx"].shape[-1]),
        "send_valid": plan["send_valid"].reshape(-1, plan["send_valid"].shape[-1]),
        "recv_slot": plan["recv_slot"].reshape(-1, plan["recv_slot"].shape[-1]),
        "owned_mask": plan["owned_mask"].reshape(-1).astype(dtype),
        # scalars
        "N_bdry": np.asarray(static.N_bdry),
        "b_min": np.asarray(static.b_min),
    }
    if mg_plan is not None:
        c = cells_np.shape[0]
        # per-shard localization: element entries -> global level-1 slots
        # (padding cells alias cell 0's slots but carry zero Jacobians)
        map9_g = np.asarray(mg_plan.map9).reshape(c, 9)
        payload["mg_map9"] = map9_g[cell_ids].reshape(-1, 9)  # (P*cmax, 9)
        payload["mg_agg_fine"] = (glob_ids // cfg.mg_agg).astype(
            np.int32).reshape(-1)                             # (P*L,)
    plan["coarse_m"] = coarse_m
    plan["mg_plan"] = mg_plan
    plan["op_meta"] = op_meta
    return payload, plan, cfg


def _make_local_model(plan, axis):
    """Closure rebuilding the per-shard (Mesh, StaticFields) pair inside a
    shard_map body from one shard's slice of every planned array — shared
    by the transient and steady distributed runners."""
    coarse_m = plan["coarse_m"]
    mg_plan = plan["mg_plan"]
    op_meta = plan["op_meta"]
    omax = int(plan["omax"])

    def local_model(cells, area, grads, valid, gb0,
                    nodes, node_area, z_b, z_s, G, inputs, storage,
                    dirichlet, op_l, coarse_agg_l,
                    send_idx, send_valid, recv_slot, owned_mask,
                    mg_sharded, mg_rep, N_bdry, b_min):
        halo = H.Halo(send_idx=send_idx, send_valid=send_valid,
                      recv_slot=recv_slot, owned_mask=owned_mask, axis=axis,
                      omax=omax)
        mg_local = None
        if mg_plan is not None:
            from shakti_tpu.solve.mg import MGPlan
            mg_local = MGPlan(map9=mg_sharded["map9"].reshape(-1),
                              agg_fine=mg_sharded["agg_fine"],
                              cols=mg_rep[0], diag_slot=mg_rep[1],
                              next_map=mg_rep[2],
                              m_c=mg_plan.m_c, agg=mg_plan.agg)
        fmt = op_meta["format"]
        op_fields = {}
        if fmt == "ell":
            op_fields = dict(ell_cols=op_l["cols"], ell_map=op_l["map"],
                             ell_diag_slot=op_l["diag"])
        elif fmt == "bell":
            op_fields = dict(bell_nbr=op_l["nbr"], bell_map=op_l["map"],
                             bell_diag_pos=op_l["diag"],
                             bell_B=op_meta["B"])
        elif fmt == "bcsr":
            op_fields = dict(bcsr_brow=op_l["brow"], bcsr_bcol=op_l["bcol"],
                             bcsr_blk=op_l["blk"], bcsr_off=op_l["off"],
                             bcsr_diag_blk=op_l["dblk"],
                             bcsr_diag_off=op_l["doff"],
                             bcsr_B=op_meta["B"], bcsr_NB=op_meta["NB"])
        lmesh = Mesh(nodes=nodes, cells=cells, area=area, grads=grads,
                     node_area=node_area, cell_valid=valid, halo=halo,
                     coarse_agg=coarse_agg_l, coarse_m=coarse_m,
                     mg=mg_local, **op_fields)
        lstatic = StaticFields(z_b=z_b, z_s=z_s, G=G, inputs=inputs,
                               storage=storage, gb0=gb0,
                               dirichlet=dirichlet.astype(bool),
                               N_bdry=N_bdry, b_min=b_min)
        return lmesh, lstatic

    return local_model


def _mp_placers(jmesh, axis):
    """Multi-process global-array placement (utils/multihost.py launches).

    Every process holds the FULL payload host-side (the setup runs
    replicated, like the reference's per-rank initialize()), but
    shard_map over the GLOBAL device mesh needs global jax.Arrays —
    plain jnp.asarray would commit to local devices only and fail the
    jit device-set check.  Returns (put_sharded, put_replicated), each
    mapping a host pytree leaf to a global array; identity-free (always
    rebuilds), so call once at setup and per forcing window only."""
    from jax.sharding import NamedSharding

    def put(leaf, spec):
        h = np.asarray(leaf)
        sh = NamedSharding(jmesh, spec if h.ndim else P())
        return jax.make_array_from_callback(h.shape, sh, lambda i: h[i])

    return put, (lambda tree: jax.tree_util.tree_map(
        lambda l: put(l, P()), tree))


def _mp_globalize_args(jmesh, axis, args, state0):
    """Re-place the 23 assembled runner arguments + initial state as
    global arrays matching the runner's in_specs (see body signature)."""
    pl, rep = P(axis), P()
    specs = ([pl] * 5 + [pl] * 8 + [pl, pl] + [pl] * 4 + [pl, rep]
             + [rep, rep])
    assert len(args) == len(specs), "args layout changed — update specs"
    put, _ = _mp_placers(jmesh, axis)
    args = [jax.tree_util.tree_map(lambda l, s=s: put(l, s), a)
            for a, s in zip(args, specs)]
    state0 = jax.tree_util.tree_map(lambda l: put(l, pl), state0)
    return args, state0


def _assemble_args(payload, mg_plan, dtype):
    """Device arrays for the shard_map body's model arguments (everything
    before the marching state), plus the stacked initial state."""
    ar = lambda k, dt=None: jnp.asarray(payload[k], dtype=dt)
    state0 = State(N=ar("N0", dtype), b=ar("b0", dtype),
                   q=ar("q0", dtype), melt=ar("melt0", dtype),
                   N_prev=ar("Nprev0", dtype))
    args = ([ar(k) if k == "cells" else ar(k, dtype) for k in ("cells",)]
            + [ar("area", dtype), ar("grads", dtype), ar("valid", dtype),
               ar("gb0", dtype)]
            + [ar("nodes", dtype), ar("node_area", dtype), ar("z_b", dtype),
               ar("z_s", dtype), ar("G", dtype), ar("inputs", dtype),
               ar("storage", dtype), ar("dirichlet", dtype)]
            + [{k: jnp.asarray(v) for k, v in payload["op"].items()},
               jnp.asarray(payload["coarse_agg"])]
            + [jnp.asarray(payload["send_idx"]),
               jnp.asarray(payload["send_valid"]),
               jnp.asarray(payload["recv_slot"]), ar("owned_mask", dtype)]
            + [{"map9": jnp.asarray(payload["mg_map9"]),
                "agg_fine": jnp.asarray(payload["mg_agg_fine"])}
               if mg_plan is not None else {},
               (mg_plan.cols, mg_plan.diag_slot, mg_plan.next_map)
               if mg_plan is not None else ((), (), ())]
            + [ar("N_bdry", dtype), ar("b_min", dtype)])
    return args, state0


def make_distributed_steady_runner(md, jmesh=None, axis: str = "x",
                                   cycle_window: int = 0, **steady_kw):
    """(runner, state0_stacked, plan): runner(state) -> (state, info) —
    the pseudo-transient steady-state solve (solve/steady.py) on the
    node-sharded halo path.  One device program: the SER/PTC while-loop
    runs under shard_map with ghost-masked psum norms, so acceptance,
    convergence, and the global dt cap are identical decisions on every
    shard.  ``steady_kw`` forwards to :func:`steady_solve` (tol, dt0,
    max_steps, ...); info scalars come back replicated.  With
    ``cycle_window > 0`` the plan also carries ``plan["cycle_run"]``:
    (state_stacked, dt) -> (mean_state_stacked, info) running
    :func:`solve.steady.cycle_certify` under the same shard_map (psum'd
    norms keep the certificate shard-consistent)."""
    jmesh = jmesh or make_device_mesh()
    payload, plan, cfg = build_distributed(md, jmesh, axis)
    params = md.params
    from shakti_tpu.solve.steady import (cycle_certify, make_steady_step,
                                         steady_solve)

    pl = P(axis)
    rep = P()
    local_model = _make_local_model(plan, axis)

    def body(cells, area, grads, valid, gb0,
             nodes, node_area, z_b, z_s, G, inputs, storage, dirichlet,
             op_l, coarse_agg_l,
             send_idx, send_valid, recv_slot, owned_mask,
             mg_sharded, mg_rep,
             N_bdry, b_min, state):
        lmesh, lstatic = local_model(
            cells, area, grads, valid, gb0, nodes, node_area, z_b, z_s, G,
            inputs, storage, dirichlet, op_l, coarse_agg_l, send_idx,
            send_valid, recv_slot, owned_mask, mg_sharded, mg_rep,
            N_bdry, b_min)
        step, _ = make_steady_step(lmesh, lstatic, params, cfg)
        # N-pinned nodes leave the drift certificate (api/steady.py has
        # the rationale); steady_solve composes this with the owned mask
        return steady_solve(step, state, mesh=lmesh, params=params,
                            drift_mask=~lstatic.dirichlet, **steady_kw)

    sharded = shard_map(
        body, mesh=jmesh,
        in_specs=(pl,) * 5 + (pl,) * 8 + (pl, pl) + (pl,) * 4
                 + (pl, rep) + (rep, rep, pl),
        out_specs=(pl, rep),
        check_vma=not cfg.differentiable,
    )

    args, state0 = _assemble_args(payload, plan["mg_plan"], md.dtype)

    sharded_cycle = None
    if cycle_window:
        def body_cycle(*a):
            state, dt = a[-2], a[-1]
            lmesh, lstatic = local_model(*a[:-2])
            step, _ = make_steady_step(lmesh, lstatic, params, cfg)
            return cycle_certify(
                step, state, params=params, dt=dt,
                tol=steady_kw.get("tol", 1e-2),
                t_ref=steady_kw.get("t_ref", 3.1536e7),
                window=cycle_window,
                max_rel_change=steady_kw.get("max_rel_change", 0.5),
                drift_mask=~lstatic.dirichlet, mesh=lmesh)

        sharded_cycle = shard_map(
            body_cycle, mesh=jmesh,
            in_specs=(pl,) * 5 + (pl,) * 8 + (pl, pl) + (pl,) * 4
                     + (pl, rep) + (rep, rep, pl, rep),
            out_specs=(pl, rep),
            check_vma=not cfg.differentiable,
        )

    if jax.process_count() > 1:
        args, state0 = _mp_globalize_args(jmesh, axis, args, state0)

        @jax.jit
        def _runner_mp(a, state):
            return sharded(*a, state)

        runner = lambda state: _runner_mp(args, state)
        if sharded_cycle is not None:
            _cyc_mp = jax.jit(lambda a, s, dt: sharded_cycle(*a, s, dt))
            plan["cycle_run"] = lambda s, dt: _cyc_mp(args, s, dt)
    else:
        @jax.jit
        def runner(state):
            return sharded(*args, state)

        if sharded_cycle is not None:
            plan["cycle_run"] = jax.jit(
                lambda s, dt: sharded_cycle(*args, s, dt))

    return runner, state0, plan


def make_distributed_runner(md, jmesh=None, axis: str = "x",
                            control: str | None = None):
    """(runner, state0_stacked, plan): runner(state, dts) -> (state, diags)
    with state arrays stacked (P*L, ...) and diags replicated.

    ``control``: optionally expose one nodal static field ("inputs", "G",
    or "storage" — fields with no freeze-time derived precomputes) as a
    runtime argument instead of a baked-in constant: the runner signature
    becomes runner(field_stacked, state, dts) with field_stacked in the
    same (P*L,) layout as the state arrays.  Combined with
    cfg.differentiable this is the DISTRIBUTED field-inversion path: build
    the stacked field inside the loss as
    ``f_global[plan['glob_ids'].reshape(-1)] * plan['live_mask']`` (a jnp
    gather), and reverse-mode AD scatter-adds each shard's ghost-slot
    cotangents back into the global control dofs."""
    jmesh = jmesh or make_device_mesh()
    payload, plan, cfg = build_distributed(md, jmesh, axis)
    params = md.params

    pl = P(axis)
    rep = P()

    local_model = _make_local_model(plan, axis)

    def body(cells, area, grads, valid, gb0,
             nodes, node_area, z_b, z_s, G, inputs, storage, dirichlet,
             op_l, coarse_agg_l,
             send_idx, send_valid, recv_slot, owned_mask,
             mg_sharded, mg_rep,
             N_bdry, b_min, state, dts):
        lmesh, lstatic = local_model(
            cells, area, grads, valid, gb0, nodes, node_area, z_b, z_s, G,
            inputs, storage, dirichlet, op_l, coarse_agg_l, send_idx,
            send_valid, recv_slot, owned_mask, mg_sharded, mg_rep,
            N_bdry, b_min)
        step = make_step_fn(lmesh, lstatic, params, cfg)
        return run_window(step, state, dts)

    sharded = shard_map(
        body, mesh=jmesh,
        in_specs=(pl,) * 5 + (pl,) * 8 + (pl, pl) + (pl,) * 4
                 + (pl, rep)
                 + (rep, rep, pl, rep),
        out_specs=(pl, rep),
        # vma tracking cannot type custom_vjp cotangents (see
        # parallel/shard.py) — the differentiable path needs the legacy
        # transpose; keep the check on for the plain production runner
        check_vma=not cfg.differentiable,
    )

    args, state0 = _assemble_args(payload, plan["mg_plan"], md.dtype)

    _mp = jax.process_count() > 1
    if _mp:
        args, state0 = _mp_globalize_args(jmesh, axis, args, state0)
        _put, _rep_tree = _mp_placers(jmesh, axis)
        # api/run.py resume path: checkpointed global host state ->
        # localized stacked host arrays -> global sharded placement
        plan["place_state"] = lambda tree: jax.tree_util.tree_map(
            lambda l: _put(l, pl), tree)
    else:
        _rep_tree = lambda tree: tree
        plan["place_state"] = lambda tree: tree

    if control is None:
        if _mp:
            # multi-process: global arrays spanning non-addressable
            # devices cannot be closed over — pass them as arguments.
            # (Single-process keeps the closure-constant pattern: XLA
            # folds/dedupes constants, see api/model.make_runner.)
            @jax.jit
            def _runner_mp(a, state, dts):
                return sharded(*a, state, dts)

            def runner(state, dts):
                return _runner_mp(args, state, _rep_tree(dts))
        else:
            @jax.jit
            def runner(state, dts):
                return sharded(*args, state, dts)

        # Grouped save-window execution — the dist twin of api/run.py's
        # run_group (replaces the reference's per-save rank-0 gather
        # funnel, solvers.py:205-215): scan g consecutive equal-length
        # save windows inside ONE device program, emitting per window a
        # packed row of OWNED state slots (4*omax) + diagnostics
        # (4*wlen), so the host pulls a single (g, P*(4*omax+4*wlen))
        # array per GROUP instead of one full-global gather_state per
        # window.  At 10M dof the per-window gather is ~160 MB of
        # device->host traffic per save — the host chatter the
        # single-device path's grouped runner also avoids.
        omax = int(plan["omax"])

        def body_g(*a):
            state_in, f_grp = a[-2], a[-1]
            lmesh, lstatic = local_model(*a[:-2])
            step = make_step_fn(lmesh, lstatic, params, cfg)

            def gbody(s, f_win):
                s, diags = run_window(step, s, f_win)
                dt_ = s.N.dtype
                row = jnp.concatenate(
                    [s.N[:omax], s.b[:omax],
                     s.q[:omax, 0], s.q[:omax, 1],
                     diags["converged"].astype(dt_),
                     diags["newton_iters"].astype(dt_),
                     diags["cg_iters"].astype(dt_),
                     diags["rnorm"].astype(dt_)])
                return s, row

            return jax.lax.scan(gbody, state_in, f_grp)

        sh_group = shard_map(
            body_g, mesh=jmesh,
            in_specs=(pl,) * 5 + (pl,) * 8 + (pl, pl) + (pl,) * 4
                     + (pl, rep) + (rep, rep, pl, rep),
            out_specs=(pl, P(None, axis)),
            check_vma=not cfg.differentiable)
        if _mp:
            _run_group = jax.jit(lambda a, s, f: sh_group(*a, s, f))
            run_group = lambda s, f: _run_group(args, s, _rep_tree(f))
        else:
            _run_group = jax.jit(lambda s, f: sh_group(*args, s, f))
            run_group = lambda s, f: _run_group(s, f)

        # host-side stitch indices: global solver-order node i is owned
        # by shard own_p[i] at local slot own_slot[i] (owned slots are
        # the contiguous RCB ranges [starts[p], starts[p]+sizes[p]))
        n_nodes = int(plan["sizes"].sum())
        own_p = (np.searchsorted(plan["starts"], np.arange(n_nodes),
                                 side="right") - 1).astype(np.int64)
        plan["group"] = {
            "run": run_group, "omax": omax, "own_p": own_p,
            "own_slot": np.arange(n_nodes) - plan["starts"][own_p],
        }
    else:
        # positional index of the field in body(...)/args — nodal fields
        # only, and only those without freeze-time derived precomputes
        # (z_b/z_s are excluded: gb0 is computed from them at freeze)
        ctrl_idx = {"G": 9, "inputs": 10, "storage": 11}
        if control not in ctrl_idx:
            raise ValueError(f"control must be one of {set(ctrl_idx)}, "
                             f"got '{control}'")
        ci = ctrl_idx[control]
        assert len(args) == 23, "args layout changed — update ctrl_idx"

        @jax.jit
        def runner(field, state, dts):
            a = list(args)
            a[ci] = field
            return sharded(*a, state, dts)

    return runner, state0, plan


def gather_state(plan, state_stacked: State) -> State:
    """Stacked (P*L, ...) state -> global solver-order arrays.

    Under multi-process execution the stacked arrays are global (not
    fully addressable): to_host runs one allgather collective, so every
    process must reach this call — api/run.py's SPMD host loop does."""
    from shakti_tpu.utils.multihost import to_host
    Pn, L = plan["P"], plan["L"]
    g = lambda a: jnp.asarray(
        H.globalize_nodal(plan, to_host(a).reshape((Pn, L) + a.shape[1:])))
    return State(N=g(state_stacked.N), b=g(state_stacked.b),
                 q=g(state_stacked.q), melt=g(state_stacked.melt),
                 N_prev=g(state_stacked.N_prev))
