"""Transient driver + results IO: the `solvers.solve(md)` equivalent.

Reproduces the reference's run protocol (reference solvers.py:57-238):

  * results directory must not pre-exist (solvers.py:91-102) — unless resuming;
  * writes t.npy, nodes_x.npy, nodes_y.npy up front (solvers.py:119-121);
  * copies the setup file into the results dir for provenance (:123-125);
  * saves nodal N/b/qx/qy history rows after step i whenever
    i % nt_save == 0 (:199-215), with rolling checkpoint writes of the
    accumulated arrays every nt_check steps (:217-223) and a final write
    (:231-236);
  * aborts on Newton non-convergence (the reference's `assert converged`,
    :179-180) — here raised host-side from the in-graph flag.

Differences: steps run in `lax.scan` windows that end exactly at
save events (1 device launch per save interval instead of per-step host
chatter), per-step solver diagnostics are recorded to log.csv, and a real
resume checkpoint is written alongside (shakti_tpu.io.checkpoint — the
reference cannot resume, SURVEY §5).
"""

from __future__ import annotations

import os
import shutil
import time

import jax
import numpy as np

from shakti_tpu.io import checkpoint as ckpt
from shakti_tpu.solve.timestep import (make_forcing, make_step_fn,
                                       run_window)
from shakti_tpu.utils.multihost import to_host


class ConvergenceError(RuntimeError):
    pass


def _save_windows(nt: int, nt_save: int, start: int):
    """Yield (start, length, save_after) covering steps [start, nt) with
    windows ending at save events (i % nt_save == 0 saves AFTER step i)."""
    i = start
    while i < nt:
        r = i % nt_save
        nxt = i if r == 0 else i + (nt_save - r)
        if nxt >= nt:
            yield i, nt - i, False
            return
        yield i, nxt - i + 1, True
        i = nxt + 1


def _ck_due(i0: int, last: int, nt_check: int) -> bool:
    """True when steps [i0, last] contain a rolling-checkpoint event
    (some step index that is a multiple of nt_check, step 0 included).
    Save windows end at multiples of nt_save, so when nt_check is not a
    multiple of nt_save the boundary falls mid-window — the checkpoint is
    then written at that window's save, keeping the reference's
    every-nt_check-steps cadence (solvers.py:217-223) to within one save
    interval instead of silently never firing."""
    return (last // nt_check) > ((i0 - 1) // nt_check)


def _group_windows(windows, nt_check: int, max_group: int):
    """Group consecutive equal-length save windows so ONE device call (and
    ONE device->host pull of on-device-accumulated save rows) covers the
    whole group.  Groups are cut at checkpoint boundaries — the host needs
    the full state there (consume's ck_state is the group-end state, so a
    checkpoint window must end its group) — and around irregular
    (first/partial/non-save) windows, which run as singleton groups
    through the plain path."""
    cur = []
    for w in windows:
        i0, wlen, do_save = w
        if cur and (not do_save or wlen != cur[0][1]):
            yield cur
            cur = []
        if not do_save:
            yield [w]
            continue
        cur.append(w)
        if _ck_due(i0, i0 + wlen - 1, nt_check) or len(cur) >= max_group:
            yield cur
            cur = []
    if cur:
        yield cur


def _bootstrap_f64(md, timesteps, nt_save, k_steps):
    """March the first ``k_steps`` (rounded up to a save boundary) in
    FLOAT64 on the host CPU, regardless of the run's marching dtype.

    Why: the reference's exact cold start (setup_cooke2.py:66,
    b = 0.001 + N(0, 0.005) UNCLAMPED — 46% of nodes at b < 0, |b|^3
    spanning ~10 decades cell to cell) is solvable by its direct PETSc
    LU but NOT certifiable by an f32 iterative Newton-Krylov (measured:
    the step-1 residual stalls at ~8e-3 of scale).  f64 powers through
    (26 Newton / 12.8k CG on the flagship); once the violent
    equilibration has smoothed the fields, f32 certifies the rest of
    the horizon.  This is the in-run equivalent of the PETSc-LU
    robustness the reference leans on (SHAKTI_REFERENCE_BINIT=1 sets
    ``md.bootstrap_steps`` in setups/setup_cooke2.py).

    Mechanics: temporarily enables x64 (before the main loop has
    compiled anything, so no f32 jit cache is invalidated), freezes an
    f64 twin of the model on the CPU backend, marches it with the same
    run_window/save-window protocol, and returns the final state plus
    the per-window (i0, wlen, flat_row, diag) data the caller replays
    through its normal history bookkeeping.  Returns
    (state64, windows, boot_end) — the caller casts state64 into its
    own dtype/state structure and starts the main loop at boot_end.
    """
    import dataclasses as _dc

    import jax.numpy as jnp

    k = int(k_steps)
    nt = timesteps.size
    if k % nt_save:
        k += nt_save - (k % nt_save)
    k = min(k, nt - 1)

    x64_was = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", True)
    try:
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            old_dtype = md.dtype
            md.dtype = jnp.float64
            try:
                mesh, static, state, cfg = md.freeze()
            finally:
                md.dtype = old_dtype
            step_fn = make_step_fn(mesh, static, md.params, cfg)
            runner = jax.jit(lambda s, d: run_window(step_fn, s, d))
            forcing = make_forcing(
                timesteps, dtype=jnp.float64,
                seasonal=getattr(md, 'seasonal_inputs', None),
                degree_day=getattr(md, 'degree_day', None))
            wins = []
            for i0, wlen, do_save in _save_windows(k + 1, nt_save, 0):
                f_win = jax.tree_util.tree_map(
                    lambda a: a[i0:i0 + wlen], forcing)
                state, diags = runner(state, f_win)
                dg = np.stack([
                    np.asarray(diags["converged"], np.float64),
                    np.asarray(diags["newton_iters"], np.float64),
                    np.asarray(diags["cg_iters"], np.float64),
                    np.asarray(diags["rnorm"], np.float64)])
                flat = None
                if do_save:
                    q = np.asarray(state.q)
                    flat = np.concatenate(
                        [np.asarray(state.N), np.asarray(state.b),
                         q[:, 0], q[:, 1]])
                wins.append((i0, wlen, flat, dg))
    finally:
        jax.config.update("jax_enable_x64", x64_was)
    return state, wins, k + 1


def solve(md, *, resume: bool = False, progress: bool = True):
    """Run the transient problem defined by a ModelSetup.

    Returns a dict with the final state, in-memory history arrays, and
    aggregated diagnostics.  Writes the reference-compatible results
    directory when ``md.results_name`` is set.
    """
    md.validate()
    dist_on = bool(getattr(md, "distributed", False)) and len(jax.devices()) > 1
    # multi-process (pod) launches (utils/multihost.py): all results IO
    # funnels through process 0, matching the reference's rank-0 gather
    # funnel (reference solvers.py:86-102,205-215).  Collectives (the
    # to_host allgathers inside extract/process) still run on EVERY
    # process — the host loop below is itself SPMD.  Resume reads assume
    # a shared filesystem, like the reference's results dir.
    nproc = jax.process_count()
    primary = jax.process_index() == 0
    timesteps = np.asarray(md.timesteps, dtype=np.float64)
    nt = timesteps.size
    nt_save = int(md.nt_save) if md.nt_save else 1
    nt_check = int(md.nt_check) if md.nt_check else max(nt_save * 50, nt_save)
    forcing = make_forcing(timesteps, dtype=md.dtype,
                           seasonal=getattr(md, 'seasonal_inputs', None),
                           degree_day=getattr(md, 'degree_day', None))
    n_saves = -(-nt // nt_save)          # saves at i = 0, nt_save, 2 nt_save, ...
    n_nodes = md.nodes.shape[0]
    state = None

    io_on = md.results_name is not None
    start_step, row = 0, 0

    if io_on:
        rdir = str(md.results_name)
        mesh_fp = ckpt.mesh_fingerprint(md.nodes)
        loaded = (ckpt.load_state(rdir, dtype=md.dtype, fingerprint=mesh_fp)
                  if resume else None)
        if loaded is not None:
            state, start_step, row = loaded
        else:
            # pre-existing-dir abort, coordinated like the reference's
            # bcast'd error code (solvers.py:91-102): only the primary
            # probes/creates; its verdict is broadcast so every process
            # raises (instead of the others hanging at the first
            # collective after a lone primary abort)
            ok = True
            if primary:
                try:
                    os.makedirs(rdir, exist_ok=False)
                except FileExistsError:
                    ok = False
            if nproc > 1:
                from jax.experimental import multihost_utils as _mhu
                ok = bool(_mhu.broadcast_one_to_all(np.int32(ok)))
            if not ok:
                raise FileExistsError(
                    f"Error: Directory '{rdir}' already exists.\n"
                    "Choose another name in setup file or delete this directory.")
        if primary:
            t_i = np.linspace(0, timesteps.max(), n_saves)
            np.save(os.path.join(rdir, "t.npy"), t_i)
            np.save(os.path.join(rdir, "nodes_x.npy"), md.x)
            np.save(os.path.join(rdir, "nodes_y.npy"), md.y)
            if md.setup_file and os.path.exists(str(md.setup_file)):
                shutil.copy(str(md.setup_file),
                            os.path.join(rdir, os.path.basename(str(md.setup_file))))

    # history rows carry the marching dtype (f32 in production): widening
    # to f64 would add no information and double the rolling-checkpoint IO
    # volume.  With a results dir the histories are MEMMAP-backed .npy
    # files: each daily row is written to disk once when it lands and
    # checkpoints only flush the dirty pages — a whole-array np.save
    # rewrite would cost 4 x n_saves x n_nodes bytes PER CHECKPOINT (the
    # flagship: ~716 MB every 1,200 steps, ~51 GB over the run).
    hist_dt = np.dtype(md.dtype)

    def _open_hist(k):
        f = os.path.join(rdir, f"{k}.npy")
        if start_step > 0 and os.path.exists(f):
            old = np.lib.format.open_memmap(f, mode="r+")
            if old.shape == (n_saves, n_nodes) and old.dtype == hist_dt:
                return old            # resume in place
            mm = np.lib.format.open_memmap(
                f + ".new", mode="w+", dtype=hist_dt,
                shape=(n_saves, n_nodes))
            m = min(old.shape[0], n_saves)
            mm[:m] = old[:m]
            del old
            os.replace(f + ".new", f)
            return np.lib.format.open_memmap(f, mode="r+")
        return np.lib.format.open_memmap(f, mode="w+", dtype=hist_dt,
                                         shape=(n_saves, n_nodes))

    if io_on:
        # non-primary processes hold no history buffers at all (at 10M
        # dof x daily saves the in-memory alternative would replicate
        # GBs per host for rows only the primary ever writes)
        hist = ({k: _open_hist(k) for k in ("N", "b", "qx", "qy")}
                if primary else None)
    else:
        hist = {k: np.zeros((n_saves, n_nodes), dtype=hist_dt)
                for k in ("N", "b", "qx", "qy")}
    log_rows = []
    if io_on and primary and start_step > 0:
        # preserve pre-resume diagnostics (log.csv is rewritten whole)
        logf = os.path.join(rdir, "log.csv")
        if os.path.exists(logf):
            with open(logf) as f:
                log_rows = [tuple(ln.strip().split(","))
                            for ln in f.readlines()[1:]
                            if ln.strip() and int(ln.split(",")[0]) < start_step]

    def write_histories():
        if hist is None:
            return
        for k in hist:
            hist[k].flush()

    def write_log():
        if not primary:
            return
        with open(os.path.join(rdir, "log.csv"), "w") as f:
            f.write("step,t,newton_mean,newton_max,cg_mean,rnorm_max,"
                    "N_min\n")
            for r in log_rows:
                f.write(",".join(str(v) for v in r) + "\n")

    # distributed (node-sharded SPMD) execution through the same protocol:
    # set md.distributed = True (or CLI --dist) with >1 jax device
    import dataclasses as _dc
    grp_info = None
    if dist_on:
        from shakti_tpu.parallel import halo as _H
        from shakti_tpu.parallel.dist import (gather_state,
                                              make_distributed_runner)
        runner, dist_state0, plan = make_distributed_runner(md)
        if start_step == 0:
            state = dist_state0
        else:
            # localize the checkpointed (global solver-order) state; any
            # carried operator belongs to the single-device formats and is
            # dropped (the dist path rebuilds per-shard operators)
            import jax.numpy as jnp
            state = _dc.replace(state, lag_op=None)
            loc = lambda a: jnp.asarray(
                _H.localize_nodal(plan, np.asarray(a)).reshape(
                    (-1,) + np.asarray(a).shape[1:]), dtype=md.dtype)
            state = jax.tree_util.tree_map(loc, state)
            # multi-process: sharded global placement (identity otherwise)
            state = plan.get("place_state", lambda t: t)(state)
        extract = lambda st: gather_state(plan, st)
        pack_fn = None
        grp_info = plan.get("group")
        if grp_info is not None:
            run_group = grp_info["run"]
            omax_g = grp_info["omax"]
            own_p, own_slot = grp_info["own_p"], grp_info["own_slot"]

            def unpack_row(row, wlen):
                """One pulled (P*(4*omax+4*wlen),) group row -> (flat
                solver-order 4*n state fields, (4, wlen) diagnostics).
                Owned slots stitch by precomputed shard/slot indices; the
                diagnostics block is replicated — read shard 0's copy."""
                W = 4 * omax_g + 4 * wlen
                base = own_p * W + own_slot
                flat = np.concatenate(
                    [row[base + k * omax_g] for k in range(4)])
                return flat, row[4 * omax_g:4 * omax_g + 4 * wlen].reshape(
                    4, wlen)
    else:
        mesh, static, state0, cfg = md.freeze()
        if state is None:
            state = state0
        elif cfg.lag_operator:
            lag = state.lag_op
            ref = state0.lag_op
            same = (lag is not None and len(lag) == len(ref)
                    and all((a is None) == (b is None)
                            and (a is None or np.asarray(a).shape
                                 == np.asarray(b).shape)
                            for a, b in zip(lag, ref)))
            if not same:
                # checkpoint predates lag persistence or was written under a
                # different operator format/coarse size; reseed (first
                # resumed step then rebuilds instead of reusing)
                from shakti_tpu.solve.newton import zero_lag
                lag = zero_lag(mesh, md.dtype, cfg)
            state = _dc.replace(state, lag_op=lag)
        elif state.lag_op is not None:
            state = _dc.replace(state, lag_op=None)
        step_fn = make_step_fn(mesh, static, md.params, cfg)
        runner = jax.jit(lambda s, d: run_window(step_fn, s, d))
        extract = lambda st: st
        # one concatenated device->host transfer per save window instead of
        # four pulls (each pull is a host round trip; see bench.py pack)
        import jax.numpy as jnp
        pack_fn = jax.jit(lambda st: jnp.concatenate(
            [st.N, st.b, st.q[:, 0], st.q[:, 1]]))

    # per-window solver diagnostics ride the SAME single transfer rule:
    # converged/newton/cg/rnorm as one packed (4*wlen,) pull instead of
    # four separate np.asarray round trips per window
    import jax.numpy as _jnp
    _diag_cat = lambda d: _jnp.concatenate([
        d["converged"].astype(d["rnorm"].dtype),
        d["newton_iters"].astype(d["rnorm"].dtype),
        d["cg_iters"].astype(d["rnorm"].dtype),
        d["rnorm"]])
    pack_diag = jax.jit(_diag_cat)
    # save windows: state + diagnostics in ONE pull (diag counts/flags are
    # small integers and flags — exact in the state's dtype)
    pack_all = (jax.jit(lambda st, d: _jnp.concatenate(
        [pack_fn(st), _diag_cat(d).astype(st.N.dtype)]))
        if pack_fn is not None else None)

    # grouped device calls: scan over b consecutive save windows ON
    # DEVICE, accumulating one packed (state row + diag row) per window,
    # and pull the (b, ...) result once — each per-window dispatch and
    # transfer is a host round trip, and at the flagship's cadence
    # (24-step windows, checkpoint every 50) this reduces the device<->host
    # chatter per checkpoint interval from ~100 round trips to 2.  The
    # on-device row buffer is capped at ~32 MB (per device on the dist
    # path, whose grouped runner lives in parallel/dist.py and emits owned
    # rows only).
    itemsize = _jnp.dtype(md.dtype).itemsize        # f64 rows are 2x f32
    if pack_all is not None:
        _group_jits = {}

        def run_group(st, f_grp):
            key = tuple(jax.tree_util.tree_map(
                lambda a: a.shape, f_grp)["dt"])  # (b, wlen)
            if key not in _group_jits:
                def gbody(s, f_win):
                    s, diags = run_window(step_fn, s, f_win)
                    return s, _jnp.concatenate(
                        [pack_fn(s), _diag_cat(diags).astype(s.N.dtype)])
                _group_jits[key] = jax.jit(
                    lambda s, f: jax.lax.scan(gbody, s, f))
            return _group_jits[key](st, f_grp)

        def unpack_row(row, wlen):
            return (row[:4 * n_nodes],
                    row[4 * n_nodes:].reshape(4, wlen))

        row_elems = 4 * n_nodes + 4 * nt_save
        max_group = max(1, min(64, int(32e6 / (itemsize * row_elems))))
    elif dist_on and grp_info is not None:
        # per-DEVICE buffer row (owned slots + diagnostics)
        row_elems = 4 * omax_g + 4 * nt_save
        max_group = max(1, min(64, int(32e6 / (itemsize * row_elems))))
    else:
        max_group = 1
    if (pack_all is not None or (dist_on and grp_info is not None)) \
            and os.environ.get("SHAKTI_RUN_GROUP"):  # A/B + test override
        max_group = max(1, int(os.environ["SHAKTI_RUN_GROUP"]))

    newton_total = cg_total = host_pulls = 0
    t0 = time.time()
    unp = md.node_iperm if md.node_iperm is not None else slice(None)

    def consume(i0, wlen, flat, dg, ck_state):
        """Per-window host bookkeeping from the pulled row.  ``ck_state``
        is the (immutable) device state pytree from the end of the group
        this window belongs to — the correct checkpoint snapshot even when
        the main loop has already dispatched the next group.  ``None``
        suppresses rolling checkpoints for this window (the f64 bootstrap
        replay has no per-window state — only the boot-END state — so a
        mid-replay checkpoint would pair an early next_step with a later
        state and corrupt any resume; the replay writes ONE correct
        checkpoint after it completes)."""
        nonlocal row, newton_total, cg_total
        conv, ni, ci, rn = dg[0] > 0.0, dg[1], dg[2], dg[3]
        if not conv.all():
            bad = i0 + int(np.argmin(conv))
            if io_on:
                write_histories()
            raise ConvergenceError(
                f"Newton failed to converge at time step {bad} "
                f"(residual {float(rn[bad - i0]):.3e})")
        newton_total += int(ni.sum())
        cg_total += int(ci.sum())
        last = i0 + wlen - 1
        if flat is None:
            return last
        # histories are written in the caller's original node order
        # (freeze may renumber nodes for block locality)
        if hist is not None:
            vals = tuple(flat[k * n_nodes:(k + 1) * n_nodes]
                         for k in range(4))
            for k, v in zip(("N", "b", "qx", "qy"), vals):
                hist[k][row] = v[unp]
        # N_min: the artesian flag (SHMIP.md artesian note) — SHAKTI's
        # signed closure permits transient N < 0 (water pressure above
        # overburden; reference constitutive.py:29-31 N|N|^{n-1}); the
        # per-save minimum makes artesian excursions visible in the run
        # log instead of silent
        log_rows.append((last, float(timesteps[last]), float(ni.mean()),
                         int(ni.max()), float(ci.mean()), float(rn.max()),
                         float(vals[0].min()) if hist is not None
                         else float("nan")))
        row += 1
        if io_on and ck_state is not None and _ck_due(i0, last, nt_check):
            write_histories()
            write_log()
            # rolling checkpoints omit the carried operator (crash
            # insurance only; the carry is a recomputable cache whose
            # device->host pull + write dominates checkpoint cost — see
            # io/checkpoint.save_state); the final checkpoint keeps it
            # so planned resumes replay bit-exactly.  extract runs on
            # every process (collective); only the primary writes.
            gs = extract(ck_state)
            if primary:
                ckpt.save_state(rdir, gs, last + 1, row,
                                fingerprint=mesh_fp, include_lag=False)
        return last

    def process(item):
        """Pull + bookkeep one finished group.  Runs while the DEVICE is
        already crunching the next group (the main loop dispatches ahead;
        jax dispatch is async), so the device->host transfers, history
        writes, and rolling checkpoints hide under compute instead of
        serializing with it."""
        nonlocal host_pulls
        kind, grp, payload, ck_state = item
        if kind == "group":
            rows = to_host(payload)                        # ONE pull
            host_pulls += 1
            for j, (i0, wlen_j, _) in enumerate(grp):
                flat, dg = unpack_row(rows[j], wlen_j)
                last = consume(i0, wlen_j, flat, dg, ck_state)
            return last
        i0, wlen, do_save = grp[0]
        diags = payload
        if do_save and pack_all is not None:
            both = np.asarray(pack_all(ck_state, diags))
            host_pulls += 1
            flat = both[:4 * n_nodes]
            dg = both[4 * n_nodes:].reshape(4, wlen)
        else:
            dg = to_host(pack_diag(diags)).reshape(4, wlen)
            host_pulls += 1
            if do_save:
                gs = extract(ck_state)
                host_pulls += 1
                flat = np.concatenate(
                    [np.asarray(gs.N), np.asarray(gs.b),
                     np.asarray(gs.q[:, 0]), np.asarray(gs.q[:, 1])])
            else:
                flat = None
        return consume(i0, wlen, flat, dg, ck_state)

    # ---- optional float64 cold-start bootstrap (md.bootstrap_steps) ----
    # marches the first steps in f64 on the host CPU before the f32 device
    # loop — the in-run equivalent of the reference's PETSc-LU robustness
    # for its unclamped noisy IC (see _bootstrap_f64).  Single-process,
    # single-device-path, fresh runs only (a resume already has a smooth
    # state).
    boot_steps = int(getattr(md, "bootstrap_steps", 0) or 0)
    if (boot_steps > 0 and start_step == 0 and not dist_on and nproc == 1
            and np.dtype(md.dtype) != np.float64):
        s64, bwins, boot_end = _bootstrap_f64(md, timesteps, nt_save,
                                              boot_steps)
        cast = lambda a: _jnp.asarray(np.asarray(a), dtype=md.dtype)
        state = _dc.replace(
            state, N=cast(s64.N), b=cast(s64.b), q=cast(s64.q),
            melt=cast(s64.melt),
            N_prev=None if state.N_prev is None else cast(s64.N_prev))
        for (i0, wlen, flat, dg) in bwins:
            flat32 = None if flat is None else flat.astype(hist_dt)
            consume(i0, wlen, flat32, dg, None)
        start_step = boot_end
        if io_on:
            # one correct checkpoint at the bootstrap boundary: state
            # after step boot_end-1 paired with next_step=boot_end, so a
            # crash before the first main-loop rolling checkpoint resumes
            # from here instead of re-marching certified f64 steps from a
            # wrong state (the replayed windows above checkpoint nothing)
            write_histories()
            write_log()
            if primary:
                ckpt.save_state(rdir, state, boot_end, row,
                                fingerprint=mesh_fp, include_lag=False)
        if progress and primary:
            print(f"f64 bootstrap: steps 0..{boot_end - 1} marched on the "
                  f"host CPU, continuing in {np.dtype(md.dtype).name}")

    windows = list(_save_windows(nt, nt_save, start_step))
    pending = None
    for g_idx, grp in enumerate(_group_windows(windows, nt_check, max_group)):
        if len(grp) > 1:
            g0, wlen = grp[0][0], grp[0][1]
            b = len(grp)
            f_grp = jax.tree_util.tree_map(
                lambda a: a[g0:g0 + b * wlen].reshape((b, wlen)
                                                      + a.shape[1:]), forcing)
            state, rows = run_group(state, f_grp)
            item = ("group", grp, rows, state)
        else:
            i0, wlen, do_save = grp[0]
            f_win = jax.tree_util.tree_map(
                lambda a: a[i0:i0 + wlen], forcing)
            state, diags = runner(state, f_win)
            item = ("single", grp, diags, state)
        if pending is not None:
            last = process(pending)
            if progress and primary and g_idx % 10 == 0:
                done = last + 1
                print(f"Time step {done} of {nt} completed "
                      f"({done / nt * 100:.1f}%)", end="\r", flush=True)
        pending = item
    if pending is not None:
        process(pending)

    wall = time.time() - t0
    state = extract(state)
    if io_on and primary:
        write_histories()
        write_log()
        ckpt.save_state(rdir, state, nt, row, fingerprint=mesh_fp)
        import json
        steps_run = nt - start_step
        with open(os.path.join(rdir, "run_meta.json"), "w") as f:
            json.dump({
                "wall_s": wall,
                "steps": steps_run,
                "ms_per_step": 1e3 * wall / max(steps_run, 1),
                "platform": jax.devices()[0].platform,
                "device_kind": jax.devices()[0].device_kind,
                "dtype": str(np.dtype(md.dtype)),
                "n_nodes": int(n_nodes),
                "resumed_from": start_step,
            }, f, indent=1)

    return {
        "state": state,
        "history": hist,
        "t": np.linspace(0, timesteps.max(), n_saves),
        "wall_time": wall,
        "newton_iters_total": newton_total,
        "cg_iters_total": cg_total,
        "steps": nt - start_step,
        # device->host transfer events during the loop (grouping A/B metric)
        "host_pulls": host_pulls,
    }
