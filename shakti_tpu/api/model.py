"""Experiment/model-state API: the `model_setup` equivalent.

Mirrors the reference's mutable setup object (reference model_setup.py:18-119)
so that experiment modules port 1:1: construct, set fields/toggles/ICs, call
``solve()``.  Differences by design:

  * no MPI communicator — device parallelism comes from jax.sharding at
    solve time (shakti_tpu.parallel), not from the setup object;
  * fields are plain numpy arrays during setup (host-side), frozen into
    device pytrees by :meth:`freeze` when the solver starts;
  * the RNG for stochastic initial conditions is seeded (the reference's
    `np.random.normal` at setup_cooke2.py:66 is unseeded — SURVEY §4 flags
    determinism as a gap we close).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from shakti_tpu.data.interp import GridInterpolator, subset_grid
from shakti_tpu.mesh import geometry as geo
from shakti_tpu.mesh.mesh import build_mesh
from shakti_tpu.params import DEFAULT_PARAMS, PhysicalParams
from shakti_tpu.solve.newton import NewtonConfig
from shakti_tpu.solve.timestep import State, make_static_fields


def default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class ModelSetup:
    """Mutable experiment configuration (reference model_setup.py:18-66).

    Construct with raw mesh arrays; mutate attributes; then ``solve()``.
    """

    def __init__(self, nodes: np.ndarray, cells: np.ndarray, *,
                 params: PhysicalParams = DEFAULT_PARAMS, dtype=None):
        self.nodes = np.asarray(nodes, dtype=np.float64)
        self.cells = np.asarray(cells, dtype=np.int32)
        self.x = self.nodes[:, 0]
        self.y = self.nodes[:, 1]
        self.params = params
        self.dtype = dtype or default_dtype()

        n = self.nodes.shape[0]
        # bounding box w/ data buffer (reference model_setup.py:34-37,93-106)
        buffer = self.get_buffer()
        self.bounds = [self.x.min() - buffer, self.x.max() + buffer,
                       self.y.min() - buffer, self.y.max() + buffer]

        # BC options (reference model_setup.py:40-41)
        self.outflow_on = True
        self.storage_on = True
        self.OutflowBoundary = None      # predicate (m,2)->bool

        # physical input fields, nodal (reference model_setup.py:43-53)
        self.z_b = np.zeros(n)
        self.z_s = np.zeros(n)
        self.G = np.zeros(n)
        self.inputs = np.zeros(n)
        self.b_init = np.zeros(n)
        self.N_init = np.zeros(n)
        self.q_init = np.zeros((n, 2))
        self.melt_init = np.zeros(n)
        self.lake_bdry = np.zeros(n)
        self.N_bdry = 0.0
        self.b_min = 1.0e-5
        # optional gap-height upper bound: None (reference semantics,
        # unbounded), "thickness" (cap at the local ice column z_s - z_b),
        # or an (n,) array.  Needed on domains that pinch to ~zero ice
        # thickness (SHMIP valley terminus): with the Dirichlet N pinned at
        # a ~1 m overburden, closure cannot balance the concentrated
        # dissipation melt and b grows past the ice thickness itself
        # (measured: b -> 22 m -> NaN on suite E1); the cap keeps the gap
        # physical (it cannot exceed the ice column) and the run bounded.
        self.b_cap = None

        # float64 cold-start bootstrap: march the first k steps in f64 on
        # the host CPU before the f32 device loop (api/run._bootstrap_f64)
        # — certifies cold starts too violent for f32 (the reference's
        # unclamped noisy b draw, setup_cooke2.py:66).  0 = off.
        self.bootstrap_steps = 0

        # lake outline: (k, 2) polygon array (NaN rows delimit multipolygons)
        self.outline = None

        # output names (reference model_setup.py:58-61)
        self.lake_name = None
        self.results_name = None
        self.setup_name = None
        self.setup_file = None           # path copied into results for provenance

        # time stepping / IO cadence (reference model_setup.py:63-66)
        self.timesteps = None
        self.nt_save = None
        self.nt_check = None
        # optional seasonal modulation of `inputs`: (amplitude, period_s,
        # phase) -> inputs * max(0, 1 + A sin(2 pi t/T + phase)) per step
        # (a capability beyond the reference's static inputs)
        self.seasonal_inputs = None
        # optional degree-day elevation-band melt added to `inputs`:
        # dict(dT=..., ddf=..., lapse=..., t_mean=..., t_amp=..., period=...)
        # -> inputs + max(0, DDF (T_0(t) - lapse z_s)) per step (the SHMIP
        # suite-D/F seasonal runoff model; see solve/timestep.make_forcing)
        self.degree_day = None

        # solver configuration (new: the reference hardcodes PETSc defaults).
        # adaptive_dt_levels=1: one in-graph dt-halving retry when a step's
        # Newton solve stalls — measured to rescue the reference's own
        # rough-b cold start (unclamped noisy b_init, setup_cooke2.py:66,
        # ~46% of nodes start with b<0) at zero steady-state runtime cost;
        # the price is a ~2x larger compiled step (the retry branch traces
        # two half-dt sub-steps).  lag_operator stays None = auto (resolved
        # at freeze: on for block-ELL meshes).  Large-scale runs that
        # would rather fail fast can set md.solver = NewtonConfig()
        # explicitly.
        self.solver = NewtonConfig(adaptive_dt_levels=1)
        # operator format: 'auto' = scalar ELL on every backend; or 'ell' /
        # 'bell' (block-ELL, RCB node reordering) / 'bcsr' (block-CSR)
        self.operator = "auto"
        # set by freeze(): solver-order -> user-order permutation (or None)
        self.node_iperm = None

    # ------------------------------------------------------------------ setup
    def get_buffer(self) -> float:
        """10x the max grid spacing in x/y (reference model_setup.py:93-106)."""
        xs, ys = np.unique(self.x), np.unique(self.y)
        bx = 10 * np.max(np.diff(xs)) if xs.size > 1 else 0.0
        by = 10 * np.max(np.diff(ys)) if ys.size > 1 else 0.0
        return max(bx, by)

    def set_lake_bdry(self, outline: np.ndarray):
        """Point-in-polygon lake indicator (reference model_setup.py:68-72,
        vectorized — no per-node shapely loop)."""
        self.outline = np.asarray(outline, dtype=np.float64)
        self.lake_bdry = geo.points_in_polygon(self.nodes, self.outline).astype(np.float64)

    def interp_data(self, var_name: str, x_d, y_d, f) -> GridInterpolator:
        """Interpolate gridded data onto mesh nodes and store it on
        ``self.<var_name>`` (reference model_setup.py:74-91).  Returns the
        interpolator for reuse (outflow detection, setup_cooke2.py:72)."""
        xs, ys, fs = subset_grid(np.asarray(x_d), np.asarray(y_d),
                                 np.asarray(f), self.bounds)
        itp = GridInterpolator(xs, ys, fs)
        setattr(self, var_name, itp(self.x, self.y))
        return itp

    def add_moulin(self, xy, Q: float):
        """Add a point moulin of discharge Q [m^3/s] at the node nearest to
        ``xy``, as a lumped nodal source (the reference expresses moulins via
        the distributed `inputs` field [m/s], model_setup.py:47; a point
        source of rate Q corresponds to inputs = Q / (nodal lumped area))."""
        k = int(np.argmin((self.x - xy[0]) ** 2 + (self.y - xy[1]) ** 2))
        # lumped P1 nodal area = (sum of adjacent cell areas) / 3
        from shakti_tpu.mesh.mesh import cell_geometry
        sa, _ = cell_geometry(self.nodes, self.cells)
        node_area = np.zeros(self.nodes.shape[0])
        np.add.at(node_area, self.cells.reshape(-1), np.repeat(np.abs(sa), 3))
        self.inputs[k] += Q / (node_area[k] / 3.0)
        return k

    # ----------------------------------------------------------------- freeze
    def dirichlet_nodes(self) -> np.ndarray:
        if not self.outflow_on or self.OutflowBoundary is None:
            return np.zeros(0, dtype=np.int64)
        return geo.locate_boundary_nodes(self.nodes, self.cells, self.OutflowBoundary)

    def to_user_order(self, arr):
        """Map a solver-order nodal array (e.g. out['state'].N) back to this
        setup's original node order.  No-op when freeze() did not renumber."""
        a = np.asarray(arr)
        return a if self.node_iperm is None else a[self.node_iperm]

    def validate(self, require_timesteps: bool = True):
        """Fail early with actionable messages (the reference crashes with
        raw TypeErrors when e.g. OutflowBoundary is unset, solvers.py:22)."""
        if require_timesteps and (self.timesteps is None
                                  or np.size(self.timesteps) < 2):
            raise ValueError(
                "md.timesteps must be an array of at least 2 times "
                "(e.g. np.linspace(0, t_final, n_steps))")
        if self.outflow_on and self.OutflowBoundary is None:
            raise ValueError(
                "outflow_on=True but md.OutflowBoundary is unset; provide a "
                "boundary predicate (coords (m,2) -> bool) or set "
                "md.outflow_on = False for a no-outflow run")
        for name in ("z_b", "z_s", "G", "inputs", "b_init", "N_init"):
            a = np.asarray(getattr(self, name), dtype=object
                           if getattr(self, name) is None else None)
            if getattr(self, name) is None or np.ndim(a) == 0:
                raise ValueError(
                    f"md.{name} must be a per-node array of length "
                    f"{self.nodes.shape[0]} (got a scalar/None; use "
                    f"np.full(md.x.size, value) for uniform fields)")
            if a.shape[0] != self.nodes.shape[0]:
                raise ValueError(f"md.{name} has {a.shape[0]} entries for "
                                 f"{self.nodes.shape[0]} nodes")

    def freeze(self):
        """Build the immutable device-side problem:
        (mesh, static_fields, initial_state, newton_config).

        The operator is built in the format ``self.operator`` names ('auto'
        is scalar ELL).  The blocked formats ('bell', 'bcsr') renumber the
        nodes by recursive coordinate bisection; ``self.node_iperm`` is then
        the solver-order -> user-order permutation, which the run layer uses
        so all outputs stay in the caller's original node order."""
        # timesteps are a run-layer concern (api/run.py validates them);
        # freezing only needs mesh/fields/BCs (steady solves have no
        # timesteps at all)
        self.validate(require_timesteps=False)
        op = self.operator
        if op == "auto":
            op = "ell"
        if getattr(self, "distributed", False):
            # distributed runs build their own per-shard operators
            # (parallel/dist.py); skip the global operator structures
            op = "none"

        n = self.nodes.shape[0]
        nodes, cells = self.nodes, self.cells
        perm = None
        reorder = (op in ("bell", "bcsr")
                   or getattr(self, "distributed", False)
                   # contiguous-range aggregation (solve/mg.py) needs the
                   # RCB ordering for spatially-compact aggregates
                   or self.solver.precond == "mg")
        if reorder:
            from shakti_tpu.parallel.partition import rcb_order
            perm = rcb_order(nodes)
            iperm = np.argsort(perm)
            nodes = nodes[perm]
            cells = iperm[cells].astype(np.int32)
            self.node_iperm = iperm
        else:
            self.node_iperm = None
        p = (lambda a: np.asarray(a)[perm]) if perm is not None else np.asarray

        # block size for the blocked operators: 128-wide tiles for block-ELL
        # (mid-size meshes); small blocks for block-CSR — at B=128 the dense
        # blocks hold ~7 real nonzeros per row, and XLA keeps 2-3 live
        # copies of the fold inside the Newton loop (observed OOM at 1M dof
        # with B=128 BCSR).  Override via md.operator_block.
        blk = getattr(self, "operator_block", None)
        if blk is None:
            blk = (32 if n <= 6_000_000 else 16) if op == "bcsr" else 128
        mesh = build_mesh(nodes, cells, dtype=self.dtype, operator=op,
                          bell_block=blk)
        dnodes = geo.locate_boundary_nodes(nodes, cells, self.OutflowBoundary) \
            if (self.outflow_on and self.OutflowBoundary is not None) \
            else np.zeros(0, dtype=np.int64)
        dmask = geo.dirichlet_mask(n, dnodes)
        storage = self.lake_bdry if self.storage_on else np.zeros(n)
        b_cap = getattr(self, "b_cap", None)
        if isinstance(b_cap, str):
            if b_cap != "thickness":
                raise ValueError(f"b_cap must be None, 'thickness', or an "
                                 f"array, got {b_cap!r}")
            b_cap = np.maximum(np.asarray(self.z_s) - np.asarray(self.z_b),
                               self.b_min)
        static = make_static_fields(
            mesh, p(self.z_b), p(self.z_s), p(self.G), p(self.inputs),
            p(storage), dmask, self.N_bdry, self.b_min, self.params,
            b_max=None if b_cap is None else p(b_cap))
        f = lambda a: jnp.asarray(p(a), dtype=self.dtype)
        state0 = State(N=f(self.N_init), b=f(self.b_init),
                       q=f(self.q_init), melt=f(self.melt_init),
                       N_prev=f(self.N_init))
        cfg = self.solver.for_dtype(self.dtype)
        if cfg.coarse_block is None:  # the 'auto' default
            # auto coarse-aggregate size: cap the dense coarse problem at
            # ~1.5k dofs (its inverse is rebuilt every Newton iteration);
            # on the block operator start from the 128-wide blocks so the
            # restriction is a plain row-sum over the (NB, B) layout
            import dataclasses as _dc
            blk = 128 if op == "bell" else 64
            while n // blk > 1536:
                blk *= 2
            cfg = _dc.replace(cfg, coarse_block=blk)
        if cfg.precond == "mg" and not getattr(self, "distributed", False):
            # multilevel hierarchy (solve/mg.py) is host-built per mesh;
            # small meshes return None and degenerate to two_level.
            # Distributed runs build their own localized hierarchy in
            # parallel/dist.build_distributed.
            from shakti_tpu.solve.mg import build_hierarchy
            import dataclasses as _dcm
            plan = build_hierarchy(cells, n, agg=cfg.mg_agg,
                                   cap=cfg.mg_coarse_cap)
            if plan is not None:
                mesh = _dcm.replace(mesh, mg=plan)
        if cfg.lag_operator is None:
            # auto: carry the operator exactly in the block-ELL regime
            # (memory-safe at <= 200k nodes) — see NewtonConfig.lag_operator.
            # The carry holds a two-level coarse inverse, so it is
            # incompatible with the multilevel preconditioner.
            import dataclasses as _dc2
            cfg = _dc2.replace(cfg, lag_operator=(op == "bell"
                                                  and cfg.precond != "mg"))
        elif cfg.lag_operator and cfg.precond == "mg":
            import dataclasses as _dc2b
            cfg = _dc2b.replace(cfg, lag_operator=False)
        if cfg.lag_operator:
            # seed the carried-operator slot (invalid until step 1 builds
            # it) — AFTER the coarse_block adjustment so A_inv's shape
            # matches what the Newton loop will build
            import dataclasses as _dc3
            from shakti_tpu.solve.newton import zero_lag
            state0 = _dc3.replace(state0,
                                  lag_op=zero_lag(mesh, self.dtype, cfg))
        return mesh, static, state0, cfg

    # ------------------------------------------------------------------ solve
    def solve(self, **kw):
        """Run the transient problem and write results
        (reference model_setup.py:118-119 delegating to solvers.solve)."""
        from shakti_tpu.api.run import solve as _solve
        return _solve(self, **kw)

    def solve_steady(self, **kw):
        """Solve directly for the steady state (pseudo-transient
        continuation, api/steady.py — a capability the reference lacks;
        its users spin up by marching md.timesteps for years).
        ``md.timesteps`` is optional here (it only seeds the initial
        pseudo-dt when present)."""
        from shakti_tpu.api.steady import solve_steady as _steady
        return _steady(self, **kw)
