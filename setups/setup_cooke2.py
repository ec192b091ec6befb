"""Cook_E2 subglacial-lake experiment: the reference's production case
(reference setups/setup_cooke2.py) rebuilt on the JAX framework.

Follows the reference's recipe step for step: load the lake-catchment mesh,
mask the lake from the outline inventory, interpolate bed (BedMachine),
surface (ICESat-2 ATL14) and geothermal flux (AQ1) onto the nodes, detect
the outflow boundary as the minimum of the background hydraulic potential,
and run 10 years at 24 steps/day with daily saves.

Data locations come from environment variables instead of the reference's
hard-coded user paths (setup_cooke2.py:39,48,57; load_lakes.py:19):

  SHAKTI_MESH_DIR         directory containing <lake>_mesh.msh
  SHAKTI_LAKE_INVENTORY   outlines .h5 (Siegfried&Fricker) or .npz
  SHAKTI_BEDMACHINE       BedMachineAntarctica .nc
  SHAKTI_ATL14            ATL14 surface .nc
  SHAKTI_AQ1              AQ1 geothermal flux .nc

Anything missing falls back to a synthetic Cook_E2-like analogue (same
domain scale, lake basin, data-interpolation code path), so the experiment
is runnable end-to-end without the proprietary datasets.
"""

import os

import numpy as np

from shakti_tpu.api.model import ModelSetup
from shakti_tpu.data.interp import GridInterpolator
from shakti_tpu.params import DEFAULT_PARAMS as P


def _synthetic_grids(bounds, lake_xy):
    """Cook_E2-scale synthetic bed/surface/GHF grids (used when the real
    datasets are absent), sized to the MESH bounding box so they remain
    valid for any catchment mesh (the committed basin mesh spans ~200 km —
    a fixed 100 km grid would leave most of it extrapolated).  Bed: sloping
    with a closed depression under the lake; surface: gently sloping ice
    sheet ~1.5 km thick."""
    x0, x1, y0, y1 = bounds
    mx, my = x1 - x0, y1 - y0
    gx = np.linspace(x0 - 0.1 * mx, x1 + 0.1 * mx, 500)
    gy = np.linspace(y0 - 0.1 * my, y1 + 0.1 * my, 500)
    X, Y = np.meshgrid(gx, gy)
    # depression depth/width: -60 m over 15 km gives a clear closed basin
    # (potential low ~50 kPa) with a cold-start transient the f32
    # solver certifies; the real BedMachine trough enters via the data path
    r2 = ((X - lake_xy[0]) ** 2 + (Y - lake_xy[1]) ** 2) / (15e3) ** 2
    bed = -400.0 + 0.004 * (X - x0) + 0.002 * (Y - y0) - 60.0 * np.exp(-r2)
    surf = bed + 1500.0 - 0.006 * (X - x0)
    ghf = np.full_like(bed, 0.055) + 0.01 * np.sin(X / 3e4) * np.cos(Y / 4e4)
    return (gx, gy, bed), (gx, gy, surf), (gx, gy, ghf)


def initialize(days=10 * 365, nt_per_day=24, results_name="auto", seed=0):
    lake_name = "Cook_E2"
    lx = ly = 100e3

    # ---- mesh: production .msh if available, else synthetic catchment ----
    mesh_dir = os.environ.get("SHAKTI_MESH_DIR")
    msh_path = os.path.join(mesh_dir, f"{lake_name}_mesh.msh") if mesh_dir else None
    if msh_path and os.path.exists(msh_path):
        from shakti_tpu.mesh.msh_io import read_msh
        nodes, cells = read_msh(msh_path)
    else:
        from shakti_tpu.mesh.generate import rectangle_mesh
        nodes, cells = rectangle_mesh(50, 50, lx, ly, jitter=0.25, seed=seed)

    md = ModelSetup(nodes, cells)
    md.setup_name = "setup_cooke2"
    md.setup_file = os.path.abspath(__file__)
    md.lake_name = lake_name

    # outflow boundary condition (reference setup_cooke2.py:29-31)
    md.N_bdry = 3.7e5
    if results_name == "auto":
        results_name = f"results/{lake_name}_{int(md.N_bdry / 1e3):d}kpa"
    md.results_name = results_name

    # ---- lake outline -> storage mask (reference :34-36) ----
    inv_path = os.environ.get("SHAKTI_LAKE_INVENTORY")
    outline = None
    if inv_path and os.path.exists(inv_path):
        from shakti_tpu.data.lakes import load_inventory, outline_m
        inv = load_inventory(inv_path)
        if lake_name in inv:
            outline = outline_m(inv, lake_name)
    if outline is None and msh_path and os.path.exists(msh_path):
        # a lake outline committed alongside the mesh (mesh-aligned
        # coordinates — the synthetic circle below is bbox-relative and
        # may miss an irregular catchment entirely)
        lk = os.path.join(os.path.dirname(msh_path), "lake.npy")
        if os.path.exists(lk):
            outline = np.load(lk)
    if outline is None:
        cx = 0.5 * (md.x.min() + md.x.max())
        cy = 0.5 * (md.y.min() + md.y.max())
        th = np.linspace(0, 2 * np.pi, 181)
        outline = np.column_stack([cx + 11e3 * np.cos(th),
                                   cy + 9e3 * np.sin(th)])
    md.set_lake_bdry(outline)
    if not md.lake_bdry.any():
        import warnings
        warnings.warn("setup_cooke2: lake outline contains no mesh nodes — "
                      "the storage term will be identically zero",
                      RuntimeWarning)
    lake_c = (outline[np.isfinite(outline[:, 0]), 0].mean(),
              outline[np.isfinite(outline[:, 1]), 1].mean())

    # ---- gridded data -> nodal fields (reference :39-62) ----
    def grid_or(env, reader, fallback):
        path = os.environ.get(env)
        if path and os.path.exists(path):
            return reader(path)
        return fallback

    mesh_bounds = (md.x.min(), md.x.max(), md.y.min(), md.y.max())
    bed_f, surf_f, ghf_f = _synthetic_grids(mesh_bounds, lake_c)
    try:
        from shakti_tpu.data import netcdf as nc
        bed_g = grid_or("SHAKTI_BEDMACHINE", nc.read_bedmachine, bed_f)
        surf_g = grid_or("SHAKTI_ATL14", nc.read_atl14, surf_f)
        ghf_g = grid_or("SHAKTI_AQ1", nc.read_aq1, ghf_f)
    except ImportError:
        bed_g, surf_g, ghf_g = bed_f, surf_f, ghf_f

    bed_interp = md.interp_data("z_b", *bed_g)
    surf_interp = md.interp_data("z_s", *surf_g)
    md.interp_data("G", *ghf_g)

    # ---- initial conditions (reference :66-69; seeded unlike the ref) ----
    # Documented deviation: the reference draws b ~ 0.001 + N(0, 0.005)
    # UNCLAMPED (46% of nodes start with unphysical b < 0; |b|^3 spans ~10
    # decades cell-to-cell), which its direct PETSc LU solves tolerate but
    # an f32 iterative Newton-Krylov cannot certify (measured: step-1
    # residual stalls at ~8e-3 of scale even with dt-halving).  The noise
    # only exists to seed channelization asymmetry, so we keep it at a
    # tenth the amplitude and clamped to b_min — same role, certifiable
    # cold start (the bench uses the identical recipe).  Set
    # SHAKTI_REFERENCE_BINIT=1 to reproduce the reference's exact draw
    # (requires float64).
    rng = np.random.default_rng(seed)
    if os.environ.get("SHAKTI_REFERENCE_BINIT") == "1":
        md.b_init = 0.001 + rng.normal(scale=0.005, size=md.x.size)
        # the exact draw is uncertifiable in f32 — bootstrap the violent
        # equilibration in f64 on the host CPU (api/run._bootstrap_f64),
        # mirroring the PETSc-LU robustness the reference leans on;
        # default one day of hourly steps, env-overridable
        md.bootstrap_steps = int(
            os.environ.get("SHAKTI_BOOTSTRAP_STEPS", "24"))
    else:
        md.b_init = np.maximum(
            0.001 + rng.normal(scale=5e-4, size=md.x.size), 1e-5)
    md.N_init = np.full(md.x.size, md.N_bdry)

    # ---- outflow = minimum background potential (reference :72-80) ----
    def potential(x, y):
        return P.rho_i * P.g * surf_interp(x, y) \
            + (P.rho_w - P.rho_i) * P.g * bed_interp(x, y)

    pot = potential(md.x, md.y)
    P_min, P_std = float(pot.min()), float(pot.std())
    md.OutflowBoundary = \
        lambda p: np.abs(potential(p[:, 0], p[:, 1]) - P_min) < 0.5 * P_std
    md.outflow_on = True
    md.storage_on = True

    # no moulin inputs in this experiment (reference :89)
    md.inputs = np.zeros(md.x.size)

    # ---- time stepping (reference :92-99) ----
    t_final = (days / 365) * 3.154e7
    md.timesteps = np.linspace(0, t_final, int(days * nt_per_day))
    md.nt_save = nt_per_day
    md.nt_check = 50 * md.nt_save
    return md
