"""DEM -> drainage basin -> mesh -> transient run, fully automated.

The script equivalent of reference notebooks/create_mesh.ipynb (cells 1-18)
with the hand-traced ``plt.ginput`` step (cell 16) replaced by automatic
flow routing + boundary extraction (shakti_tpu.mesh.basin):

  1. surface + bed grids (real datasets when SHAKTI_ATL14/SHAKTI_BEDMACHINE
     point at netCDF files and SHAKTI_LAKES at the inventory; a synthetic
     Cook_E2-like catchment otherwise),
  2. background hydraulic potential (cell 7),
  3. D8 flow routing -> drainage basins -> the basin(s) under the lake
     (cells 11-15),
  4. traced + simplified catchment outline (replaces cell 16),
  5. triangulation at 2 km resolution (cell 17) and a .msh written next to
     the results (cell 17's gmsh.write),
  6. a 10-step transient run on the new mesh to prove it solves.

    python examples/basin_pipeline.py [outdir]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_grids(L0=50e3):
    """(x, y, z_s, z_b, lake_outline) around the target lake.

    Real path mirrors create_mesh.ipynb cells 3-6 (ATL14 surface +
    BedMachine bed subset to a 2*L0 box around the lake centroid, nearest
    resampled to a common 1000x1000 grid); otherwise a synthetic catchment.
    """
    atl14 = os.environ.get("SHAKTI_ATL14")
    bm = os.environ.get("SHAKTI_BEDMACHINE")
    lakes = os.environ.get("SHAKTI_LAKES")
    lake_name = os.environ.get("SHAKTI_LAKE", "Cook_E2")
    if atl14 and bm and lakes:
        from shakti_tpu.data import netcdf as ncio
        from shakti_tpu.data.interp import GridInterpolator, subset_grid
        from shakti_tpu.data.lakes import load_inventory, outline_m
        inv = load_inventory(lakes)
        outline = outline_m(inv, lake_name)
        x0, y0 = outline.mean(axis=0)
        bounds = (x0 - L0, x0 + L0, y0 - L0, y0 + L0)
        xs, ys, h = subset_grid(*ncio.read_atl14(atl14), bounds)
        xb, yb, bed = subset_grid(*ncio.read_bedmachine(bm), bounds)
        x = np.linspace(bounds[0], bounds[1], 1000)
        y = np.linspace(bounds[2], bounds[3], 1000)
        X, Y = np.meshgrid(x, y)
        z_s = GridInterpolator(xs, ys, h)(X, Y)
        z_b = GridInterpolator(xb, yb, bed)(X, Y)
        return x, y, z_s, z_b, outline

    # ---- synthetic catchment: two competing outlets (curved divide) and a
    # closed surface low over the lake, nearer outlet 1 ----
    print("# no SHAKTI_ATL14/SHAKTI_BEDMACHINE/SHAKTI_LAKES env vars — "
          "using the synthetic catchment", file=sys.stderr)
    n = 500
    x = np.linspace(-L0, L0, n)
    y = np.linspace(-L0, L0, n)
    X, Y = np.meshgrid(x, y)
    c1 = np.hypot(X + L0, Y + 20e3)          # outlet 1: (-L0, -20 km)
    c2 = np.hypot(X - L0, Y - 20e3)          # outlet 2: (+L0, +20 km)
    bowl = 60.0 * np.exp(-((X + 10e3) / 12e3) ** 2 - ((Y - 5e3) / 9e3) ** 2)
    z_s = 1000.0 + 0.004 * np.minimum(c1, 1.05 * c2) - bowl
    z_b = -100.0 + 0.0005 * X
    th = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    outline = np.column_stack([-10e3 + 8e3 * np.cos(th),
                               5e3 + 6e3 * np.sin(th)])
    return x, y, z_s, z_b, outline


def main(outdir="results/basin_pipeline"):
    from shakti_tpu.api.model import ModelSetup
    from shakti_tpu.api.run import solve
    from shakti_tpu.mesh import basin
    from shakti_tpu.mesh.msh_io import write_msh

    x, y, z_s, z_b, lake_outline = load_grids()

    phi = basin.background_potential(z_s, z_b)
    print(f"potential grid {phi.shape}, relief {phi.max() - phi.min():.3g} Pa")

    # GeoTIFF round-trip of the uint8-normalized potential — the exact
    # raster leg of the reference workflow (create_mesh.ipynb cells 8-10:
    # normalize to uint8, write a GTiff with a from_bounds transform,
    # read it back for flow routing in cell 11).  Flow routing then runs
    # on the quantized values read from disk, like topotoolbox's.
    from shakti_tpu.data.geotiff import (quantize_potential, read_geotiff,
                                         write_geotiff)
    os.makedirs(outdir, exist_ok=True)
    tif = os.path.join(outdir, "potential_dem.tif")
    dx = float(x[1] - x[0])
    dy = float(abs(y[1] - y[0]))
    # north-up raster: row 0 at y.max (phi rows follow ascending y here)
    write_geotiff(tif, quantize_potential(phi)[::-1], west=x.min() - dx / 2,
                  north=y.max() + dy / 2, dx=dx, dy=dy, epsg=3031)
    xt, yt, phi8, meta = read_geotiff(tif)
    if yt[0] > yt[-1]:          # north-up raster rows -> ascending y grid
        yt, phi8 = yt[::-1], phi8[::-1]
    print(f"wrote+read {tif}: {phi8.dtype} {phi8.shape} epsg={meta['epsg']}")

    nodes, cells, outline = basin.basin_mesh(
        xt, yt, phi8.astype(np.float64), lake_outline=lake_outline,
        resolution=2000.0)
    print(f"catchment outline: {outline.shape[0]} vertices; "
          f"mesh: {nodes.shape[0]} nodes / {cells.shape[0]} triangles")

    os.makedirs(outdir, exist_ok=True)
    msh_path = os.path.join(outdir, "basin_mesh.msh")
    write_msh(msh_path, nodes, cells)
    np.save(os.path.join(outdir, "basin_outline.npy"), outline)
    print(f"wrote {msh_path}")

    # ---- 10 transient steps on the new mesh ----
    md = ModelSetup(nodes, cells)
    from shakti_tpu.data.interp import GridInterpolator

    itp_b = GridInterpolator(x, y, z_b)
    itp_s = GridInterpolator(x, y, z_s)
    itp_phi = GridInterpolator(x, y, phi)
    md.z_b = itp_b(md.x, md.y)
    md.z_s = np.maximum(itp_s(md.x, md.y), md.z_b + 50.0)
    md.G = np.full(md.x.size, 0.06)
    md.N_bdry = 3.7e5
    phi_n = itp_phi(md.x, md.y)
    lo = np.quantile(phi_n, 0.02)
    md.OutflowBoundary = lambda p: itp_phi(p[:, 0], p[:, 1]) <= lo
    md.set_lake_bdry(lake_outline)
    md.storage_on = True
    md.b_init = np.full(md.x.size, 0.01)
    md.N_init = np.full(md.x.size, md.N_bdry)
    md.timesteps = np.linspace(0.0, 10 * 3600.0, 11)
    md.nt_save = 5
    out = solve(md, progress=False)
    N = np.asarray(out["state"].N)
    print(f"ran {out['steps']} steps: N in [{N.min():.3g}, {N.max():.3g}] Pa, "
          f"newton_total={out['newton_iters_total']}")
    assert np.isfinite(N).all()
    print("OK")


if __name__ == "__main__":
    main(*sys.argv[1:])
