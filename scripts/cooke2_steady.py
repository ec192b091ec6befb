"""Direct steady state of the Cook_E2 flagship case (CPU f64).

Cross-validates the PTC steady solver (solve/steady.py) against the
10-year transient artifact (COOKE2_RUN.md / cooke2_results.json, written
by scripts/cooke2_report.py):
the far-field metrics of the directly-computed equilibrium must match the
transient's year-10 state (the far field equilibrates within ~the first
year; reference notebooks/solution-plots.ipynb cell-13's check).  The lake
region is EXPECTED to differ: at the true steady state the lake has
finished filling (storage term inactive), while year 10 of the transient
catches it mid-fill at 3.35 m — so lake-region numbers are reported, not
asserted against.

    SHAKTI_MESH_DIR=assets/cooke2_synth python scripts/cooke2_steady.py

Writes scripts/cooke2_steady.json.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("SHAKTI_MESH_DIR", os.path.join(ROOT, "assets", "cooke2_synth"))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import setups.setup_cooke2 as cooke2  # noqa: E402

OUT = os.path.join(ROOT, "scripts", "cooke2_steady.json")
REF = os.path.join(ROOT, "scripts", "cooke2_results.json")


def main(tol=1e-3, max_steps=20000):
    md = cooke2.initialize(results_name=None)
    lake = md.lake_bdry.astype(bool)
    far = ~lake
    far[md.dirichlet_nodes()] = False
    cx, cy = md.x[lake].mean(), md.y[lake].mean()
    far &= np.hypot(md.x - cx, md.y - cy) > 25e3   # cooke2_report.far_mask

    t0 = time.time()
    res = md.solve_steady(tol=tol, max_steps=max_steps)
    info = res["info"]
    N, b = res["N"], res["b"]
    out = {
        "solver": {k: info[k] for k in ("converged", "steps", "accepted",
                                        "rejected", "rate", "newton_total",
                                        "cg_total", "t_pseudo", "wall_s")},
        "tol_per_yr": tol,
        "dtype": "float64",
        "far_field_mean_N_MPa": round(float(N[far].mean()) / 1e6, 4),
        "far_field_ratio": round(float(N[far].mean()) / md.N_bdry, 4),
        "lake_mean_N_MPa": round(float(N[lake].mean()) / 1e6, 4),
        "mean_gap_mm": round(float(b.mean()) * 1e3, 3),
        "Q_out_m3s": round(float(res["Q_out"]), 4),
        "Q_src_m3s": round(float(res["Q_src"]), 4),
    }
    if os.path.exists(REF):
        ref = json.load(open(REF))["f64"]
        out["transient_year10_far_field_ratio"] = ref["far_field_ratio"]
        out["transient_year10_far_field_mean_N_MPa"] = ref["far_field_mean_N_MPa"]
        out["far_field_ratio_diff"] = round(
            abs(out["far_field_ratio"] - ref["far_field_ratio"]), 4)
    out["total_wall_s"] = round(time.time() - t0, 1)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    tol = float(sys.argv[sys.argv.index("--tol") + 1]) if "--tol" in sys.argv else 1e-3
    main(tol=tol)
