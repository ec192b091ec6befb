"""Flagship-run validation figures for COOKE2_RUN.md.

Renders the reference solution-plots.ipynb battery (cells 7-13) as
committed PNGs from the production results directory (and the float64
CPU twin when present):

  * lake level vs time + fitted filling rate (cell 12),
  * far-field mean N vs the outflow boundary value (cell 13),
  * final-state field maps N / b / |q| (cell 12's movie panels),
  * full-horizon f32-vs-f64 relative drift (when the twin is complete).

    python scripts/cooke2_figures.py [results_dir] [f64_results_dir]

Writes assets/figures/cooke2_*.png (small, committed artifacts).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import matplotlib.tri as mtri
import numpy as np

os.environ.setdefault("SHAKTI_MESH_DIR",
                      os.path.join(os.path.dirname(os.path.dirname(
                          os.path.abspath(__file__))),
                          "assets", "cooke2_synth"))

import setups.setup_cooke2 as c2
from scripts.cooke2_report import drift_series, far_mask
from shakti_tpu import post

YEAR = 3.154e7
BLUE, ORANGE, INK, MUTED = "#4269d0", "#efb118", "#1a1a2e", "#9a9aa5"


def _style(ax):
    ax.grid(True, color="#e8e8ee", lw=0.6)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)


def run_label(rdir):
    """Legend label naming the device that produced ``rdir``
    (api/run.py records it in run_meta.json)."""
    import json

    meta_p = os.path.join(rdir, "run_meta.json")
    meta = json.load(open(meta_p)) if os.path.exists(meta_p) else {}
    return f"f32 run ({meta.get('device_kind', meta.get('platform', '?'))})"


def fig_lake_level(out, t_yr, res32, res64, lake, label):
    lvl = post.lake_level(res32["N"], lake)
    rate = post.filling_rate(res32["t"], res32["N"], lake) * YEAR
    fig, ax = plt.subplots(figsize=(6.4, 3.6))
    ax.plot(t_yr, lvl, color=BLUE, lw=1.6, label=label)
    if res64 is not None:
        lvl64 = post.lake_level(res64["N"], lake)
        ax.plot(t_yr[:lvl64.size], lvl64, color=ORANGE, lw=1.4, ls="--",
                label="f64 CPU twin")
        ax.legend(frameon=False, loc="lower right")
    ax.set_xlabel("time [yr]")
    ax.set_ylabel("lake level change [m]")
    ax.set_title(f"Cook_E2 lake level — fitted filling rate {rate:.3f} m/yr",
                 fontsize=10, color=INK)
    _style(ax)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def fig_far_field(out, t_yr, res32, res64, far, N_bdry, label):
    m32 = res32["N"][:, far].mean(axis=1) / 1e6
    fig, ax = plt.subplots(figsize=(6.4, 3.6))
    ax.axhline(N_bdry / 1e6, color=MUTED, lw=1.0, ls=":")
    ax.text(t_yr[-1], N_bdry / 1e6, " outflow BC 0.37 MPa", fontsize=8,
            color=MUTED, va="bottom", ha="right")
    ax.plot(t_yr, m32, color=BLUE, lw=1.6, label=label)
    if res64 is not None:
        m64 = res64["N"][:, far].mean(axis=1) / 1e6
        ax.plot(t_yr[:m64.size], m64, color=ORANGE, lw=1.4, ls="--",
                label="f64 CPU twin")
        ax.legend(frameon=False, loc="lower right")
    ratio = m32[-1] * 1e6 / N_bdry
    ax.set_xlabel("time [yr]")
    ax.set_ylabel("far-field mean N [MPa]")
    ax.set_title("Far-field effective pressure relaxes toward the BC "
                 f"(final ratio {ratio:.3f}; reference anchor 0.36/0.37)",
                 fontsize=10, color=INK)
    _style(ax)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def fig_final_fields(out, md, res32):
    x, y = res32["nodes_x"] / 1e3, res32["nodes_y"] / 1e3
    tri = mtri.Triangulation(x, y, md.cells)
    panels = [
        (res32["N"][-1] / 1e6, "N [MPa]"),
        (res32["b"][-1] * 1e3, "gap height b [mm]"),
        (np.hypot(res32["qx"][-1], res32["qy"][-1]), "|q| [m$^2$/s]"),
    ]
    fig, axs = plt.subplots(1, 3, figsize=(12.6, 3.8))
    for ax, (field, label) in zip(axs, panels):
        tc = ax.tripcolor(tri, field, cmap="viridis", shading="gouraud")
        fig.colorbar(tc, ax=ax, label=label)
        if getattr(md, "outline", None) is not None:
            ol = np.asarray(md.outline)
            ax.plot(ol[:, 0] / 1e3, ol[:, 1] / 1e3, "w--", lw=1.0)
        ax.set_xlabel("x [km]")
        ax.set_aspect("equal")
    axs[0].set_ylabel("y [km]")
    fig.suptitle("Cook_E2 final state (t = 10 yr); dashed: lake outline",
                 fontsize=10, color=INK)
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)


def fig_drift(out, t_yr, res32, res64):
    dN, db, m = drift_series(res32, res64)
    fig, ax = plt.subplots(figsize=(6.4, 3.6))
    ax.semilogy(t_yr[:m], dN, color=BLUE, lw=1.4, label="N")
    ax.semilogy(t_yr[:m], db, color=ORANGE, lw=1.4, ls="--", label="b")
    ax.set_xlabel("time [yr]")
    ax.set_ylabel("relative L2 difference (f32 vs f64)")
    ax.set_title("Full-horizon f32 drift decays after the cold-start "
                 "transient", fontsize=10, color=INK)
    ax.legend(frameon=False, loc="upper right")
    _style(ax)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def main(rdir="results/Cook_E2_370kpa",
         rdir64="results/Cook_E2_370kpa_f64cpu"):
    md = c2.initialize(days=3650, results_name=None)
    res32 = post.load_results(rdir)
    lake = md.lake_bdry.astype(bool)
    far = far_mask(md)
    t_yr = res32["t"] / YEAR

    res64 = None
    if os.path.isdir(rdir64) and os.path.exists(os.path.join(rdir64, "N.npy")):
        cand = post.load_results(rdir64)
        filled = np.flatnonzero(np.abs(cand["N"]).max(axis=1) > 0)
        if filled.size:
            # trim a still-running twin to its filled rows
            m = int(filled[-1]) + 1
            res64 = {k: (v[:m] if getattr(v, "ndim", 0) and
                         v.shape[0] == cand["N"].shape[0] else v)
                     for k, v in cand.items()}

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fdir = os.path.join(root, "assets", "figures")
    os.makedirs(fdir, exist_ok=True)
    fig_lake_level(os.path.join(fdir, "cooke2_lake_level.png"),
                   t_yr, res32, res64, lake, run_label(rdir))
    fig_far_field(os.path.join(fdir, "cooke2_far_field.png"),
                  t_yr, res32, res64, far, md.N_bdry, run_label(rdir))
    fig_final_fields(os.path.join(fdir, "cooke2_final_fields.png"), md, res32)
    if res64 is not None and res64["N"].shape[0] >= 365:
        fig_drift(os.path.join(fdir, "cooke2_drift.png"), t_yr, res32, res64)
    print("wrote", fdir)


if __name__ == "__main__":
    main(*sys.argv[1:])
