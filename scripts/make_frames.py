"""Regenerate the committed 6-panel movie-frame figure set (VERDICT r4
item 7 done-bar: committed figures from a real run).

Runs the synthetic lake filling/draining experiment (setups/setup_lake.py
— storage + outflow + lake mask, i.e. every panel of the reference's
solution-plots.ipynb cell-12 composition is exercised, including the
lake-level regression row) on the CPU backend at a reduced horizon, then
renders frames with post.render_frames and copies first / middle / last
into assets/figures/.

    JAX_PLATFORMS=cpu python scripts/make_frames.py [days]
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    days = float(sys.argv[1]) if len(sys.argv) > 1 else 90.0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "setups"))
    import setup_lake
    from shakti_tpu import post
    from shakti_tpu.api.run import solve

    rdir = os.path.join(repo, "results", "lake_frames")
    md = setup_lake.initialize(days=days, results_name=rdir)
    if os.path.isdir(rdir):
        shutil.rmtree(rdir)
    solve(md, progress=True)

    res = post.load_results(rdir)
    frames_dir = os.path.join(rdir, "frames")
    nt = res["t"].size
    import numpy as np
    lake_mask = np.asarray(md.lake_bdry) > 0.5
    outflow_mask = np.zeros(md.x.size, bool)
    outflow_mask[md.dirichlet_nodes()] = True
    out = post.render_frames(
        res, frames_dir, every=max(1, nt // 12),
        lake_mask=lake_mask, storage_on=True,
        outflow_mask=outflow_mask, cells=md.cells)
    print(f"rendered {out['frames']} frames x {out['panels']} panels")

    import glob
    frames = sorted(glob.glob(os.path.join(frames_dir, "*.png")))
    figdir = os.path.join(repo, "assets", "figures")
    for tag, idx in (("first", 0), ("mid", len(frames) // 2),
                     ("last", len(frames) - 1)):
        dst = os.path.join(figdir, f"lake_frame_{tag}.png")
        shutil.copy(frames[idx], dst)
        print("committed-figure candidate:", dst)


if __name__ == "__main__":
    sys.exit(main())
