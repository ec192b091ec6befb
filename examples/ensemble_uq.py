"""Ensemble uncertainty quantification over the stochastic gap-height IC.

The reference seeds channelization with an UNSEEDED random initial gap
height (reference setups/setup_cooke2.py:66) — every run samples one draw
and reports a single trajectory.  Here the draw becomes a controlled
ensemble axis (parallel/ensemble.py): `vmap` turns the whole Newton–Krylov
timestep into a batched integrator, so M perturbed members integrate in
ONE XLA program on one device, amortizing per-kernel launch overhead
across the batch (scripts/ensemble_bench.py measures the throughput).

This demo integrates a slab transient under M perturbed b-ICs and prints
the ensemble spread of the outlet effective pressure — the uncertainty the
reference's single unseeded draw hides.

    python examples/ensemble_uq.py            (~2 min, CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import setups.setup_slab as slab
from shakti_tpu.parallel.ensemble import (make_ensemble_runner,
                                          perturbed_ensemble)
from shakti_tpu.solve.timestep import timestep_sizes


def main(members: int = 8, days: float = 5.0):
    md = slab.initialize(nx=24, ny=24, days=days, nt_per_day=8)
    mesh, static, state, cfg = md.freeze()
    ens = perturbed_ensemble(state, members, b_scale=5e-4, seed=0)
    runner = make_ensemble_runner(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)

    win = int(md.nt_save)
    lo = np.asarray(static.dirichlet, bool)  # outlet nodes (Dirichlet row)
    print(f"# {members} members x {dts.shape[0]} steps, "
          f"{mesh.n_nodes} nodes, backend={jax.devices()[0].platform}")
    for j in range(dts.shape[0] // win):
        ens, diag = runner(ens, dts[j * win:(j + 1) * win])
        assert bool(np.asarray(diag["converged"]).all())
        N = np.asarray(ens.N) / 1e6                      # (M, n) MPa
        inner = N[:, ~lo]
        day = (j + 1) * win / 8
        print(f"day {day:5.2f}  mean N {inner.mean():8.5f} MPa  "
              f"ensemble spread (std of member means) "
              f"{inner.mean(axis=1).std():.2e} MPa  "
              f"max member spread {(inner.max(0) - inner.min(0)).max():.2e}")

    # headline: the IC uncertainty the single-draw reference run hides
    final = np.asarray(ens.N)[:, ~lo].mean(axis=1) / 1e6
    print(f"final mean-N across members: {final.mean():.6f} MPa "
          f"+/- {final.std():.2e} (M={members})")
    return 0


if __name__ == "__main__":
    sys.exit(main(*[int(a) if a.isdigit() else float(a)
                    for a in sys.argv[1:]]))
