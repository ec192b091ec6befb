"""Command-line launcher (reference source/main.py equivalent).

    python -m shakti_tpu <setup_module> [--resume]

The reference's contract (main.py:8-21): import the named module from a
``setups/`` directory, call ``initialize()`` to get a model object, then
``md.solve()``.  We keep that contract minus MPI: a single process drives
the local GPUs through jax (one device unless ``--dist``); multi-host
launches use jax.distributed (see shakti_tpu.parallel) under the same
entry point.  XLA executables persist in JAX's compilation cache
(shakti_tpu.utils.backend), so repeat runs skip the large-mesh compiles.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys


def load_setup(name: str):
    """Import a setup module by name (searched in ./setups and CWD) or path."""
    if name.endswith(".py") and os.path.exists(name):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(name))[0], name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    for d in (os.path.join(os.getcwd(), "setups"), os.getcwd()):
        if os.path.exists(os.path.join(d, name + ".py")) and d not in sys.path:
            sys.path.insert(0, d)
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if getattr(e, "name", None) == name:
            raise SystemExit(
                f"error: setup module '{name}' not found — looked for "
                f"{name}.py in ./setups and the current directory, and on "
                "PYTHONPATH. Pass a module name or a path to a .py file.")
        raise


def main(argv=None):
    ap = argparse.ArgumentParser(prog="shakti_tpu",
                                 description="SHAKTI subglacial hydrology on GPUs (JAX/XLA)")
    ap.add_argument("setup", help="setup module name (in ./setups) or a .py path")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in the results directory")
    ap.add_argument("--dist", action="store_true",
                    help="node-sharded SPMD over all local jax devices")
    ap.add_argument("--multihost", action="store_true",
                    help="join a multi-host pod run via jax.distributed "
                         "(JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/"
                         "JAX_PROCESS_ID); run one process per host")
    ap.add_argument("--steady", action="store_true",
                    help="solve directly for the steady state "
                         "(pseudo-transient continuation) instead of "
                         "marching md.timesteps; writes steady.npz + "
                         "steady_info.json to <results_name>_steady/")
    ap.add_argument("--steady-tol", type=float, default=1e-2, metavar="TOL",
                    help="steady drift tolerance per year (default 1e-2)")
    ap.add_argument("--polish", action="store_true",
                    help="with --steady: after the PTC march, solve the "
                         "coupled (N, b) steady system directly by "
                         "monolithic Newton (certifies channelized "
                         "regimes the staggered march plateaus on; "
                         "single-device only)")
    ap.add_argument("--cycle-window", type=int, default=0, metavar="K",
                    help="with --steady: if the drift certificate cannot "
                         "fire (persistently cycling regime), march two "
                         "windows of K accepted pseudo-steps and certify "
                         "the LIMIT CYCLE instead (orbit centroid "
                         "stationary to tol/yr); output becomes the "
                         "cycle-mean state (default 0 = off)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from shakti_tpu.utils.backend import enable_compile_cache
    cache_dir = enable_compile_cache()
    if not args.quiet:
        print(f"compilation cache: {cache_dir}")

    if args.multihost:
        from shakti_tpu.utils.multihost import init_multihost
        nproc, pid, primary = init_multihost()
        if not args.quiet and primary:
            print(f"multihost: {nproc} processes")
        if nproc > 1:
            # multi-process execution only exists on the node-sharded
            # path; a per-process single-device run would race on IO
            args.dist = True

    setup = load_setup(args.setup)
    md = setup.initialize()
    if md.setup_file is None and getattr(setup, "__file__", None):
        md.setup_file = setup.__file__
    if args.dist:
        md.distributed = True
    if args.steady:
        import json

        import numpy as np
        out = md.solve_steady(tol=args.steady_tol,
                              cycle_window=args.cycle_window,
                              polish=args.polish)
        info = out["info"]
        verdict = info.get("verdict", "steady")
        print(f"\n{verdict} state in {info['steps']} PTC steps "
              f"({info['rejected']} rejected, {info['newton_total']} Newton)"
              f" — drift {info['rate']:.2e}/t_ref, wall {info['wall_s']:.2f} s")
        if verdict == "cycle":
            print(f"limit cycle certified: centroid rate "
                  f"{info['cycle_rate']:.2e}/t_ref, relative amplitude "
                  f"N {info['cycle_amp_N']:.2e} / b {info['cycle_amp_b']:.2e}"
                  f" — fields are the cycle mean")
        if "Q_out" in out:
            print(f"mass budget: boundary discharge {float(out['Q_out']):.6g}"
                  f" vs production {float(out['Q_src']):.6g} m^3/s")
        if md.results_name is not None:
            rdir = f"{md.results_name}_steady"
            os.makedirs(rdir, exist_ok=True)
            np.savez(os.path.join(rdir, "steady.npz"), N=out["N"],
                     b=out["b"], qx=out["qx"], qy=out["qy"])
            info_j = dict(info)
            for k in ("Q_out", "Q_src"):
                if k in out:
                    info_j[k] = float(out[k])
            with open(os.path.join(rdir, "steady_info.json"), "w") as f:
                json.dump(info_j, f, indent=1)
            if not args.quiet:
                print(f"wrote {rdir}/steady.npz")
        return 0
    out = md.solve(resume=args.resume, progress=not args.quiet)
    print(f"\ncompleted {out['steps']} steps in {out['wall_time']:.2f} s "
          f"({1e3 * out['wall_time'] / max(out['steps'], 1):.3f} ms/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
