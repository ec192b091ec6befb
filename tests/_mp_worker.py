"""Worker process for tests/test_multihost.py — NOT a test module.

Runs one of N coordinated processes of a distributed transient solve:

    python _mp_worker.py <process_id> <num_processes> <port> <results_dir>

Each process sees 4 virtual CPU devices; jax.distributed joins them into
one 8-device global mesh (the multi-process twin of the single-process
8-device runs the rest of the suite uses).  Mirrors the reference's
`mpirun -np N python main.py <setup>` entry (reference main.py:7-21).
"""

import os
import sys

pid, nproc = int(sys.argv[1]), int(sys.argv[2])
port, rdir = sys.argv[3], sys.argv[4]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shakti_tpu.utils.multihost import init_multihost  # noqa: E402

n, p, primary = init_multihost(f"localhost:{port}", num_processes=nproc,
                               process_id=pid)
assert (n, p) == (nproc, pid), (n, p)
assert len(jax.devices()) == 4 * nproc, jax.devices()

import dataclasses  # noqa: E402

import setups.setup_slab as slab  # noqa: E402

md = slab.initialize(nx=10, ny=10, days=2.0, nt_per_day=4,
                     results_name=rdir)
md.solver = dataclasses.replace(md.solver, precond="jacobi")
md.distributed = True
out = md.solve(progress=False)
print(f"[proc {pid}] ok steps={out['steps']} pulls={out['host_pulls']}",
      flush=True)
