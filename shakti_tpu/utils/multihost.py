"""Multi-host launch support.

The reference scales out with `mpirun -np N python main.py <setup>`
(reference source/main.py + README): MPI ranks each own a mesh partition
via DOLFINx/PETSc.  The jax-native equivalent is one PROCESS PER HOST
(not per chip), each seeing its local chips, joined into one global
device mesh by `jax.distributed.initialize()`; the node-sharded SPMD
runner (parallel/dist.py) then shards over ALL global devices exactly as
it does over local ones — shard_map/psum/all_to_all are
topology-agnostic.

Launch (one process per host, each seeing its local GPUs):

    JAX_COORDINATOR_ADDRESS=host0:8476 JAX_NUM_PROCESSES=4 \
    JAX_PROCESS_ID=<0..3> python -m shakti_tpu setup_cooke2 --dist --multihost

IO note: the run layer (api/run.py) funnels all file IO through process 0
(`is_primary`) — directory creation, history memmaps, log.csv, checkpoints
and run_meta.json are primary-only, matching the reference's rank-0 gather
funnel (reference solvers.py:86-102,205-215).  Checkpoint RESUME reads
happen on every process and therefore assume a shared filesystem (the
reference makes the same assumption for its results dir).  Exercised for
real by tests/test_multihost.py: two coordinated CPU processes x 4 virtual
devices each must reproduce the single-process 8-device run.
"""

from __future__ import annotations

import os


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None):
    """Initialize jax.distributed.

    With explicit arguments (tests, bespoke launchers) they are passed
    straight to ``jax.distributed.initialize``; otherwise they come from
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``.  Returns (num_processes,
    process_id, is_primary).  With no coordinator configured the caller
    is single-process and gets (1, 0, True) without touching
    jax.distributed.  A failed initialization raises: a launcher that was
    asked for several processes must not carry on as one.
    """
    import jax

    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if not coordinator:
            return 1, 0, True
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return (jax.process_count(), jax.process_index(),
            jax.process_index() == 0)


def to_host(x):
    """Full global numpy value of ``x``, identical on EVERY process.

    Single-process (or fully-addressable) arrays are a plain
    device->host pull; fully-replicated global arrays read the local
    copy; sharded global arrays go through ONE allgather collective —
    so under multi-process execution every process must reach this call
    (the SPMD host loop in api/run.py does).  This is the jax-native
    equivalent of the reference's comm.gather IO funnel
    (reference solvers.py:205-215), except the gathered value lands on
    all ranks and only process 0 writes it (api/run.py primary gating).
    """
    import jax
    import numpy as np

    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(x)
    if x.sharding.is_fully_replicated:
        return np.asarray(x.addressable_data(0))
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
