"""SPMD domain decomposition over a jax device mesh via shard_map.

JAX re-provision of the reference's single parallelism strategy —
spatial decomposition of the unstructured mesh over MPI ranks with ghost
exchange (SURVEY §2c) — re-shaped for XLA collectives:

  * cells are partitioned by RCB (parallel/partition.py) and sharded over a
    1-D device mesh axis; each device assembles its own cells' element
    contributions (the embarrassingly-parallel 99% of the FLOPs);
  * nodal state is replicated; one `psum` over the mesh axis completes each
    assembly (fem/ops.scatter_add_cells) — this single explicit collective
    replaces the reference's ghost-accumulate + scatter_forward +
    Krylov-dot allreduce zoo (SURVEY §2d): Krylov vector algebra runs
    replicated, so dots/norms need no communication at all;
  * every device executes the identical Newton/CG control flow on replicated
    reductions, so control flow stays SPMD-consistent by construction (no
    mutable ghost state to race on — SURVEY §5 race-detection row).

This "sharded-cells, replicated-nodes" scheme is exact (bit-identical math
to single-device up to floating-point reduction order) and scales compute
and cell memory by n_devices; nodal memory is replicated, which comfortably
fits ~10M-dof problems in HBM.  The fully node-sharded scheme with explicit
halo exchange lives in parallel/halo.py + parallel/dist.py (the weak-scaling
path beyond that).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs, check_vma=True):
    # check_vma=False is REQUIRED when reverse-mode differentiating a
    # body that contains a custom_vjp (the IFT adjoint,
    # solve/implicit.py): the varying-manual-axes tracker cannot type
    # custom_vjp cotangents and silently drops them (zero gradients;
    # reduced repro in tests/test_adjoint.py history).  The untracked
    # transpose routes them correctly.
    return _shard_map(f, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=check_vma)


from shakti_tpu.mesh.mesh import Mesh
from shakti_tpu.parallel.partition import pad_to_blocks, partition_cells
from shakti_tpu.solve.timestep import make_step_fn, run_window


def make_device_mesh(n_devices: int | None = None, axis: str = "x") -> DeviceMesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return DeviceMesh(np.array(devs[:n]), (axis,))


def shard_cell_data(mesh: Mesh, gb0, jmesh: DeviceMesh, axis: str = "x"):
    """Partition + pad the global mesh's cell data and place it sharded.

    Returns (cell_arrays, n_block) where cell_arrays is a dict of arrays of
    leading dim n_devices * n_block, device-sharded along the mesh axis.
    """
    ndev = jmesh.shape[axis]
    nodes_np = np.asarray(mesh.nodes)
    cells_np = np.asarray(mesh.cells)
    order, counts = partition_cells(nodes_np, cells_np, ndev)
    idx, valid = pad_to_blocks(order, counts)            # (ndev, block)
    block = idx.shape[1]
    flat = idx.reshape(-1)

    sharding = NamedSharding(jmesh, P(axis))
    put = lambda a: jax.device_put(a, sharding)
    arrays = {
        "cells": put(mesh.cells[flat]),
        "area": put(mesh.area[flat]),
        "grads": put(mesh.grads[flat]),
        "valid": put(mesh.cell_valid[flat] * jnp.asarray(
            valid.reshape(-1), dtype=mesh.area.dtype)),
        "gb0": put(gb0[flat]),
    }
    return arrays, block


def make_parallel_step_fn(mesh: Mesh, static, params, cfg,
                          jmesh: DeviceMesh, axis: str = "x"):
    """Build step(state, dt) running cell-sharded over ``jmesh``.

    Drop-in replacement for solve/timestep.make_step_fn: same signature,
    same results (up to reduction order), executed SPMD.
    """
    # the per-shard cell meshes have no foldable operator structure, so the
    # lagged-operator carry cannot apply here (freeze may have auto-enabled
    # it for the global bell mesh)
    cfg = dataclasses.replace(cfg, lag_operator=False)
    cell_arrays, _ = shard_cell_data(mesh, static.gb0, jmesh, axis)
    # gb0 travels sharded; blank it in the replicated static payload
    static_slim = dataclasses.replace(
        static, gb0=jnp.zeros((1, 2), dtype=mesh.area.dtype))

    def body(cells_l, area_l, grads_l, valid_l, gb0_l,
             nodes, node_area, static_in, state, dt):
        lmesh = Mesh(nodes=nodes, cells=cells_l, area=area_l,
                     grads=grads_l, node_area=node_area,
                     cell_valid=valid_l, paxis=axis)
        lstatic = dataclasses.replace(static_in, gb0=gb0_l)
        return make_step_fn(lmesh, lstatic, params, cfg)(state, dt)

    sharded = shard_map(
        body, mesh=jmesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(), P(), P(), P(), P()),
        out_specs=(P(), P()),
    )

    def step(state, dt):
        return sharded(cell_arrays["cells"], cell_arrays["area"],
                       cell_arrays["grads"], cell_arrays["valid"],
                       cell_arrays["gb0"], mesh.nodes, mesh.node_area,
                       static_slim, state, dt)

    return step


def make_parallel_runner(mesh, static, params, cfg, jmesh, axis: str = "x"):
    """jit-compiled (state, dts) -> (state, diags) window runner, SPMD."""
    step = make_parallel_step_fn(mesh, static, params, cfg, jmesh, axis)
    return jax.jit(lambda s, d: run_window(step, s, d))
