"""Batched ensembles: vmap the timestep over perturbed model states.

A parallel axis the reference does not have (SURVEY §2c notes it as the
cheap JAX-native extension): the whole Newton-Krylov timestep is a pure
function, so `jax.vmap` turns it into an ensemble integrator — e.g. for
uncertainty quantification over the stochastic initial gap height that the
reference draws unseeded (setup_cooke2.py:66).  Composes with jit and with
the SPMD cell-sharding (vmap inside, shard_map outside).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shakti_tpu.solve.timestep import State, make_step_fn, run_window


def stack_states(states) -> State:
    """Stack a list of States into one batched State (leading ensemble axis)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def perturbed_ensemble(state: State, n_members: int, *, b_scale: float = 5e-4,
                       seed: int = 0) -> State:
    """Ensemble of initial states with perturbed gap height b (the
    reference's stochastic IC, made a controlled ensemble axis)."""
    rng = np.random.default_rng(seed)
    members = []
    for _ in range(n_members):
        db = jnp.asarray(rng.normal(scale=b_scale, size=state.b.shape),
                         state.b.dtype)
        # no lag carry: make_ensemble_step_fn forces lag_operator=False
        # (vmap lowers lax.cond to select — both branches execute — so the
        # lagged path would rebuild the operator every step AND pay the
        # carry's memory M times)
        members.append(State(N=state.N, b=state.b + db, q=state.q,
                             melt=state.melt, N_prev=state.N_prev))
    return stack_states(members)


def make_ensemble_step_fn(mesh, static, params, cfg):
    """step(batched_state, dt) -> (batched_state, batched_diagnostics).

    Forces ``lag_operator=False``: under vmap, XLA lowers ``lax.cond`` to
    ``select`` (both branches execute every step), so the lagged-operator
    carry degrades to always-rebuild plus M carried copies of the folded
    operator values — strictly worse than the plain path.  The plain step
    is what vmap amortizes well: every kernel widens by the member axis
    instead of multiplying the launch count."""
    import dataclasses

    cfg = dataclasses.replace(cfg, lag_operator=False)
    step = make_step_fn(mesh, static, params, cfg)
    return jax.vmap(step, in_axes=(0, None))


def make_ensemble_runner(mesh, static, params, cfg):
    """jit-compiled (batched_state, dts) -> (batched_state, diags)."""
    estep = make_ensemble_step_fn(mesh, static, params, cfg)
    return jax.jit(lambda s, d: run_window(estep, s, d))
