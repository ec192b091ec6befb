"""Structural performance-regression guards.

At the 12k bench size the step is launch-bound: step time tracks the
compiled program's kernel (fusion) count, and peak device memory tracks
the XLA temp allocation.  Both are properties of the compiled HLO, so they
can be pinned on the CPU backend without the GPU —
a regression of the kind found in r2 (each tiny einsum silently lowering to
its own convolution kernel + transposes, CLAUDE.md performance record) trips
these bounds long before anyone re-benches on hardware.

Bounds carry ~25-35% headroom over the measured values (CPU x64, jax 0.7
era): bell+lag 708 fusions / 3.80 MB temp, ell 496 / 1.49 MB for a 6-step
window at 289 nodes.  If a deliberate feature raises them, re-measure and
move the bound in the same commit — don't delete the guard.
"""

import re

import jax

import setups.setup_slab as slab
from shakti_tpu.solve.timestep import make_step_fn, run_window, timestep_sizes


def _compile_window(operator: str, n_steps: int = 6):
    md = slab.initialize(nx=16, ny=16, days=5.0, nt_per_day=6)
    md.operator = operator
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)[:n_steps]
    comp = jax.jit(lambda s, d: run_window(step, s, d)).lower(state, dts).compile()
    return comp, cfg


def _fusion_count(comp):
    return len(re.findall(r" = .*fusion\(", comp.as_text()))


def test_step_kernel_count_bell_lag():
    # the block-ELL + lag-carry configuration
    comp, cfg = _compile_window("bell")
    assert cfg.lag_operator            # auto rule picked the production mode
    n = _fusion_count(comp)
    assert n < 900, f"fusion count regressed: {n} (measured baseline 708)"
    ma = comp.memory_analysis()
    assert ma.temp_size_in_bytes < 8e6, (
        f"compiled temp memory regressed: {ma.temp_size_in_bytes/1e6:.2f} MB "
        "(measured baseline 3.80 MB)")


def test_step_kernel_count_ell():
    comp, cfg = _compile_window("ell")
    assert not cfg.lag_operator
    n = _fusion_count(comp)
    assert n < 650, f"fusion count regressed: {n} (measured baseline 496)"
    ma = comp.memory_analysis()
    assert ma.temp_size_in_bytes < 4e6, (
        f"compiled temp memory regressed: {ma.temp_size_in_bytes/1e6:.2f} MB "
        "(measured baseline 1.49 MB)")


def test_no_convolution_lowering():
    """The r2 regression class: tiny einsums lowering to convolution kernels
    (each with its own transposes/copies).  The compute path pins einsums to
    broadcast-sum arithmetic (fem/ops.ein docstring); a convolution in the
    compiled step means someone added a raw einsum/tensordot back."""
    comp, _ = _compile_window("bell")
    txt = comp.as_text()
    assert len(re.findall(r" = .*convolution\(", txt)) == 0
