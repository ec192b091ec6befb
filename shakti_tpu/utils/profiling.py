"""Profiling / timing utilities.

The reference's only performance instrumentation is a wall clock around the
whole mpirun (example.ipynb cell-4) and a progress printf (solvers.py:170).
Here (SURVEY §5 tracing row):

  * :class:`Timer` — block_until_ready-correct wall timing of jax work;
  * :func:`time_steps` — steady-state ms/step measurement harness (what
    bench.py uses conceptually);
  * :func:`trace` — context manager around jax.profiler for device traces
    viewable in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import time

import jax


class Timer:
    """with Timer() as t: ... ; t.ms — blocks on all outstanding work."""

    def __enter__(self):
        jax.effects_barrier()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self.ms = self.seconds * 1e3
        return False

    def stop(self, *arrays):
        """Block on ``arrays`` then record elapsed time."""
        jax.block_until_ready(arrays)
        self.seconds = time.perf_counter() - self._t0
        self.ms = self.seconds * 1e3
        return self


def time_fn(fn, *args, iters: int = 10, warmup: int = 1):
    """Mean wall ms per call of a jitted function (device-synchronized)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def time_steps(runner, state, dts, windows: int = 5):
    """Steady-state ms/step of a window runner (state, dts) -> (state, diag)."""
    state, _ = runner(state, dts)          # compile + settle
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(windows):
        state, diag = runner(state, dts)
    jax.block_until_ready(state)
    per_step = (time.perf_counter() - t0) / (windows * dts.shape[0]) * 1e3
    return per_step, state, diag


@contextlib.contextmanager
def trace(logdir: str):
    """Device trace via jax.profiler (open with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
