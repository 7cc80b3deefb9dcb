"""Profiling hooks (SURVEY §5: the reference has only `verbose` prints and
stats tuples; this build adds `jax.profiler` integration).

Usage:

    from exponentialutilities_jl_tpu.utils.profiling import trace, annotate

    with trace("/tmp/jax-trace"):            # view in TensorBoard/XProf
        with annotate("expv-production"):
            w = expv(t, op, b, m=30)

A profiler that cannot start raises: a measurement that silently records
nothing is worse than one that fails.

``timed`` is the one warm-time loop of ``chip_smoke.py`` and ``bench.py``.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import jax

__all__ = ["trace", "annotate", "timed"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed block into ``log_dir``
    (TensorBoard / XProf format)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region in the profiler timeline
    (``jax.profiler.TraceAnnotation``)."""
    return jax.profiler.TraceAnnotation(name)


def timed(fn, reps: int = 3):
    """``(fn(), first-call seconds, median warm seconds)``.

    Every call ends in ``jax.block_until_ready``, so the first call holds
    tracing and compilation and the ``reps`` warm calls do not; with
    ``reps=0`` the warm time is None."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return out, first, statistics.median(warm) if warm else None
