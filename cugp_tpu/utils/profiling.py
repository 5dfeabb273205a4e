"""Tracing/profiling helpers (SURVEY.md section 5, aux subsystems).

The reference prints CUDA-event wall-clock timings from its driver; the
equivalents here: profiler trace capture (jax.profiler), compiled cost
analysis per op, and a small wall-clock timer with FLOP models for the
benchmark harness (BASELINE.json:2 metric definitions).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def xprof_trace(logdir):
    """Capture a profiler trace of the enclosed block (view with
    tensorboard or perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def cost_analysis(fn, *args):
    """XLA's own FLOP/byte estimates for jit(fn)(*args)."""
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, list):
        costs = costs[0]
    return costs


def timed_loop(step_fn, init, iters=8, warmup=True):
    """Per-iteration seconds of step_fn chained on-device iters times.

    The loop runs inside one jit (lax.scan with a data dependency through
    the carry), so sub-millisecond ops are timed without per-call dispatch.
    step_fn must return something of the same structure as its input.
    """

    @jax.jit
    def run(x):
        def body(c, _):
            return step_fn(c), None

        c, _ = jax.lax.scan(body, x, None, length=iters)
        return c

    if warmup:
        jax.block_until_ready(run(init))
    t0 = time.perf_counter()
    jax.block_until_ready(run(init))
    return (time.perf_counter() - t0) / iters


def timed(fn, *args, warmup=1, iters=5):
    """Median wall-clock seconds of fn(*args), ended by block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


# FLOP models (BASELINE.md): the accounting used by every benchmark
def chol_flops(n):
    return n**3 / 3.0


def cov_flops(n1, n2, d):
    return 2.0 * n1 * n2 * d


def trsm_flops(n, n_rhs):
    return float(n) * n * n_rhs


def gflops(flops, seconds):
    return flops / seconds / 1e9
