"""Profiling / timing harness.

Rebuild of the observability gap in the reference (SURVEY.md §5 "Tracing /
profiling": absent beyond Keras progress bars): steady-state timing for
utterances/sec and latency percentiles, plus a ``jax.profiler`` trace
context for TensorBoard/Perfetto (the ``--profile`` flag on the experiment
CLIs routes here).

Every timing ends in ``jax.block_until_ready``: JAX returns before the
device finishes, so a timing without it measures the enqueue.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, Optional

import jax


def _percentiles(ts) -> Dict[str, float]:
    ts = sorted(ts)
    return {
        "mean_s": sum(ts) / len(ts),
        "p50_s": statistics.median(ts),
        "p95_s": ts[min(len(ts) - 1, int(0.95 * len(ts)))],
        "min_s": ts[0],
    }


def _warm(fn, args, kw, warmup: int) -> None:
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args, **kw))


def time_fn(
    fn: Callable,
    *args,
    iters: int = 30,
    warmup: int = 5,
    **kw,
) -> Dict[str, float]:
    """Seconds per call of a (jitted) fn: ``iters`` calls, each waited for.

    Returns mean / p50 / p95 / min over the calls; the first call (compile)
    and ``warmup`` more run before timing starts.
    """
    _warm(fn, args, kw, warmup)
    ts = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    return _percentiles(ts)


def single_request_latency(
    fn: Callable, *args, samples: int = 20, warmup: int = 3, **kw
) -> Dict[str, float]:
    """Single-request latency: dispatch → result in host memory, what a
    client waits for one request (includes the device→host copy)."""
    _warm(fn, args, kw, warmup)
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        jax.device_get(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    return _percentiles(ts)


def throughput(
    fn: Callable, *args, items_per_call: int, iters: int = 30, warmup: int = 5, **kw
) -> Dict[str, float]:
    """items/sec of a (jitted) fn over ``iters`` back-to-back calls, with one
    wait at the end (calls pipeline on the device, as in a serving loop).

    Queued calls keep their outputs alive; for fns with large outputs time
    ``jit(lambda *a: fn(*a).sum())`` instead so the window measures compute,
    not allocator pressure.
    """
    _warm(fn, args, kw, warmup)
    n = max(iters, 1)
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    sec_per_call = max((time.perf_counter() - t0) / n, 1e-9)
    return {
        "items_per_sec": items_per_call / sec_per_call,
        "sec_per_call": sec_per_call,
    }


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """jax.profiler trace context (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield


class StepTimer:
    """Rolling step-time tracker for train loops (host-side, cheap)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.samples: list = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.window:
                self.samples.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        return {
            "step_p50_s": statistics.median(s),
            "step_p95_s": s[min(len(s) - 1, int(0.95 * len(s)))],
            "steps_per_sec": 1.0 / (sum(s) / len(s)),
        }
