"""Profiling harness unit tests."""

import jax.numpy as jnp

from voicemap.utils import profiling


def test_time_fn():
    f = lambda x: x * 2.0
    stats = profiling.time_fn(f, jnp.ones((8, 8)), iters=5, warmup=1)
    assert set(stats) == {"mean_s", "p50_s", "p95_s", "min_s"}
    assert stats["min_s"] <= stats["p50_s"] <= stats["p95_s"]


def test_throughput():
    f = lambda x: x + 1.0
    r = profiling.throughput(f, jnp.ones((4,)), items_per_call=4, iters=5, warmup=1)
    assert r["items_per_sec"] > 0
    assert r["sec_per_call"] > 0


def test_trace_noop():
    with profiling.trace(None):
        pass


def test_step_timer():
    t = profiling.StepTimer(window=3)
    assert t.stats() == {}
    for _ in range(5):
        t.tick()
    s = t.stats()
    assert len(t.samples) == 3
    assert s["steps_per_sec"] > 0


def test_single_request_latency():
    f = lambda x: (x * 2).sum()
    stats = profiling.single_request_latency(f, jnp.ones((8, 8)), samples=5)
    assert stats["min_s"] > 0
    assert stats["p50_s"] >= stats["min_s"]
    assert stats["p95_s"] >= stats["p50_s"]
