"""Distance-kernel tests: matmul-form matrices vs brute-force numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.ops import distance as D


@pytest.fixture(scope="module")
def qs(rng=None):
    r = np.random.default_rng(0)
    q = r.standard_normal((7, 32)).astype(np.float32)
    s = r.standard_normal((11, 32)).astype(np.float32)
    return q, s


def brute(q, s, fn):
    return np.array([[fn(a, b) for b in s] for a in q], dtype=np.float32)


def test_sq_euclidean(qs):
    q, s = qs
    out = np.asarray(D.pairwise_sq_euclidean(jnp.asarray(q), jnp.asarray(s)))
    expect = brute(q, s, lambda a, b: np.sum((a - b) ** 2))
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


def test_euclidean(qs):
    q, s = qs
    out = np.asarray(D.pairwise_euclidean(jnp.asarray(q), jnp.asarray(s)))
    expect = brute(q, s, lambda a, b: np.linalg.norm(a - b))
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


def test_l1(qs):
    q, s = qs
    out = np.asarray(D.pairwise_l1(jnp.asarray(q), jnp.asarray(s)))
    expect = brute(q, s, lambda a, b: np.abs(a - b).sum())
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_weighted_l1(qs):
    q, s = qs
    r = np.random.default_rng(1)
    w = r.standard_normal((32, 1)).astype(np.float32)
    b = np.float32(0.3)
    out = np.asarray(
        D.pairwise_weighted_l1(jnp.asarray(q), jnp.asarray(s), jnp.asarray(w), b)
    )
    expect = brute(q, s, lambda a, c: np.abs(a - c) @ w[:, 0] + b)
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


def test_cosine(qs):
    q, s = qs
    out = np.asarray(D.pairwise_cosine_distance(jnp.asarray(q), jnp.asarray(s)))
    expect = brute(
        q, s,
        lambda a, b: 1 - a @ b / (np.linalg.norm(a) * np.linalg.norm(b)),
    )
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


def test_sq_euclidean_self_zero():
    r = np.random.default_rng(2)
    q = r.standard_normal((5, 16)).astype(np.float32)
    out = np.asarray(D.pairwise_sq_euclidean(jnp.asarray(q), jnp.asarray(q)))
    np.testing.assert_allclose(np.diag(out), 0.0, atol=1e-4)
    assert (out >= 0).all()


def test_class_distances():
    d = jnp.asarray(np.arange(12, dtype=np.float32).reshape(2, 6))
    out = np.asarray(D.class_distances(d, n=2, k=3))
    expect = np.asarray(d).reshape(2, 3, 2).mean(-1)
    np.testing.assert_allclose(out, expect)


def test_merge_features_shapes():
    r = np.random.default_rng(3)
    e1 = jnp.asarray(r.standard_normal((4, 8)), jnp.float32)
    e2 = jnp.asarray(r.standard_normal((4, 8)), jnp.float32)
    assert D.merge_features(e1, e2, "weighted_l1").shape == (4, 8)
    for m in ("uniform_l1", "uniform_euclidean", "dot_product", "cosine_distance"):
        assert D.merge_features(e1, e2, m).shape == (4, 1)
    with pytest.raises(ValueError):
        D.merge_features(e1, e2, "nope")
