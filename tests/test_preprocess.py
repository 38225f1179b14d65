"""Preprocessing op tests: jnp chain vs numpy reference semantics
(SURVEY.md §4 items 1 & 3 — the parity harness substituting for
bit-comparison against the unreadable reference)."""

import jax
import jax.numpy as jnp
import numpy as np

from voicemap.ops import preprocess


def np_whiten(batch, rms=0.038021, eps=1e-8):
    """Numpy reference semantics of voicemap/utils.py :: whiten."""
    mean = batch.mean(axis=1, keepdims=True)
    centered = batch - mean
    cur = np.sqrt((centered**2).mean(axis=1, keepdims=True))
    return centered * (rms / (cur + eps))


def test_whiten_matches_numpy(rng):
    x = rng.standard_normal((4, 1000)).astype(np.float32)
    out = np.asarray(preprocess.whiten(jnp.asarray(x)))
    np.testing.assert_allclose(out, np_whiten(x), rtol=1e-5, atol=1e-6)


def test_whiten_properties(rng):
    x = (rng.standard_normal((8, 4096)) * 0.3 + 0.5).astype(np.float32)
    out = np.asarray(preprocess.whiten(jnp.asarray(x), rms=0.038021))
    np.testing.assert_allclose(out.mean(axis=1), 0.0, atol=1e-6)
    np.testing.assert_allclose(
        np.sqrt((out**2).mean(axis=1)), 0.038021, rtol=1e-4
    )


def test_whiten_zero_signal_safe():
    x = jnp.zeros((2, 256), jnp.float32)
    out = np.asarray(preprocess.whiten(x))
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, 0.0)


def test_whiten_3d_shape(rng):
    x = rng.standard_normal((3, 500, 1)).astype(np.float32)
    out = np.asarray(preprocess.whiten(jnp.asarray(x)))
    assert out.shape == x.shape
    np.testing.assert_allclose(out[..., 0], np_whiten(x[..., 0]), rtol=1e-5, atol=1e-6)


def test_stride_decimate_equals_numpy_slice(rng):
    x = rng.standard_normal((2, 48000)).astype(np.float32)
    for d in (1, 2, 4, 8):
        out = np.asarray(preprocess.stride_decimate(jnp.asarray(x), d))
        np.testing.assert_array_equal(out, x[:, ::d])


def test_extract_fragments(rng):
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    offs = jnp.asarray([0, 100, 500])
    out = np.asarray(preprocess.extract_fragments(jnp.asarray(x), offs, 400))
    for i, o in enumerate([0, 100, 500]):
        np.testing.assert_array_equal(out[i], x[i, o : o + 400])


def test_gather_fragments(rng):
    store = rng.integers(-30000, 30000, size=(10, 2000)).astype(np.int16)
    idx = jnp.asarray([3, 7, 0])
    offs = jnp.asarray([10, 500, 0])
    out = np.asarray(
        preprocess.gather_fragments(jnp.asarray(store), idx, offs, 800)
    )
    for r, (i, o) in enumerate([(3, 10), (7, 500), (0, 0)]):
        np.testing.assert_array_equal(out[r], store[i, o : o + 800])


def test_preprocess_batch_end_to_end(rng):
    """Fused chain == numpy: gather → ÷32768 → [::d] → whiten."""
    raw = rng.integers(-32768, 32767, size=(5, 48000)).astype(np.int16)
    offs = np.array([0, 5, 11, 100, 7], dtype=np.int32)
    frag_len, d = 32000, 4
    out = np.asarray(
        preprocess.preprocess_batch(
            jnp.asarray(raw), jnp.asarray(offs), frag_len, d
        )
    )
    assert out.shape == (5, frag_len // d, 1)
    expect = np.stack([raw[i, o : o + frag_len] for i, o in enumerate(offs)])
    expect = expect.astype(np.float32) / 32768.0
    expect = expect[:, ::d]
    expect = np_whiten(expect)
    np.testing.assert_allclose(out[..., 0], expect, rtol=1e-4, atol=1e-6)


def test_sample_offsets_bounds():
    key = jax.random.PRNGKey(0)
    lengths = jnp.asarray([1000, 500, 400, 2000], jnp.int32)
    frag = 400
    offs = np.asarray(preprocess.sample_offsets(key, lengths, frag))
    assert (offs >= 0).all()
    assert (offs <= np.asarray([600, 100, 0, 1600])).all()
    det = np.asarray(
        preprocess.sample_offsets(key, lengths, frag, stochastic=False)
    )
    np.testing.assert_array_equal(det, 0)


def test_sample_offsets_distribution():
    """Offsets roughly uniform over the valid range (SURVEY.md §4: offset
    distribution invariant)."""
    key = jax.random.PRNGKey(1)
    lengths = jnp.full((4000,), 1000, jnp.int32)
    offs = np.asarray(preprocess.sample_offsets(key, lengths, 500))
    assert offs.min() == 0
    assert offs.max() == 500
    assert abs(offs.mean() - 250) < 20
