"""The on-device preprocessing chain (gather → ÷32768 → stride-decimate →
whiten, as ``train.steps.fetch_batch`` runs it) against the host numpy
reference of ``data/preprocessing.py``, over its edge cases; and the L1
distance forms against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.config import DataConfig, ExperimentConfig
from voicemap.data import preprocessing as host
from voicemap.ops import distance as dist_ops
from voicemap.ops import preprocess
from voicemap.train import steps


def host_chain(store, idx, offs, frag, ds, whiten=True):
    frags = np.stack([store[i, o:o + frag] for i, o in zip(idx, offs)])
    x = frags.astype(np.float32) / 32768.0
    return host.preprocess_instances(ds, whitening=whiten)(x)


def make_case(seed, N, T_store, frag, B):
    rng = np.random.default_rng(seed)
    store = rng.integers(-30000, 30000, (N, T_store), dtype=np.int16)
    idx = rng.integers(0, N, B).astype(np.int32)
    offs = rng.integers(0, T_store - frag, B).astype(np.int32)
    return store, idx, offs


def device_chain(store, idx, offs, frag, ds, whiten_rms=preprocess.DEFAULT_WHITEN_RMS):
    rows = preprocess.gather_fragments(jnp.asarray(store), jnp.asarray(idx),
                                       jnp.asarray(offs), frag)
    return np.asarray(preprocess.preprocess_batch(
        rows, jnp.zeros(len(idx), jnp.int32), frag, ds, whiten_rms=whiten_rms))


@pytest.mark.parametrize("frag,ds,B", [
    (3200, 4, 16),   # the serving layout
    (3200, 4, 11),   # batch not a multiple of anything
    (1000, 1, 8),    # fragment not a multiple of 128, no decimation
    (1001, 4, 3),    # fragment not a multiple of the decimation
])
def test_chain_matches_host_reference(frag, ds, B):
    store, idx, offs = make_case(0, 20, 6000, frag, B)
    out = device_chain(store, idx, offs, frag, ds)
    assert out.shape == (B, -(-frag // ds), 1)
    np.testing.assert_allclose(out[..., 0], host_chain(store, idx, offs, frag, ds),
                               rtol=1e-5, atol=1e-6)


def test_chain_zero_and_edge_offsets():
    frag, ds = 1280, 2
    store, idx, _ = make_case(1, 6, 4000, frag, 8)
    offs = np.asarray([0, 128, 2048, 2048 + 129, 1, 2720, 255, 1920], np.int32)
    np.testing.assert_allclose(device_chain(store, idx, offs, frag, ds)[..., 0],
                               host_chain(store, idx, offs, frag, ds),
                               rtol=1e-5, atol=1e-6)


def test_chain_no_whiten_no_decimation():
    frag = 1280
    store, idx, offs = make_case(2, 6, 4000, frag, 8)
    out = device_chain(store, idx, offs, frag, 1, whiten_rms=None)
    np.testing.assert_allclose(out[..., 0],
                               host_chain(store, idx, offs, frag, 1, whiten=False),
                               rtol=1e-6)


@pytest.mark.parametrize("stochastic", [False, True])
def test_fetch_batch_matches_host_reference(stochastic):
    """fetch_batch draws offsets on device (start of file when not
    stochastic) and runs the chain; same result as the host path with the
    same offsets."""
    cfg = ExperimentConfig(data=DataConfig(seconds=0.25, downsampling=4))
    frag = cfg.data.fragment_length
    r = np.random.default_rng(3)
    N, T = 12, 9000
    audio = r.integers(-30000, 30000, (N, T), dtype=np.int16)
    lengths = r.integers(frag, T, N).astype(np.int32)
    store = steps.DeviceStore(
        audio=jnp.asarray(audio), lengths=jnp.asarray(lengths),
        labels=jnp.zeros(N, jnp.int32), speaker_utts=jnp.zeros((1, N), jnp.int32),
        speaker_counts=jnp.asarray([N], jnp.int32))
    idx = jnp.asarray(r.integers(0, N, 9), jnp.int32)
    key = jax.random.PRNGKey(4)
    out = np.asarray(steps.fetch_batch(store, idx, key, cfg, stochastic=stochastic))
    offs = np.asarray(preprocess.sample_offsets(key, jnp.asarray(lengths)[idx], frag,
                                                stochastic=stochastic))
    if not stochastic:
        assert (offs == 0).all()
    assert (offs + frag <= lengths[np.asarray(idx)]).all()
    np.testing.assert_allclose(out[..., 0],
                               host_chain(audio, np.asarray(idx), offs, frag, 4),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nq,ns,d", [(50, 70, 64), (32, 64, 16)])
def test_pairwise_l1_matches_numpy(nq, ns, d):
    rng = np.random.default_rng(nq)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    s = rng.standard_normal((ns, d)).astype(np.float32)
    out = np.asarray(dist_ops.pairwise_l1(jnp.asarray(q), jnp.asarray(s)))
    expect = np.abs(q[:, None, :] - s[None, :, :]).sum(-1)
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-4)


def test_pairwise_weighted_l1_matches_numpy():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((33, 64)).astype(np.float32)
    s = rng.standard_normal((41, 64)).astype(np.float32)
    w = rng.standard_normal((64, 1)).astype(np.float32)
    out = np.asarray(dist_ops.pairwise_weighted_l1(q, s, w, 0.25))
    expect = np.abs(q[:, None, :] - s[None, :, :]) @ w[:, 0] + 0.25
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)
