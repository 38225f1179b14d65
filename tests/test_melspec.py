"""Log-mel frontend tests: filterbank properties, the rfft log-mel path vs
numpy across framing geometries and batch shapes, and the 2D-CNN model
end-to-end."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.config import (
    DataConfig, EncoderConfig, ExperimentConfig, MelConfig, TrainConfig,
)
from voicemap.ops import melspec

CFG = MelConfig(n_fft=256, hop_length=80, win_length=200, n_mels=32)
SR = 16000


def test_filterbank_shape_and_coverage():
    fb = melspec.mel_filterbank(SR, 512, 64)
    assert fb.shape == (257, 64)
    assert (fb >= 0).all()
    # Every filter has support; filters tile the band.
    assert (fb.sum(axis=0) > 0).all()
    peak_bins = fb.argmax(axis=0)
    assert (np.diff(peak_bins) >= 0).all(), "filter centers must be ordered"


def test_mel_scale_roundtrip():
    f = np.array([0.0, 250.0, 999.0, 1000.0, 4000.0, 7999.0])
    np.testing.assert_allclose(
        melspec.mel_to_hz(melspec.hz_to_mel(f)), f, rtol=1e-10, atol=1e-8
    )
    np.testing.assert_allclose(
        melspec.mel_to_hz(melspec.hz_to_mel(f, htk=True), htk=True), f,
        rtol=1e-10, atol=1e-6,
    )


def test_frame_signal():
    x = jnp.arange(100, dtype=jnp.float32)[None, :]
    frames = melspec.frame_signal(x, 30, 10)
    assert frames.shape == (1, 8, 30)
    np.testing.assert_array_equal(np.asarray(frames[0, 0]), np.arange(30))
    np.testing.assert_array_equal(np.asarray(frames[0, 3]), np.arange(30, 60))


def numpy_log_mel(x, cfg, sr=SR):
    """Direct numpy log-mel of (B, T) audio: Hann window, uncentered frames,
    power spectrum, Slaney mel filterbank, log with floor."""
    win = melspec.hann_window(cfg.win_length)
    fb = melspec.mel_filterbank(sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    n = melspec.num_frames(x.shape[1], cfg)
    out = np.empty((x.shape[0], n, cfg.n_mels))
    for f in range(n):
        seg = x[:, f * cfg.hop_length:f * cfg.hop_length + cfg.win_length]
        power = np.abs(np.fft.rfft(seg.astype(np.float64) * win, n=cfg.n_fft)) ** 2
        out[:, f] = np.log(power @ fb + cfg.log_eps)
    return out


def test_log_mel_vs_numpy():
    """rfft path vs a direct numpy computation."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3200)).astype(np.float32)
    out = np.asarray(melspec.log_mel_spectrogram(jnp.asarray(x), CFG, SR))
    assert out.shape == (2, melspec.num_frames(3200, CFG), CFG.n_mels)
    np.testing.assert_allclose(out, numpy_log_mel(x, CFG), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg,T", [
    (MelConfig(), 48000),                                 # config #4: 3 s
    (MelConfig(hop_length=128, win_length=384), 16000),   # hop/win of 128s
    (MelConfig(n_fft=512, hop_length=160, win_length=512, n_mels=40,
               fmin=20.0, fmax=7600.0), 4000),            # band limits
])
def test_log_mel_geometries_vs_numpy(cfg, T):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T)).astype(np.float32)
    out = np.asarray(melspec.log_mel_spectrogram(jnp.asarray(x), cfg, SR))
    np.testing.assert_allclose(out, numpy_log_mel(x, cfg), rtol=1e-3, atol=1e-3)


def test_log_mel_odd_batch_and_3d_input():
    """(B, T, 1) input with an odd batch gives the same frames as (B, T)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1600)).astype(np.float32)
    a = np.asarray(melspec.log_mel_spectrogram(jnp.asarray(x[..., None]), CFG, SR))
    b = np.asarray(melspec.log_mel_spectrogram(jnp.asarray(x), CFG, SR))
    assert a.shape == (3, melspec.num_frames(1600, CFG), CFG.n_mels)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, numpy_log_mel(x, CFG), rtol=1e-4, atol=1e-4)


def test_melspec_classifier_trains(corpus_root):
    """End-to-end config #4: mel frontend + 2D CNN through the train loop."""
    from voicemap.data.dataset import SpeakerDataset
    from voicemap.models.spectrogram import MelSpecClassifier
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = ExperimentConfig(
        mode="melspec2d",
        data=DataConfig(
            data_root=corpus_root, subsets=("dev-clean",), seconds=1.0,
            downsampling=1,
        ),
        encoder=EncoderConfig(filters=16, embedding_dim=16, dropout=0.0,
                              compute_dtype="float32"),
        mel=CFG,
        train=TrainConfig(batch_size=8, learning_rate=3e-3),
    )
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root, seed=0)
    store = steps_mod.DeviceStore.from_host(ds.to_store())
    model = MelSpecClassifier(cfg.encoder, cfg.mel, num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)
    step, _ = steps_mod.make_classifier_train_step(model, cfg)
    key = jax.random.PRNGKey(0)
    losses = []
    for _ in range(25):
        state, m = step(state, store, key)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "melspec2d loss flat"
