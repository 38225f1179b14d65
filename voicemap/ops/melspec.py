"""Log-mel spectrogram frontend.

BASELINE.json config #4: "log-mel spectrogram frontend + 2D-CNN embedder".
The reference repo has no spectrogram path of its own (its librosa dependency
provided one); this is the rebuild's own frontend with librosa-compatible
semantics: Hann window, centered=False framing, power spectrum, Slaney-style
mel filterbank (librosa.filters.mel defaults: HTK=False, slaney area norm),
log with floor.

The spectrum is an rfft (cuFFT on the GPU) and the mel projection a
matmul.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MelConfig


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(
            np.maximum(f, 1e-300) / min_log_hz
        ) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
) -> np.ndarray:
    """(n_freq, n_mels) triangular filterbank, Slaney-normalized."""
    fmax = fmax or sample_rate / 2
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freq)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_freq, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        # Slaney area normalization.
        fb[:, m] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window; ``periodic=True`` matches librosa/scipy ``fftbins=True``
    (denominator N, not N−1 — np.hanning is the symmetric variant)."""
    k = np.arange(n)
    denom = n if periodic else n - 1
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)).astype(np.float32)


def frame_signal(x: jnp.ndarray, win_length: int, hop_length: int) -> jnp.ndarray:
    """(B, T) → (B, n_frames, win_length), centered=False framing."""
    T = x.shape[-1]
    n_frames = 1 + (T - win_length) // hop_length
    idx = (
        np.arange(n_frames)[:, None] * hop_length + np.arange(win_length)[None, :]
    )
    return x[..., idx]


def num_frames(T: int, cfg: MelConfig) -> int:
    return 1 + (T - cfg.win_length) // cfg.hop_length


@functools.partial(jax.jit, static_argnames=("cfg", "sample_rate"))
def log_mel_spectrogram(
    x: jnp.ndarray, cfg: MelConfig, sample_rate: int
) -> jnp.ndarray:
    """(B, T) or (B, T, 1) waveform → (B, n_frames, n_mels) log-mel.

    Hann window → zero-pad to n_fft → power spectrum → mel → log(·+eps).
    """
    if x.ndim == 3:
        x = x[..., 0]
    frames = frame_signal(x.astype(jnp.float32), cfg.win_length, cfg.hop_length)
    window = jnp.asarray(hann_window(cfg.win_length))
    frames = frames * window
    if cfg.n_fft > cfg.win_length:
        frames = jnp.pad(
            frames, ((0, 0), (0, 0), (0, cfg.n_fft - cfg.win_length))
        )
    spec = jnp.fft.rfft(frames, n=cfg.n_fft, axis=-1)
    power = jnp.square(jnp.real(spec)) + jnp.square(jnp.imag(spec))
    fb = jnp.asarray(
        mel_filterbank(sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    )
    mel = jnp.einsum(
        "btf,fm->btm", power, fb, preferred_element_type=jnp.float32
    )
    return jnp.log(mel + cfg.log_eps)

