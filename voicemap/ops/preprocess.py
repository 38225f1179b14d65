"""On-device preprocessing: fragment gather → stride-decimate → whiten.

Rebuild of the reference's host-side preprocessing chain
(reference: ``voicemap/librispeech.py :: __getitem__`` fragment slice +
``voicemap/utils.py :: preprocess_instances`` stride decimation +
``voicemap/utils.py :: whiten`` — SURVEY.md §2.1). Here the whole chain is a
single traced function over static shapes, running inside the compiled train
step, where XLA fuses it into one pass.

Semantics pinned here (survey flags some as [MED] recall, so they are knobs):

- int16 → float32 via x / 32768 (soundfile convention).
- Stride decimation ``x[:, ::d]`` — deliberately *no* anti-alias filter, to
  match the reference ("naive stride decimation, no anti-alias filter").
- Whitening: per-fragment zero-mean, then rescale the *demeaned* signal to a
  fixed target RMS (default 0.038021), with an epsilon guard.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import DEFAULT_WHITEN_RMS

INT16_SCALE = 1.0 / 32768.0


def whiten(batch: jnp.ndarray, rms: float = DEFAULT_WHITEN_RMS, eps: float = 1e-8) -> jnp.ndarray:
    """Zero-mean + fixed-RMS rescale per fragment.

    Accepts (B, T) or (B, T, 1); reduction is over the time axis.
    Reference: ``voicemap/utils.py :: whiten(batch, rms=0.038021)``.
    """
    time_axis = 1
    mean = jnp.mean(batch, axis=time_axis, keepdims=True)
    centered = batch - mean
    cur_rms = jnp.sqrt(jnp.mean(jnp.square(centered), axis=time_axis, keepdims=True))
    return centered * (rms / (cur_rms + eps))


def stride_decimate(batch: jnp.ndarray, downsampling: int) -> jnp.ndarray:
    """Naive stride decimation along the time axis (axis 1).

    Reference: ``preprocess_instances`` does ``instances[:, ::downsampling, :]``.
    """
    if downsampling == 1:
        return batch
    return batch[:, ::downsampling]


def extract_fragments(
    audio: jnp.ndarray, offsets: jnp.ndarray, fragment_length: int
) -> jnp.ndarray:
    """Gather per-row fragments at dynamic offsets with static output shape.

    ``audio``: (B, T_store) — rows already gathered from the corpus store.
    ``offsets``: (B,) int32 start sample per row (caller guarantees
    offset + fragment_length <= T_store; the store is zero-padded so reads
    past the true length yield silence, matching the reference's pad mode).
    """

    def one(row, off):
        return jax.lax.dynamic_slice(row, (off,), (fragment_length,))

    return jax.vmap(one)(audio, offsets)


@partial(jax.jit, static_argnames=("fragment_length", "downsampling"))
def preprocess_batch(
    audio_rows: jnp.ndarray,
    offsets: jnp.ndarray,
    fragment_length: int,
    downsampling: int,
    whiten_rms: Optional[float] = DEFAULT_WHITEN_RMS,
    whiten_eps: float = 1e-8,
) -> jnp.ndarray:
    """Fused fragment-gather + decimate + whiten → (B, T_model, 1) float32.

    ``audio_rows`` may be int16 (converted on-device, ÷32768) or float32.
    XLA fuses the whole chain into a couple of device-memory passes.
    """
    frags = extract_fragments(audio_rows, offsets, fragment_length)
    if frags.dtype == jnp.int16:
        frags = frags.astype(jnp.float32) * INT16_SCALE
    else:
        frags = frags.astype(jnp.float32)
    frags = stride_decimate(frags, downsampling)
    if whiten_rms is not None:
        frags = whiten(frags, whiten_rms, whiten_eps)
    return frags[..., None]


def gather_fragments(
    store: jnp.ndarray,
    indices: jnp.ndarray,
    offsets: jnp.ndarray,
    fragment_length: int,
) -> jnp.ndarray:
    """Gather (B,) rows at (B,) offsets from the corpus store in one pass.

    Reads only ``fragment_length`` samples per row from HBM (no full-row
    gather): ``out[b] = store[indices[b], offsets[b] : offsets[b]+fragment]``.
    """

    def one(idx, off):
        return jax.lax.dynamic_slice(store, (idx, off), (1, fragment_length))[0]

    return jax.vmap(one)(indices, offsets)


def sample_offsets(
    key: jax.Array,
    lengths: jnp.ndarray,
    fragment_length: int,
    stochastic: bool = True,
) -> jnp.ndarray:
    """Random (or zero) fragment start offsets, on-device.

    Mirrors the reference's random-start logic in ``__getitem__``: start ∈
    [0, len - fragment] when the file is long enough, else 0 (short files are
    only present when pad=True; the zero-padded store then supplies silence).
    """
    max_start = jnp.maximum(lengths - fragment_length, 0)
    if not stochastic:
        return jnp.zeros_like(lengths)
    u = jax.random.uniform(key, lengths.shape)
    return (u * (max_start + 1).astype(jnp.float32)).astype(jnp.int32)
