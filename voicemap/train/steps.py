"""Fused on-device train/eval steps.

The on-device answer to the reference's ``fit_generator`` +
multiprocessing-worker pipeline (SURVEY.md §3.1 hot loops #1 and #2): one
compiled XLA program per step that performs **sampling → fragment gather →
decimate/whiten → forward → loss → backward → Adam update** with zero host
involvement beyond the PRNG key fold-in. The corpus lives on-device as an
int16 store (``DeviceStore``); host ↔ device traffic per step is O(1).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ExperimentConfig
from ..data.dataset import AudioStore
from ..ops import preprocess, sampling
from . import losses
from .state import TrainState, apply_updates, make_optimizer


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceStore:
    """AudioStore shipped to device memory (or sharded across a mesh)."""

    audio: jnp.ndarray  # (N, T_store) int16
    lengths: jnp.ndarray  # (N,) int32
    labels: jnp.ndarray  # (N,) int32
    speaker_utts: jnp.ndarray  # (S, max_utt) int32
    speaker_counts: jnp.ndarray  # (S,) int32

    @classmethod
    def from_host(
        cls, store: AudioStore, device=None, min_length: int = 0,
    ) -> "DeviceStore":
        """Ship the corpus to device memory.

        ``min_length`` zero-pads rows to at least this many raw samples so
        fragment gathers stay in-bounds when every file is shorter than the
        configured fragment (pad=True mode).
        """
        put = partial(jax.device_put, device=device)
        audio = jnp.asarray(store.audio)
        if min_length and audio.shape[1] < min_length:
            audio = jnp.pad(audio, ((0, 0), (0, min_length - audio.shape[1])))
        return cls(
            audio=put(audio),
            lengths=put(jnp.asarray(store.lengths)),
            labels=put(jnp.asarray(store.labels)),
            speaker_utts=put(jnp.asarray(store.speaker_utts)),
            speaker_counts=put(jnp.asarray(store.speaker_counts)),
        )


def device_store_for(cfg: ExperimentConfig, audio_store, device=None) -> "DeviceStore":
    """Ship a host store to the device, padded for this config's fragments."""
    return DeviceStore.from_host(
        audio_store, device, min_length=cfg.data.fragment_length,
    )


def fetch_batch(
    store: DeviceStore,
    indices: jnp.ndarray,
    key: jax.Array,
    cfg: ExperimentConfig,
    stochastic: bool = True,
) -> jnp.ndarray:
    """indices → preprocessed model inputs (B, T_model, 1): the
    gather → decimate → whiten chain, which XLA fuses into one pass."""
    frag = cfg.data.fragment_length
    offsets = preprocess.sample_offsets(
        key, store.lengths[indices], frag, stochastic=stochastic
    )
    rows = preprocess.gather_fragments(store.audio, indices, offsets, frag)
    return preprocess_fragments(rows, cfg)


def classifier_loss_fn(model, cfg: Optional[ExperimentConfig] = None,
                       bn_axis: Optional[str] = None):
    """Shared by the single-chip and data-parallel train steps (which pass
    ``bn_axis`` to synchronize BatchNorm over the data axis)."""

    def loss_fn(params, batch_stats, x, y, dropout_key):
        out, new_bs = model.apply(
            {"params": params, "batch_stats": batch_stats},
            x, train=True, rng=dropout_key, bn_axis=bn_axis,
        )
        loss = losses.softmax_ce(out, y)
        acc = losses.categorical_accuracy(out, y)
        return loss, (new_bs, acc)

    return loss_fn


def siamese_loss_fn(model, cfg: ExperimentConfig, bn_axis: Optional[str] = None):
    """Shared by the single-chip and data-parallel train steps."""
    same_label = cfg.siamese.same_label
    use_contrastive = cfg.train.loss == "contrastive"
    margin = cfg.train.contrastive_margin

    def loss_fn(params, batch_stats, x1, x2, y, dropout_key):
        variables = {"params": params, "batch_stats": batch_stats}
        if use_contrastive:
            # Contrastive loss acts on embedding euclidean distances.
            Bsz = x1.shape[0]
            stacked = jnp.concatenate([x1, x2], axis=0)
            emb, new_bs = model.embed(
                variables, stacked, train=True, rng=dropout_key, bn_axis=bn_axis,
            )
            d = jnp.sqrt(
                jnp.sum(jnp.square(emb[:Bsz] - emb[Bsz:]), axis=-1) + 1e-12
            )
            loss = losses.contrastive(d, y, margin=margin, same_label=same_label)
            # Predicted "different" when d > margin/2; map to the configured
            # label convention (different = 1 - same_label).
            pred = jnp.where(d > margin / 2, 1.0 - same_label, float(same_label))
            acc = jnp.mean(pred == y)
        else:
            logits, new_bs = model.apply(
                variables, x1, x2, train=True, rng=dropout_key, bn_axis=bn_axis,
            )
            loss = losses.bce_with_logits(logits, y)
            acc = losses.binary_accuracy(logits, y)
        return loss, (new_bs, acc)

    return loss_fn


def make_classifier_train_step(
    model, cfg: ExperimentConfig
) -> Tuple[Callable, Any]:
    """Returns (jitted step, optax tx). Step: (state, store, key) → (state, metrics)."""
    tx = make_optimizer(cfg.train.clipnorm)
    B = cfg.train.batch_size
    loss_fn = classifier_loss_fn(model, cfg)

    @jax.jit
    def step(state: TrainState, store: DeviceStore, key: jax.Array):
        k_idx, k_off, k_drop = jax.random.split(
            jax.random.fold_in(key, state.step), 3
        )
        idx = sampling.sample_classifier_batch(k_idx, store.labels.shape[0], B)
        x = fetch_batch(store, idx, k_off, cfg, stochastic=cfg.data.stochastic)
        y = store.labels[idx]
        (loss, (new_bs, acc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x, y, k_drop
        )
        new_state = apply_updates(state, grads, tx, new_bs)
        return new_state, {"loss": loss, "accuracy": acc}

    return step, tx


def make_siamese_train_step(
    model, cfg: ExperimentConfig
) -> Tuple[Callable, Any]:
    """Siamese verification step: BCE (default) or contrastive loss.

    Reference: ``experiments/train_siamese_net.py`` training flow
    (SURVEY.md §3.1); pair sampling is the on-device
    ``sample_verification_batch`` instead of forked generator workers.
    """
    tx = make_optimizer(cfg.train.clipnorm)
    B = cfg.train.batch_size
    same_label = cfg.siamese.same_label
    loss_fn = siamese_loss_fn(model, cfg)

    @jax.jit
    def step(state: TrainState, store: DeviceStore, key: jax.Array):
        k_pair, k_off1, k_off2, k_drop = jax.random.split(
            jax.random.fold_in(key, state.step), 4
        )
        batch = sampling.sample_verification_batch(
            k_pair, store.speaker_utts, store.speaker_counts, B, same_label
        )
        x1 = fetch_batch(store, batch.idx_1, k_off1, cfg, cfg.data.stochastic)
        x2 = fetch_batch(store, batch.idx_2, k_off2, cfg, cfg.data.stochastic)
        (loss, (new_bs, acc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x1, x2, batch.labels, k_drop
        )
        new_state = apply_updates(state, grads, tx, new_bs)
        return new_state, {"loss": loss, "accuracy": acc}

    return step, tx


def preprocess_fragments(frags_i16: jnp.ndarray, cfg: ExperimentConfig) -> jnp.ndarray:
    """(B, frag) int16 host-cut fragments → (B, T_model, 1) f32 (streaming path)."""
    d = cfg.data
    x = frags_i16.astype(jnp.float32) * preprocess.INT16_SCALE
    x = preprocess.stride_decimate(x, d.downsampling)
    if d.whiten_rms is not None:
        x = preprocess.whiten(x, d.whiten_rms, d.whiten_eps)
    return x[..., None]


def make_streaming_classifier_step(model, cfg: ExperimentConfig):
    """Train step for the host-streaming pipeline (data/pipeline.py):
    (state, fragments (B, frag) int16, labels, key) → (state, metrics)."""
    tx = make_optimizer(cfg.train.clipnorm)
    loss_fn = classifier_loss_fn(model, cfg)

    @jax.jit
    def step(state: TrainState, frags: jnp.ndarray, y: jnp.ndarray, key):
        k_drop = jax.random.fold_in(key, state.step)
        x = preprocess_fragments(frags, cfg)
        (loss, (new_bs, acc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x, y, k_drop
        )
        new_state = apply_updates(state, grads, tx, new_bs)
        return new_state, {"loss": loss, "accuracy": acc}

    return step, tx


def make_streaming_siamese_step(model, cfg: ExperimentConfig):
    """Siamese train step over host-streamed pair fragments."""
    tx = make_optimizer(cfg.train.clipnorm)
    loss_fn = siamese_loss_fn(model, cfg)

    @jax.jit
    def step(state: TrainState, f1: jnp.ndarray, f2: jnp.ndarray,
             y: jnp.ndarray, key):
        k_drop = jax.random.fold_in(key, state.step)
        x1 = preprocess_fragments(f1, cfg)
        x2 = preprocess_fragments(f2, cfg)
        (loss, (new_bs, acc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x1, x2, y, k_drop
        )
        new_state = apply_updates(state, grads, tx, new_bs)
        return new_state, {"loss": loss, "accuracy": acc}

    return step, tx


def make_embed_fn(model, cfg: ExperimentConfig) -> Callable:
    """Jitted (state, store, indices, key) → embeddings, via the fused pipeline."""

    @jax.jit
    def embed(state: TrainState, store: DeviceStore, indices: jnp.ndarray, key):
        x = fetch_batch(store, indices, key, cfg, stochastic=False)
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        return model.embed(variables, x)

    return embed
