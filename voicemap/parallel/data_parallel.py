"""Data-parallel training over a device mesh.

The equivalent of the DP row in SURVEY.md §2.2's parallelism
checklist (the reference is single-device): batch sharded over the ``data``
mesh axis via ``shard_map``, gradients reduced with ``pmean`` across
devices, parameters and optimizer state replicated. BatchNorm is
synchronized: every shard normalizes with the statistics of the whole
global batch (``bn_axis``), so one DP step equals the single-device step on
the same global batch.

Two input regimes, same reduction semantics:

- **device-store steps** (corpus resident in HBM): state and store are
  replicated (in_specs ``P()``); each device samples its own ``B/n``
  sub-batch on device by folding its ``axis_index`` into the PRNG key — no
  host-side scatter at all.
- **streaming steps** (corpus larger than HBM, host pipeline
  ``data/pipeline.py``): the host batch is sharded over the axis on its
  batch dimension at the jit boundary (in_specs ``P(axis)``), so the H2D
  transfer itself splits across devices.

The global batch is always ``cfg.train.batch_size``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import ExperimentConfig
from ..ops import sampling
from ..train import steps as steps_mod
from ..train.state import TrainState, apply_updates, make_optimizer


def _pmean_tree(tree, axis: str):
    return jax.tree.map(lambda x: jax.lax.pmean(x, axis), tree)


def _dp_step(
    cfg: ExperimentConfig,
    mesh: Mesh,
    axis: str,
    in_specs: Sequence,
    local_loss: Callable,
) -> Tuple[Callable, Any]:
    """Shared DP step skeleton: per-device loss/grads from ``local_loss``,
    then the one true reduction — pmean grads/BN-stats/metrics over ``axis``
    and a replicated optimizer update.

    ``local_loss(state, key, *inputs) → ((loss, (new_bs, acc)), grads)``
    owns sampling/preprocessing and its own PRNG-key folding (device-store
    steps fold ``axis_index`` before drawing per-device sample keys;
    streaming steps only decorrelate dropout).
    """
    tx = make_optimizer(cfg.train.clipnorm)
    n_dev = mesh.shape[axis]
    if cfg.train.batch_size % n_dev:
        raise ValueError(
            f"data-axis size {n_dev} must divide the global batch "
            f"{cfg.train.batch_size}"
        )

    def device_step(state: TrainState, *inputs_and_key):
        *inputs, key = inputs_and_key
        (loss, (new_bs, acc)), grads = local_loss(state, key, *inputs)
        grads = _pmean_tree(grads, axis)
        new_bs = _pmean_tree(new_bs, axis)
        loss = jax.lax.pmean(loss, axis)
        acc = jax.lax.pmean(acc, axis)
        new_state = apply_updates(state, grads, tx, new_bs)
        return new_state, {"loss": loss, "accuracy": acc}

    step = jax.jit(
        jax.shard_map(
            device_step,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )
    return step, tx


def make_dp_classifier_train_step(
    model, cfg: ExperimentConfig, mesh: Mesh, axis: str = "data"
) -> Tuple[Callable, Any]:
    """(state, store, key) → (state, metrics), sharded over ``axis``.

    State and store are replicated; each device runs the fully fused
    sample→gather→preprocess→fwd/bwd pipeline on its local sub-batch.
    """
    local_B = cfg.train.batch_size // mesh.shape[axis]
    loss_fn = steps_mod.classifier_loss_fn(model, cfg, bn_axis=axis)

    def local_loss(state, key, store):
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        k_idx, k_off, k_drop = jax.random.split(
            jax.random.fold_in(key, state.step), 3
        )
        idx = sampling.sample_classifier_batch(
            k_idx, store.labels.shape[0], local_B
        )
        x = steps_mod.fetch_batch(store, idx, k_off, cfg, cfg.data.stochastic)
        y = store.labels[idx]
        return jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x, y, k_drop
        )

    return _dp_step(cfg, mesh, axis, (P(), P(), P()), local_loss)


def make_dp_siamese_train_step(
    model, cfg: ExperimentConfig, mesh: Mesh, axis: str = "data"
) -> Tuple[Callable, Any]:
    """Data-parallel siamese verification step (BCE or contrastive)."""
    local_B = cfg.train.batch_size // mesh.shape[axis]
    same_label = cfg.siamese.same_label
    loss_fn = steps_mod.siamese_loss_fn(model, cfg, bn_axis=axis)

    def local_loss(state, key, store):
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        k_pair, k_off1, k_off2, k_drop = jax.random.split(
            jax.random.fold_in(key, state.step), 4
        )
        batch = sampling.sample_verification_batch(
            k_pair, store.speaker_utts, store.speaker_counts, local_B,
            same_label,
        )
        x1 = steps_mod.fetch_batch(
            store, batch.idx_1, k_off1, cfg, cfg.data.stochastic
        )
        x2 = steps_mod.fetch_batch(
            store, batch.idx_2, k_off2, cfg, cfg.data.stochastic
        )
        return jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x1, x2, batch.labels, k_drop
        )

    return _dp_step(cfg, mesh, axis, (P(), P(), P()), local_loss)


def make_dp_streaming_classifier_step(
    model, cfg: ExperimentConfig, mesh: Mesh, axis: str = "data"
) -> Tuple[Callable, Any]:
    """DP train step over HOST-STREAMED batches (corpora too large for HBM).

    (state, fragments (B, frag) int16, labels (B,), key) → (state, metrics);
    the host batch shards over ``axis`` on its batch dimension at the jit
    boundary. Composes the streaming pipeline (data/pipeline.py) with
    multi-chip training — a combination the reference's ``fit_generator``
    never had.
    """
    loss_fn = steps_mod.classifier_loss_fn(model, cfg, bn_axis=axis)

    def local_loss(state, key, frags, y):
        k_drop = jax.random.fold_in(
            jax.random.fold_in(key, state.step), jax.lax.axis_index(axis)
        )
        x = steps_mod.preprocess_fragments(frags, cfg)
        return jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x, y, k_drop
        )

    return _dp_step(cfg, mesh, axis, (P(), P(axis), P(axis), P()), local_loss)


def make_dp_streaming_siamese_step(
    model, cfg: ExperimentConfig, mesh: Mesh, axis: str = "data"
) -> Tuple[Callable, Any]:
    """DP siamese step over host-streamed pair fragments.

    (state, f1, f2, labels, key), pair batch sharded over ``axis``. The
    pipeline's half-alike/half-differing layout is order-independent under
    sharding (the loss is a mean over equal-size shards), so no reshuffle
    is needed.
    """
    loss_fn = steps_mod.siamese_loss_fn(model, cfg, bn_axis=axis)

    def local_loss(state, key, f1, f2, y):
        k_drop = jax.random.fold_in(
            jax.random.fold_in(key, state.step), jax.lax.axis_index(axis)
        )
        x1 = steps_mod.preprocess_fragments(f1, cfg)
        x2 = steps_mod.preprocess_fragments(f2, cfg)
        return jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x1, x2, y, k_drop
        )

    return _dp_step(
        cfg, mesh, axis, (P(), P(axis), P(axis), P(axis), P()), local_loss
    )
