"""Sequence (time-axis) parallelism for the conv stack: halo-exchange conv1d.

The convolutional analog of context parallelism (SURVEY.md §5 "Long-context /
sequence parallelism"): long waveform fragments are sharded along the time
axis across the mesh; every 'SAME' convolution needs ``(k-1)//2 · dilation``
neighbor samples at each shard boundary, exchanged with ``ppermute``
(zero-fill at the global edges — exactly XLA's 'SAME' zero padding). Max
pooling stays local (shard lengths are kept divisible by the pool factor),
the final GlobalMaxPool is a ``pmax``, and the Dense head is replicated.

``sharded_encoder_apply`` mirrors ``models.encoder.ConvEncoder`` in inference
mode from the same params, so the property test asserts exact equality
with the single-device forward — required for BASELINE.json config #3
(dilated stack at 4 kHz) at pod scale.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import EncoderConfig


def halo_exchange(x_local: jnp.ndarray, halo: int, axis: str) -> jnp.ndarray:
    """Concatenate ``halo`` boundary samples from both neighbors (zeros at
    the global edges). x_local: (B, T_local, C) → (B, T_local + 2·halo, C)."""
    if halo == 0:
        return x_local
    n_dev = jax.lax.axis_size(axis)
    # Send my right edge to my right neighbor (their left halo), and my left
    # edge to my left neighbor (their right halo). ppermute zero-fills
    # devices with no source — matching 'SAME' zero padding at the ends.
    right_perm = [(i, i + 1) for i in range(n_dev - 1)]
    left_perm = [(i + 1, i) for i in range(n_dev - 1)]
    left_halo = jax.lax.ppermute(x_local[:, -halo:, :], axis, right_perm)
    right_halo = jax.lax.ppermute(x_local[:, :halo, :], axis, left_perm)
    return jnp.concatenate([left_halo, x_local, right_halo], axis=1)


def halo_conv1d(
    x_local: jnp.ndarray,
    kernel: jnp.ndarray,
    bias: Optional[jnp.ndarray],
    axis: str,
    dilation: int = 1,
) -> jnp.ndarray:
    """'SAME' conv1d over a time-sharded (B, T_local, Cin) input.

    ``kernel``: (K, Cin, Cout) in the models' layout. Requires odd K·dilation reach
    ('SAME' centers odd kernels; even kernels pad asymmetrically —
    handled by splitting the halo ⌈·⌉ left / ⌊·⌋ right as XLA does).
    """
    K = kernel.shape[0]
    reach = (K - 1) * dilation
    halo_l = reach // 2
    halo_r = reach - halo_l
    halo = max(halo_l, halo_r)
    x = halo_exchange(x_local, halo, axis)
    # After symmetric exchange of `halo`, trim to the exact asymmetric reach.
    start = halo - halo_l
    x = x[:, start : start + x_local.shape[1] + reach, :]
    out = jax.lax.conv_general_dilated(
        x.astype(kernel.dtype),
        kernel,
        window_strides=(1,),
        padding="VALID",
        rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC"),
    )
    if bias is not None:
        out = out + bias
    return out


def _bn_inference(x, scale, bias_, mean, var, eps):
    inv = jax.lax.rsqrt(var + eps) * scale
    return (x - mean) * inv + bias_


def sharded_encoder_apply(
    variables: dict,
    cfg: EncoderConfig,
    x_local: jnp.ndarray,
    axis: str,
) -> jnp.ndarray:
    """Inference forward of ConvEncoder over time-sharded input.

    Runs inside shard_map; mirrors models/encoder.py::ConvEncoder exactly
    (conv+relu → BN(running stats) → maxpool per block, then global-max via
    pmax and the Dense head). Shard T_local must stay divisible by each
    block's pool size.
    """
    params = variables["params"]
    stats = variables["batch_stats"]
    x = x_local.astype(jnp.float32)
    for i, (mult, k, p_sz, dil) in enumerate(
        zip(cfg.filter_multipliers, cfg.kernel_sizes, cfg.pool_sizes, cfg.dilations)
    ):
        blk = params[f"block_{i}"]
        bst = stats[f"block_{i}"]["bn"]
        x = halo_conv1d(x, blk["conv"]["kernel"].astype(jnp.float32),
                        blk["conv"]["bias"].astype(jnp.float32), axis, dil)
        x = jax.nn.relu(x)
        x = _bn_inference(
            x, blk["bn"]["scale"], blk["bn"]["bias"], bst["mean"], bst["var"],
            cfg.bn_epsilon,
        )
        if p_sz > 1:
            B, T, C = x.shape
            x = x.reshape(B, T // p_sz, p_sz, C).max(axis=2)
    # GlobalMaxPool over the sharded time axis: local max, then max over the
    # all_gathered shard maxima (all_gather+max rather than pmax so the whole
    # sharded forward stays differentiable — pmax has no JVP rule).
    x = jnp.max(x, axis=1)
    x = jnp.max(jax.lax.all_gather(x, axis), axis=0)
    emb = params["embed"]
    return x @ emb["kernel"].astype(jnp.float32) + emb["bias"]


def sharded_encoder_train_apply(
    params: dict,
    batch_stats: dict,
    cfg: EncoderConfig,
    x_local: jnp.ndarray,
    seq_axis: str,
    stat_axes: tuple,
    dropout_key=None,
):
    """TRAIN-mode forward of ConvEncoder over time-sharded input.

    Runs inside shard_map. BatchNorm batch statistics reduce over the local
    (batch, time) block AND over every mesh axis in ``stat_axes`` (the seq
    axis reassembles the full time extent; including the data axis gives
    cross-replica BN, matching data_parallel's DP semantics) — so a
    ``(data × seq)`` step with ``stat_axes=(data, seq)`` has exactly the
    single-device full-batch train semantics, which the property test
    exploits (tests/test_parallel.py::test_dp_sp_grads_match_single_device).

    Spatial dropout masks broadcast over time, so one mask per (batch row,
    channel) must be shared by every seq shard: pass a ``dropout_key`` that
    is identical across the seq axis (fold only the data index).

    → (embedding (B_local, D) f32, new_batch_stats pytree).
    """
    stats = batch_stats
    x = x_local.astype(jnp.float32)
    new_stats: dict = {}
    m = cfg.bn_momentum
    for i, (mult, k, p_sz, dil) in enumerate(
        zip(cfg.filter_multipliers, cfg.kernel_sizes, cfg.pool_sizes, cfg.dilations)
    ):
        blk = params[f"block_{i}"]
        bst = stats[f"block_{i}"]["bn"]
        a = jax.nn.relu(
            halo_conv1d(x, blk["conv"]["kernel"].astype(jnp.float32),
                        blk["conv"]["bias"].astype(jnp.float32), axis=seq_axis,
                        dilation=dil)
        )
        mu = jnp.mean(a, axis=(0, 1))
        e2 = jnp.mean(a * a, axis=(0, 1))
        for ax in stat_axes:
            mu = jax.lax.pmean(mu, ax)
            e2 = jax.lax.pmean(e2, ax)
        var = jnp.maximum(e2 - mu * mu, 0.0)
        r = jax.lax.rsqrt(var + cfg.bn_epsilon)
        x = (a - mu) * (blk["bn"]["scale"] * r) + blk["bn"]["bias"]
        if cfg.dropout > 0.0:
            keep = 1.0 - cfg.dropout
            mask = jax.random.bernoulli(
                jax.random.fold_in(dropout_key, i), keep,
                (x.shape[0], 1, x.shape[2]),
            )
            x = jnp.where(mask, x / keep, 0.0)
        if p_sz > 1:
            B, T, C = x.shape
            x = x.reshape(B, T // p_sz, p_sz, C).max(axis=2)
        new_stats[f"block_{i}"] = {"bn": {
            "mean": m * bst["mean"] + (1.0 - m) * mu,
            "var": m * bst["var"] + (1.0 - m) * var,
        }}
    # Differentiable global max over the sharded time axis (all_gather+max;
    # pmax has no JVP rule).
    x = jnp.max(x, axis=1)
    x = jnp.max(jax.lax.all_gather(x, seq_axis), axis=0)
    emb = params["embed"]
    out = x @ emb["kernel"].astype(jnp.float32) + emb["bias"]
    return out, new_stats


def make_sharded_embed_fn(cfg: EncoderConfig, mesh: Mesh, axis: str = "seq"):
    """jit(shard_map) wrapper: (variables, x (B, T, 1)) → (B, D) embeddings,
    with x sharded along time over ``axis`` and the result replicated."""

    f = jax.shard_map(
        lambda v, x: sharded_encoder_apply(v, cfg, x, axis),
        mesh=mesh,
        in_specs=(P(), P(None, axis, None)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(f)
