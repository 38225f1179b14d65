"""1D-convolutional waveform encoder, as plain functions over a variable tree.

Rebuild of the reference encoder (reference:
``voicemap/models.py :: get_baseline_convolutional_encoder(filters,
embedding_dim, input_shape, dropout)`` — SURVEY.md §3.5):

    4 × [Conv1D(f·mult, k, 'same', relu) → BatchNorm → SpatialDropout1D
         → MaxPool1D] → GlobalMaxPool1D → Dense(embedding_dim)

Every model in :mod:`voicemap.models` is a frozen (hashable) dataclass with

- ``init(key) -> variables``: ``{"params": ..., "batch_stats": ...}``;
- ``apply(variables, *inputs, train=False, rng=None, bn_axis=None)``: the
  output, or ``(output, new_batch_stats)`` when ``train`` is true
  (BatchNorm on batch statistics, running averages updated; ``rng`` seeds
  dropout; ``bn_axis`` names the mesh axis to synchronize batch statistics
  over when called inside ``shard_map``).

The variable tree is ``{"params": {"block_i": {"conv": {"kernel", "bias"},
"bn": {"scale", "bias"}}, "embed": {"kernel", "bias"}}, "batch_stats":
{"block_i": {"bn": {"mean", "var"}}}}``; conv kernels are ``(k, Cin, Cout)``
and dense kernels ``(Din, Dout)``.

Semantics follow Keras exactly:
- NTC layout (batch, time, channels).
- relu *inside* the conv, then BatchNorm, computed in float32 (momentum
  0.99, epsilon 1e-3; variance ``max(E[x²] − E[x]², 0)``).
- SpatialDropout: whole channels dropped, the mask broadcast over time.
- VALID max-pool: the remainder of the time axis is dropped.
- Compute dtype bfloat16 by default, parameters float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import EncoderConfig

_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}

_lecun_normal = jax.nn.initializers.lecun_normal()


def init_conv(key, shape, param_dtype=jnp.float32) -> Dict:
    """Conv kernel ``shape = (*window, Cin, Cout)``, LeCun-normal, zero bias."""
    return {"kernel": _lecun_normal(key, shape, param_dtype),
            "bias": jnp.zeros((shape[-1],), param_dtype)}


def init_dense(key, d_in: int, d_out: int, param_dtype=jnp.float32) -> Dict:
    return {"kernel": _lecun_normal(key, (d_in, d_out), param_dtype),
            "bias": jnp.zeros((d_out,), param_dtype)}


def init_bn(c: int):
    """→ (params {"scale", "bias"}, batch_stats {"mean", "var"})."""
    return ({"scale": jnp.ones((c,), jnp.float32),
             "bias": jnp.zeros((c,), jnp.float32)},
            {"mean": jnp.zeros((c,), jnp.float32),
             "var": jnp.ones((c,), jnp.float32)})


def dense(p: Dict, x: jnp.ndarray, dtype) -> jnp.ndarray:
    return x.astype(dtype) @ p["kernel"].astype(dtype) + p["bias"].astype(dtype)


def conv(p: Dict, x: jnp.ndarray, dtype, dilation: int = 1) -> jnp.ndarray:
    """SAME conv over the spatial axes of a channels-last ``x``, plus bias."""
    nd = p["kernel"].ndim - 2
    dn = {1: ("NWC", "WIO", "NWC"), 2: ("NHWC", "HWIO", "NHWC")}[nd]
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (1,) * nd, "SAME",
        rhs_dilation=(dilation,) * nd, dimension_numbers=dn,
    )
    return y + p["bias"].astype(dtype)


def batch_norm(p: Dict, stats: Dict, x: jnp.ndarray, *, train: bool,
               momentum: float, eps: float, axis_name: Optional[str] = None):
    """BatchNorm over every axis but the last, in float32 → (y, new_stats).

    ``axis_name`` (inside ``shard_map``): batch statistics are averaged over
    that mesh axis, so every shard normalizes with the global batch's
    statistics (synchronized BatchNorm)."""
    x = x.astype(jnp.float32)
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axis=axes)
        mean_sq = jnp.mean(x * x, axis=axes)
        if axis_name is not None:
            mean = jax.lax.pmean(mean, axis_name)
            mean_sq = jax.lax.pmean(mean_sq, axis_name)
        var = jnp.maximum(mean_sq - mean * mean, 0.0)
        stats = {"mean": momentum * stats["mean"] + (1.0 - momentum) * mean,
                 "var": momentum * stats["var"] + (1.0 - momentum) * var}
    else:
        mean, var = stats["mean"], stats["var"]
    mul = jax.lax.rsqrt(var + eps) * p["scale"]
    return (x - mean) * mul + p["bias"], stats


def spatial_dropout(x: jnp.ndarray, rate: float, rng) -> jnp.ndarray:
    """Drop whole channels: one mask per (example, channel), broadcast over
    every spatial axis."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    mask = jax.random.bernoulli(rng, keep, shape)
    return jnp.where(mask, x / keep, jnp.zeros((), x.dtype)).astype(x.dtype)


def max_pool(x: jnp.ndarray, pool: int) -> jnp.ndarray:
    """VALID max-pool with window = stride = ``pool`` on every spatial axis
    (the remainder is dropped)."""
    if pool <= 1:
        return x
    B, C = x.shape[0], x.shape[-1]
    spatial = x.shape[1:-1]
    kept = tuple(s // pool for s in spatial)
    x = x[(slice(None),) + tuple(slice(0, k * pool) for k in kept)]
    shape = (B,) + sum(((k, pool) for k in kept), ()) + (C,)
    axes = tuple(2 + 2 * i for i in range(len(kept)))
    return x.reshape(shape).max(axis=axes)


def conv_block(p: Dict, stats: Dict, x: jnp.ndarray, *, pool: int,
               dilation: int, dropout: float, train: bool, rng,
               momentum: float, eps: float, dtype,
               bn_axis: Optional[str] = None):
    """conv(relu) → BN → spatial dropout → max-pool → (y, new_bn_stats)."""
    y = jax.nn.relu(conv(p["conv"], x, dtype, dilation))
    y, new = batch_norm(p["bn"], stats["bn"], y, train=train,
                        momentum=momentum, eps=eps, axis_name=bn_axis)
    y = y.astype(dtype)
    if train and dropout > 0.0:
        if rng is None:
            raise ValueError("rng is required for dropout in train mode")
        y = spatial_dropout(y, dropout, rng)
    return max_pool(y, pool), {"bn": new}


def _finish(out, new_stats, train: bool):
    return (out, new_stats) if train else out


@dataclass(frozen=True)
class ConvEncoder:
    """Waveform (B, T, 1) float32 → embedding (B, D) float32."""

    cfg: EncoderConfig

    def init(self, key) -> Dict:
        cfg = self.cfg
        pdt = _DTYPES[cfg.param_dtype]
        n = len(cfg.filter_multipliers)
        keys = jax.random.split(key, n + 1)
        params: Dict = {}
        stats: Dict = {}
        c_in = 1
        for i, (mult, k) in enumerate(zip(cfg.filter_multipliers, cfg.kernel_sizes)):
            c = cfg.filters * mult
            bn_p, bn_s = init_bn(c)
            params[f"block_{i}"] = {"conv": init_conv(keys[i], (k, c_in, c), pdt),
                                    "bn": bn_p}
            stats[f"block_{i}"] = {"bn": bn_s}
            c_in = c
        params["embed"] = init_dense(keys[n], c_in, cfg.embedding_dim, pdt)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables: Dict, x: jnp.ndarray, train: bool = False,
              rng: Optional[jax.Array] = None, bn_axis: Optional[str] = None):
        cfg = self.cfg
        cdt = _DTYPES[cfg.compute_dtype]
        params, stats = variables["params"], variables["batch_stats"]
        new_stats: Dict = {}
        h = x.astype(cdt)
        for i, (p, dil) in enumerate(zip(cfg.pool_sizes, cfg.dilations)):
            h, new_stats[f"block_{i}"] = conv_block(
                params[f"block_{i}"], stats[f"block_{i}"], h, pool=p,
                dilation=dil, dropout=cfg.dropout, train=train,
                rng=None if rng is None else jax.random.fold_in(rng, i),
                momentum=cfg.bn_momentum, eps=cfg.bn_epsilon, dtype=cdt,
                bn_axis=bn_axis,
            )
        h = jnp.max(h, axis=1)  # GlobalMaxPool1D
        out = dense(params["embed"], h, cdt).astype(jnp.float32)
        return _finish(out, new_stats, train)
