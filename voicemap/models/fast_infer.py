"""Serving forward: inference-mode encoder from the training variables.

Block 0 (Cin=1, kernel 32, pool 4) runs the fused GPU kernel
(``ops/block0_kernel.py``) when the card is there and the shape fits, else
``_xla_block``; blocks 1+ always run ``_xla_block`` (a cuDNN conv with the
folded BatchNorm, relu and pool fused around it by XLA). Inference only
(BatchNorm running statistics); tested against ``ConvEncoder.apply``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import backend
from ..config import EncoderConfig
from ..ops import block0_kernel as b0
from .encoder import _DTYPES, max_pool


def _xla_block(x, blk, bst, pool, dilation, eps, cdt):
    w = blk["conv"]["kernel"].astype(cdt)
    y = jax.lax.conv_general_dilated(
        x.astype(cdt), w, (1,), "SAME", rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC"),
    ) + blk["conv"]["bias"].astype(cdt)
    y = jax.nn.relu(y.astype(jnp.float32))
    inv = jax.lax.rsqrt(bst["var"].astype(jnp.float32) + eps) * blk["bn"]["scale"]
    y = (y - bst["mean"]) * inv + blk["bn"]["bias"]
    return max_pool(y.astype(cdt), pool)


def use_block0_kernel(cfg: EncoderConfig, x: jnp.ndarray) -> bool:
    """Whether block 0 runs the fused kernel: on a GPU, when the shape fits."""
    return backend.gpu_kernels() and b0.kernel_supported(
        cfg.kernel_sizes[0], cfg.pool_sizes[0], cfg.dilations[0], x.shape[-1])


def block0_forward(params: dict, stats: dict, cfg: EncoderConfig,
                   x: jnp.ndarray, *, requant_scale=None) -> jnp.ndarray:
    """Inference block 0 → (B, T // pool, C) in the compute dtype, or int8
    ``clip(round(y / requant_scale))`` when a scale is given."""
    cdt = _DTYPES[cfg.compute_dtype]
    blk, bst = params["block_0"], stats["block_0"]["bn"]
    if use_block0_kernel(cfg, x):
        return b0.block0_kernel(
            x, blk["conv"]["kernel"], blk["conv"]["bias"], blk["bn"]["scale"],
            blk["bn"]["bias"], bst["mean"], bst["var"], requant_scale,
            pool=cfg.pool_sizes[0], eps=cfg.bn_epsilon, out_dtype=cdt,
            gemm_dtype=cdt,
        )
    h = _xla_block(x, blk, bst, cfg.pool_sizes[0], cfg.dilations[0],
                   cfg.bn_epsilon, cdt)
    if requant_scale is None:
        return h
    return jnp.clip(jnp.round(h.astype(jnp.float32) / requant_scale),
                    -127, 127).astype(jnp.int8)


def embed_tail(variables: dict, cfg: EncoderConfig, h: jnp.ndarray) -> jnp.ndarray:
    """Blocks 1+ and the embedding layer on block 0's output → (B, D) float32."""
    params = variables["params"]
    stats = variables["batch_stats"]
    cdt = _DTYPES[cfg.compute_dtype]
    for i in range(1, len(cfg.filter_multipliers)):
        h = _xla_block(
            h,
            params[f"block_{i}"],
            stats[f"block_{i}"]["bn"],
            cfg.pool_sizes[i],
            cfg.dilations[i],
            cfg.bn_epsilon,
            cdt,
        )
    h = jnp.max(h, axis=1)
    emb = params["embed"]
    out = h @ emb["kernel"].astype(cdt) + emb["bias"].astype(cdt)
    return out.astype(jnp.float32)


def fast_embed(variables: dict, cfg: EncoderConfig, x: jnp.ndarray) -> jnp.ndarray:
    """(B, T, 1) float32 → (B, embedding_dim) float32, inference forward."""
    h = block0_forward(variables["params"], variables["batch_stats"], cfg, x)
    return embed_tail(variables, cfg, h)
