"""Encoder block 0 as one GPU kernel: conv + relu + BN + max-pool, fused.

Block 0 is the encoder's only Cin=1 layer (kernel 32, pool 4, C=128 in the
baseline). Run as separate XLA ops it writes its full-rate activation
(B·T·C values) to device memory and reads it back for BatchNorm and the
pool; this kernel keeps that activation in registers and stores only the
pooled bf16 output.

Formulation (pooled GEMM). The ``p`` conv outputs that feed one pooled
position ``q`` all read the input window ``x[q·p − pad_lo : q·p − pad_lo +
win]`` with ``win = k − 1 + p``. Stack the ``p`` phase-shifted copies of the
kernel into ``W[j, u, c] = w[u − j, c]``; then for each phase ``j``

    conv_j = frames (tq, win) @ W[j] (win, C)

on the tensor cores with float32 accumulation, and the block's output is
``max_j (relu(conv_j + b)·g + h)`` with the inference BatchNorm folded to a
per-channel affine (``g = scale·rsqrt(var + eps)``, ``h = bias − mean·g``).

One program handles one utterance and ``tq`` pooled positions. It loads its
frames with one masked gather (the mask supplies SAME padding and the tile
tail), and writes ``(tq, C)`` pooled values. The window and channel axes are
padded to powers of two (at least 16, the smallest tensor-core tile); the
pads are zero weights and masked stores.

The kernel goes through Pallas' Triton route. ``interpret=True`` runs the
same kernel on the CPU, which is how the tests check it; the serving path
calls it only when :func:`voicemap.backend.gpu_kernels` says the card is
there (``models/fast_infer.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Pooled positions per program and warps per program (swept on the card at
# the serving shape; see benchmarks/bench_kernels.py).
DEFAULT_TQ = 64
DEFAULT_NUM_WARPS = 4

_ROUND_MAGIC = 12582912.0  # 1.5 * 2**23


def _pow2(n: int, floor: int = 16) -> int:
    return max(floor, 1 << (int(n) - 1).bit_length())


def stack_weights(w: jnp.ndarray, pool: int, win_p: int, c_p: int) -> jnp.ndarray:
    """Conv kernel (k, 1, C) → phase-stacked (pool, win_p, c_p) with
    ``W[j, u, c] = w[u − j, 0, c]`` and zeros elsewhere."""
    k, _, c = w.shape
    out = jnp.zeros((pool, win_p, c_p), w.dtype)
    for j in range(pool):
        out = out.at[j, j:j + k, :c].set(w[:, 0, :])
    return out


def _block0_kernel(x_ref, w_ref, b_ref, g_ref, h_ref, s_ref, o_ref, *, pool,
                   pad_lo, win, tq, t_in, t_out, c, c_p, quantize):
    row = pl.program_id(0)
    q = pl.program_id(1) * tq + jnp.arange(tq, dtype=jnp.int32)  # (tq,)
    u = jnp.arange(w_ref.shape[1], dtype=jnp.int32)  # (win_p,)
    t = q[:, None] * pool - pad_lo + u[None, :]  # (tq, win_p)
    inside = (t >= 0) & (t < t_in) & (u[None, :] < win)
    frames = plt.load(x_ref.at[row, t], mask=inside, other=0.0)
    frames = frames.astype(w_ref.dtype)
    bias = b_ref[...]
    g = g_ref[...]
    h = h_ref[...]
    best = None
    for j in range(pool):
        z = pl.dot(frames, w_ref[j])  # (tq, c_p) float32
        y = jnp.maximum(z + bias, 0.0) * g + h
        best = y if best is None else jnp.maximum(best, y)
    if quantize:
        # Round half to even, as jnp.round: adding and subtracting 1.5·2^23
        # leaves the nearest integer for |v| < 2^22 (Triton has no round).
        v = jnp.clip(best * s_ref[...], -127.0, 127.0)
        best = (v + _ROUND_MAGIC) - _ROUND_MAGIC
    cc = jnp.arange(c_p, dtype=jnp.int32)
    keep = (q < t_out)[:, None] & (cc < c)[None, :]
    plt.store(o_ref.at[row, q[:, None] * c + cc[None, :]],
              best.astype(o_ref.dtype), mask=keep)


@functools.partial(
    jax.jit,
    static_argnames=("pool", "eps", "out_dtype", "gemm_dtype", "tq",
                     "num_warps", "interpret"),
)
def block0_kernel(
    x: jnp.ndarray,  # (B, T, 1) waveform
    w: jnp.ndarray,  # (k, 1, C) conv kernel
    b: jnp.ndarray,  # (C,) conv bias
    bn_scale: jnp.ndarray,
    bn_bias: jnp.ndarray,
    bn_mean: jnp.ndarray,
    bn_var: jnp.ndarray,
    requant_scale: Optional[jnp.ndarray] = None,
    *,
    pool: int,
    eps: float,
    out_dtype=jnp.bfloat16,
    gemm_dtype=jnp.bfloat16,
    tq: int = DEFAULT_TQ,
    num_warps: int = DEFAULT_NUM_WARPS,
    interpret: bool = False,
) -> jnp.ndarray:
    """Inference block 0 → (B, T // pool, C) in ``out_dtype``.

    ``requant_scale`` (C,) or scalar: emit int8 ``clip(round(y / s))``
    instead (the int8 serving path's input quantization, fused).
    """
    B, T, cin = x.shape
    k, _, c = w.shape
    if cin != 1:
        raise ValueError(f"block-0 kernel needs Cin=1, got {cin}")
    t_out = T // pool
    win = k - 1 + pool
    win_p, c_p = _pow2(win), _pow2(c)
    f32 = jnp.float32

    def vec(v):
        return jnp.zeros((c_p,), f32).at[:c].set(jnp.broadcast_to(v, (c,)).astype(f32))

    g = bn_scale.astype(f32) * jax.lax.rsqrt(bn_var.astype(f32) + eps)
    h = bn_bias.astype(f32) - bn_mean.astype(f32) * g
    quantize = requant_scale is not None
    inv_s = vec(1.0 / requant_scale) if quantize else jnp.ones((c_p,), f32)
    if quantize:
        out_dtype = jnp.int8
    wst = stack_weights(w.astype(f32), pool, win_p, c_p).astype(gemm_dtype)
    kernel = functools.partial(
        _block0_kernel, pool=pool, pad_lo=(k - 1) // 2, win=win, tq=tq,
        t_in=T, t_out=t_out, c=c, c_p=c_p, quantize=quantize,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, t_out * c), out_dtype),
        grid=(B, pl.cdiv(t_out, tq)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="encoder_block0",
    )(x.reshape(B, T).astype(f32), wst, vec(b), vec(g), vec(h), inv_s)
    return out.reshape(B, t_out, c)


def kernel_supported(k: int, pool: int, dilation: int, cin: int) -> bool:
    """Shapes the kernel handles: a Cin=1, undilated conv whose pooled
    window fits one 64-wide frame tile."""
    return cin == 1 and dilation == 1 and pool >= 1 and k - 1 + pool <= 64


def reference_block0(x, w, b, bn_scale, bn_bias, bn_mean, bn_var, *, pool,
                     eps, dtype=np.float64) -> np.ndarray:
    """Plain numpy block 0 (SAME conv, relu, inference BN, VALID pool)."""
    x = np.asarray(x, dtype)[..., 0]
    w = np.asarray(w, dtype)[:, 0, :]
    B, T = x.shape
    k, c = w.shape
    pad_lo = (k - 1) // 2
    xp = np.pad(x, ((0, 0), (pad_lo, k - 1 - pad_lo)))
    frames = np.stack([xp[:, m:m + T] for m in range(k)], axis=-1)  # (B,T,k)
    z = frames @ w + np.asarray(b, dtype)
    a = np.maximum(z, 0.0)
    g = np.asarray(bn_scale, dtype) / np.sqrt(np.asarray(bn_var, dtype) + eps)
    y = (a - np.asarray(bn_mean, dtype)) * g + np.asarray(bn_bias, dtype)
    t_out = T // pool
    return y[:, :t_out * pool].reshape(B, t_out, pool, c).max(axis=2)
