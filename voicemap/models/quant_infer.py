"""int8 post-training-quantized inference embedding path.

A serving path with no reference analog (the reference serves f32 Keras
inference — ``voicemap/models.py :: get_baseline_convolutional_encoder``):
blocks 1+ of the encoder are GEMM work, which int8 tensor cores can run at
twice the bf16 rate, and int8 halves the inter-block activation traffic.
On the H100 it is not yet faster than bf16 (the int8 blocks 1+ measure
about 3× slower than the bf16 cuDNN blocks at the serving batch; PERF.md),
so bf16 is the default and int8 is served only on request.

Scheme — classic symmetric per-channel PTQ:

- **Activations**: per-input-channel scales ``s_in[ci]`` from a calibration
  batch (max-abs / 127). The post-BN activation is requantized inside the
  previous block's epilogue, so blocks 1+ stream int8 activations.
- **Weights**: the input scale is folded into the weight *before* weight
  quantization (``w[k,ci,co] * s_in[ci]``), then per-output-channel
  symmetric int8 (``s_w[co]``). One conv in s8×s8→s32 then reproduces
  ``conv(x̂, w)`` up to rounding, where ``x̂`` is the dequantized input.
- **Epilogue** (fused by XLA into the conv output): with ``s_w > 0`` by
  construction, ``relu(acc·s_w + b) = s_w·relu(acc + b/s_w)``, so
  conv-bias, BN inference affine, and the next block's requantization fold
  into three per-channel f32 vectors::

      z_q = clamp(round(alpha·relu(acc + beta) + gamma))
      alpha = s_w·g / s_out,  beta = b / s_w,  gamma = h / s_out

  where ``g = scale·rsqrt(var+eps)`` and ``h = bn_bias − mean·g``.
- **Max-pool runs on the int8 tensor**: requantization is monotone per
  channel (positive scale, nondecreasing round/clamp), so
  ``max(quant(z)) == quant(max(z))`` exactly — pooling commutes with
  quantization and moves 4× less data.
- Block 0 (Cin=1) is not quantized: it runs the serving block 0
  (``fast_infer.block0_forward``) and requantizes its output once. The final
  block dequantizes in its epilogue (bf16) ahead of global max-pool + Dense.

Accuracy: property-tested against the bf16 path (embedding cosine
similarity and n-shot nearest-neighbor decisions) in
``tests/test_quant_infer.py``; gated end to end in ``bench.py --int8``.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EncoderConfig
from .encoder import _DTYPES, max_pool
from .fast_infer import _xla_block, block0_forward


def check_qvars_mode(cfg, qvars) -> None:
    """Validate a qvars artifact against the model mode, loudly.

    One shared check for every int8 entry point (eval/nshot device-store +
    streaming, parallel/pod_eval): a mismatched artifact otherwise dies in
    a conv rank error deep inside the embed program (or silently runs the
    wrong quant program). ``kind='mel'`` artifacts serve melspec2d; 'wave'
    artifacts serve the raw-waveform encoders (classifier/siamese)."""
    if cfg.mode not in ("classifier", "siamese", "melspec2d"):
        raise ValueError(f"int8 path does not support mode {cfg.mode!r}")
    if (cfg.mode == "melspec2d") != (qvars.get("kind") == "mel"):
        raise ValueError(
            "qvars artifact kind does not match cfg.mode (mel artifacts "
            "serve melspec2d; wave artifacts serve classifier/siamese)"
        )


def _bn_affine(blk: Dict, bst: Dict, eps: float):
    """Inference BatchNorm as per-channel affine: z = y*g + h (f32)."""
    inv = jax.lax.rsqrt(bst["var"].astype(jnp.float32) + eps)
    g = inv * blk["bn"]["scale"].astype(jnp.float32)
    h = blk["bn"]["bias"].astype(jnp.float32) - bst["mean"].astype(jnp.float32) * g
    return g, h


# One jitted program for the whole calibration sweep: eager per-op execution
# at serving batch sizes keeps several (B, T, C) intermediates live at once
# and can exhaust device memory; under jit XLA fuses each block and
# frees activations as soon as the per-channel amax is reduced. Module-level
# with (params, stats, x) as runtime arguments so the encoder weights stay
# program inputs (not baked-in HLO constants duplicating them in HBM) and the
# compile caches across calibrate_scales calls.
@functools.partial(jax.jit, static_argnames=("cfg", "headroom"))
def _calib_sweep(params, stats, x, cfg: EncoderConfig, headroom: float):
    cdt = _DTYPES[cfg.compute_dtype]
    h = x
    out = []
    for i in range(len(cfg.filter_multipliers)):
        h = _xla_block(h, params[f"block_{i}"], stats[f"block_{i}"]["bn"],
                       cfg.pool_sizes[i], cfg.dilations[i],
                       cfg.bn_epsilon, cdt)
        if i < len(cfg.filter_multipliers) - 1:
            amax = jnp.max(jnp.abs(h.astype(jnp.float32)), axis=(0, 1))
            out.append(jnp.maximum(amax * headroom, 1e-8) / 127.0)
    return out


def calibrate_scales(variables: Dict, cfg: EncoderConfig, x_calib: jnp.ndarray,
                     headroom: float = 1.0) -> List[jnp.ndarray]:
    """Per-channel int8 scales for each block's INPUT activation (blocks 1+).

    Runs the bf16 reference forward on ``x_calib`` (any representative
    batch; synthetic works — scales track the BN-stabilized dynamic range,
    not speaker content) and records max-abs per channel of every pooled
    block output. Returns ``scales[i]`` = scale of block ``i+1``'s input,
    ``len == n_blocks - 1``.
    """
    scales = _calib_sweep(variables["params"], variables["batch_stats"],
                          x_calib, cfg=cfg, headroom=headroom)
    return [jax.device_get(s) for s in scales]


def quantize_encoder(variables: Dict, cfg: EncoderConfig,
                     x_calib: jnp.ndarray) -> Dict:
    """Fold + quantize blocks 1+ of a trained encoder for int8 serving.

    Returns a qvars dict consumed by :func:`quant_embed`; the original
    ``variables`` stay authoritative for block 0 and the Dense head.
    """
    n = len(cfg.filter_multipliers)
    if n < 2:
        raise ValueError("quantized path needs at least 2 conv blocks")
    scales = calibrate_scales(variables, cfg, x_calib)
    params, stats = variables["params"], variables["batch_stats"]
    blocks = []
    for i in range(1, n):
        blk = params[f"block_{i}"]
        bst = stats[f"block_{i}"]["bn"]
        w = blk["conv"]["kernel"].astype(jnp.float32)  # (k, Cin, Cout)
        b = blk["conv"]["bias"].astype(jnp.float32)
        s_in = jnp.asarray(scales[i - 1], jnp.float32)  # (Cin,)
        w_f = w * s_in[None, :, None]
        s_w = jnp.maximum(jnp.max(jnp.abs(w_f), axis=(0, 1)), 1e-12) / 127.0
        w_q = jnp.clip(jnp.round(w_f / s_w[None, None, :]), -127, 127
                       ).astype(jnp.int8)
        g, h = _bn_affine(blk, bst, cfg.bn_epsilon)
        beta = b / s_w
        if i < n - 1:
            s_out = jnp.asarray(scales[i], jnp.float32)
            alpha = s_w * g / s_out
            gamma = h / s_out
        else:  # last block dequantizes: z = (s_w·g)·relu(acc+beta) + h
            alpha = s_w * g
            gamma = h
        blocks.append({"w_q": w_q, "alpha": alpha, "beta": beta,
                       "gamma": gamma})
    return {"s0": jnp.asarray(scales[0], jnp.float32), "blocks": blocks}


def quantize_from_store(state, cfg, store, n_cal: int = 256) -> Dict:
    """Calibrate + quantize off a device store (CLI convenience).

    Uses the first ``n_cal`` deterministic fragments as the calibration
    batch — representative by construction (same preprocessing as serving).
    ``state``: a TrainState with ``params['encoder']``/``batch_stats``;
    ``cfg``: the full ExperimentConfig.
    """
    from ..train.steps import fetch_batch

    n = min(n_cal, int(store.labels.shape[0]))
    x_cal = fetch_batch(store, jnp.arange(n, dtype=jnp.int32),
                        jax.random.PRNGKey(0), cfg, stochastic=False)
    enc_vars = {"params": state.params["encoder"],
                "batch_stats": state.batch_stats["encoder"]}
    if cfg.mode == "melspec2d":
        return quantize_mel_encoder(enc_vars, cfg.encoder, cfg.mel, x_cal,
                                    sample_rate=cfg.data.sample_rate)
    return quantize_encoder(enc_vars, cfg.encoder, x_cal)


def quantize_from_frags(state, cfg, frags) -> Dict:
    """Calibrate + quantize off host-cut int16 fragments (the streaming
    serving path's calibration batch — see data/pipeline.iter_embed_batches)."""
    from ..train.steps import preprocess_fragments

    x_cal = preprocess_fragments(jnp.asarray(frags), cfg)
    enc_vars = {"params": state.params["encoder"],
                "batch_stats": state.batch_stats["encoder"]}
    if cfg.mode == "melspec2d":
        return quantize_mel_encoder(enc_vars, cfg.encoder, cfg.mel, x_cal,
                                    sample_rate=cfg.data.sample_rate)
    return quantize_encoder(enc_vars, cfg.encoder, x_cal)


def save_qvars(path: str, qvars: Dict) -> None:
    """Persist a quantized encoder to one ``.npz`` serving artifact.

    int8 weights + per-channel f32 epilogue vectors — ~4× smaller than the
    bf16 params for blocks 1+ and calibration-free at load time (quantize
    once on the training host, deploy everywhere).
    """
    arrs = {"s0": np.asarray(qvars["s0"]),
            "n_blocks": np.asarray(len(qvars["blocks"]), np.int32),
            "kind": np.asarray(qvars.get("kind", "wave"))}
    for i, blk in enumerate(qvars["blocks"]):
        for k, v in blk.items():
            arrs[f"block{i}_{k}"] = np.asarray(v)
    np.savez(path, **arrs)


def load_qvars(path: str) -> Dict:
    """Load a :func:`save_qvars` artifact back into a qvars dict."""
    with np.load(path) as z:
        n = int(z["n_blocks"])
        blocks = []
        for i in range(n):
            blocks.append({
                k: jnp.asarray(z[f"block{i}_{k}"])
                for k in ("w_q", "alpha", "beta", "gamma")
            })
        out = {"s0": jnp.asarray(z["s0"]), "blocks": blocks}
        kind = str(z["kind"]) if "kind" in z else "wave"
        if kind == "mel":
            out["kind"] = "mel"
        return out


def int8_conv(x_q: jnp.ndarray, w_q: jnp.ndarray, dilation: int = 1) -> jnp.ndarray:
    """SAME convolution in exact integer arithmetic: int8 ``x_q`` (B,
    *spatial, Cin) by int8 ``w_q`` (*window, Cin, Cout) → int32.

    Written as one s8×s8→s32 ``dot_general`` per kernel tap over a shifted
    view of the padded input (int8 GEMMs on the tensor cores); XLA:GPU does
    not lower a convolution with int32 output."""
    window = w_q.shape[:-2]
    nd = len(window)
    spatial = x_q.shape[1:-1]
    reach = [(k - 1) * dilation for k in window]
    xp = jnp.pad(x_q, ((0, 0),) + tuple((r // 2, r - r // 2) for r in reach)
                 + ((0, 0),))
    acc = None
    for tap in np.ndindex(*window):
        view = xp[(slice(None),)
                  + tuple(slice(t * dilation, t * dilation + n)
                          for t, n in zip(tap, spatial))]
        part = jax.lax.dot_general(
            view, w_q[tap], (((nd + 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        acc = part if acc is None else acc + part
    return acc


def _quant_block(x_q, qblk, pool, dilation=1, *, last, out_dtype):
    """One int8 conv block (1-D or 2-D): s8×s8→s32 conv, folded epilogue,
    requantize (or dequantize when ``last``), pool on the int8 tensor."""
    acc = int8_conv(x_q, qblk["w_q"], dilation)
    z = (jax.nn.relu(acc.astype(jnp.float32) + qblk["beta"]) * qblk["alpha"]
         + qblk["gamma"])
    if last:
        y = z.astype(out_dtype)
    else:
        y = jnp.clip(jnp.round(z), -127, 127).astype(jnp.int8)
    return max_pool(y, pool)


def quant_embed(variables: Dict, qvars: Dict, cfg: EncoderConfig,
                x: jnp.ndarray) -> jnp.ndarray:
    """(B, T, 1) float32 → (B, embedding_dim) float32, int8 blocks 1+.

    Mirrors ``fast_infer.fast_embed``: block 0 runs the serving block 0 with
    its output requantized to int8 (inside the GPU kernel when it runs);
    blocks 1+ run s8×s8→s32 convs with fused requantizing epilogues.
    """
    params, stats = variables["params"], variables["batch_stats"]
    cdt = _DTYPES[cfg.compute_dtype]
    n = len(cfg.filter_multipliers)
    h_q = block0_forward(params, stats, cfg, x, requant_scale=qvars["s0"])
    for i in range(1, n):
        h_q = _quant_block(h_q, qvars["blocks"][i - 1], cfg.pool_sizes[i],
                           cfg.dilations[i], last=i == n - 1, out_dtype=cdt)
    h = jnp.max(h_q, axis=1)
    emb = params["embed"]
    out = h @ emb["kernel"].astype(cdt) + emb["bias"].astype(cdt)
    return out.astype(jnp.float32)


# ---------------------------------------------------------------------------
# config #4 (log-mel frontend + 2D CNN, models/spectrogram.py) int8 serving
# ---------------------------------------------------------------------------
# Same scheme as the 1D path above, adapted to the 2D stack: the param-free
# mel frontend stays f32 (FFT work, not a GEMM), the standardized log-mel
# image is quantized ONCE with a calibrated per-tensor scale, and all four
# conv2d blocks run s8×s8→s32 with the fused requantizing epilogue. The 2×2
# max-pool runs on the int8 tensor (monotone per channel, commutes exactly).
# Unlike the 1D path there is no block-0 special case — the image's Cin=1
# conv is just another quantized GEMM.


def _mel_image(x: jnp.ndarray, mel_cfg, sample_rate: int) -> jnp.ndarray:
    """Waveform (B, T, 1) → standardized log-mel image (B, F, M, 1), f32."""
    from .spectrogram import mel_image

    return mel_image(x, mel_cfg, sample_rate)


def _mel_block_infer(img, blk, bst, eps, cdt):
    """Inference-mode Conv2DBlock (conv→relu→BN affine→pool2), bf16 ref."""
    w = blk["conv"]["kernel"].astype(cdt)
    z = jax.lax.conv_general_dilated(
        img.astype(cdt), w, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + blk["conv"]["bias"].astype(cdt)
    a = jax.nn.relu(z)
    g, h = _bn_affine(blk, bst, eps)
    y = (a.astype(jnp.float32) * g + h).astype(cdt)
    return max_pool(y, 2)


@functools.partial(jax.jit, static_argnames=("cfg", "mel_cfg", "sample_rate",
                                             "headroom"))
def _calib_sweep_mel(params, stats, x, cfg: EncoderConfig, mel_cfg,
                     sample_rate: int, headroom: float):
    cdt = _DTYPES[cfg.compute_dtype]
    img = _mel_image(x, mel_cfg, sample_rate)
    out = [jnp.maximum(jnp.max(jnp.abs(img)) * headroom, 1e-8) / 127.0]
    h = img
    for i in range(len(cfg.filter_multipliers)):
        h = _mel_block_infer(h, params[f"block_{i}"], stats[f"block_{i}"]["bn"],
                             cfg.bn_epsilon, cdt)
        if i < len(cfg.filter_multipliers) - 1:
            amax = jnp.max(jnp.abs(h.astype(jnp.float32)), axis=(0, 1, 2))
            out.append(jnp.maximum(amax * headroom, 1e-8) / 127.0)
    return out


def quantize_mel_encoder(variables: Dict, cfg: EncoderConfig, mel_cfg,
                         x_calib: jnp.ndarray, sample_rate: int = 16000) -> Dict:
    """Fold + quantize ALL conv2d blocks of a trained mel encoder.

    Returns a qvars dict (``kind='mel'``) consumed by :func:`quant_embed_mel`.
    ``scales[0]`` is the per-tensor image scale (the standardized log-mel
    image is channel-less); blocks fold exactly like the 1D path with the
    kernel's extra spatial axis."""
    n = len(cfg.filter_multipliers)
    params, stats = variables["params"], variables["batch_stats"]
    scales = [jax.device_get(s) for s in _calib_sweep_mel(
        params, stats, x_calib, cfg=cfg, mel_cfg=mel_cfg,
        sample_rate=sample_rate, headroom=1.0)]
    blocks = []
    for i in range(n):
        blk = params[f"block_{i}"]
        bst = stats[f"block_{i}"]["bn"]
        w = blk["conv"]["kernel"].astype(jnp.float32)  # (kh, kw, Cin, Cout)
        b = blk["conv"]["bias"].astype(jnp.float32)
        s_in = jnp.atleast_1d(jnp.asarray(scales[i], jnp.float32))  # (Cin,)|(1,)
        w_f = w * s_in[None, None, :, None]
        s_w = jnp.maximum(jnp.max(jnp.abs(w_f), axis=(0, 1, 2)), 1e-12) / 127.0
        w_q = jnp.clip(jnp.round(w_f / s_w[None, None, None, :]), -127, 127
                       ).astype(jnp.int8)
        g, h = _bn_affine(blk, bst, cfg.bn_epsilon)
        beta = b / s_w
        if i < n - 1:
            s_out = jnp.asarray(scales[i + 1], jnp.float32)
            alpha = s_w * g / s_out
            gamma = h / s_out
        else:
            alpha = s_w * g
            gamma = h
        blocks.append({"w_q": w_q, "alpha": alpha, "beta": beta,
                       "gamma": gamma})
    return {"kind": "mel", "s0": jnp.asarray(scales[0], jnp.float32),
            "blocks": blocks}


def quant_embed_mel(variables: Dict, qvars: Dict, cfg: EncoderConfig,
                    mel_cfg, x: jnp.ndarray,
                    sample_rate: int = 16000) -> jnp.ndarray:
    """(B, T, 1) float32 → (B, embedding_dim) float32, int8 conv2d stack."""
    params = variables["params"]
    cdt = _DTYPES[cfg.compute_dtype]
    img = _mel_image(x, mel_cfg, sample_rate)
    h_q = jnp.clip(jnp.round(img / qvars["s0"]), -127, 127).astype(jnp.int8)
    n = len(cfg.filter_multipliers)
    for i in range(n):
        h_q = _quant_block(h_q, qvars["blocks"][i], 2, last=(i == n - 1),
                           out_dtype=cdt)
    h = jnp.max(h_q, axis=(1, 2))
    emb = params["embed"]
    out = h @ emb["kernel"].astype(cdt) + emb["bias"].astype(cdt)
    return out.astype(jnp.float32)
