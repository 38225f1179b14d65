"""Log-mel frontend + 2D-CNN embedder (BASELINE.json config #4).

The waveform enters as (B, T, 1); the frontend produces (B, frames, mels, 1)
log-mel images (``ops/melspec.py``: framing, rfft, mel matmul), and a 2D conv
stack mirroring the 1D encoder's design (conv+relu → BN → spatial dropout →
2×2 maxpool, channel multipliers 1/2/3/4) embeds them. Exposes the same
``apply``/``embed`` surface as SpeakerClassifier so the train loop, n-shot
eval, and checkpointing are reused unchanged.

Variables: ``{"params": {"encoder": {"block_i": {"conv", "bn"}, "embed"},
"head"}, "batch_stats": {"encoder": {"block_i": {"bn"}}}}``; conv kernels are
``(3, 3, Cin, Cout)``. The frontend has no parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import EncoderConfig, MelConfig
from ..ops import melspec
from .classifier import HeadedEncoder
from .encoder import (_DTYPES, _finish, conv_block, dense, init_bn, init_conv,
                      init_dense)


def mel_image(x: jnp.ndarray, mel: MelConfig, sample_rate: int = 16000) -> jnp.ndarray:
    """Waveform (B, T, 1) → log-mel image (B, frames, mels, 1), standardized
    per utterance (the spectrogram analog of whiten)."""
    m = melspec.log_mel_spectrogram(x, mel, sample_rate)
    mean = jnp.mean(m, axis=(1, 2), keepdims=True)
    std = jnp.std(m, axis=(1, 2), keepdims=True)
    return ((m - mean) / (std + 1e-5))[..., None]


def mel_base_filters(cfg: EncoderConfig) -> int:
    return max(cfg.filters // 4, 8)


@dataclass(frozen=True)
class MelSpecEncoder:
    """Waveform → log-mel image → 2D conv stack → embedding (B, D) float32."""

    cfg: EncoderConfig
    mel: MelConfig
    sample_rate: int = 16000

    def init(self, key) -> Dict:
        cfg = self.cfg
        pdt = _DTYPES[cfg.param_dtype]
        n = len(cfg.filter_multipliers)
        keys = jax.random.split(key, n + 1)
        params: Dict = {}
        stats: Dict = {}
        c_in = 1
        for i, mult in enumerate(cfg.filter_multipliers):
            c = mel_base_filters(cfg) * mult
            bn_p, bn_s = init_bn(c)
            params[f"block_{i}"] = {"conv": init_conv(keys[i], (3, 3, c_in, c), pdt),
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
        h = mel_image(x, self.mel, self.sample_rate).astype(cdt)
        for i in range(len(cfg.filter_multipliers)):
            h, new_stats[f"block_{i}"] = conv_block(
                params[f"block_{i}"], stats[f"block_{i}"], h, pool=2,
                dilation=1, dropout=cfg.dropout, train=train,
                rng=None if rng is None else jax.random.fold_in(rng, i),
                momentum=cfg.bn_momentum, eps=cfg.bn_epsilon, dtype=cdt,
                bn_axis=bn_axis,
            )
        h = jnp.max(h, axis=(1, 2))  # global max pool
        out = dense(params["embed"], h, cdt).astype(jnp.float32)
        return _finish(out, new_stats, train)


@dataclass(frozen=True)
class MelSpecClassifier(HeadedEncoder):
    """Frontend + 2D encoder + softmax head; same surface as SpeakerClassifier."""

    cfg: EncoderConfig
    mel: MelConfig
    num_classes: int = 2
    sample_rate: int = 16000

    @property
    def encoder(self):
        return MelSpecEncoder(self.cfg, self.mel, self.sample_rate)
