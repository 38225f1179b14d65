"""Softmax speaker classifier head over the conv encoder.

Reference: ``experiments/train_classifier.py`` — encoder + Dense(n_speakers,
softmax) (SURVEY.md §3.2). We emit logits (softmax lives in the loss), and
expose ``embed()`` — the penultimate-layer embedding the reference's
classifier-mode n-shot eval strips the softmax head to reach.

Variables: ``{"params": {"encoder": <encoder params>, "head": {"kernel",
"bias"}}, "batch_stats": {"encoder": <encoder stats>}}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import EncoderConfig
from .encoder import ConvEncoder, _DTYPES, _finish, dense, init_dense


def _sub(variables: Dict, name: str) -> Dict:
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


class HeadedEncoder:
    """An encoder (``self.encoder``) under a Dense head of ``num_classes``
    logits; subclasses are dataclasses with ``cfg`` and ``num_classes``."""

    def init(self, key) -> Dict:
        k_enc, k_head = jax.random.split(key)
        enc = self.encoder.init(k_enc)
        head = init_dense(k_head, self.cfg.embedding_dim, self.num_classes,
                          _DTYPES[self.cfg.param_dtype])
        return {"params": {"encoder": enc["params"], "head": head},
                "batch_stats": {"encoder": enc["batch_stats"]}}

    def embed(self, variables: Dict, x: jnp.ndarray, train: bool = False,
              rng: Optional[jax.Array] = None, bn_axis: Optional[str] = None):
        """Penultimate-layer embedding (n-shot eval path)."""
        out = self.encoder.apply(_sub(variables, "encoder"), x, train, rng,
                                 bn_axis)
        if train:
            return out[0], {"encoder": out[1]}
        return out

    def apply(self, variables: Dict, x: jnp.ndarray, train: bool = False,
              rng: Optional[jax.Array] = None, bn_axis: Optional[str] = None):
        out = self.embed(variables, x, train, rng, bn_axis)
        emb, new_stats = out if train else (out, None)
        cdt = _DTYPES[self.cfg.compute_dtype]
        logits = dense(variables["params"]["head"], emb, cdt).astype(jnp.float32)
        return _finish(logits, new_stats, train)


@dataclass(frozen=True)
class SpeakerClassifier(HeadedEncoder):
    cfg: EncoderConfig
    num_classes: int

    @property
    def encoder(self):
        return ConvEncoder(self.cfg)
