"""Siamese verification network.

Reference: ``voicemap/models.py :: build_siamese_net(encoder, input_shape,
distance_metric)`` — two inputs → shared encoder → distance merge →
Dense(1, sigmoid) (SURVEY.md §3.5).

Instead of running the shared encoder twice, the pair axis is folded into
the batch — ``(2, B, T, 1)`` is reshaped to ``(2B, T, 1)``, encoded once at
double batch, and split back for the merge. The head emits logits;
``p(different) = sigmoid(logit)`` under the same=0 label convention.

``score_support()`` exposes the head in matrix form for n-shot eval: scores
of one query block against a whole support block without tiling the query
(replaces the reference's ``model.predict([tile(query, k·n), support])``).

Variables: ``{"params": {"encoder": ..., "head": {"kernel" (F, 1), "bias"
(1,)}}, "batch_stats": {"encoder": ...}}`` with F = D for weighted_l1 and 1
for the scalar metrics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import EncoderConfig, SiameseConfig
from ..ops import distance as dist_ops
from .classifier import SpeakerClassifier
from .encoder import _DTYPES, _finish, init_dense


@dataclass(frozen=True)
class SiameseNet:
    cfg: EncoderConfig
    siamese: SiameseConfig

    @property
    def _tower(self):
        return SpeakerClassifier(self.cfg, 1)

    def init(self, key) -> Dict:
        """LeCun-normal head weights, oriented so that an untrained net
        already scores a larger distance as more likely "different" (and
        a larger dot product as more likely "same") under the configured
        label convention."""
        k_enc, k_head = jax.random.split(key)
        enc = self._tower.encoder.init(k_enc)
        metric = self.siamese.distance_metric
        d_in = self.cfg.embedding_dim if metric == "weighted_l1" else 1
        head = init_dense(k_head, d_in, 1, _DTYPES[self.cfg.param_dtype])
        sign = -1.0 if metric == "dot_product" else 1.0
        if self.siamese.same_label != 0:
            sign = -sign
        head["kernel"] = sign * jnp.abs(head["kernel"])
        return {"params": {"encoder": enc["params"], "head": head},
                "batch_stats": {"encoder": enc["batch_stats"]}}

    def embed(self, variables: Dict, x: jnp.ndarray, train: bool = False,
              rng: Optional[jax.Array] = None, bn_axis: Optional[str] = None):
        return self._tower.embed(variables, x, train, rng, bn_axis)

    def apply(self, variables: Dict, x1: jnp.ndarray, x2: jnp.ndarray,
              train: bool = False, rng: Optional[jax.Array] = None,
              bn_axis: Optional[str] = None):
        """(B, T, 1) × (B, T, 1) → (B,) logits of p(different)."""
        B = x1.shape[0]
        stacked = jnp.concatenate([x1, x2], axis=0)  # (2B, T, 1): one big conv
        out = self.embed(variables, stacked, train, rng, bn_axis)
        emb, new_stats = out if train else (out, None)
        logits = self.score_pairs(variables, emb[:B], emb[B:])
        return _finish(logits, new_stats, train)

    def score_pairs(self, variables: Dict, e1: jnp.ndarray,
                    e2: jnp.ndarray) -> jnp.ndarray:
        """Logits from precomputed embeddings (B, D) × (B, D) → (B,)."""
        head = variables["params"]["head"]
        feats = dist_ops.merge_features(e1, e2, self.siamese.distance_metric)
        feats = feats.astype(jnp.float32)
        return (feats @ head["kernel"] + head["bias"])[..., 0]

    def score_support(self, variables: Dict, q: jnp.ndarray,
                      s: jnp.ndarray) -> jnp.ndarray:
        """Score matrix (nq, ns) from embeddings q (nq, D), s (ns, D).

        Lower = more likely same speaker (same=0 convention), so n-shot
        prediction is argmin over classes — matrix form of the reference's
        per-task predict loop.
        """
        metric = self.siamese.distance_metric
        w = variables["params"]["head"]["kernel"]
        b = variables["params"]["head"]["bias"][0]
        if metric == "weighted_l1":
            return dist_ops.pairwise_weighted_l1(q, s, w, b)
        if metric == "uniform_euclidean":
            d = dist_ops.pairwise_euclidean(q, s)
        elif metric == "uniform_l1":
            d = dist_ops.pairwise_l1(q, s)
        elif metric == "dot_product":
            d = -dist_ops.pairwise_dot(q, s)  # raw dot
        elif metric == "cosine_distance":
            d = dist_ops.pairwise_cosine_distance(q, s)
        else:
            raise ValueError(metric)
        return d * w[0, 0] + b
