"""Batched distance kernels for siamese merge + n-shot evaluation.

Rebuild of (a) the reference's siamese distance merges
(reference: ``voicemap/models.py :: build_siamese_net`` distance_metric ∈
{uniform_euclidean, weighted_l1, uniform_l1, dot_product, cosine_distance})
and (b) the per-task numpy nearest-neighbor loop of
``voicemap/utils.py :: n_shot_task_evaluation`` (SURVEY.md §3.4), replaced by
one batched matmul-form distance matrix (BASELINE.json: "pairwise n-shot
evaluation becomes a single batched matmul-distance kernel").

The squared-euclidean matrix is computed in matmul form — ‖q‖² + ‖s‖² − 2QSᵀ —
so the dominant FLOPs are one GEMM. L1 has no matmul form; the jnp version
broadcasts (fused by XLA).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SIAMESE_METRICS = (
    "uniform_euclidean",
    "weighted_l1",
    "uniform_l1",
    "dot_product",
    "cosine_distance",
)


def pairwise_sq_euclidean(q: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """(nq, d) × (ns, d) → (nq, ns) squared euclidean, matmul form."""
    q = q.astype(jnp.float32)
    s = s.astype(jnp.float32)
    qn = jnp.sum(q * q, axis=-1, keepdims=True)  # (nq, 1)
    sn = jnp.sum(s * s, axis=-1, keepdims=True).T  # (1, ns)
    cross = jnp.dot(q, s.T, preferred_element_type=jnp.float32)
    return jnp.maximum(qn + sn - 2.0 * cross, 0.0)


def pairwise_euclidean(q: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(pairwise_sq_euclidean(q, s) + 1e-12)


def pairwise_l1(q: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """(nq, d) × (ns, d) → (nq, ns) L1 distance (broadcast form)."""
    return jnp.sum(jnp.abs(q[:, None, :] - s[None, :, :]), axis=-1)


def pairwise_weighted_l1(
    q: jnp.ndarray, s: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray
) -> jnp.ndarray:
    """Koch-style weighted-L1 verification score matrix: |q−s| @ w + b.

    This is the siamese head's Dense(1) applied to the elementwise |q−s| of
    every (query, support) pair — the matrix form of the reference's
    ``model.predict([tile(query, k·n), support])`` per-task loop. Lower score
    ⇒ "same" under the same=0 label convention.
    """
    w = w.reshape(-1)
    diff = jnp.abs(q[:, None, :] - s[None, :, :])  # (nq, ns, d)
    return jnp.tensordot(diff, w, axes=(-1, 0)) + b


def pairwise_cosine_distance(q: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    qn = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    sn = s / (jnp.linalg.norm(s, axis=-1, keepdims=True) + 1e-12)
    return 1.0 - jnp.dot(qn, sn.T, preferred_element_type=jnp.float32)


def pairwise_dot(q: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Negative dot product (so argmin still picks the most similar)."""
    return -jnp.dot(q, s.T, preferred_element_type=jnp.float32)


def merge_features(e1: jnp.ndarray, e2: jnp.ndarray, metric: str) -> jnp.ndarray:
    """Per-pair merge features feeding the siamese Dense(1, sigmoid) head.

    Reference: the distance merge inside ``build_siamese_net`` — weighted_l1
    keeps the d-dim |e1−e2| vector (learned weighting via the Dense), the
    uniform metrics collapse to a scalar first.
    """
    if metric == "weighted_l1":
        return jnp.abs(e1 - e2)
    if metric == "uniform_l1":
        return jnp.sum(jnp.abs(e1 - e2), axis=-1, keepdims=True)
    if metric == "uniform_euclidean":
        return jnp.sqrt(jnp.sum(jnp.square(e1 - e2), axis=-1, keepdims=True) + 1e-12)
    if metric == "dot_product":
        return jnp.sum(e1 * e2, axis=-1, keepdims=True)
    if metric == "cosine_distance":
        n1 = e1 / (jnp.linalg.norm(e1, axis=-1, keepdims=True) + 1e-12)
        n2 = e2 / (jnp.linalg.norm(e2, axis=-1, keepdims=True) + 1e-12)
        return 1.0 - jnp.sum(n1 * n2, axis=-1, keepdims=True)
    raise ValueError(f"unknown distance metric: {metric}")


def head_scores(
    q: jnp.ndarray, s: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray, metric: str
) -> jnp.ndarray:
    """Verification-head logits for batched n-shot tasks.

    ``q`` (T, D) queries, ``s`` (T, P, D) per-task support embeddings,
    ``w``/``b`` the Dense(1) head params → (T, P) logits. Matrix form of the
    reference's ``model.predict([tile(query, k·n), support])`` inner loop;
    shared by the single-device (eval/nshot.py) and pod-sharded
    (parallel/pod_eval.py) evaluators so their scores agree bit-for-bit.
    """
    w = w.reshape(-1)
    if metric == "weighted_l1":
        diff = jnp.abs(q[:, None, :] - s)  # (T, P, D)
        return jnp.einsum("tpd,d->tp", diff, w) + b
    if metric == "uniform_l1":
        d = jnp.sum(jnp.abs(q[:, None, :] - s), axis=-1)
        return d * w[0] + b
    if metric == "uniform_euclidean":
        d = jnp.sqrt(jnp.sum(jnp.square(q[:, None, :] - s), axis=-1) + 1e-12)
        return d * w[0] + b
    if metric == "dot_product":
        d = jnp.einsum("td,tpd->tp", q, s, preferred_element_type=jnp.float32)
        return d * w[0] + b
    if metric == "cosine_distance":
        qn = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
        sn = s / (jnp.linalg.norm(s, axis=-1, keepdims=True) + 1e-12)
        d = 1.0 - jnp.einsum("td,tpd->tp", qn, sn)
        return d * w[0] + b
    raise ValueError(f"unknown distance metric: {metric}")


def class_distances(dist: jnp.ndarray, n: int, k: int) -> jnp.ndarray:
    """(…, k*n) per-support distances → (…, k) per-class means.

    Reference n>1 semantics: average distances per class then argmin
    (SURVEY.md §2.1 n-shot evaluation).
    """
    return dist.reshape(dist.shape[:-1] + (k, n)).mean(axis=-1)
