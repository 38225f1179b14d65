"""Fully on-device batch/pair/task samplers.

On-device replacement for the reference's Python generator pipeline
(reference: ``voicemap/librispeech.py :: yield_verification_batches /
get_alike_pairs / get_differing_pairs / build_n_shot_task`` driven by forked
``fit_generator`` workers — SURVEY.md §2.2). Instead of host processes, the
samplers are pure jax functions over the corpus index arrays (``speaker_utts``
(S, max_utt) + ``speaker_counts`` (S,)) so sampling fuses into the compiled
train/eval step: the entire pipeline — sample → gather → preprocess → model —
is one XLA program with no host round-trips.

All samplers guarantee the reference's structural invariants:

- alike pairs: same speaker, distinct utterances;
- differing pairs: distinct speakers;
- n-shot tasks: k distinct speakers, n distinct support utterances each, one
  extra distinct query utterance from class 0 (the true class — the
  self-checking "index 0" fixture of SURVEY.md §3.4).

Distinctness is achieved with modular-shift tricks and masked top-n argsort
(no rejection sampling → static shapes, no data-dependent control flow).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class VerificationBatch(NamedTuple):
    idx_1: jnp.ndarray  # (B,) utterance ids
    idx_2: jnp.ndarray  # (B,)
    labels: jnp.ndarray  # (B,) float32, same_label for alike pairs


class NShotTasks(NamedTuple):
    query_idx: jnp.ndarray  # (tasks,) utterance ids
    support_idx: jnp.ndarray  # (tasks, k, n) utterance ids
    # True class is always 0 (reference invariant).


def _randint(key: jax.Array, shape, maxval: jnp.ndarray) -> jnp.ndarray:
    """Uniform ints in [0, maxval) with per-element (possibly traced) maxval."""
    u = jax.random.uniform(key, shape)
    return jnp.minimum((u * maxval.astype(jnp.float32)).astype(jnp.int32), maxval - 1)


def sample_classifier_batch(
    key: jax.Array, num_utterances: int, batch_size: int
) -> jnp.ndarray:
    """Uniform utterance ids (labels come from the store's labels array)."""
    return jax.random.randint(key, (batch_size,), 0, num_utterances)


def sample_distinct_speakers(
    key: jax.Array, num_speakers: int, shape: Tuple[int, ...]
) -> jnp.ndarray:
    """Pairs of distinct speaker ids: s2 = (s1 + 1 + r) mod S with r < S-1."""
    k1, k2 = jax.random.split(key)
    s1 = jax.random.randint(k1, shape, 0, num_speakers)
    shift = jax.random.randint(k2, shape, 0, num_speakers - 1)
    s2 = (s1 + 1 + shift) % num_speakers
    return s1, s2


def _pick_utterance(
    key: jax.Array, speaker_utts: jnp.ndarray, counts: jnp.ndarray, speakers: jnp.ndarray
) -> jnp.ndarray:
    """One uniform utterance id per speaker in ``speakers`` (any shape)."""
    c = counts[speakers]
    slot = _randint(key, speakers.shape, c)
    return speaker_utts[speakers, slot]


def _pick_two_distinct(
    key: jax.Array, speaker_utts: jnp.ndarray, counts: jnp.ndarray, speakers: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two distinct utterance ids per speaker (requires counts ≥ 2)."""
    k1, k2 = jax.random.split(key)
    c = counts[speakers]
    a = _randint(k1, speakers.shape, c)
    shift = _randint(k2, speakers.shape, c - 1)
    b = (a + 1 + shift) % c
    return speaker_utts[speakers, a], speaker_utts[speakers, b]


@partial(jax.jit, static_argnames=("batch_size", "same_label"))
def sample_verification_batch(
    key: jax.Array,
    speaker_utts: jnp.ndarray,
    counts: jnp.ndarray,
    batch_size: int,
    same_label: int = 0,
) -> VerificationBatch:
    """Half alike / half differing pairs, entirely on-device.

    Reference: ``build_verification_batch`` (SURVEY.md §2.1). Requires every
    speaker to have ≥ 2 utterances (the host exporter enforces/filters this);
    label convention is ``same_label`` for alike pairs.
    """
    S = speaker_utts.shape[0]
    half = batch_size // 2
    k_alike_s, k_alike_u, k_diff_s, k_diff_u1, k_diff_u2 = jax.random.split(key, 5)

    alike_speakers = jax.random.randint(k_alike_s, (half,), 0, S)
    a1, a2 = _pick_two_distinct(k_alike_u, speaker_utts, counts, alike_speakers)

    d_s1, d_s2 = sample_distinct_speakers(k_diff_s, S, (batch_size - half,))
    d1 = _pick_utterance(k_diff_u1, speaker_utts, counts, d_s1)
    d2 = _pick_utterance(k_diff_u2, speaker_utts, counts, d_s2)

    idx_1 = jnp.concatenate([a1, d1])
    idx_2 = jnp.concatenate([a2, d2])
    labels = jnp.concatenate(
        [
            jnp.full((half,), same_label, dtype=jnp.float32),
            jnp.full((batch_size - half,), 1 - same_label, dtype=jnp.float32),
        ]
    )
    return VerificationBatch(idx_1, idx_2, labels)


def _choice_without_replacement(
    key: jax.Array, n_total: int, k: int
) -> jnp.ndarray:
    """k distinct ints from [0, n_total) via random-key argsort (static k)."""
    scores = jax.random.uniform(key, (n_total,))
    return jnp.argsort(scores)[:k]


def _topn_distinct_slots(
    key: jax.Array, count: jnp.ndarray, max_utt: int, n: int
) -> jnp.ndarray:
    """n distinct slots in [0, count) (count traced, ≥ n) via masked argsort."""
    scores = jax.random.uniform(key, (max_utt,))
    slot_ids = jnp.arange(max_utt)
    scores = jnp.where(slot_ids < count, scores, jnp.inf)
    return jnp.argsort(scores)[:n]


@partial(jax.jit, static_argnames=("num_tasks", "n", "k"))
def sample_nshot_tasks(
    key: jax.Array,
    speaker_utts: jnp.ndarray,
    counts: jnp.ndarray,
    num_tasks: int,
    n: int,
    k: int,
) -> NShotTasks:
    """Batch of n-shot k-way tasks, entirely on-device.

    Reference: ``build_n_shot_task(k, n)`` looped ``num_tasks`` times in
    Python (SURVEY.md §3.4 hot loop) — here one traced program emits every
    task's indices at once; the query's true class is class 0 of each task.
    Requires every speaker to have ≥ n+1 utterances.
    """
    S, max_utt = speaker_utts.shape
    if k > S:
        raise ValueError(f"k={k} exceeds the {S} available speakers")
    if n + 1 > max_utt:
        raise ValueError(
            f"n+1={n + 1} exceeds max utterances/speaker ({max_utt})"
        )

    def one_task(tkey):
        ks, ku = jax.random.split(tkey)
        speakers = _choice_without_replacement(ks, S, k)  # (k,) distinct
        ukeys = jax.random.split(ku, k + 1)

        # Class 0: n+1 distinct utterances → query + n support.
        slots0 = _topn_distinct_slots(ukeys[0], counts[speakers[0]], max_utt, n + 1)
        utts0 = speaker_utts[speakers[0], slots0]
        query = utts0[0]
        support0 = utts0[1:]

        def per_class(ci):
            slots = _topn_distinct_slots(ukeys[ci + 1], counts[speakers[ci]], max_utt, n)
            return speaker_utts[speakers[ci], slots]

        support_rest = jax.vmap(per_class)(jnp.arange(1, k))  # (k-1, n)
        support = jnp.concatenate([support0[None], support_rest], axis=0)  # (k, n)
        return query, support

    tkeys = jax.random.split(key, num_tasks)
    query_idx, support_idx = jax.vmap(one_task)(tkeys)
    return NShotTasks(query_idx, support_idx)
