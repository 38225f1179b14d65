"""On-device sampler tests: structural invariants of pair/task sampling
(SURVEY.md §4 item 1 — alike ⇒ same speaker, differing ⇒ distinct, n-shot
index-0 invariant, k distinct speakers, n distinct utterances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.ops import sampling


@pytest.fixture(scope="module")
def toy_index():
    """5 speakers with 3–6 utterances each; utterance ids are unique ints."""
    counts = np.array([3, 4, 5, 6, 3], dtype=np.int32)
    max_utt = counts.max()
    utts = np.zeros((5, max_utt), dtype=np.int32)
    next_id = 0
    labels = {}
    for s, c in enumerate(counts):
        for j in range(c):
            utts[s, j] = next_id
            labels[next_id] = s
            next_id += 1
    return jnp.asarray(utts), jnp.asarray(counts), labels


def test_verification_batch_invariants(toy_index):
    utts, counts, labels = toy_index
    B = 64
    for seed in range(5):
        batch = sampling.sample_verification_batch(
            jax.random.PRNGKey(seed), utts, counts, B
        )
        i1, i2, y = map(np.asarray, batch)
        half = B // 2
        np.testing.assert_array_equal(y[:half], 0.0)
        np.testing.assert_array_equal(y[half:], 1.0)
        for a, b in zip(i1[:half], i2[:half]):
            assert labels[int(a)] == labels[int(b)], "alike pair crossed speakers"
            assert a != b, "alike pair repeated the same utterance"
        for a, b in zip(i1[half:], i2[half:]):
            assert labels[int(a)] != labels[int(b)], "differing pair same speaker"


def test_verification_batch_same_label_convention(toy_index):
    utts, counts, _ = toy_index
    batch = sampling.sample_verification_batch(
        jax.random.PRNGKey(0), utts, counts, 8, same_label=1
    )
    y = np.asarray(batch.labels)
    np.testing.assert_array_equal(y[:4], 1.0)
    np.testing.assert_array_equal(y[4:], 0.0)


def test_nshot_tasks_invariants(toy_index):
    utts, counts, labels = toy_index
    n, k, T = 2, 4, 50
    tasks = sampling.sample_nshot_tasks(
        jax.random.PRNGKey(3), utts, counts, T, n, k
    )
    q = np.asarray(tasks.query_idx)
    s = np.asarray(tasks.support_idx)
    assert s.shape == (T, k, n)
    for t in range(T):
        class_speakers = []
        for ci in range(k):
            spk = {labels[int(u)] for u in s[t, ci]}
            assert len(spk) == 1, "support class mixes speakers"
            assert len(set(s[t, ci].tolist())) == n, "support utterances repeat"
            class_speakers.append(spk.pop())
        assert len(set(class_speakers)) == k, "support speakers not distinct"
        # Reference invariant: query's speaker is class 0, query not in support.
        assert labels[int(q[t])] == class_speakers[0]
        assert int(q[t]) not in set(s[t, 0].tolist())


def test_nshot_uses_all_speakers(toy_index):
    utts, counts, labels = toy_index
    tasks = sampling.sample_nshot_tasks(
        jax.random.PRNGKey(5), utts, counts, 200, 1, 3
    )
    q_speakers = {labels[int(u)] for u in np.asarray(tasks.query_idx)}
    assert q_speakers == set(range(5))


def test_classifier_batch_uniform():
    idx = np.asarray(
        sampling.sample_classifier_batch(jax.random.PRNGKey(0), 100, 5000)
    )
    assert idx.min() >= 0 and idx.max() < 100
    # Roughly uniform coverage.
    hist = np.bincount(idx, minlength=100)
    assert hist.min() > 10


def test_distinct_speakers():
    s1, s2 = sampling.sample_distinct_speakers(jax.random.PRNGKey(1), 7, (1000,))
    assert not np.any(np.asarray(s1) == np.asarray(s2))
    assert np.asarray(s2).max() < 7


def test_sampling_determinism(toy_index):
    utts, counts, _ = toy_index
    a = sampling.sample_verification_batch(jax.random.PRNGKey(9), utts, counts, 16)
    b = sampling.sample_verification_batch(jax.random.PRNGKey(9), utts, counts, 16)
    np.testing.assert_array_equal(np.asarray(a.idx_1), np.asarray(b.idx_1))
    np.testing.assert_array_equal(np.asarray(a.idx_2), np.asarray(b.idx_2))
