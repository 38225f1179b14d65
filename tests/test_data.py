"""Data-layer unit tests (SURVEY.md §4 item 1).

Covers: index build + CSV cache, fragment extraction invariants
(stochastic/deterministic/pad), pair samplers, n-shot builder (index-0
invariant), label remapping.
"""

import os

import numpy as np
import pytest

from voicemap.data import audio, index as index_mod
from voicemap.data.dataset import SpeakerDataset


def test_index_build_and_cache(corpus_root):
    df = index_mod.load_index(corpus_root, ["dev-clean"], use_cache=True)
    assert len(df) == 8 * 6
    assert set(["filepath", "speaker_id", "sex", "samples", "seconds"]) <= set(df.columns)
    assert len(np.unique(df.speaker_id)) == 8
    assert np.isin(df.sex, ["M", "F"]).all()
    cache = os.path.join(corpus_root, "dev-clean.index.csv")
    assert os.path.exists(cache)
    # Cache reload path gives identical index.
    df2 = index_mod.load_index(corpus_root, ["dev-clean"], use_cache=True)
    assert (df.filepath == df2.filepath).all()
    assert (df.samples == df2.samples).all()


def test_speakers_txt_parse(corpus_root):
    sp = index_mod.read_speakers_txt(
        os.path.join(corpus_root, "LibriSpeech", "SPEAKERS.TXT")
    )
    assert len(sp) == 8
    assert len(np.unique(sp.speaker_id)) == len(sp)


def test_wav_roundtrip(tmp_path):
    data = (np.sin(np.linspace(0, 100, 16000)) * 20000).astype(np.int16)
    p = str(tmp_path / "x.wav")
    audio.write_wav(p, data, 16000)
    back, sr = audio.read_wav(p)
    assert sr == 16000
    np.testing.assert_array_equal(back, data)
    n, sr2 = audio.probe_wav(p)
    assert (n, sr2) == (16000, 16000)


def test_fragment_shape_and_determinism(dataset):
    frag, label = dataset[0]
    T = dataset.fragment_length
    assert frag.shape == (T, 1)
    assert frag.dtype == np.float32
    assert label == dataset.datasetid_to_speaker_id[0]
    # Deterministic mode: always the file head.
    det = SpeakerDataset(
        subsets=("dev-clean",),
        seconds=1.5,
        data_root=dataset.data_root,
        stochastic=False,
        seed=1,
    )
    a, _ = det[0]
    b, _ = det[0]
    np.testing.assert_array_equal(a, b)
    wav = audio.to_float(det._decode(0))
    np.testing.assert_allclose(a[:, 0], wav[: det.fragment_length])


def test_stochastic_offsets_vary(dataset):
    frags = [dataset[0][0] for _ in range(8)]
    assert any(not np.array_equal(frags[0], f) for f in frags[1:])


def test_pad_mode(corpus_root):
    # Fragment longer than every file → zero-padding must kick in.
    ds = SpeakerDataset(
        subsets=("dev-clean",),
        seconds=10.0,
        data_root=corpus_root,
        pad=True,
        stochastic=False,
        seed=2,
    )
    frag, _ = ds[0]
    assert frag.shape == (ds.fragment_length, 1)
    wav = audio.to_float(ds._decode(0))
    # Deterministic pad: original at head, zeros after.
    np.testing.assert_allclose(frag[: len(wav), 0], wav)
    assert np.all(frag[len(wav):, 0] == 0)


def test_short_files_dropped_without_pad(corpus_root):
    with pytest.raises(ValueError):
        SpeakerDataset(
            subsets=("dev-clean",),
            seconds=100.0,
            data_root=corpus_root,
            pad=False,
        )


def test_alike_pairs(dataset):
    for a, b in dataset.get_alike_pairs(20):
        assert a != b
        assert (
            dataset.datasetid_to_speaker_id[a] == dataset.datasetid_to_speaker_id[b]
        )


def test_differing_pairs(dataset):
    for a, b in dataset.get_differing_pairs(20):
        assert (
            dataset.datasetid_to_speaker_id[a] != dataset.datasetid_to_speaker_id[b]
        )


def test_verification_batch(dataset):
    [x1, x2], y = dataset.build_verification_batch(16)
    assert x1.shape == (16, dataset.fragment_length, 1)
    assert x2.shape == x1.shape
    # same=0 first half, different=1 second half.
    np.testing.assert_array_equal(y[:8], 0)
    np.testing.assert_array_equal(y[8:], 1)


def test_n_shot_task_index0_invariant(dataset):
    for _ in range(10):
        (q, q_label), (support, labels) = dataset.build_n_shot_task(k=4, n=2)
        assert support.shape == (8, dataset.fragment_length, 1)
        # Reference invariant: true class occupies support slots [0, n).
        assert all(labels[i] == q_label for i in range(2))
        # k distinct speakers, n utterances each.
        assert len(set(labels.tolist())) == 4
        counts = {s: list(labels).count(s) for s in set(labels.tolist())}
        assert all(c == 2 for c in counts.values())


def test_label_mapping_bijective(dataset):
    m = dataset.speaker_id_mapping
    assert sorted(m.values()) == list(range(dataset.num_speakers))
    assert len(set(m.keys())) == len(m)


def test_sex_label_mode(corpus_root):
    ds = SpeakerDataset(
        subsets=("dev-clean",),
        seconds=1.5,
        data_root=corpus_root,
        label="sex",
        seed=3,
    )
    _, label = ds[0]
    assert label in (0, 1)
    assert ds.num_classes() == 2


def test_store_export(dataset):
    store = dataset.to_store()
    N = len(dataset)
    assert store.audio.shape[0] == N
    assert store.audio.dtype == np.int16
    assert store.lengths.max() == store.audio.shape[1]
    # Zero padding past true length.
    i = int(np.argmin(store.lengths))
    assert np.all(store.audio[i, store.lengths[i]:] == 0)
    # Labels contiguous.
    assert set(store.labels.tolist()) == set(range(dataset.num_speakers))
    # Speaker index matrix round-trips to labels.
    for s in range(store.speaker_utts.shape[0]):
        c = store.speaker_counts[s]
        utts = store.speaker_utts[s, :c]
        assert np.all(store.labels[utts] == s)
    # Store rows match decoded audio.
    wav = dataset._decode(0)
    np.testing.assert_array_equal(store.audio[0, : len(wav)], wav[: store.audio.shape[1]])
