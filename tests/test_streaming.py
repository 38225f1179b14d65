"""Streaming host→device pipeline tests (data/pipeline.py): batch shapes,
pair-label layout, decode-cache behavior, determinism, and a short
streaming-mode training run through fit()."""

import dataclasses

import jax
import numpy as np
import pytest

from voicemap.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap.data.dataset import SpeakerDataset
from voicemap.data.pipeline import DecodeCache, StreamingPipeline


def _cfg(corpus_root, mode="classifier", batch_size=8):
    return ExperimentConfig(
        mode=mode,
        data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                        seconds=1.0, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16, dropout=0.0,
                              compute_dtype="float32"),
        siamese=SiameseConfig(),
        train=TrainConfig(batch_size=batch_size, learning_rate=3e-3),
    )


@pytest.fixture(scope="module")
def ds(corpus_root):
    return SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                          data_root=corpus_root, seed=0)


def test_decode_cache(ds):
    cache = DecodeCache(ds, max_bytes=1 << 20)
    ids = np.asarray([0, 1, 2, 0, 1])
    wavs = cache.get_many(ids)
    assert len(wavs) == 5
    np.testing.assert_array_equal(wavs[0], wavs[3])
    np.testing.assert_array_equal(wavs[0], ds._decode(0))


def test_decode_cache_eviction(ds):
    tiny = DecodeCache(ds, max_bytes=1)  # evicts everything immediately
    wavs = tiny.get_many(np.asarray([0, 1]))
    assert len(wavs) == 2
    assert tiny._bytes <= max(w.nbytes for w in wavs)


def test_classifier_stream_batches(corpus_root, ds):
    cfg = _cfg(corpus_root)
    p = StreamingPipeline(ds, cfg, mode="classifier", seed=3)
    try:
        for _ in range(3):
            frags, labels = next(p)
            assert frags.shape == (8, cfg.data.fragment_length)
            assert frags.dtype == np.int16
            assert labels.shape == (8,)
            assert labels.max() < ds.num_speakers
    finally:
        p.close()


def test_siamese_stream_batches(corpus_root, ds):
    cfg = _cfg(corpus_root, mode="siamese")
    p = StreamingPipeline(ds, cfg, mode="siamese", seed=4)
    try:
        f1, f2, y = next(p)
        assert f1.shape == f2.shape == (8, cfg.data.fragment_length)
        np.testing.assert_array_equal(y[:4], 0.0)
        np.testing.assert_array_equal(y[4:], 1.0)
    finally:
        p.close()


def test_stream_deterministic(corpus_root, ds):
    cfg = _cfg(corpus_root)

    def first_batch(seed):
        d = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                           data_root=corpus_root, seed=0)
        p = StreamingPipeline(d, cfg, mode="classifier", seed=seed)
        try:
            return next(p)
        finally:
            p.close()

    a1, l1 = first_batch(7)
    a2, l2 = first_batch(7)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(l1, l2)


def test_fit_streaming_mode(corpus_root):
    from voicemap.train.loop import fit

    cfg = _cfg(corpus_root).replace(
        train=TrainConfig(batch_size=8, learning_rate=3e-3, num_steps=12,
                          evaluate_every=6, num_eval_tasks=50, k_way=3),
    )
    state, history = fit(cfg, pipeline="streaming", verbose=False)
    assert len(history) == 2
    assert int(state.step) == 12
    assert np.isfinite(history[-1]["loss"])


def test_producer_error_surfaces(corpus_root, ds):
    cfg = _cfg(corpus_root)
    p = StreamingPipeline(ds, cfg, mode="classifier", seed=1)
    # Sabotage the cache to make the producer fail.
    p.cache.get_many = None  # type: ignore
    try:
        with pytest.raises((RuntimeError, TypeError)):
            for _ in range(10):
                next(p)
    finally:
        p.close()

def test_siamese_stream_honors_same_label(corpus_root, ds):
    cfg = _cfg(corpus_root, mode="siamese")
    cfg = dataclasses.replace(cfg, siamese=SiameseConfig(same_label=1))
    p = StreamingPipeline(ds, cfg, mode="siamese", seed=5)
    try:
        _, _, y = next(p)
        np.testing.assert_array_equal(y[:4], 1.0)  # alike pairs
        np.testing.assert_array_equal(y[4:], 0.0)  # differing pairs
    finally:
        p.close()


def test_cut_raises_on_short_file_without_pad(corpus_root, ds):
    # fragment longer than every corpus file + pad=False must fail loudly
    # (the reference's pad=False assertion), not silently zero-pad.
    cfg = _cfg(corpus_root)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, seconds=60.0)
    )
    assert not cfg.data.pad
    p = StreamingPipeline(ds, cfg, mode="classifier", seed=6)
    try:
        with pytest.raises(RuntimeError):
            next(p)
    finally:
        p.close()


def test_cut_pads_short_file_with_pad(corpus_root, ds):
    cfg = _cfg(corpus_root)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, seconds=60.0, pad=True)
    )
    p = StreamingPipeline(ds, cfg, mode="classifier", seed=6)
    try:
        frags, _ = next(p)
        assert frags.shape == (8, cfg.data.fragment_length)
    finally:
        p.close()


def test_iter_embed_batches_order_and_padding(corpus_root, ds):
    """Corpus-order coverage: every utterance exactly once, in id order,
    with the final partial batch zero-padded and its valid count right."""
    from voicemap.data.pipeline import iter_embed_batches

    cfg = _cfg(corpus_root)
    B = 7  # deliberately does not divide the corpus size
    N = len(ds.df)
    seen = 0
    frag = cfg.data.fragment_length
    for frags, count in iter_embed_batches(ds, cfg, B):
        assert frags.shape == (B, frag)
        assert frags.dtype == np.int16
        expect_count = min(B, N - seen)
        assert count == expect_count
        # Rows match the decoded waveform's offset-0 fragment.
        for j in range(count):
            wav = ds._decode(seen + j)
            np.testing.assert_array_equal(frags[j], wav[:frag])
        if count < B:
            assert not frags[count:].any()
        seen += count
    assert seen == N


def test_embed_all_streaming_matches_device(corpus_root, ds):
    """The streaming embedding table equals the device-store table
    row-for-row (both embed deterministic offset-0 fragments)."""
    from voicemap.eval import nshot
    from voicemap.models.classifier import SpeakerClassifier
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = _cfg(corpus_root)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)

    t_dev = np.asarray(nshot.embed_all(model, state, store, cfg, batch_size=16))
    t_str = np.asarray(
        nshot.embed_all_streaming(model, state, cfg, ds, batch_size=16)
    )
    assert t_str.shape == t_dev.shape
    np.testing.assert_allclose(t_str, t_dev, rtol=1e-5, atol=1e-6)


def test_embed_all_streaming_int8_matches_device(corpus_root, ds):
    """Streaming + int8: the frag-calibrated qvars equal the store-calibrated
    ones (same deterministic calibration batch) and the tables agree."""
    from voicemap.eval import nshot
    from voicemap.models.classifier import SpeakerClassifier
    from voicemap.models.quant_infer import (
        quantize_from_frags, quantize_from_store,
    )
    from voicemap.data.pipeline import iter_embed_batches
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = _cfg(corpus_root)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)

    n_cal = 16
    frags, count = next(iter_embed_batches(ds, cfg, n_cal))
    q_frag = quantize_from_frags(state, cfg, frags[:count])
    q_store = quantize_from_store(state, cfg, store, n_cal=n_cal)
    np.testing.assert_allclose(np.asarray(q_frag["s0"]),
                               np.asarray(q_store["s0"]), rtol=1e-6)
    for a, b in zip(q_frag["blocks"], q_store["blocks"]):
        np.testing.assert_array_equal(np.asarray(a["w_q"]),
                                      np.asarray(b["w_q"]))

    t_dev = np.asarray(
        nshot.embed_all(model, state, store, cfg, batch_size=16, qvars=q_store)
    )
    t_str = np.asarray(
        nshot.embed_all_streaming(model, state, cfg, ds, batch_size=16,
                                  qvars=q_frag)
    )
    np.testing.assert_allclose(t_str, t_dev, rtol=1e-5, atol=1e-6)


def test_embed_all_streaming_int8_mel(corpus_root, ds):
    """Streaming + int8 for config #4 (melspec2d): the streaming table
    matches the device-store int8 table, and a mismatched wave artifact
    fails with the typed kind-vs-mode error (regression: the streaming
    path used to hard-reject melspec2d int8 outright)."""
    from voicemap.config import MelConfig
    from voicemap.eval import nshot
    from voicemap.models.quant_infer import (
        quantize_from_frags, quantize_from_store,
    )
    from voicemap.models.spectrogram import MelSpecClassifier
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = _cfg(corpus_root, mode="melspec2d")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, downsampling=1),
        mel=MelConfig(hop_length=128, win_length=384),
    )
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = MelSpecClassifier(cfg.encoder, cfg.mel,
                              num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)

    q_store = quantize_from_store(state, cfg, store, n_cal=16)
    assert q_store["kind"] == "mel"
    t_dev = np.asarray(
        nshot.embed_all(model, state, store, cfg, batch_size=16,
                        qvars=q_store)
    )
    from voicemap.data.pipeline import iter_embed_batches

    frags, count = next(iter_embed_batches(ds, cfg, 16))
    q_frag = quantize_from_frags(state, cfg, frags[:count])
    t_str = np.asarray(
        nshot.embed_all_streaming(model, state, cfg, ds, batch_size=16,
                                  qvars=q_frag)
    )
    assert t_str.shape == t_dev.shape
    np.testing.assert_allclose(t_str, t_dev, rtol=1e-5, atol=1e-6)

    with pytest.raises(ValueError, match="artifact kind"):
        nshot.embed_all_streaming(model, state, cfg, ds,
                                  qvars={"kind": "wave"})
