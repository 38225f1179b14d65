"""Threshold-free verification metrics (eval/verification.py): EER/AUC math
on constructed score sets, orientation handling, and the end-to-end pair
scoring path on the synthetic corpus."""

import jax
import numpy as np
import pytest

from voicemap.config import (
    DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
)
from voicemap.eval.verification import (
    auc_from_scores,
    eer_from_scores,
    evaluate_verification,
    verification_scores,
)


def test_eer_perfect_separation():
    scores = np.concatenate([np.linspace(0, 0.4, 50), np.linspace(0.6, 1, 50)])
    labels = np.concatenate([np.zeros(50), np.ones(50)])  # same=0
    eer, thr = eer_from_scores(scores, labels, same_label=0)
    assert eer == 0.0
    assert 0.4 <= thr < 0.6
    assert auc_from_scores(scores, labels) == 1.0


def test_eer_total_confusion():
    """Identical score distributions ⇒ EER ~0.5, AUC ~0.5."""
    rng = np.random.default_rng(0)
    scores = np.tile(rng.standard_normal(500), 2)
    labels = np.concatenate([np.zeros(500), np.ones(500)])
    eer, _ = eer_from_scores(scores, labels)
    assert abs(eer - 0.5) < 0.02
    assert abs(auc_from_scores(scores, labels) - 0.5) < 0.02


def test_eer_known_overlap():
    """Hand-built 25% overlap: same U[0,1], diff U[0.5,1.5] ⇒ EER = FAR=FRR
    crossing at t=0.75 → 0.25."""
    same = np.linspace(0, 1, 1001)
    diff = np.linspace(0.5, 1.5, 1001)
    scores = np.concatenate([same, diff])
    labels = np.concatenate([np.zeros(1001), np.ones(1001)])
    eer, thr = eer_from_scores(scores, labels)
    assert abs(eer - 0.25) < 0.01
    assert abs(thr - 0.75) < 0.01


def test_auc_tie_handling():
    """All scores identical ⇒ AUC exactly 0.5 (ties counted half)."""
    scores = np.ones(40)
    labels = np.concatenate([np.zeros(20), np.ones(20)])
    assert auc_from_scores(scores, labels) == 0.5


def test_eer_requires_both_classes():
    with pytest.raises(ValueError, match="both"):
        eer_from_scores(np.ones(4), np.zeros(4))


def _cfg(corpus_root, **siamese_kw):
    return ExperimentConfig(
        mode="siamese",
        data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                        seconds=1.0, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16, dropout=0.0,
                              compute_dtype="float32"),
        siamese=SiameseConfig(**siamese_kw),
        train=TrainConfig(batch_size=8),
    )


@pytest.fixture(scope="module")
def siamese_setup(corpus_root):
    from voicemap.data.dataset import SpeakerDataset
    from voicemap.models.siamese import SiameseNet
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = _cfg(corpus_root)
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root, seed=0)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SiameseNet(cfg.encoder, cfg.siamese)
    state = init_model_state(model, cfg)
    return model, state, store, cfg


def test_verification_scores_balanced_pairs(siamese_setup):
    model, state, store, cfg = siamese_setup
    scores, labels = verification_scores(
        model, state, store, cfg, jax.random.PRNGKey(0), num_pairs=64
    )
    assert scores.shape == (64,)
    assert set(np.unique(labels)) == {0.0, 1.0}
    # reference half-alike/half-differing layout
    assert (labels == cfg.siamese.same_label).sum() == 32
    assert np.isfinite(scores).all()


def test_evaluate_verification_end_to_end(siamese_setup):
    """Deterministic per key; EER/AUC in range. Same-speaker synthetic pairs
    share a spectral signature, so even a random-init encoder should not be
    WORSE than chance by much."""
    model, state, store, cfg = siamese_setup
    v1 = evaluate_verification(model, state, store, cfg,
                               jax.random.PRNGKey(3), num_pairs=256)
    v2 = evaluate_verification(model, state, store, cfg,
                               jax.random.PRNGKey(3), num_pairs=256)
    assert v1 == v2
    assert 0.0 <= v1["eer"] <= 0.6
    assert 0.0 <= v1["auc"] <= 1.0
    assert v1["num_pairs"] == 256


def test_verification_same_label_orientation(corpus_root, siamese_setup):
    """same_label=1 flips the head-logit orientation: the reported EER must
    be ≤ 0.5-symmetric (scoring through -logits), not 1-EER."""
    from voicemap.models.siamese import SiameseNet
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state
    from voicemap.data.dataset import SpeakerDataset

    cfg1 = _cfg(corpus_root, same_label=1)
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root, seed=0)
    store = steps_mod.device_store_for(cfg1, ds.to_store())
    model = SiameseNet(cfg1.encoder, cfg1.siamese)
    state = init_model_state(model, cfg1)
    scores, labels = verification_scores(
        model, state, store, cfg1, jax.random.PRNGKey(1), num_pairs=64
    )
    # labels carry the configured convention; both classes present.
    assert (labels == 1.0).sum() == 32
    eer, _ = eer_from_scores(scores, labels, same_label=1)
    assert 0.0 <= eer <= 1.0

    # Protocol relabeling (same_label=) changes ONLY the label values — the
    # head orientation stays the TRAINED convention, so scores are identical
    # and EER/AUC are invariant (regression: the protocol runner used to
    # override cfg.siamese.same_label, flipping orientation for heads
    # trained with same=1).
    s2, l2 = verification_scores(
        model, state, store, cfg1, jax.random.PRNGKey(1), num_pairs=64,
        same_label=0,
    )
    np.testing.assert_array_equal(scores, s2)
    np.testing.assert_array_equal(labels, 1.0 - l2)
    eer2, _ = eer_from_scores(s2, l2, same_label=0)
    assert eer2 == eer
    assert auc_from_scores(s2, l2, same_label=0) == auc_from_scores(
        scores, labels, same_label=1)
