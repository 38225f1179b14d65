"""n-shot evaluation unit tests: siamese scoring across every distance
metric, classifier scoring, statistical sanity (perfect embeddings → 100%,
random embeddings → chance), and the evaluate() wrapper."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.eval import nshot


def toy_index(n_speakers=6, utts=4):
    counts = np.full(n_speakers, utts, np.int32)
    speaker_utts = np.arange(n_speakers * utts, dtype=np.int32).reshape(
        n_speakers, utts
    )
    labels = np.repeat(np.arange(n_speakers), utts)
    return jnp.asarray(speaker_utts), jnp.asarray(counts), labels


def test_classifier_nshot_perfect_embeddings():
    """Embeddings identical within speaker, orthogonal across → accuracy 1."""
    speaker_utts, counts, labels = toy_index()
    table = jnp.asarray(np.eye(6, dtype=np.float32)[labels] * 10.0)
    acc = nshot.classifier_nshot_accuracy(
        table, speaker_utts, counts, jax.random.PRNGKey(0), 100, n=1, k=4
    )
    assert float(acc) == 1.0
    acc2 = nshot.classifier_nshot_accuracy(
        table, speaker_utts, counts, jax.random.PRNGKey(1), 100, n=3, k=5
    )
    assert float(acc2) == 1.0


def test_classifier_nshot_random_embeddings_chance():
    speaker_utts, counts, labels = toy_index(n_speakers=10, utts=6)
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((60, 32)), jnp.float32)
    accs = [
        float(
            nshot.classifier_nshot_accuracy(
                table, speaker_utts, counts, jax.random.PRNGKey(s), 400, 1, 4
            )
        )
        for s in range(3)
    ]
    # chance = 0.25; allow Monte-Carlo spread.
    assert 0.15 < np.mean(accs) < 0.4, accs


@pytest.mark.parametrize(
    "metric",
    ["weighted_l1", "uniform_l1", "uniform_euclidean", "dot_product",
     "cosine_distance"],
)
def test_siamese_nshot_perfect_embeddings(metric):
    speaker_utts, counts, labels = toy_index()
    table = jnp.asarray(np.eye(6, dtype=np.float32)[labels])
    D = table.shape[1]
    # Positive head weight ⇒ smaller distance ⇒ smaller score ⇒ argmin correct.
    w = jnp.ones((D, 1), jnp.float32)
    b = jnp.zeros((), jnp.float32)
    if metric == "dot_product":
        # dot similarity: larger = more similar; head weight w>0 makes the
        # score *larger* for same speaker, so argmin would be wrong — the
        # trained head learns w<0 for dot_product. Emulate that.
        w = -w
    acc = nshot.siamese_nshot_accuracy(
        table, w, b, speaker_utts, counts, jax.random.PRNGKey(0), 100, 1, 4,
        metric=metric,
    )
    assert float(acc) == 1.0, metric


def test_evaluate_wrapper_guards(corpus_root):
    from voicemap.config import DataConfig, EncoderConfig, ExperimentConfig
    from voicemap.data.dataset import SpeakerDataset
    from voicemap.models.classifier import SpeakerClassifier
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = ExperimentConfig(
        mode="classifier",
        data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                        seconds=1.0, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16,
                              compute_dtype="float32"),
    )
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)
    with pytest.raises(ValueError):
        nshot.evaluate(model, state, store, cfg, jax.random.PRNGKey(0),
                       num_tasks=10, n=1, k=999)
    with pytest.raises(ValueError):
        nshot.evaluate(model, state, store, cfg, jax.random.PRNGKey(0),
                       num_tasks=10, n=99, k=2)
    acc = nshot.evaluate(model, state, store, cfg, jax.random.PRNGKey(0),
                         num_tasks=50, n=1, k=2, embed_batch=16)
    assert 0.0 <= acc <= 1.0


def test_contrastive_siamese_evaluates_by_embedding(corpus_root):
    """Contrastive-trained siamese: the Dense(1) head receives no gradients,
    so evaluate() must score by embedding distance, not head logits."""
    from voicemap.config import (
        DataConfig, EncoderConfig, ExperimentConfig, SiameseConfig, TrainConfig,
    )
    from voicemap.data.dataset import SpeakerDataset
    from voicemap.models.siamese import SiameseNet
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = ExperimentConfig(
        mode="siamese",
        data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                        seconds=1.0, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16, dropout=0.0,
                              compute_dtype="float32"),
        siamese=SiameseConfig(distance_metric="uniform_euclidean"),
        train=TrainConfig(batch_size=16, learning_rate=3e-3,
                          loss="contrastive"),
    )
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root, seed=0)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SiameseNet(cfg.encoder, cfg.siamese)
    state = init_model_state(model, cfg)
    # Sabotage the head with a NEGATIVE weight: head-based scoring would
    # invert rankings; embedding-based scoring must be unaffected.
    state = state.replace(params={
        **state.params,
        "head": {
            "kernel": jnp.full_like(state.params["head"]["kernel"], -5.0),
            "bias": state.params["head"]["bias"],
        },
    })
    step, _ = steps_mod.make_siamese_train_step(model, cfg)
    for _ in range(40):
        state, m = step(state, store, jax.random.PRNGKey(0))
    acc = nshot.evaluate(model, state, store, cfg, jax.random.PRNGKey(1),
                         num_tasks=200, n=1, k=2, embed_batch=16)
    assert acc > 0.55, f"contrastive eval below chance: {acc}"


def test_evaluate_fast_path_matches(corpus_root):
    """fast=True (fused inference forward) ≈ standard eval on CPU (exact:
    the CPU fallback is the same XLA math)."""
    from voicemap.config import DataConfig, EncoderConfig, ExperimentConfig
    from voicemap.data.dataset import SpeakerDataset
    from voicemap.models.classifier import SpeakerClassifier
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = ExperimentConfig(
        mode="classifier",
        data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                        seconds=1.0, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16,
                              compute_dtype="float32"),
    )
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)
    key = jax.random.PRNGKey(3)
    a1 = nshot.evaluate(model, state, store, cfg, key, num_tasks=100, n=1, k=3,
                        embed_batch=16)
    a2 = nshot.evaluate(model, state, store, cfg, key, num_tasks=100, n=1, k=3,
                        embed_batch=16, fast=True)
    assert abs(a1 - a2) < 1e-6

def test_siamese_nshot_same_label_one_flips_selection():
    """same_label=1 ⇒ higher logit means same speaker ⇒ argmax selection.

    Negating (w, b) negates every score, so argmax under same_label=1 must
    pick exactly what argmin picks under same_label=0 — accuracies equal.
    """
    speaker_utts, counts, labels = toy_index(n_speakers=8, utts=5)
    rng = np.random.default_rng(3)
    table = jnp.asarray(rng.standard_normal((40, 16)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((16, 1)), jnp.float32)
    b = jnp.asarray(0.3, jnp.float32)
    key = jax.random.PRNGKey(5)
    a0 = nshot.siamese_nshot_accuracy(
        table, w, b, speaker_utts, counts, key, 200, 1, 4,
        metric="weighted_l1", same_label=0,
    )
    a1 = nshot.siamese_nshot_accuracy(
        table, -w, -b, speaker_utts, counts, key, 200, 1, 4,
        metric="weighted_l1", same_label=1,
    )
    assert float(a0) == float(a1)
    # And with the same (w, b), flipping the convention changes the picks.
    a_flip = nshot.siamese_nshot_accuracy(
        table, w, b, speaker_utts, counts, key, 200, 1, 4,
        metric="weighted_l1", same_label=1,
    )
    assert float(a_flip) != float(a0)


def test_evaluate_sweep_one_table_many_points(corpus_root, tmp_path):
    """k-sweep (reference README accuracy-vs-k figure): one embedding table,
    one point per (n, k); unsupported settings are skipped, not raised;
    points are deterministic and match a standalone evaluate() at the same
    folded key; plot_sweep writes a PNG."""
    from voicemap.config import DataConfig, EncoderConfig, ExperimentConfig
    from voicemap.data.dataset import SpeakerDataset
    from voicemap.models.classifier import SpeakerClassifier
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = ExperimentConfig(
        mode="classifier",
        data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                        seconds=1.0, downsampling=4),
        encoder=EncoderConfig(filters=8, embedding_dim=16,
                              compute_dtype="float32"),
    )
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)
    key = jax.random.PRNGKey(11)
    # 8 speakers x 6 utts: k=9,10 must skip; n=5 needs 6 utts -> supported.
    res = nshot.evaluate_sweep(
        model, state, store, cfg, key, n_shots=[1, 5],
        k_values=range(2, 11), num_tasks=50, embed_batch=16,
    )
    assert len(res) == 2 * 9
    for r in res:
        if r["k_way"] > 8:
            assert "skipped" in r and "accuracy" not in r
        else:
            assert 0.0 <= r["accuracy"] <= 1.0
            assert r["chance"] == pytest.approx(1.0 / r["k_way"])
    # Determinism + parity with the single-point path at the folded key.
    res2 = nshot.evaluate_sweep(
        model, state, store, cfg, key, n_shots=[1, 5],
        k_values=range(2, 11), num_tasks=50, embed_batch=16,
    )
    assert [r.get("accuracy") for r in res] == [r.get("accuracy") for r in res2]
    one = nshot.evaluate(
        model, state, store, cfg, jax.random.fold_in(key, 1 * 1009 + 4),
        num_tasks=50, n=1, k=4, embed_batch=16,
    )
    point = next(r for r in res if r["n_shot"] == 1 and r["k_way"] == 4)
    assert point["accuracy"] == pytest.approx(one)

    # The CLI's plot helper produces the artifact.
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "evaluate_cli", os.path.join(repo, "experiments", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    png = tmp_path / "sweep.png"
    mod.plot_sweep(res, str(png), ["dev-clean"])
    assert png.stat().st_size > 5000
