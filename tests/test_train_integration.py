"""Single-chip integration tests (SURVEY.md §4 item 4): short training runs
on the synthetic corpus through the fully fused on-device pipeline —
loss decreases and n-shot accuracy beats chance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.config import (
    DataConfig,
    EncoderConfig,
    ExperimentConfig,
    SiameseConfig,
    TrainConfig,
)
from voicemap.eval import nshot
from voicemap.models.classifier import SpeakerClassifier
from voicemap.models.siamese import SiameseNet
from voicemap.train import steps as steps_mod
from voicemap.train.state import init_state


def small_cfg(corpus_root, mode, **train_kw):
    return ExperimentConfig(
        mode=mode,
        data=DataConfig(
            data_root=corpus_root,
            subsets=("dev-clean",),
            seconds=1.0,
            downsampling=4,
        ),
        encoder=EncoderConfig(
            filters=8, embedding_dim=16, dropout=0.0, compute_dtype="float32"
        ),
        siamese=SiameseConfig(),
        train=TrainConfig(**{"batch_size": 16, "learning_rate": 3e-3,
                             **train_kw}),
    )


@pytest.fixture(scope="module")
def store_and_root(corpus_root):
    from voicemap.data.dataset import SpeakerDataset

    ds = SpeakerDataset(
        subsets=("dev-clean",), seconds=1.0, data_root=corpus_root, seed=0
    )
    return steps_mod.DeviceStore.from_host(ds.to_store()), ds, corpus_root


def _init(model, cfg, example_inputs):
    variables = model.init(jax.random.PRNGKey(0))
    from voicemap.train.state import make_optimizer

    tx = make_optimizer(cfg.train.clipnorm)
    return init_state(
        variables["params"],
        variables["batch_stats"],
        tx,
        cfg.train.learning_rate,
    )


def test_classifier_overfits(store_and_root):
    store, ds, root = store_and_root
    cfg = small_cfg(root, "classifier")
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    T = cfg.data.model_length
    state = _init(model, cfg, (jnp.zeros((1, T, 1)),))
    step, _ = steps_mod.make_classifier_train_step(model, cfg)
    key = jax.random.PRNGKey(42)
    first_losses, last_losses = [], []
    for i in range(60):
        state, metrics = step(state, store, key)
        if i < 5:
            first_losses.append(float(metrics["loss"]))
        if i >= 55:
            last_losses.append(float(metrics["loss"]))
    assert np.mean(last_losses) < np.mean(first_losses) * 0.7, (
        f"loss did not decrease: {np.mean(first_losses)} → {np.mean(last_losses)}"
    )
    # n-shot eval beats chance (1-shot 2-way chance = 0.5).
    acc = nshot.evaluate(
        model, state, store, cfg, jax.random.PRNGKey(7),
        num_tasks=200, n=1, k=2, embed_batch=16,
    )
    assert acc > 0.6, f"1-shot 2-way accuracy {acc} not above chance"


def test_siamese_trains_bce(store_and_root):
    store, ds, root = store_and_root
    cfg = small_cfg(root, "siamese")
    model = SiameseNet(cfg.encoder, cfg.siamese)
    T = cfg.data.model_length
    x = jnp.zeros((1, T, 1))
    state = _init(model, cfg, (x, x))
    step, _ = steps_mod.make_siamese_train_step(model, cfg)
    key = jax.random.PRNGKey(0)
    losses = []
    for i in range(60):
        state, metrics = step(state, store, key)
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "siamese BCE loss flat"
    acc = nshot.evaluate(
        model, state, store, cfg, jax.random.PRNGKey(8),
        num_tasks=200, n=1, k=2, embed_batch=16,
    )
    assert acc > 0.55, f"siamese 1-shot 2-way accuracy {acc}"


def test_siamese_trains_contrastive(store_and_root):
    store, ds, root = store_and_root
    cfg = small_cfg(root, "siamese", loss="contrastive")
    model = SiameseNet(cfg.encoder, cfg.siamese)
    T = cfg.data.model_length
    x = jnp.zeros((1, T, 1))
    state = _init(model, cfg, (x, x))
    step, _ = steps_mod.make_siamese_train_step(model, cfg)
    key = jax.random.PRNGKey(0)
    losses = []
    for i in range(40):
        state, metrics = step(state, store, key)
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "contrastive loss flat"


def test_train_step_determinism(store_and_root):
    """Same seed ⇒ identical metrics (SURVEY.md §5 race-detection rebuild:
    double-execution determinism check)."""
    store, ds, root = store_and_root
    cfg = small_cfg(root, "classifier")
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    T = cfg.data.model_length

    def run():
        state = _init(model, cfg, (jnp.zeros((1, T, 1)),))
        step, _ = steps_mod.make_classifier_train_step(model, cfg)
        key = jax.random.PRNGKey(123)
        out = []
        for _ in range(5):
            state, m = step(state, store, key)
            out.append(float(m["loss"]))
        return out

    np.testing.assert_array_equal(run(), run())


def test_embed_table_deterministic(store_and_root):
    store, ds, root = store_and_root
    cfg = small_cfg(root, "classifier")
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    T = cfg.data.model_length
    state = _init(model, cfg, (jnp.zeros((1, T, 1)),))
    t1 = nshot.embed_all(model, state, store, cfg, batch_size=16)
    t2 = nshot.embed_all(model, state, store, cfg, batch_size=32)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-5, atol=1e-5)


def test_checkpoint_roundtrip(store_and_root, tmp_path):
    """Checkpoint save → restore returns identical state (params, opt, step, lr)."""
    store, ds, root = store_and_root
    cfg = small_cfg(root, "classifier")
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    T = cfg.data.model_length
    state = _init(model, cfg, (jnp.zeros((1, T, 1)),))
    step, _ = steps_mod.make_classifier_train_step(model, cfg)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        state, _m = step(state, store, key)

    from voicemap.train.checkpoints import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    assert mgr.save_best(state, 0.75)
    assert not mgr.save_best(state, 0.60)  # worse metric must not overwrite

    template = _init(model, cfg, (jnp.zeros((1, T, 1)),))
    restored = mgr.restore_latest(template)
    assert restored is not None
    assert int(restored.step) == 3
    for a, b in zip(jax.tree.leaves(state.params), jax.tree.leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(state.opt_state), jax.tree.leaves(restored.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    best = mgr.restore_best(template)
    assert int(best.step) == 3


def test_best_metric_persists_across_restart(store_and_root, tmp_path):
    """A resumed run must not overwrite the historical best with a worse
    post-restart evaluation (code-review finding)."""
    store, ds, root = store_and_root
    cfg = small_cfg(root, "classifier")
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    T = cfg.data.model_length
    state = _init(model, cfg, (jnp.zeros((1, T, 1)),))

    from voicemap.train.checkpoints import CheckpointManager

    d = str(tmp_path / "ck2")
    mgr = CheckpointManager(d)
    assert mgr.save_best(state, 0.9)
    # Simulate restart: fresh manager over the same directory.
    mgr2 = CheckpointManager(d)
    assert mgr2.best_metric == 0.9
    assert not mgr2.save_best(state, 0.3)
    assert mgr2.save_best(state, 0.95)


def test_pad_mode_device_pipeline(corpus_root):
    """pad=True keeps short files; the device store zero-pads and the fused
    pipeline trains on them without NaNs."""
    cfg = ExperimentConfig(
        mode="classifier",
        data=DataConfig(
            data_root=corpus_root, subsets=("dev-clean",),
            seconds=5.0,  # longer than most synthetic files → pad engages
            downsampling=4, pad=True,
        ),
        encoder=EncoderConfig(filters=8, embedding_dim=16, dropout=0.0,
                              compute_dtype="float32"),
        train=TrainConfig(batch_size=8, learning_rate=1e-3),
    )
    from voicemap.data.dataset import SpeakerDataset

    ds = SpeakerDataset(subsets=("dev-clean",), seconds=5.0, pad=True,
                        data_root=corpus_root, seed=0)
    assert len(ds) == 48  # nothing dropped
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    state = _init(model, cfg, (jnp.zeros((1, cfg.data.model_length, 1)),))
    step, _ = steps_mod.make_classifier_train_step(model, cfg)
    for _ in range(5):
        state, m = step(state, store, jax.random.PRNGKey(0))
    assert np.isfinite(float(m["loss"]))


def test_fit_warns_on_training_store_eval(store_and_root):
    """No val_subsets ⇒ fit must warn loudly (reference protocol is held-out)."""
    from voicemap.train.loop import fit

    _, _, root = store_and_root
    cfg = small_cfg(root, "classifier", num_steps=2, evaluate_every=2,
                    num_eval_tasks=10, k_way=2)
    with pytest.warns(UserWarning, match="TRAINING store"):
        fit(cfg, verbose=False)


def test_fit_refuses_training_store_eval_when_strict(store_and_root):
    from voicemap.train.loop import fit

    _, _, root = store_and_root
    cfg = small_cfg(root, "classifier", num_steps=2, evaluate_every=2,
                    num_eval_tasks=10, k_way=2, require_holdout_eval=True)
    with pytest.raises(ValueError, match="val_subsets"):
        fit(cfg, verbose=False)


def test_fit_holdout_eval_uses_val_subsets(tmp_path):
    """With val_subsets set, fit gates on the held-out store (no warning)."""
    import warnings

    from voicemap.data import synthetic
    from voicemap.train.loop import fit

    root = str(tmp_path / "corpus2")
    spec = synthetic.SyntheticSpec(
        n_speakers=6, utterances_per_speaker=4, min_seconds=1.2,
        max_seconds=2.0, seed=3,
    )
    synthetic.generate_corpus(root, subsets=("dev-clean", "test-clean"),
                              spec=spec)
    cfg = small_cfg(root, "classifier", num_steps=2, evaluate_every=2,
                    num_eval_tasks=10, k_way=2)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, val_subsets=("test-clean",)))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        _, history = fit(cfg, verbose=False)
    assert len(history) == 1
    assert "val_1-shot_acc" in history[0]


def test_checkpoint_head_metadata(store_and_root, tmp_path):
    """head_num_classes reads the stored classifier head width from the
    checkpoint file (no template) so eval/embed CLIs can size their restore
    template to the checkpoint instead of the corpus being embedded."""
    store, ds, root = store_and_root
    cfg = small_cfg(root, "classifier")
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    T = cfg.data.model_length
    state = _init(model, cfg, (jnp.zeros((1, T, 1)),))

    from voicemap.train.checkpoints import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ckmeta"))
    mgr.save(state)
    mgr.save_best(state, 0.5)
    assert mgr.head_num_classes("latest") == ds.num_speakers
    assert mgr.head_num_classes("best") == ds.num_speakers
    # Restore with a template sized from the metadata — the scenario where
    # the embedding corpus has a different class count than the checkpoint.
    sized = SpeakerClassifier(cfg.encoder,
                              num_classes=mgr.head_num_classes("best"))
    template = _init(sized, cfg, (jnp.zeros((1, T, 1)),))
    restored = mgr.restore_best(template)
    assert restored is not None
    # An empty directory yields None (callers fall back to corpus sizing).
    empty = CheckpointManager(str(tmp_path / "ckempty"))
    assert empty.head_num_classes("best") is None
    # template_num_classes applies the sizing policy in one place.
    assert mgr.template_num_classes("best", 999) == ds.num_speakers
    assert empty.template_num_classes("best", 7) == 7


def test_checkpoint_head_metadata_siamese(store_and_root, tmp_path):
    """A siamese Dense(1) verification head must NOT be mistaken for a
    1-class classifier head: head_num_classes returns None and
    template_num_classes keeps the corpus sizing."""
    from voicemap.models.siamese import SiameseNet
    from voicemap.train.checkpoints import CheckpointManager

    store, ds, root = store_and_root
    cfg = small_cfg(root, "siamese")
    model = SiameseNet(cfg.encoder, cfg.siamese)
    T = cfg.data.model_length
    x = jnp.zeros((1, T, 1))
    state = _init(model, cfg, (x, x))
    mgr = CheckpointManager(str(tmp_path / "cksia"))
    mgr.save(state)
    assert mgr.head_num_classes("latest") is None
    assert mgr.template_num_classes("latest", ds.num_speakers) == ds.num_speakers


def test_fit_dp_streaming(corpus_root):
    """dp='on' with the streaming pipeline trains data-parallel over the
    faked 8-device mesh: each host batch is sharded over the mesh at the
    jit boundary (the >HBM-corpus multi-chip combination)."""
    from voicemap.train.loop import fit

    cfg = small_cfg(corpus_root, "classifier", num_steps=4)
    state, history = fit(cfg, verbose=False, pipeline="streaming", dp="on")
    assert int(state.step) == 4
    assert np.isfinite(history[-1]["loss"])
    assert 0.0 <= history[-1]["val_1-shot_acc"] <= 1.0


@pytest.mark.skipif(
    jax.device_count() < 2,
    reason="batch 9 divides by 1 device — the rejection can only trip on a "
    "multi-device mesh",
)
def test_fit_dp_on_rejects_indivisible_batch(corpus_root):
    """An explicit dp='on' must fail loudly when the batch cannot shard."""
    from voicemap.train.loop import fit

    cfg = small_cfg(corpus_root, "classifier", num_steps=1, batch_size=9)
    with pytest.raises(ValueError, match="dp='on'"):
        fit(cfg, verbose=False, pipeline="streaming", dp="on")
