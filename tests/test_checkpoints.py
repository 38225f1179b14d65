"""The .npz checkpoint manager (train/checkpoints.py): round trip, retention,
best-metric persistence, atomic writes, strict restores, resume via fit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.config import EncoderConfig
from voicemap.models.classifier import SpeakerClassifier
from voicemap.train.checkpoints import (
    CheckpointManager,
    flatten_state,
    unflatten_state,
)
from voicemap.train.state import init_state, make_optimizer


def _state(num_classes=5, seed=0, step=0):
    model = SpeakerClassifier(EncoderConfig(filters=4, embedding_dim=8,
                                            compute_dtype="float32"), num_classes)
    v = model.init(jax.random.PRNGKey(seed))
    st = init_state(v["params"], v["batch_stats"], make_optimizer(), 1e-3)
    return st.replace(step=jnp.asarray(step, jnp.int32))


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_flatten_roundtrip_keeps_dtypes():
    st = _state()
    flat = flatten_state(st)
    assert ".params['head']['kernel']" in flat
    back = unflatten_state(flat, _state(seed=1))
    assert _leaves_equal(back, st)
    assert back.step.dtype == jnp.int32 and back.lr.dtype == jnp.float32


def test_save_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state(step=7, seed=3)
    mgr.save(st)
    assert os.path.exists(tmp_path / "latest" / "7.npz")
    restored = mgr.restore_latest(_state())
    assert int(restored.step) == 7 and _leaves_equal(restored, st)


def test_max_to_keep_prunes_oldest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(_state(step=step))
    assert sorted(os.listdir(tmp_path / "latest")) == ["3.npz", "4.npz"]
    assert int(mgr.restore_latest(_state()).step) == 4


def test_best_metric_persists_and_gates(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save_best(_state(step=1), 0.5)
    assert not mgr.save_best(_state(step=2), 0.4)
    assert mgr.save_best(_state(step=3), 0.7)
    assert os.listdir(tmp_path / "best") == ["3.npz"]  # one kept
    with open(tmp_path / "best_metric.json") as f:
        assert json.load(f) == {"metric": 0.7, "step": 3}
    again = CheckpointManager(str(tmp_path))
    assert again.best_metric == 0.7
    assert not again.save_best(_state(step=4), 0.6)
    assert int(again.restore_best(_state()).step) == 3


def test_writes_leave_no_temporary_files(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(step=1))
    mgr.save_best(_state(step=1), 0.1)
    names = [n for _, _, files in os.walk(tmp_path) for n in files]
    assert not [n for n in names if n.endswith(".tmp")]


def test_empty_directory_restores_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(_state()) is None
    assert mgr.restore_best(_state()) is None
    assert mgr.head_num_classes("best") is None


def test_restore_is_shape_strict(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(num_classes=5, step=2))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore_latest(_state(num_classes=6))
    assert mgr.head_num_classes("latest") == 5
    assert mgr.template_num_classes("latest", 6) == 5


def test_restore_rejects_missing_entries(tmp_path):
    path = tmp_path / "x.npz"
    flat = flatten_state(_state())
    flat.pop(".params['head']['bias']")
    np.savez(path, **flat)
    with np.load(path) as z, pytest.raises(KeyError, match="head"):
        unflatten_state(z, _state())


def test_fit_resumes_from_checkpoint(corpus_root, tmp_path):
    from voicemap.config import DataConfig, ExperimentConfig, TrainConfig
    from voicemap.train.loop import fit

    def cfg(steps):
        return ExperimentConfig(
            mode="classifier",
            data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                            val_subsets=("dev-clean",), seconds=1.0),
            encoder=EncoderConfig(filters=4, embedding_dim=8, dropout=0.0,
                                  compute_dtype="float32"),
            train=TrainConfig(batch_size=8, num_steps=steps, evaluate_every=2,
                              num_eval_tasks=10, k_way=2,
                              checkpoint_dir=str(tmp_path / "ck")),
        )

    first, _ = fit(cfg(2), verbose=False)
    resumed, hist = fit(cfg(4), verbose=False)
    assert int(resumed.step) == 4
    assert [r["step"] for r in hist] == [4]  # steps 1-2 were not re-run
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert sorted(os.listdir(tmp_path / "ck" / "latest")) == ["2.npz", "4.npz"]
    assert _leaves_equal(mgr.restore_latest(first).params, resumed.params)
