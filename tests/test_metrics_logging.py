"""JSONL metrics writer + plateau LR scheduler unit tests."""

import json

import numpy as np

from voicemap.train.metrics import JSONLWriter, PlateauScheduler


def test_jsonl_writer(tmp_path):
    p = str(tmp_path / "m.jsonl")
    w = JSONLWriter(p)
    w.write(1, loss=0.5, accuracy=np.float32(0.25), note="x")
    w.write(2, loss=0.4)
    w.close()
    lines = [json.loads(l) for l in open(p)]
    assert lines[0]["step"] == 1
    assert lines[0]["loss"] == 0.5
    assert abs(lines[0]["accuracy"] - 0.25) < 1e-9
    assert lines[0]["note"] == "x"
    assert "wall_s" in lines[1]


def test_jsonl_writer_no_path():
    w = JSONLWriter(None)
    rec = w.write(3, loss=1.0)
    assert rec["step"] == 3
    w.close()


def test_plateau_reduces_after_patience():
    """Keras semantics: reduce once `patience` bad evals accumulate."""
    s = PlateauScheduler(1.0, factor=0.5, patience=2, min_lr=0.01)
    assert s.update(0.5) == 1.0  # first value establishes the best
    assert s.update(0.4) == 1.0  # bad 1
    assert s.update(0.4) == 0.5  # bad 2 → reduce
    assert s.update(0.6) == 0.5  # improvement resets
    assert s.update(0.5) == 0.5
    assert s.update(0.5) == 0.25


def test_plateau_min_lr_floor():
    s = PlateauScheduler(0.1, factor=0.1, patience=1, min_lr=0.05)
    s.update(1.0)
    assert s.update(0.9) == 0.05  # clamped, not 0.01
    assert s.update(0.8) == 0.05


def test_plateau_min_mode():
    s = PlateauScheduler(1.0, factor=0.5, patience=1, min_lr=0.0, mode="min")
    s.update(1.0)
    assert s.update(0.5) == 1.0  # lower is better in min mode
    assert s.update(0.7) == 0.5  # worse → reduce
