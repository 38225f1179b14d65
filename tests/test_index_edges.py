"""Index-builder edge cases and CLI argparse smoke tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

from voicemap.data import audio, index as index_mod


def test_unknown_speaker_gets_question_mark(tmp_path):
    """Files whose speaker id is missing from SPEAKERS.TXT still index."""
    root = str(tmp_path)
    d = os.path.join(root, "LibriSpeech", "dev-clean", "999", "1")
    os.makedirs(d)
    audio.write_wav(os.path.join(d, "999-1-0000.wav"),
                    np.zeros(16000, np.int16), 16000)
    with open(os.path.join(root, "LibriSpeech", "SPEAKERS.TXT"), "w") as f:
        f.write("; header\n19   | M | dev-clean | 1.0 | X\n")
    df = index_mod.index_subset(root, "dev-clean")
    assert len(df) == 1
    assert df.sex[0] == "?"


def test_non_audio_files_skipped(tmp_path):
    root = str(tmp_path)
    d = os.path.join(root, "LibriSpeech", "dev-clean", "19", "1")
    os.makedirs(d)
    audio.write_wav(os.path.join(d, "19-1-0000.wav"),
                    np.zeros(8000, np.int16), 16000)
    open(os.path.join(d, "19-1.trans.txt"), "w").write("transcript\n")
    with open(os.path.join(root, "LibriSpeech", "SPEAKERS.TXT"), "w") as f:
        f.write("19 | M | dev-clean | 1.0 | X\n")
    df = index_mod.index_subset(root, "dev-clean")
    assert len(df) == 1  # the .txt was skipped


def test_missing_subset_raises(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "LibriSpeech"))
    with open(os.path.join(root, "LibriSpeech", "SPEAKERS.TXT"), "w") as f:
        f.write("19 | M | x | 1.0 | X\n")
    with pytest.raises(FileNotFoundError):
        index_mod.index_subset(root, "dev-clean")


@pytest.mark.parametrize("script", [
    "experiments/train_classifier.py",
    "experiments/train_siamese.py",
    "experiments/evaluate.py",
    "experiments/visualize_embeddings.py",
])
def test_cli_help(script):
    """argparse wiring stays importable and self-documenting."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, script), "--help"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert "--data-root" in r.stdout
