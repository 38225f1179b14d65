"""Checkpointing: params + opt_state + step + lr, with auto-resume and a
best-by-n-shot-accuracy export policy.

Each checkpoint is one ``.npz`` file whose keys are the key paths of the
flattened state pytree (``jax.tree_util.keystr``), written under a
temporary name and renamed into place, so a crash never leaves a torn file
behind. Layout under ``directory``::

    latest/<step>.npz     the last ``max_to_keep`` saves
    best/<step>.npz       the best save by metric (one kept)
    best_metric.json      {"metric", "step"} of that best save

Restoring needs a template state of the same structure (shapes and dtypes
are checked leaf by leaf).

Sampler state needs no explicit checkpointing: batch sampling is a pure
function of (seed, step) — every train step folds ``state.step`` into the
PRNG key — so restoring ``step`` exactly resumes the data stream
(SURVEY.md §5 "checkpoint/resume": the reference could not resume at all).

Rebuild of the reference's ``ModelCheckpoint(monitor='val_1-shot_acc',
mode='max', save_best_only)`` → ``models/*.hdf5`` (SURVEY.md §5
"Checkpoint / resume") — extended with full optimizer-state resume, which the
reference lacked.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import jax
import numpy as np

from .state import TrainState

_HEAD_KERNEL = ".params['head']['kernel']"


def flatten_state(tree: Any) -> Dict[str, np.ndarray]:
    """Pytree → {key path: host array}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(jax.device_get(leaf))
            for path, leaf in leaves}


def unflatten_state(arrays, template: Any) -> Any:
    """{key path: array} → a pytree shaped like ``template``."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in leaves:
        key = jax.tree_util.keystr(path)
        if key not in arrays:
            raise KeyError(f"checkpoint has no entry {key}")
        arr = np.asarray(arrays[key])
        want = np.shape(leaf)
        if arr.shape != tuple(want):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"template shape {tuple(want)}")
        out.append(jax.numpy.asarray(arr, dtype=jax.numpy.result_type(leaf)))
    return jax.tree_util.tree_unflatten(treedef, out)


def _write_atomic(path: str, arrays: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class _StepDir:
    """One directory of ``<step>.npz`` files, pruned to ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            stem, ext = os.path.splitext(name)
            if ext == ".npz" and stem.isdigit():
                out.append(int(stem))
        return sorted(out)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.npz")

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        _write_atomic(self.path(step), flatten_state(state))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, template: Any) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        with np.load(self.path(step)) as z:
            return unflatten_state(z, template)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self._latest = _StepDir(os.path.join(self.directory, "latest"), max_to_keep)
        self._best = _StepDir(os.path.join(self.directory, "best"), 1)
        # Best metric persists on disk so a resumed run cannot overwrite the
        # historical best checkpoint with a worse post-restart evaluation.
        self._best_metric_path = os.path.join(self.directory, "best_metric.json")
        self.best_metric: Optional[float] = None
        if os.path.exists(self._best_metric_path):
            try:
                with open(self._best_metric_path) as f:
                    self.best_metric = float(json.load(f)["metric"])
            except (ValueError, KeyError, json.JSONDecodeError):
                self.best_metric = None

    def _dir(self, which: str) -> _StepDir:
        return self._best if which == "best" else self._latest

    def save(self, state: TrainState) -> None:
        self._latest.save(int(state.step), state)

    def save_best(self, state: TrainState, metric: float) -> bool:
        """Keep only the best-by-metric state (mode='max'). Returns True if saved."""
        if self.best_metric is None or metric > self.best_metric:
            self.best_metric = metric
            self._best.save(int(state.step), state)
            tmp = self._best_metric_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"metric": float(metric), "step": int(state.step)}, f)
            os.replace(tmp, self._best_metric_path)
            return True
        return False

    def restore_latest(self, template: TrainState) -> Optional[TrainState]:
        return self._latest.restore(template)

    def restore_best(self, template: TrainState) -> Optional[TrainState]:
        return self._best.restore(template)

    def head_num_classes(self, which: str = "best") -> Optional[int]:
        """Width of the stored classifier head, or None when it doesn't
        constrain the class count (siamese Dense(1) heads, no checkpoint).
        Lets eval/embed CLIs size their restore template to the checkpoint
        instead of guessing from the corpus being evaluated."""
        d = self._dir(which)
        step = d.latest_step()
        if step is None:
            return None
        with np.load(d.path(step)) as z:
            if _HEAD_KERNEL not in z.files:
                return None
            shape = z[_HEAD_KERNEL].shape
        if len(shape) != 2 or int(shape[-1]) <= 1:
            # Siamese verification heads are Dense(1) — width 1 says nothing
            # about a class count.
            return None
        return int(shape[-1])

    def template_num_classes(self, which: str, corpus_classes: int) -> int:
        """The class count a restore template must use: the checkpoint's
        stored head width when it differs from the corpus's (restore is
        shape-strict; the corpus being evaluated or embedded has no bearing
        on the trained head)."""
        ckpt_classes = self.head_num_classes(which)
        if ckpt_classes is not None and ckpt_classes != corpus_classes:
            print(f"sizing head to checkpoint: {ckpt_classes} classes "
                  f"(corpus has {corpus_classes})")
            return ckpt_classes
        return corpus_classes
