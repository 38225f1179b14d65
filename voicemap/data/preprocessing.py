"""Host-side (numpy) preprocessing — the reference-parity API surface.

Direct functional equivalents of the reference's ``voicemap/utils.py``
preprocessing helpers (SURVEY.md §2.1), for users porting scripts from the
reference and for the CPU-baseline path. The production pipeline performs
the same math on the device (``ops/preprocess.py``); these are
property-tested against it.

- ``whiten(batch, rms)``            — reference: voicemap/utils.py :: whiten
- ``preprocess_instances(downsampling, whitening)`` — :: preprocess_instances
- ``BatchPreProcessor(mode, …)``    — :: BatchPreProcessor
- ``label_preprocessor(num_classes, mapping)`` — :: label_preprocessor
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import DEFAULT_WHITEN_RMS


def whiten(batch: np.ndarray, rms: float = DEFAULT_WHITEN_RMS,
           eps: float = 1e-8) -> np.ndarray:
    """Per-fragment zero-mean, fixed-RMS rescale.

    Reference: ``whiten(batch, rms=0.038021)`` — asserts 3-D (B, T, 1) input
    (we also accept (B, T)); reduction over the time axis.
    """
    if batch.ndim not in (2, 3):
        raise ValueError(f"whiten expects (B, T) or (B, T, 1), got {batch.shape}")
    x = batch.astype(np.float32)
    mean = x.mean(axis=1, keepdims=True)
    centered = x - mean
    cur = np.sqrt((centered**2).mean(axis=1, keepdims=True))
    return centered * (rms / (cur + eps))


def preprocess_instances(
    downsampling: int, whitening: bool = True, rms: float = DEFAULT_WHITEN_RMS
) -> Callable[[np.ndarray], np.ndarray]:
    """Closure: naive stride decimation then (optional) whitening.

    Reference: ``preprocess_instances`` — ``instances[:, ::downsampling, :]``
    with **no anti-alias filter**, then whiten.
    """

    def fn(instances: np.ndarray) -> np.ndarray:
        x = instances[:, ::downsampling]
        if whitening:
            x = whiten(x, rms)
        return x

    return fn


def label_preprocessor(
    num_classes: int, speaker_id_mapping: Dict[int, int]
) -> Callable[[np.ndarray], np.ndarray]:
    """Raw speaker ids → contiguous indices → one-hot (B, num_classes).

    Reference: ``label_preprocessor`` (classifier one-hot labels).
    """

    def fn(labels: np.ndarray) -> np.ndarray:
        idx = np.asarray([speaker_id_mapping[int(l)] for l in np.ravel(labels)])
        out = np.zeros((len(idx), num_classes), dtype=np.float32)
        out[np.arange(len(idx)), idx] = 1.0
        return out

    return fn


class BatchPreProcessor:
    """Apply instance/target preprocessing to raw generator batches.

    Reference: ``BatchPreProcessor(mode, instance_preprocessor,
    target_preprocessor)`` with mode ∈ {'siamese', 'classifier'}: siamese
    batches are ``([input_1, input_2], labels)``, classifier batches
    ``(instances, labels)``.
    """

    def __init__(
        self,
        mode: str,
        instance_preprocessor: Callable[[np.ndarray], np.ndarray],
        target_preprocessor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        if mode not in ("siamese", "classifier"):
            raise ValueError("mode must be 'siamese' or 'classifier'")
        self.mode = mode
        self.instance_preprocessor = instance_preprocessor
        self.target_preprocessor = target_preprocessor or (lambda y: y)

    def __call__(self, batch: Tuple) -> Tuple:
        inputs, targets = batch
        if self.mode == "siamese":
            x1, x2 = inputs
            inputs = [
                self.instance_preprocessor(x1),
                self.instance_preprocessor(x2),
            ]
        else:
            inputs = self.instance_preprocessor(inputs)
        return inputs, self.target_preprocessor(np.asarray(targets))
