"""voicemap — speaker-embedding framework in JAX.

A from-scratch JAX rebuild of the capabilities of
``oscarknagg/voicemap`` (design blueprint: SURVEY.md). Public surface:

- :mod:`voicemap.config` — dataclass configs + BASELINE.json presets
- :mod:`voicemap.data` — index/dataset/synthetic corpus/audio decode
- :mod:`voicemap.ops` — on-device preprocess, sampling, distance kernels
- :mod:`voicemap.models` — conv1d encoder, classifier, siamese nets
- :mod:`voicemap.train` — fused train steps, losses, checkpoints
- :mod:`voicemap.eval` — batched n-shot k-way evaluation
- :mod:`voicemap.parallel` — mesh/sharding layer (DP, sharded eval, halo conv)
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
