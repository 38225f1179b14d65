"""Golden-value regression tests: pin the preprocessing semantics against
hand-computed constants so accidental drift across build rounds is caught
(the reference could not be bit-compared — SURVEY.md provenance — so these
values ARE the spec once pinned)."""

import jax.numpy as jnp
import numpy as np

from voicemap.config import DEFAULT_WHITEN_RMS
from voicemap.ops import preprocess


def test_whiten_constant_value():
    assert DEFAULT_WHITEN_RMS == 0.038021  # voicemap/utils.py :: whiten default


def test_whiten_golden():
    # x = [1, 2, 3, 4] scaled: mean 2.5, centered [-1.5,-0.5,.5,1.5],
    # rms = sqrt(2.5/2)? -> sqrt((2.25+.25+.25+2.25)/4) = sqrt(1.25)
    x = jnp.asarray([[1.0, 2.0, 3.0, 4.0]])
    out = np.asarray(preprocess.whiten(x, rms=1.0, eps=0.0))
    expect = np.array([-1.5, -0.5, 0.5, 1.5]) / np.sqrt(1.25)
    np.testing.assert_allclose(out[0], expect, rtol=1e-6)


def test_int16_scale_convention():
    # soundfile convention: int16 / 2**15, so -32768 → -1.0 exactly.
    assert preprocess.INT16_SCALE == 1.0 / 32768.0


def test_preprocess_golden_pipeline():
    """Fixed int16 input through the full fused chain → pinned output."""
    raw = jnp.asarray(
        np.arange(-8, 8, dtype=np.int16)[None, :] * 1000
    )  # (1, 16)
    out = np.asarray(
        preprocess.preprocess_batch(
            raw, jnp.zeros((1,), jnp.int32), 16, 2, whiten_rms=1.0
        )
    )[0, :, 0]
    # decimated: raw[::2] = [-8,-6,-4,-2,0,2,4,6]*1000/32768; mean=-1000/32768
    vals = np.arange(-8, 8, 2) * 1000 / 32768.0
    centered = vals - vals.mean()
    expect = centered / np.sqrt((centered**2).mean())
    np.testing.assert_allclose(out, expect, rtol=1e-5)
