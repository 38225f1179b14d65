"""Reference-parity host preprocessing API tests (data/preprocessing.py),
including cross-checks against the on-device jnp implementations."""

import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.data.preprocessing import (
    BatchPreProcessor,
    label_preprocessor,
    preprocess_instances,
    whiten,
)
from voicemap.ops import preprocess as device_pre


def test_whiten_matches_device(rng):
    x = rng.standard_normal((4, 2000, 1)).astype(np.float32)
    host = whiten(x)
    dev = np.asarray(device_pre.whiten(jnp.asarray(x)))
    np.testing.assert_allclose(host, dev, rtol=1e-5, atol=1e-6)


def test_whiten_shape_assert():
    with pytest.raises(ValueError):
        whiten(np.zeros((10,)))


def test_preprocess_instances_matches_device(rng):
    x = rng.standard_normal((3, 4000, 1)).astype(np.float32)
    host = preprocess_instances(4, whitening=True)(x)
    dev = device_pre.whiten(device_pre.stride_decimate(jnp.asarray(x), 4))
    np.testing.assert_allclose(host, np.asarray(dev), rtol=1e-5, atol=1e-6)
    raw = preprocess_instances(2, whitening=False)(x)
    np.testing.assert_array_equal(raw, x[:, ::2])


def test_label_preprocessor():
    mapping = {19: 0, 42: 1, 77: 2}
    fn = label_preprocessor(3, mapping)
    out = fn(np.asarray([42, 19, 77, 42]))
    expect = np.asarray(
        [[0, 1, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=np.float32
    )
    np.testing.assert_array_equal(out, expect)


def test_batch_preprocessor_classifier(rng):
    x = rng.standard_normal((4, 800, 1)).astype(np.float32)
    y = np.asarray([19, 42, 42, 77])
    bp = BatchPreProcessor(
        "classifier",
        preprocess_instances(4),
        label_preprocessor(3, {19: 0, 42: 1, 77: 2}),
    )
    xi, yi = bp((x, y))
    assert xi.shape == (4, 200, 1)
    assert yi.shape == (4, 3)


def test_batch_preprocessor_siamese(rng):
    x1 = rng.standard_normal((4, 800, 1)).astype(np.float32)
    x2 = rng.standard_normal((4, 800, 1)).astype(np.float32)
    y = np.zeros(4, np.float32)
    bp = BatchPreProcessor("siamese", preprocess_instances(2))
    (o1, o2), yo = bp(([x1, x2], y))
    assert o1.shape == o2.shape == (4, 400, 1)
    np.testing.assert_array_equal(yo, y)
    with pytest.raises(ValueError):
        BatchPreProcessor("other", preprocess_instances(2))


def test_end_to_end_with_dataset_generator(dataset):
    """Reference-style usage: wrap the verification generator."""
    bp = BatchPreProcessor("siamese", preprocess_instances(4))
    gen = dataset.yield_verification_batches(8)
    (x1, x2), y = bp(next(gen))
    T = dataset.fragment_length // 4
    assert x1.shape == (8, T, 1)
    assert x2.shape == (8, T, 1)
    assert set(np.unique(y)) <= {0.0, 1.0}