"""Encoder block-0 GPU kernel (ops/block0_kernel.py) and the choice of it.

On the CPU the kernel runs through Pallas' interpreter (``interpret=True``)
and is compared with the numpy reference block and with the plain XLA block
(``fast_infer._xla_block``). The ``gpu``-marked tests compile it for the
card and run at the serving width.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.config import EncoderConfig
from voicemap.models.encoder import ConvEncoder
from voicemap.models.fast_infer import (
    _xla_block,
    block0_forward,
    fast_embed,
    use_block0_kernel,
)
from voicemap.ops.block0_kernel import (
    block0_kernel,
    kernel_supported,
    reference_block0,
    stack_weights,
)


def _block_params(k, c, seed=0, negative_scales=True):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((k, 1, c)) * 0.3).astype(np.float32)
    b = (r.standard_normal(c) * 0.1).astype(np.float32)
    scale = r.uniform(0.5, 1.5, c).astype(np.float32)
    if negative_scales:
        scale[::3] *= -1.0  # the pool max must follow the BN affine's sign
    bias = r.standard_normal(c).astype(np.float32)
    mean = r.uniform(0.0, 0.5, c).astype(np.float32)
    var = r.uniform(0.5, 2.0, c).astype(np.float32)
    return w, b, scale, bias, mean, var


def _x(B, T, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, 1)).astype(np.float32)


# (k, pool, T, C, B, tq): T not a multiple of the tile or of the pool, B = 1
# and odd B, channel counts below and above the 16-wide tensor-core tile.
SHAPES = [
    (32, 4, 1280, 16, 2, 64),
    (32, 4, 1000, 16, 3, 64),
    (32, 4, 1030, 8, 1, 64),
    (32, 4, 512, 128, 2, 32),
    (16, 2, 777, 24, 5, 64),
    (3, 2, 250, 16, 2, 32),
    (8, 4, 300, 32, 1, 16),
    (31, 4, 513, 16, 2, 128),
]


@pytest.mark.parametrize("k,pool,T,C,B,tq", SHAPES)
def test_kernel_matches_reference_f32(k, pool, T, C, B, tq):
    params = _block_params(k, C)
    x = _x(B, T)
    got = block0_kernel(x, *params, pool=pool, eps=1e-3, out_dtype=jnp.float32,
                        gemm_dtype=jnp.float32, tq=tq, interpret=True)
    ref = reference_block0(x, *params, pool=pool, eps=1e-3)
    assert got.shape == (B, T // pool, C)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [1200, 1206])
def test_kernel_bf16_matches_xla_block(T):
    """bf16 operands, f32 accumulation: within 2e-2·max|ref| of the plain
    bf16 XLA block (k = 32 products per output)."""
    k, pool, C = 32, 4, 32
    w, b, scale, bias, mean, var = _block_params(k, C, seed=3)
    x = _x(2, T, seed=4)
    blk = {"conv": {"kernel": w, "bias": b}, "bn": {"scale": scale, "bias": bias}}
    bst = {"mean": mean, "var": var}
    ref = np.asarray(_xla_block(x, blk, bst, pool, 1, 1e-3, jnp.bfloat16)
                     .astype(jnp.float32))
    got = block0_kernel(x, w, b, scale, bias, mean, var, pool=pool, eps=1e-3,
                        interpret=True)
    assert got.dtype == jnp.bfloat16
    err = np.abs(np.asarray(got.astype(jnp.float32)) - ref).max()
    assert err <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("per_channel", [False, True])
def test_kernel_requant_epilogue(per_channel):
    """requant_scale → int8 clip(round(y / s)) of the f32 block, within one
    code (the f32 round of a value on a .5 boundary may go either way)."""
    k, pool, C = 32, 4, 16
    params = _block_params(k, C, seed=5)
    x = _x(2, 800, seed=6)
    ref = reference_block0(x, *params, pool=pool, eps=1e-3)
    s = (np.abs(ref).max(axis=(0, 1)) / 127.0 if per_channel
         else np.float32(np.abs(ref).max() / 127.0))
    got = block0_kernel(x, *params, jnp.asarray(s, jnp.float32), pool=pool,
                        eps=1e-3, gemm_dtype=jnp.float32, interpret=True)
    assert got.dtype == jnp.int8
    expect = np.clip(np.round(ref / s), -127, 127)
    assert np.abs(np.asarray(got, np.int32) - expect).max() <= 1


def test_stack_weights_layout():
    w = np.arange(3 * 1 * 2, dtype=np.float32).reshape(3, 1, 2)
    st = np.asarray(stack_weights(jnp.asarray(w), 2, 16, 16))
    assert st.shape == (2, 16, 16)
    for j in range(2):
        np.testing.assert_array_equal(st[j, j:j + 3, :2], w[:, 0, :])
        assert st[j].sum() == w.sum()  # zeros everywhere else


@pytest.mark.parametrize("k,pool,dil,cin,ok", [
    (32, 4, 1, 1, True), (3, 2, 1, 1, True), (61, 4, 1, 1, True),
    (62, 4, 1, 1, False), (32, 4, 2, 1, False), (3, 2, 1, 8, False),
])
def test_kernel_supported(k, pool, dil, cin, ok):
    assert kernel_supported(k, pool, dil, cin) is ok


def test_kernel_rejects_multichannel_input():
    with pytest.raises(ValueError, match="Cin=1"):
        block0_kernel(np.zeros((1, 64, 2), np.float32),
                      *_block_params(3, 16), pool=2, eps=1e-3, interpret=True)


def test_choice_auto_is_plain_xla_off_gpu():
    cfg = EncoderConfig()
    x = jnp.zeros((1, 400, 1))
    assert jax.default_backend() == "cpu"
    assert use_block0_kernel(cfg, x) is False


def test_choice_auto_on_gpu_follows_shape(monkeypatch):
    from voicemap import backend

    monkeypatch.setattr(backend, "gpu_kernels", lambda: True)
    x = jnp.zeros((1, 400, 1))
    assert use_block0_kernel(EncoderConfig(), x) is True
    dilated = EncoderConfig(dilations=(2, 1, 1, 1))
    assert use_block0_kernel(dilated, x) is False
    assert use_block0_kernel(EncoderConfig(kernel_sizes=(62, 3, 3, 3)), x) is False


def test_choice_rejects_bad_requests(monkeypatch):
    """Shapes the kernel does not take run the plain block, even on a GPU."""
    from voicemap import backend
    from voicemap.ops import block0_kernel as b0

    def refuse(*a, **kw):
        raise AssertionError("kernel called for a shape it does not support")

    monkeypatch.setattr(backend, "gpu_kernels", lambda: True)
    monkeypatch.setattr(b0, "block0_kernel", refuse)
    cfg = EncoderConfig(filters=8, dilations=(2, 1, 1, 1), compute_dtype="float32")
    w, b, scale, bias, mean, var = _block_params(32, 8)
    params = {"block_0": {"conv": {"kernel": w, "bias": b},
                          "bn": {"scale": scale, "bias": bias}}}
    stats = {"block_0": {"bn": {"mean": mean, "var": var}}}
    x = jnp.asarray(_x(2, 400))
    got = block0_forward(params, stats, cfg, x)
    ref = _xla_block(x, params["block_0"], stats["block_0"]["bn"], 4, 2,
                     cfg.bn_epsilon, jnp.float32)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.fixture
def interpreted_kernel(monkeypatch):
    """Make the serving path choose the kernel and run it in Pallas'
    interpreter, as it would compiled on a GPU."""
    from voicemap import backend
    from voicemap.ops import block0_kernel as b0

    monkeypatch.setattr(backend, "gpu_kernels", lambda: True)
    monkeypatch.setattr(b0, "block0_kernel",
                        functools.partial(block0_kernel, interpret=True))


def _small_encoder(compute_dtype="float32"):
    cfg = EncoderConfig(filters=16, embedding_dim=8, dropout=0.0,
                        compute_dtype=compute_dtype)
    v = ConvEncoder(cfg).init(jax.random.PRNGKey(0))
    r = np.random.default_rng(2)
    stats = {k: {"bn": {"mean": jnp.asarray(r.uniform(0, .5, b["bn"]["mean"].shape),
                                            jnp.float32),
                        "var": jnp.asarray(r.uniform(.5, 2, b["bn"]["var"].shape),
                                           jnp.float32)}}
             for k, b in v["batch_stats"].items()}
    return cfg, {"params": v["params"], "batch_stats": stats}


@pytest.mark.parametrize("B,T", [(2, 1024), (3, 1030)])
def test_fast_embed_with_kernel_matches_encoder(B, T, interpreted_kernel):
    cfg, v = _small_encoder()
    x = jnp.asarray(_x(B, T, seed=7))
    ref = np.asarray(ConvEncoder(cfg).apply(v, x))
    got = np.asarray(fast_embed(v, cfg, x))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_block0_forward_requant_paths_agree(request):
    """int8 block 0: the kernel's fused requantization and the plain block's
    separate one give the same codes (to one step at rounding boundaries)."""
    cfg, v = _small_encoder()
    x = jnp.asarray(_x(2, 800, seed=8))
    s0 = jnp.full((16,), 0.02, jnp.float32)
    b = block0_forward(v["params"], v["batch_stats"], cfg, x, requant_scale=s0)
    request.getfixturevalue("interpreted_kernel")
    a = block0_forward(v["params"], v["batch_stats"], cfg, x, requant_scale=s0)
    assert a.dtype == b.dtype == jnp.int8
    assert np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max() <= 1


# --------------------------------------------------------------------------
# Compiled for the card (skipped without a GPU)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("k,pool,T,C,B,tq", SHAPES)
def test_kernel_compiled_matches_reference(k, pool, T, C, B, tq):
    params = _block_params(k, C)
    x = _x(B, T)
    got = block0_kernel(x, *params, pool=pool, eps=1e-3, out_dtype=jnp.float32,
                        gemm_dtype=jnp.float32, tq=tq)
    ref = reference_block0(x, *params, pool=pool, eps=1e-3)
    # float32 operands go through the tensor cores as TF32 (10-bit mantissa).
    np.testing.assert_allclose(np.asarray(got), ref, rtol=5e-3,
                               atol=5e-3 * np.abs(ref).max())


@pytest.mark.gpu
def test_kernel_compiled_serving_width():
    """EncoderConfig() block 0 (C=128, k=32, pool 4) at T = 12,000."""
    cfg = EncoderConfig()
    v = ConvEncoder(cfg).init(jax.random.PRNGKey(0))
    x = jnp.asarray(_x(16, 12000, seed=9))
    blk, bst = v["params"]["block_0"], v["batch_stats"]["block_0"]["bn"]
    ref = np.asarray(_xla_block(x, blk, bst, 4, 1, cfg.bn_epsilon, jnp.bfloat16)
                     .astype(jnp.float32))
    assert use_block0_kernel(cfg, x)
    got = block0_forward(v["params"], v["batch_stats"], cfg, x)
    err = np.abs(np.asarray(got.astype(jnp.float32)) - ref).max()
    assert err <= 2e-2 * np.abs(ref).max()


@pytest.mark.gpu
def test_fast_embed_compiled_kernel_matches_xla(monkeypatch):
    from voicemap import backend

    cfg = dataclasses.replace(EncoderConfig(), dropout=0.0)
    v = ConvEncoder(cfg).init(jax.random.PRNGKey(1))
    x = jnp.asarray(_x(64, 12000, seed=10))
    a = np.asarray(fast_embed(v, cfg, x), np.float64)
    monkeypatch.setattr(backend, "gpu_kernels", lambda: False)  # plain block 0
    b = np.asarray(fast_embed(v, cfg, x), np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.999


@pytest.mark.gpu
def test_kernel_compiled_requant_matches_xla_codes(monkeypatch):
    """The kernel's in-register rounding gives the plain path's int8 codes
    (exactly, bar a rare .5 tie under different f32 rounding)."""
    from voicemap import backend

    cfg, v = _small_encoder()
    x = jnp.asarray(_x(8, 4000, seed=11))
    s0 = jnp.full((16,), 0.01, jnp.float32)
    a = np.asarray(block0_forward(v["params"], v["batch_stats"], cfg, x,
                                  requant_scale=s0), np.int32)
    monkeypatch.setattr(backend, "gpu_kernels", lambda: False)  # plain block 0
    b = np.asarray(block0_forward(v["params"], v["batch_stats"], cfg, x,
                                  requant_scale=s0), np.int32)
    assert np.abs(a - b).max() <= 1
    assert (a == b).mean() >= 0.99
