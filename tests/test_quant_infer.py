"""int8 PTQ inference path (models/quant_infer.py) vs the bf16/f32 encoder.

The reference serves f32 Keras inference (``voicemap/models.py ::
get_baseline_convolutional_encoder``); the quantized path is a
serving addition, so parity here is statistical (embedding fidelity and
nearest-neighbor decision agreement), not bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.config import EncoderConfig
from voicemap.models.encoder import ConvEncoder
from voicemap.models.quant_infer import (
    _quant_block, calibrate_scales, int8_conv, quant_embed,
    quantize_encoder,
)

F32 = dict(compute_dtype="float32")


def _make(cfg, seed=0, batch=4, t=1024):
    model = ConvEncoder(cfg)
    x = jnp.asarray(
        np.random.default_rng(seed).standard_normal((batch, t, 1)), jnp.float32
    )
    variables = model.init(jax.random.PRNGKey(0))
    return model, variables, x


def _cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12
    return num / den


def test_quant_embed_close_to_f32():
    cfg = EncoderConfig(filters=16, embedding_dim=32, dropout=0.0, **F32)
    model, variables, x = _make(cfg)
    qvars = quantize_encoder(variables, cfg, x)
    ref = model.apply(variables, x, train=False)
    out = quant_embed(variables, qvars, cfg, x)
    cos = _cosine(out, ref)
    assert cos.min() > 0.995, cos
    rel = (np.linalg.norm(np.asarray(out) - np.asarray(ref), axis=-1)
           / (np.linalg.norm(np.asarray(ref), axis=-1) + 1e-12))
    assert rel.max() < 0.08, rel


def test_quant_embed_dilated_config():
    """Dilated blocks (pool=1 interleave) route rhs_dilation through the
    int8 conv and skip pooling correctly."""
    cfg = EncoderConfig(
        filters=8, embedding_dim=16, dropout=0.0,
        filter_multipliers=(1, 2, 2, 3), kernel_sizes=(32, 3, 3, 3),
        pool_sizes=(4, 1, 2, 1), dilations=(1, 2, 1, 4), **F32,
    )
    model, variables, x = _make(cfg, seed=1)
    qvars = quantize_encoder(variables, cfg, x)
    ref = model.apply(variables, x, train=False)
    out = quant_embed(variables, qvars, cfg, x)
    assert _cosine(out, ref).min() > 0.995


def test_quant_embed_bf16_block0():
    """With bf16 compute the unquantized pieces (block 0, Dense) run bf16;
    the quantization error bound only loosens slightly."""
    cfg = EncoderConfig(filters=16, embedding_dim=32, dropout=0.0,
                        compute_dtype="bfloat16")
    model, variables, x = _make(cfg, seed=2)
    qvars = quantize_encoder(variables, cfg, x)
    ref = model.apply(variables, x, train=False)
    out = quant_embed(variables, qvars, cfg, x)
    assert _cosine(out, ref).min() > 0.99


def test_quant_pool_commutes_with_requant():
    """max-pool on the int8 tensor == requantize(max-pool(f32)): positive
    per-channel scale + nondecreasing round/clamp preserve the argmax."""
    rng = np.random.default_rng(3)
    z = jnp.asarray(rng.standard_normal((2, 64, 8)) * 30, jnp.float32)
    s = jnp.asarray(rng.uniform(0.1, 2.0, (8,)), jnp.float32)

    def quant(v):
        return jnp.clip(jnp.round(v / s), -127, 127).astype(jnp.int8)

    pool = 4
    pooled_f = z.reshape(2, 16, pool, 8).max(axis=2)
    q_then_pool = quant(z).reshape(2, 16, pool, 8).max(axis=2)
    np.testing.assert_array_equal(
        np.asarray(q_then_pool), np.asarray(quant(pooled_f))
    )


def test_quantized_weights_reproduce_conv():
    """Dequantized int8 conv matches the f32 conv within per-channel-PTQ
    tolerance (the folded-scale formulation is what quant_embed runs)."""
    cfg = EncoderConfig(filters=16, embedding_dim=32, dropout=0.0, **F32)
    _, variables, x = _make(cfg, seed=4)
    scales = calibrate_scales(variables, cfg, x)
    qvars = quantize_encoder(variables, cfg, x)
    # Reconstruct block 1's float weight from the quantized one and compare.
    w = np.asarray(variables["params"]["block_1"]["conv"]["kernel"], np.float64)
    s_in = np.asarray(scales[0], np.float64)
    w_q = np.asarray(qvars["blocks"][0]["w_q"], np.float64)
    # alpha folds s_w·g/s_out; recover s_w from the max-abs construction.
    w_f = w * s_in[None, :, None]
    s_w = np.abs(w_f).max(axis=(0, 1)) / 127.0
    w_round = w_q * s_w[None, None, :] / s_in[None, :, None]
    err = np.abs(w_round - w) / (np.abs(w).max() + 1e-12)
    assert err.max() < 0.01  # one int8 step of the per-channel range


def test_nshot_decision_agreement():
    """Nearest-neighbor (1-shot) decisions agree between the quantized and
    f32 embeddings on a support/query split — the metric that matters for
    the n-shot eval protocol."""
    cfg = EncoderConfig(filters=16, embedding_dim=32, dropout=0.0, **F32)
    model, variables, _ = _make(cfg)
    rng = np.random.default_rng(5)
    # 24 utterances: 8 "speakers" × 3 utterances of correlated noise, so
    # embeddings carry structure even with a random-init encoder.
    base = rng.standard_normal((8, 1, 1024, 1))
    utts = base + 0.3 * rng.standard_normal((8, 3, 1024, 1))
    x = jnp.asarray(utts.reshape(24, 1024, 1), jnp.float32)
    qvars = quantize_encoder(variables, cfg, x)
    ref = np.asarray(model.apply(variables, x, train=False))
    out = np.asarray(quant_embed(variables, qvars, cfg, x))

    def nn_decisions(emb):
        emb = emb.reshape(8, 3, -1)
        q, s = emb[:, 0], emb[:, 1]  # query vs one support per speaker
        d = ((q[:, None] - s[None]) ** 2).sum(-1)
        return d.argmin(axis=1)

    agree = (nn_decisions(ref) == nn_decisions(out)).mean()
    assert agree >= 7 / 8, (nn_decisions(ref), nn_decisions(out))


def test_embed_all_int8_path(corpus_root):
    """The serving-table entry point (eval/nshot.embed_all) accepts qvars and
    produces embeddings close to the f32 table — the path the embed CLI's
    --int8 flag drives."""
    from voicemap.config import DataConfig, ExperimentConfig
    from voicemap.data.dataset import SpeakerDataset
    from voicemap.eval import nshot
    from voicemap.models.classifier import SpeakerClassifier
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state
    from voicemap.train.steps import fetch_batch

    cfg = ExperimentConfig(
        mode="classifier",
        data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                        seconds=1.0, downsampling=4, stochastic=False),
        encoder=EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, **F32),
    )
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)

    n_cal = min(16, int(store.labels.shape[0]))
    x_cal = fetch_batch(store, jnp.arange(n_cal, dtype=jnp.int32),
                        jax.random.PRNGKey(0), cfg, stochastic=False)
    enc_vars = {"params": state.params["encoder"],
                "batch_stats": state.batch_stats["encoder"]}
    qvars = quantize_encoder(enc_vars, cfg.encoder, x_cal)

    ref = nshot.embed_all(model, state, store, cfg, batch_size=16)
    out = nshot.embed_all(model, state, store, cfg, batch_size=16, qvars=qvars)
    assert out.shape == ref.shape
    assert _cosine(np.asarray(out), np.asarray(ref)).min() > 0.99

    melspec_cfg = dataclasses.replace(cfg, mode="melspec2d")
    # A wave artifact must not serve the melspec2d mode (kind mismatch).
    with pytest.raises(ValueError, match="artifact kind"):
        nshot.embed_all(model, state, store, melspec_cfg, qvars=qvars)


def test_nshot_evaluate_int8_close_to_f32(corpus_root):
    """nshot.evaluate(qvars=...) — the deployment accuracy-parity run — stays
    within a few task-flips of the f32 accuracy on the same pinned tasks."""
    from voicemap.config import DataConfig, ExperimentConfig, TrainConfig
    from voicemap.data.dataset import SpeakerDataset
    from voicemap.eval import nshot
    from voicemap.models.classifier import SpeakerClassifier
    from voicemap.models.quant_infer import quantize_from_store
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import init_model_state

    cfg = ExperimentConfig(
        mode="classifier",
        data=DataConfig(data_root=corpus_root, subsets=("dev-clean",),
                        seconds=1.0, downsampling=4, stochastic=False),
        encoder=EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, **F32),
        train=TrainConfig(num_eval_tasks=100, n_shot=1, k_way=2),
    )
    ds = SpeakerDataset(subsets=("dev-clean",), seconds=1.0,
                        data_root=corpus_root)
    store = steps_mod.device_store_for(cfg, ds.to_store())
    model = SpeakerClassifier(cfg.encoder, num_classes=ds.num_speakers)
    state = init_model_state(model, cfg)
    qvars = quantize_from_store(state, cfg, store, n_cal=16)

    key = jax.random.PRNGKey(3)
    acc_f32 = nshot.evaluate(model, state, store, cfg, key)
    acc_int8 = nshot.evaluate(model, state, store, cfg, key, qvars=qvars)
    # Same task seed → same tasks; cos>0.99 embeddings flip only near-ties.
    assert abs(acc_int8 - acc_f32) <= 0.10, (acc_f32, acc_int8)


def test_qvars_save_load_roundtrip(tmp_path):
    """The .npz serving artifact reproduces the in-memory quantization
    bit-exactly (int8 weights and f32 epilogue vectors identical, so the
    deployed embeddings are identical too)."""
    from voicemap.models.quant_infer import load_qvars, save_qvars

    cfg = EncoderConfig(filters=16, embedding_dim=32, dropout=0.0, **F32)
    _, variables, x = _make(cfg, seed=7)
    qvars = quantize_encoder(variables, cfg, x)
    path = str(tmp_path / "enc_int8.npz")
    save_qvars(path, qvars)
    loaded = load_qvars(path)
    assert loaded["blocks"][0]["w_q"].dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(loaded["s0"]),
                                  np.asarray(qvars["s0"]))
    for a, b in zip(loaded["blocks"], qvars["blocks"]):
        for k in ("w_q", "alpha", "beta", "gamma"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    out_mem = quant_embed(variables, qvars, cfg, x)
    out_load = quant_embed(variables, loaded, cfg, x)
    np.testing.assert_array_equal(np.asarray(out_mem), np.asarray(out_load))


def test_quantize_rejects_single_block():
    cfg = EncoderConfig(filters=8, embedding_dim=16, dropout=0.0,
                        filter_multipliers=(1,), kernel_sizes=(32,),
                        pool_sizes=(4,), dilations=(1,), **F32)
    _, variables, x = _make(cfg, seed=6, t=256)
    with pytest.raises(ValueError, match="at least 2"):
        quantize_encoder(variables, cfg, x)


def test_quant_embed_mel_close_to_f32():
    """config #4 int8 path (quant_embed_mel): all conv2d blocks in
    s8×s8→s32 with folded epilogues track the MelSpecEncoder embed
    within quantization error; artifacts round-trip with kind='mel'."""
    from voicemap.config import MelConfig
    from voicemap.models.quant_infer import (
        load_qvars, quant_embed_mel, quantize_mel_encoder, save_qvars,
    )
    from voicemap.models.spectrogram import MelSpecEncoder

    cfg = EncoderConfig(filters=16, embedding_dim=32, dropout=0.0, **F32)
    mel = MelConfig(hop_length=128, win_length=384)
    model = MelSpecEncoder(cfg, mel)
    x = jnp.asarray(
        np.random.default_rng(3).standard_normal((4, 8192, 1)) * 0.1,
        jnp.float32,
    )
    variables = model.init(jax.random.PRNGKey(0))
    qvars = quantize_mel_encoder(variables, cfg, mel, x)
    assert qvars["kind"] == "mel"
    assert len(qvars["blocks"]) == len(cfg.filter_multipliers)
    ref = model.apply(variables, x, train=False)
    out = quant_embed_mel(variables, qvars, cfg, mel, x)
    cos = _cosine(out, ref)
    assert cos.min() > 0.99, cos
    rel = (np.linalg.norm(np.asarray(out) - np.asarray(ref), axis=-1)
           / (np.linalg.norm(np.asarray(ref), axis=-1) + 1e-12))
    assert rel.max() < 0.12, rel

    # Artifact round trip preserves the mel kind and the embedding bits.
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "q.npz")
        save_qvars(path, qvars)
        q2 = load_qvars(path)
        assert q2.get("kind") == "mel"
        out2 = quant_embed_mel(variables, q2, cfg, mel, x)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(out2))


def test_quant_kind_mode_mismatch_raises():
    """embed_all refuses a wave artifact for melspec2d and vice versa."""
    import dataclasses

    from voicemap.config import DataConfig, ExperimentConfig
    from voicemap.eval import nshot

    cfg = EncoderConfig(filters=8, embedding_dim=16, dropout=0.0, **F32)
    model, variables, x = _make(cfg, seed=4, t=512)
    qvars = quantize_encoder(variables, cfg, x)  # wave artifact, no 'kind'
    exp = ExperimentConfig(mode="melspec2d", data=DataConfig(), encoder=cfg)
    with pytest.raises(ValueError, match="artifact kind"):
        nshot.embed_all(None, None, None, exp, qvars=qvars)


# --------------------------------------------------------------------------
# The int8 convolution and block against exact numpy integer arithmetic
# --------------------------------------------------------------------------

def numpy_int8_conv(x, w, dilation=1):
    """SAME conv of int8 (B, *spatial, Cin) by (*window, Cin, Cout), int64."""
    window = w.shape[:-2]
    reach = [(k - 1) * dilation for k in window]
    xp = np.pad(x.astype(np.int64),
                [(0, 0)] + [(r // 2, r - r // 2) for r in reach] + [(0, 0)])
    out = 0
    for tap in np.ndindex(*window):
        view = xp[(slice(None),) + tuple(slice(t * dilation, t * dilation + n)
                                         for t, n in zip(tap, x.shape[1:-1]))]
        out = out + view @ w[tap].astype(np.int64)
    return out


def _rand_qblk(rng, w_shape):
    cout = w_shape[-1]
    return {"w_q": rng.integers(-127, 128, w_shape).astype(np.int8),
            "alpha": rng.uniform(1e-4, 1e-3, cout).astype(np.float32),
            "beta": rng.uniform(-500, 500, cout).astype(np.float32),
            "gamma": rng.uniform(-5, 5, cout).astype(np.float32)}


# (cin, cout, T, k, dilation): the mid-block shapes the int8 path serves,
# odd lengths, even kernels and dilations.
CONV1D = [(16, 32, 60, 3, 1), (16, 32, 64, 3, 1), (8, 16, 30, 3, 1),
          (16, 16, 48, 3, 2), (16, 16, 47, 4, 1), (128, 256, 250, 3, 1),
          (4, 8, 17, 5, 3), (1, 8, 33, 32, 1)]


@pytest.mark.parametrize("cin,cout,T,k,dil", CONV1D)
def test_int8_conv_bit_exact(cin, cout, T, k, dil):
    rng = np.random.default_rng(cin * 31 + T)
    x = rng.integers(-127, 128, (3, T, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, cin, cout)).astype(np.int8)
    got = np.asarray(int8_conv(jnp.asarray(x), jnp.asarray(w), dil))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, numpy_int8_conv(x, w, dil))


@pytest.mark.parametrize("H,W,cin,cout", [(12, 9, 1, 8), (7, 8, 8, 16),
                                          (5, 5, 16, 4)])
def test_int8_conv2d_bit_exact(H, W, cin, cout):
    rng = np.random.default_rng(H * W)
    x = rng.integers(-127, 128, (2, H, W, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    np.testing.assert_array_equal(np.asarray(int8_conv(jnp.asarray(x), jnp.asarray(w))),
                                  numpy_int8_conv(x, w))


def _numpy_epilogue(acc, qblk, pool, last):
    z = (np.maximum(acc.astype(np.float32) + qblk["beta"], 0.0) * qblk["alpha"]
         + qblk["gamma"])
    y = z if last else np.clip(np.round(z), -127, 127)
    if pool > 1:
        B, T, C = y.shape
        y = y[:, :(T // pool) * pool].reshape(B, T // pool, pool, C).max(axis=2)
    return y


@pytest.mark.parametrize("cin,cout,T,pool,last", [
    (16, 32, 60, 2, False), (16, 32, 64, 2, False), (8, 16, 30, 2, True),
    (16, 16, 47, 2, False), (16, 16, 48, 1, False), (32, 8, 33, 2, True),
])
def test_quant_block_matches_numpy(cin, cout, T, pool, last):
    """Requantized codes within one step of the numpy epilogue over the
    exact accumulator (the f32 epilogue may round a .5 either way); the
    dequantized last block within bf16 rounding."""
    rng = np.random.default_rng(T)
    x = rng.integers(-127, 128, (4, T, cin)).astype(np.int8)
    qblk = _rand_qblk(rng, (3, cin, cout))
    got = _quant_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in qblk.items()},
                       pool, 1, last=last, out_dtype=jnp.bfloat16)
    want = _numpy_epilogue(numpy_int8_conv(x, qblk["w_q"]), qblk, pool, last)
    assert got.dtype == (jnp.bfloat16 if last else jnp.int8)
    got = np.asarray(got.astype(jnp.float32))
    if last:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        assert np.abs(got - want).max() <= 1


def test_quant_block2d_matches_numpy():
    rng = np.random.default_rng(11)
    x = rng.integers(-127, 128, (2, 10, 9, 8)).astype(np.int8)
    qblk = _rand_qblk(rng, (3, 3, 8, 16))
    got = np.asarray(_quant_block(jnp.asarray(x), qblk, 2, last=False,
                                  out_dtype=jnp.bfloat16), np.int32)
    acc = numpy_int8_conv(x, qblk["w_q"])
    z = np.clip(np.round(np.maximum(acc + qblk["beta"], 0) * qblk["alpha"]
                         + qblk["gamma"]), -127, 127)
    want = z[:, :10, :8].reshape(2, 5, 2, 4, 2, 16).max(axis=(2, 4))
    assert np.abs(got - want).max() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,T,k,dil", CONV1D)
def test_int8_conv_compiled_bit_exact(cin, cout, T, k, dil):
    """On the card the int8 GEMMs run on the tensor cores; still exact."""
    rng = np.random.default_rng(cin * 31 + T)
    x = rng.integers(-127, 128, (3, T, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, cin, cout)).astype(np.int8)
    got = np.asarray(jax.jit(int8_conv, static_argnums=2)(x, w, dil))
    np.testing.assert_array_equal(got, numpy_int8_conv(x, w, dil))
