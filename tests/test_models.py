"""Model unit tests (SURVEY.md §4 item 2): output shapes per config,
parameter counts, siamese symmetry, gradient flow to both towers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voicemap.config import EncoderConfig, SiameseConfig, dilated_4khz
from voicemap.models.classifier import SpeakerClassifier
from voicemap.models.encoder import ConvEncoder
from voicemap.models.siamese import SiameseNet

# float32 for exact symmetry/grad checks on CPU.
CFG = EncoderConfig(filters=8, embedding_dim=16, compute_dtype="float32")
T = 1200  # small time dim for fast CPU tests


def test_encoder_output_shape():
    model = ConvEncoder(CFG)
    x = jnp.zeros((2, T, 1))
    variables = model.init(jax.random.PRNGKey(0))
    out = model.apply(variables, x, train=False)
    assert out.shape == (2, 16)
    assert out.dtype == jnp.float32


def test_encoder_channel_progression():
    """Filter multipliers 1/2/3/4 and pooling 4/2/2/2 as in the reference
    topology (SURVEY.md §3.5)."""
    model = ConvEncoder(CFG)
    x = jnp.zeros((1, T, 1))
    variables = model.init(jax.random.PRNGKey(0))
    p = variables["params"]
    assert p["block_0"]["conv"]["kernel"].shape == (32, 1, 8)
    assert p["block_1"]["conv"]["kernel"].shape == (3, 8, 16)
    assert p["block_2"]["conv"]["kernel"].shape == (3, 16, 24)
    assert p["block_3"]["conv"]["kernel"].shape == (3, 24, 32)
    assert p["embed"]["kernel"].shape == (32, 16)


def test_encoder_param_count():
    """Parameter-count check against hand-computed topology numbers."""
    model = ConvEncoder(CFG)
    variables = model.init(jax.random.PRNGKey(0))
    n = sum(x.size for x in jax.tree.leaves(variables["params"]))
    # conv kernels+bias: 32*1*8+8, 3*8*16+16, 3*16*24+24, 3*24*32+32
    # bn scale+bias: 2*(8+16+24+32); dense: 32*16+16
    expect = (32 * 8 + 8) + (3 * 8 * 16 + 16) + (3 * 16 * 24 + 24) + (
        3 * 24 * 32 + 32
    ) + 2 * (8 + 16 + 24 + 32) + (32 * 16 + 16)
    assert n == expect


def test_dilated_config_builds():
    cfg = dilated_4khz().encoder
    cfg = dataclasses.replace(cfg, filters=4, compute_dtype="float32")
    model = ConvEncoder(cfg)
    x = jnp.zeros((1, 2048, 1))
    variables = model.init(jax.random.PRNGKey(0))
    out = model.apply(variables, x, train=False)
    assert out.shape == (1, cfg.embedding_dim)


def test_classifier_shapes():
    model = SpeakerClassifier(CFG, num_classes=10)
    x = jnp.zeros((3, T, 1))
    variables = model.init(jax.random.PRNGKey(0))
    logits = model.apply(variables, x, train=False)
    assert logits.shape == (3, 10)
    emb = model.embed(variables, x)
    assert emb.shape == (3, 16)


@pytest.mark.parametrize(
    "metric",
    ["uniform_euclidean", "weighted_l1", "uniform_l1", "dot_product", "cosine_distance"],
)
def test_siamese_shapes_all_metrics(metric):
    model = SiameseNet(CFG, SiameseConfig(distance_metric=metric))
    x1 = jnp.asarray(np.random.default_rng(0).standard_normal((2, T, 1)), jnp.float32)
    x2 = jnp.asarray(np.random.default_rng(1).standard_normal((2, T, 1)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0))
    out = model.apply(variables, x1, x2, train=False)
    assert out.shape == (2,)


@pytest.mark.parametrize("metric", ["uniform_euclidean", "weighted_l1", "uniform_l1"])
def test_siamese_symmetry(metric):
    """d(a,b) == d(b,a) for symmetric merges (SURVEY.md §4 item 2)."""
    model = SiameseNet(CFG, SiameseConfig(distance_metric=metric))
    rng = np.random.default_rng(2)
    x1 = jnp.asarray(rng.standard_normal((4, T, 1)), jnp.float32)
    x2 = jnp.asarray(rng.standard_normal((4, T, 1)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0))
    ab = model.apply(variables, x1, x2, train=False)
    ba = model.apply(variables, x2, x1, train=False)
    np.testing.assert_allclose(np.asarray(ab), np.asarray(ba), rtol=1e-5, atol=1e-5)


def test_siamese_gradients_flow_to_encoder():
    """Gradient flows through both towers into the shared encoder."""
    model = SiameseNet(CFG, SiameseConfig())
    rng = np.random.default_rng(3)
    x1 = jnp.asarray(rng.standard_normal((2, T, 1)), jnp.float32)
    x2 = jnp.asarray(rng.standard_normal((2, T, 1)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0))

    def loss(params):
        out = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x1,
            x2,
            train=False,
        )
        return jnp.sum(out**2)

    grads = jax.grad(loss)(variables["params"])
    gnorm = jnp.sqrt(
        sum(jnp.sum(g**2) for g in jax.tree.leaves(grads["encoder"]))
    )
    assert float(gnorm) > 0.0


def test_score_support_matches_pairwise():
    """Matrix-form head scores == per-pair forward logits."""
    for metric in ["weighted_l1", "uniform_euclidean", "uniform_l1"]:
        model = SiameseNet(CFG, SiameseConfig(distance_metric=metric))
        rng = np.random.default_rng(4)
        x1 = jnp.asarray(rng.standard_normal((1, T, 1)), jnp.float32)
        xs = jnp.asarray(rng.standard_normal((5, T, 1)), jnp.float32)
        variables = model.init(jax.random.PRNGKey(0))
        q = model.embed(variables, x1)
        s = model.embed(variables, xs)
        mat = model.score_support(variables, q, s)  # (1, 5)
        pair = model.apply(
            variables, jnp.tile(x1, (5, 1, 1)), xs, train=False
        )  # (5,)
        np.testing.assert_allclose(
            np.asarray(mat)[0], np.asarray(pair), rtol=1e-4, atol=1e-4
        )


def test_batchnorm_updates_stats():
    model = ConvEncoder(CFG)
    x = jnp.asarray(
        np.random.default_rng(5).standard_normal((4, T, 1)), jnp.float32
    )
    variables = model.init(jax.random.PRNGKey(0))
    _, new_stats = model.apply(
        variables, x, train=True, rng=jax.random.PRNGKey(1),
    )
    before = variables["batch_stats"]["block_0"]["bn"]["mean"]
    after = new_stats["block_0"]["bn"]["mean"]
    assert not np.allclose(np.asarray(before), np.asarray(after))


# --------------------------------------------------------------------------
# Plain-JAX modules: variable trees, numpy forward, BatchNorm, dropout, dtypes
# --------------------------------------------------------------------------

from voicemap.config import MelConfig  # noqa: E402
from voicemap.models import encoder as enc_mod  # noqa: E402
from voicemap.models.spectrogram import MelSpecClassifier  # noqa: E402


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def test_classifier_variable_tree_layout():
    v = SpeakerClassifier(CFG, num_classes=10).init(jax.random.PRNGKey(0))
    assert set(v) == {"params", "batch_stats"}
    assert set(v["params"]) == {"encoder", "head"}
    p = v["params"]["encoder"]
    assert set(p) == {"block_0", "block_1", "block_2", "block_3", "embed"}
    assert _shapes(p["block_1"]) == {"conv": {"kernel": (3, 8, 16), "bias": (16,)},
                                     "bn": {"scale": (16,), "bias": (16,)}}
    assert _shapes(v["batch_stats"]) == {"encoder": {
        f"block_{i}": {"bn": {"mean": (c,), "var": (c,)}}
        for i, c in enumerate((8, 16, 24, 32))}}
    assert _shapes(v["params"]["head"]) == {"kernel": (16, 10), "bias": (10,)}


@pytest.mark.parametrize("metric,width", [("weighted_l1", 16), ("uniform_euclidean", 1),
                                          ("cosine_distance", 1)])
def test_siamese_head_layout(metric, width):
    v = SiameseNet(CFG, SiameseConfig(distance_metric=metric)).init(
        jax.random.PRNGKey(0))
    assert _shapes(v["params"]["head"]) == {"kernel": (width, 1), "bias": (1,)}
    assert set(v["batch_stats"]) == {"encoder"}


@pytest.mark.parametrize("metric,same_label,positive", [
    ("uniform_euclidean", 0, True), ("dot_product", 0, False),
    ("uniform_l1", 1, False), ("dot_product", 1, True),
])
def test_siamese_head_init_orientation(metric, same_label, positive):
    """An untrained head already scores larger distances (smaller dot
    products) as more likely "different" under the label convention."""
    v = SiameseNet(CFG, SiameseConfig(distance_metric=metric,
                                      same_label=same_label)).init(
        jax.random.PRNGKey(5))
    w = np.asarray(v["params"]["head"]["kernel"])
    assert (w > 0).all() if positive else (w < 0).all()


def test_mel_classifier_variable_tree_layout():
    model = MelSpecClassifier(CFG, MelConfig(), num_classes=3)
    v = model.init(jax.random.PRNGKey(0))
    p = v["params"]["encoder"]
    assert "frontend" not in p  # the frontend has no parameters
    assert p["block_0"]["conv"]["kernel"].shape == (3, 3, 1, 8)
    assert p["block_3"]["conv"]["kernel"].shape == (3, 3, 24, 32)
    assert p["embed"]["kernel"].shape == (32, 16)
    out = model.apply(v, jnp.zeros((2, 16000, 1)))
    assert out.shape == (2, 3) and out.dtype == jnp.float32


def _numpy_encoder(v, cfg, x):
    """Eval-mode ConvEncoder in numpy float64."""
    p, s = v["params"], v["batch_stats"]
    h = np.asarray(x, np.float64)
    for i, (pool, dil) in enumerate(zip(cfg.pool_sizes, cfg.dilations)):
        w = np.asarray(p[f"block_{i}"]["conv"]["kernel"], np.float64)
        k = w.shape[0]
        reach = (k - 1) * dil
        hp = np.pad(h, ((0, 0), (reach // 2, reach - reach // 2), (0, 0)))
        T = h.shape[1]
        z = sum(hp[:, m * dil:m * dil + T] @ w[m] for m in range(k))
        z = np.maximum(z + np.asarray(p[f"block_{i}"]["conv"]["bias"]), 0.0)
        bn, st = p[f"block_{i}"]["bn"], s[f"block_{i}"]["bn"]
        z = ((z - np.asarray(st["mean"])) / np.sqrt(np.asarray(st["var"]) + cfg.bn_epsilon)
             * np.asarray(bn["scale"]) + np.asarray(bn["bias"]))
        t = (z.shape[1] // pool) * pool
        h = z[:, :t].reshape(z.shape[0], t // pool, pool, -1).max(axis=2)
    return h.max(axis=1) @ np.asarray(p["embed"]["kernel"]) + np.asarray(p["embed"]["bias"])


@pytest.mark.parametrize("T", [1200, 1203])
def test_encoder_matches_numpy_forward(T):
    model = ConvEncoder(CFG)
    v = model.init(jax.random.PRNGKey(1))
    r = np.random.default_rng(T)
    v["batch_stats"] = jax.tree.map(
        lambda a: jnp.asarray(r.uniform(0.5, 1.5, a.shape), jnp.float32),
        v["batch_stats"])
    x = r.standard_normal((2, T, 1)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(model.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(got, _numpy_encoder(v, CFG, x), rtol=1e-4, atol=1e-4)


def test_batchnorm_train_update_matches_formula():
    r = np.random.default_rng(7)
    x = r.standard_normal((4, 50, 6)).astype(np.float32) * 3 + 1
    p = {"scale": jnp.full((6,), 2.0), "bias": jnp.full((6,), 0.5)}
    st = {"mean": jnp.full((6,), 0.3), "var": jnp.full((6,), 1.7)}
    y, new = enc_mod.batch_norm(p, st, jnp.asarray(x), train=True,
                                momentum=0.99, eps=1e-3)
    mu = x.mean(axis=(0, 1))
    var = (x * x).mean(axis=(0, 1)) - mu * mu
    np.testing.assert_allclose(np.asarray(new["mean"]), 0.99 * 0.3 + 0.01 * mu,
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(new["var"]), 0.99 * 1.7 + 0.01 * var,
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(y), (x - mu) / np.sqrt(var + 1e-3) * 2 + 0.5,
                               rtol=1e-4, atol=1e-4)
    y_eval, same = enc_mod.batch_norm(p, st, jnp.asarray(x), train=False,
                                      momentum=0.99, eps=1e-3)
    assert same is st
    np.testing.assert_allclose(np.asarray(y_eval),
                               (x - 0.3) / np.sqrt(1.7 + 1e-3) * 2 + 0.5,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 40, 16), (4, 6, 5, 16)])
def test_spatial_dropout_drops_whole_channels(shape):
    x = jnp.ones(shape, jnp.float32)
    y = np.asarray(enc_mod.spatial_dropout(x, 0.5, jax.random.PRNGKey(3)))
    per_channel = y.reshape(shape[0], -1, shape[-1])
    # Every (example, channel) column is all 0 or all 1/keep.
    assert np.all((per_channel == 0).all(axis=1) | (per_channel == 2.0).all(axis=1))
    assert 0 < (per_channel[:, 0] == 0).mean() < 1


def test_dropout_needs_rng_in_train_mode():
    model = ConvEncoder(EncoderConfig(filters=4, embedding_dim=8, dropout=0.1))
    v = model.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="rng"):
        model.apply(v, jnp.zeros((2, 400, 1)), train=True)
    a, _ = model.apply(v, jnp.ones((2, 400, 1)), train=True, rng=jax.random.PRNGKey(1))
    b, _ = model.apply(v, jnp.ones((2, 400, 1)), train=True, rng=jax.random.PRNGKey(2))
    assert not np.allclose(np.asarray(a), np.asarray(b))
    # Eval ignores dropout entirely.
    np.testing.assert_array_equal(np.asarray(model.apply(v, jnp.ones((2, 400, 1)))),
                                  np.asarray(model.apply(v, jnp.ones((2, 400, 1)))))


@pytest.mark.parametrize("shape,pool,out", [((2, 9, 3), 4, (2, 2, 3)),
                                            ((2, 7, 5, 3), 2, (2, 3, 2, 3)),
                                            ((1, 4, 2), 1, (1, 4, 2))])
def test_max_pool_valid_floor(shape, pool, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    y = np.asarray(enc_mod.max_pool(jnp.asarray(x), pool))
    assert y.shape == out
    if len(shape) == 3 and pool > 1:
        np.testing.assert_array_equal(y, x[:, :8].reshape(2, 2, 4, 3).max(axis=2))


def test_dtypes_bf16_compute_f32_params():
    cfg = EncoderConfig(filters=8, embedding_dim=16)  # bf16 compute default
    model = SpeakerClassifier(cfg, num_classes=4)
    v = model.init(jax.random.PRNGKey(0))
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(v))
    logits, new = model.apply(v, jnp.ones((2, 600, 1)), train=True,
                              rng=jax.random.PRNGKey(1))
    assert logits.dtype == jnp.float32
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(new))
    assert model.embed(v, jnp.ones((2, 600, 1))).dtype == jnp.float32


def test_models_are_hashable_values():
    """Models key jit/lru caches: equal configs give equal, hashable models."""
    a = SpeakerClassifier(CFG, 3)
    assert a == SpeakerClassifier(CFG, 3) and hash(a) == hash(SpeakerClassifier(CFG, 3))
    assert a != SpeakerClassifier(CFG, 4)
