"""Smoke run of the whole system on one NVIDIA GPU, through its entry points.

    python chip_smoke.py              # every phase, one card
    python chip_smoke.py --four-cards # the multi-device paths, four cards

One process runs every phase on a synthetic LibriSpeech-shaped corpus made
from a fixed seed under a temporary directory, at the full width of BASELINE
config #1 (``EncoderConfig()``: filters 128, multipliers 1/2/3/4, kernels
32/3/3/3, pools 4/2/2/2, embedding 64; 3 s at 16 kHz decimated by 4, so
T = 12,000):

1. device — JAX must run on a GPU (the script exits non-zero otherwise);
   prints the card's name and power limit, the JAX version and XLA_FLAGS.
2. train-classifier — ``train.loop.fit`` on config #1, batch 32: one step,
   then a resumed run to 30 steps from its checkpoint; the loss falls, the
   training accuracy ends far above chance and the checkpoint restores.
3. train-siamese — config #2 (weighted_l1) and config #4 (log-mel 2-D
   CNN), 10 steps each, finite losses.
4. embed — ``models.fast_infer.fast_embed`` at B = 2048 in bf16 against a
   float32 forward of the same variables at "highest" matmul precision
   (min row cosine ≥ 0.999), and the block-0 kernel against the plain block
   (max |Δ| ≤ 2e-2·max|ref|).
5. int8 — ``quantize_encoder`` + ``quant_embed`` at B = 2048; min cosine
   against bf16 on held-out rows ≥ ``bench.INT8_FIDELITY_GATE``.
6. eval — ``eval.nshot.evaluate``, 1-shot 5-way, 100 tasks, on the step-30
   checkpoint of phase 2: above chance, and what ``fit`` logged for the same
   tasks at that step.
7. gpu-tests — the ``gpu``-marked tests, compiled for the card.

``--four-cards`` runs only the multi-device paths, each against what it
must match: one data-parallel train step (synchronized BatchNorm, pmean of
gradients) against the single-device step on the same global batch;
sharded and ring-scheduled scoring against ``ops/distance.py``; and the
placement of what those paths return: every array of the data-parallel
step's state and metrics on four distinct devices, and the sharded distance
matrix split into four slices on four devices.

Each phase prints one result line; any failure ends the run with a non-zero
exit. The last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def cosine_rows(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1) + 1e-12)


def phase_device(jax):
    from voicemap import backend

    check(jax.default_backend() == "gpu",
          f"JAX's default backend is {jax.default_backend()!r}, not 'gpu'")
    print(backend.nvidia_smi_line(), flush=True)
    info = backend.device_info()
    log("device", jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""),
        compile_cache=backend.enable_compile_cache(), **info)
    return info


def make_corpus(root: str) -> None:
    from voicemap.data import synthetic

    spec = synthetic.SyntheticSpec(n_speakers=16, utterances_per_speaker=8,
                                   min_seconds=3.5, max_seconds=5.0, seed=1234)
    synthetic.generate_corpus(root, subsets=("dev-clean", "test-clean"), spec=spec)


def data_cfg(cfg, root: str, downsampling=None):
    import dataclasses

    return dataclasses.replace(
        cfg.data, data_root=root, subsets=("dev-clean",),
        val_subsets=("test-clean",),
        downsampling=cfg.data.downsampling if downsampling is None else downsampling,
    )


def phase_train_classifier(root: str, ckpt: str):
    import dataclasses

    import jax

    from voicemap.config import classifier_baseline
    from voicemap.train.checkpoints import CheckpointManager
    from voicemap.train.loop import build_model, fit, init_model_state

    base = classifier_baseline()
    cfg = base.replace(
        data=data_cfg(base, root),
        train=dataclasses.replace(base.train, num_steps=1, evaluate_every=1,
                                  num_eval_tasks=100, checkpoint_dir=ckpt),
    )
    t0 = time.perf_counter()
    _, hist0 = fit(cfg, verbose=False)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_steps=30,
                                                evaluate_every=30))
    state, hist = fit(cfg, verbose=False)
    seconds = time.perf_counter() - t0
    first, last = hist0[0]["loss"], hist[-1]["loss"]
    check(int(state.step) == 30, f"resumed run ended at step {int(state.step)}")
    check(np.isfinite(first) and np.isfinite(last), "non-finite loss")
    check(last < first, f"loss did not fall: {first} -> {last}")
    # Training accuracy through the classifier head: chance is 1/16 speakers.
    acc_first, acc_last = hist0[0]["accuracy"], hist[-1]["accuracy"]
    check(acc_last >= 0.5, f"training accuracy {acc_last} after 30 steps")

    mgr = CheckpointManager(ckpt)
    model = build_model(cfg, num_classes=mgr.head_num_classes("latest"))
    restored = mgr.restore_latest(init_model_state(model, cfg))
    check(restored is not None and int(restored.step) == 30,
          "latest checkpoint did not restore at step 30")
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree.leaves(state.params), jax.tree.leaves(restored.params)))
    check(same, "restored params differ from the trained state")
    log("train-classifier", steps=30, loss_first=first, loss_last=last,
        train_acc_first=acc_first, train_acc_last=acc_last,
        val_1shot_acc=hist[-1]["val_1-shot_acc"], seconds=seconds,
        checkpoint="restored")
    return cfg, state, hist[-1]["val_1-shot_acc"]


def phase_train_siamese(root: str):
    import dataclasses

    from voicemap.config import SiameseConfig, melspec_2d, siamese_verification
    from voicemap.train.loop import fit

    out = {}
    for name, base in (("siamese_weighted_l1", siamese_verification(
            siamese=SiameseConfig(distance_metric="weighted_l1"))),
                       ("melspec_2d", melspec_2d())):
        cfg = base.replace(
            data=data_cfg(base, root),
            train=dataclasses.replace(base.train, num_steps=10, evaluate_every=10,
                                      num_eval_tasks=50),
        )
        t0 = time.perf_counter()
        state, hist = fit(cfg, verbose=False)
        loss = hist[-1]["loss"]
        check(int(state.step) == 10 and np.isfinite(loss), f"{name}: loss {loss}")
        out[name] = {"loss": loss, "seconds": time.perf_counter() - t0}
    log("train-siamese", **out)


def serving_batch(cfg, root: str, batch: int, seed: int):
    """(batch, T, 1) model inputs cut from the corpus with random offsets."""
    import jax
    import jax.numpy as jnp

    from voicemap.data.dataset import dataset_from_config
    from voicemap.train import steps

    store = steps.device_store_for(cfg, dataset_from_config(cfg.data).to_store())
    idx = jnp.arange(batch, dtype=jnp.int32) % store.labels.shape[0]
    return steps.fetch_batch(store, idx, jax.random.PRNGKey(seed), cfg)


def phase_embed(cfg, state, root: str):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from voicemap.models.encoder import ConvEncoder, _DTYPES
    from voicemap.models.fast_infer import _xla_block, fast_embed, use_block0_kernel
    from voicemap.ops.block0_kernel import block0_kernel

    enc = {"params": state.params["encoder"],
           "batch_stats": state.batch_stats["encoder"]}
    e = cfg.encoder
    x = serving_batch(cfg, root, 2048, seed=5)
    got = jax.jit(lambda v, x: fast_embed(v, e, x))(enc, x)
    f32 = ConvEncoder(dataclasses.replace(e, compute_dtype="float32"))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, x: f32.apply(v, x))(enc, x)
    cos = cosine_rows(got, ref)
    check(got.shape == (x.shape[0], e.embedding_dim) and np.isfinite(np.asarray(got)).all(),
          "fast_embed output shape or values")
    check(cos.min() >= 0.999, f"fast_embed min cosine {cos.min()} < 0.999")

    kernel_on = use_block0_kernel(e, x)
    blk = enc["params"]["block_0"]
    bst = enc["batch_stats"]["block_0"]["bn"]
    cdt = _DTYPES[e.compute_dtype]
    plain = jax.jit(lambda x: _xla_block(x, blk, bst, e.pool_sizes[0], 1,
                                         e.bn_epsilon, cdt))(x)
    fused = block0_kernel(x, blk["conv"]["kernel"], blk["conv"]["bias"],
                          blk["bn"]["scale"], blk["bn"]["bias"], bst["mean"],
                          bst["var"], pool=e.pool_sizes[0], eps=e.bn_epsilon)
    ref0 = np.asarray(plain.astype(jnp.float32))
    err = float(np.abs(np.asarray(fused.astype(jnp.float32)) - ref0).max())
    tol = 2e-2 * float(np.abs(ref0).max())
    check(err <= tol, f"block-0 kernel max |d| {err} > {tol}")
    log("embed", batch=int(x.shape[0]), min_cosine_vs_f32=float(cos.min()),
        block0_kernel_in_fast_embed=bool(kernel_on),
        block0_kernel_max_abs_err=err, block0_tol=tol)
    return enc, x


def phase_int8(cfg, enc, x, root: str):
    import dataclasses

    import jax

    from bench import INT8_FIDELITY_GATE
    from voicemap.models.fast_infer import fast_embed
    from voicemap.models.quant_infer import quant_embed, quantize_encoder

    e = cfg.encoder
    qvars = quantize_encoder(enc, e, x[:256])
    held_cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, subsets=cfg.data.val_subsets))
    held = serving_batch(held_cfg, root, 2048, seed=6)  # held-out speakers
    got = jax.jit(lambda v, q, x: quant_embed(v, q, e, x))(enc, qvars, held)
    ref = jax.jit(lambda v, x: fast_embed(v, e, x))(enc, held)
    cos = cosine_rows(got, ref)
    check(np.isfinite(np.asarray(got)).all(), "int8 embeddings not finite")
    check(cos.min() >= INT8_FIDELITY_GATE,
          f"int8 min cosine {cos.min()} < {INT8_FIDELITY_GATE}")
    log("int8", batch=int(held.shape[0]), min_cosine_vs_bf16=float(cos.min()),
        gate=INT8_FIDELITY_GATE)


def phase_eval(cfg, ckpt: str, logged_acc: float):
    """1-shot 5-way on the held-out speakers with the step-30 checkpoint,
    on the tasks ``fit`` drew for its own evaluation at that step.

    On this synthetic corpus an untrained encoder already separates held-out
    speakers almost perfectly, so the n-shot accuracy cannot tell training
    from none (phase 2's training accuracy does). The untrained encoder's
    score on the same tasks is printed beside it for that reason.
    """
    import dataclasses

    import jax

    from voicemap.data.dataset import dataset_from_config
    from voicemap.eval import nshot
    from voicemap.train import steps
    from voicemap.train.checkpoints import CheckpointManager
    from voicemap.train.loop import build_model, init_model_state

    mgr = CheckpointManager(ckpt)
    model = build_model(cfg, num_classes=mgr.head_num_classes("latest"))
    untrained = init_model_state(model, cfg)
    state = mgr.restore_latest(untrained)
    check(state is not None and int(state.step) == 30,
          "no step-30 checkpoint to evaluate")
    val = dataclasses.replace(cfg.data, subsets=cfg.data.val_subsets,
                              stochastic=False)
    store = steps.device_store_for(cfg, dataset_from_config(val).to_store())
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed + 1), 29)
    acc, acc0 = (nshot.evaluate(model, s, store, cfg, key, num_tasks=100, n=1, k=5)
                 for s in (state, untrained))
    check(acc > 0.2, f"1-shot 5-way accuracy {acc} is not above chance 0.2")
    check(abs(acc - logged_acc) <= 0.02,
          f"restored checkpoint scores {acc}, fit logged {logged_acc} at step 30")
    log("eval", n_shot=1, k_way=5, tasks=100, accuracy=acc, chance=0.2,
        step=int(state.step), accuracy_logged_by_fit=logged_acc,
        accuracy_untrained=acc0)


def phase_gpu_tests():
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["JAX_PLATFORMS"] = "cuda"  # tests/conftest.py: stay on the card
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")
    log("gpu-tests", pytest_exit=int(rc))


def four_cards(jax):
    import dataclasses

    import jax.numpy as jnp

    from voicemap.config import DataConfig, EncoderConfig, ExperimentConfig, TrainConfig
    from voicemap.models.classifier import SpeakerClassifier
    from voicemap.ops import distance, sampling
    from voicemap.parallel import data_parallel, mesh as mesh_mod
    from voicemap.parallel.sharded_distance import (ring_sq_euclidean,
                                                    sharded_nearest_support,
                                                    sharded_sq_euclidean)
    from voicemap.train import steps
    from voicemap.train.loop import init_model_state
    from voicemap.train.state import apply_updates, make_optimizer

    n = len(jax.devices())
    check(n == 4, f"--four-cards needs 4 devices, found {n}")
    mesh = mesh_mod.data_mesh(4)

    def on_four(arr, what):
        devs = {s.device for s in arr.addressable_shards}
        check(len(devs) == 4, f"{what}: shards on {len(devs)} device(s)")
        return devs

    # Data-parallel train step vs the single-device step on the same batch.
    cfg = ExperimentConfig(
        mode="classifier", data=DataConfig(seconds=3.0, downsampling=4),
        encoder=EncoderConfig(dropout=0.0, compute_dtype="float32"),
        train=TrainConfig(batch_size=32),
    )
    r = np.random.default_rng(0)
    n_utts, t = 256, 64000
    store = steps.DeviceStore(
        audio=jnp.asarray(r.integers(-8000, 8000, (n_utts, t), dtype=np.int16)),
        lengths=jnp.full((n_utts,), t, jnp.int32),
        labels=jnp.asarray(np.arange(n_utts, dtype=np.int32) % 16),
        speaker_utts=jnp.asarray(np.arange(n_utts, dtype=np.int32).reshape(16, 16).T),
        speaker_counts=jnp.full((16,), 16, jnp.int32),
    )
    model = SpeakerClassifier(cfg.encoder, num_classes=16)
    state = init_model_state(model, cfg)
    key = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("highest"):
        step, _ = data_parallel.make_dp_classifier_train_step(model, cfg, mesh)
        dp_state, dp_m = step(state, store, key)
        # The same global batch, drawn exactly as each replica draws its part.
        xs, ys = [], []
        for d in range(4):
            kd = jax.random.fold_in(key, d)
            k_idx, k_off, _ = jax.random.split(jax.random.fold_in(kd, state.step), 3)
            idx = sampling.sample_classifier_batch(k_idx, n_utts, 8)
            xs.append(steps.fetch_batch(store, idx, k_off, cfg))
            ys.append(store.labels[idx])
        x, y = jnp.concatenate(xs), jnp.concatenate(ys)
        loss_fn = steps.classifier_loss_fn(model, cfg)
        (loss, (bs, _)), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, x, y, key)
        ref = apply_updates(state, g, make_optimizer(cfg.train.clipnorm), bs)
    # Relative L2 difference of all parameters. (Per element it would be
    # ill-posed: Adam's first step moves each parameter by ≈ lr·sign(g), so
    # components whose gradient is at rounding level may move either way.)
    flat_dp = np.concatenate([np.ravel(a) for a in jax.tree.leaves(dp_state.params)])
    flat_ref = np.concatenate([np.ravel(b) for b in jax.tree.leaves(ref.params)])
    worst = float(np.linalg.norm(flat_dp - flat_ref) / np.linalg.norm(flat_ref))
    check(worst <= 1e-3, f"DP params differ from single-device by {worst} (rel)")
    check(abs(float(dp_m["loss"]) - float(loss)) <= 1e-3 * abs(float(loss)),
          "DP loss differs from single-device loss")
    log("four-cards-dp", devices=4, loss_dp=float(dp_m["loss"]),
        loss_single=float(loss), rel_param_diff=worst)
    # The step's outputs: the replicated state and metrics live on every card.
    dp_out = jax.tree.leaves((dp_state, dp_m))
    devs = set().union(*(on_four(a, "data-parallel step output") for a in dp_out))

    # Pod-scale scoring against the unsharded matmul-form distances.
    q = jnp.asarray(r.standard_normal((512, 64)), jnp.float32)
    s = jnp.asarray(r.standard_normal((8192, 64)), jnp.float32)
    with jax.default_matmul_precision("highest"):
        d_ref = np.asarray(distance.pairwise_sq_euclidean(q, s))
        d_sh = sharded_sq_euclidean(q, s, mesh)
        d_ring = ring_sq_euclidean(q, s, mesh)
        nearest = sharded_nearest_support(q, s, mesh)
    on_four(d_sh, "sharded distance matrix")
    slices = {str(sh.index) for sh in d_sh.addressable_shards}
    check(len(slices) == 4, f"sharded distance matrix: {len(slices)} distinct slices")
    for name, d in (("sharded", d_sh), ("ring", d_ring)):
        err = float(np.abs(np.asarray(d) - d_ref).max())
        check(err <= 1e-4 * max(1.0, float(np.abs(d_ref).max())),
              f"{name} distances differ by {err}")
    check(np.array_equal(np.asarray(nearest), d_ref.argmin(axis=1)),
          "sharded nearest-support argmin differs")
    check(np.array_equal(np.asarray(d_ring).argmin(axis=1), d_ref.argmin(axis=1)),
          "ring argmin differs")
    log("four-cards-scoring", queries=512, support=8192,
        max_abs_err_sharded=float(np.abs(np.asarray(d_sh) - d_ref).max()),
        max_abs_err_ring=float(np.abs(np.asarray(d_ring) - d_ref).max()))
    log("four-cards-placement", dp_step_arrays=len(dp_out),
        devices=sorted(str(d) for d in devs), distance_slices=sorted(slices))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-device paths (needs 4 GPUs)")
    args = p.parse_args()

    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    info = phase_device(jax)
    if args.four_cards:
        four_cards(jax)
    else:
        with tempfile.TemporaryDirectory(prefix="voicemap_smoke_") as tmp:
            root, ckpt = os.path.join(tmp, "data"), os.path.join(tmp, "ckpt")
            make_corpus(root)
            cfg, state, val_acc = phase_train_classifier(root, ckpt)
            phase_train_siamese(root)
            enc, x = phase_embed(cfg, state, root)
            phase_int8(cfg, enc, x, root)
            phase_eval(cfg, ckpt, val_acc)
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
