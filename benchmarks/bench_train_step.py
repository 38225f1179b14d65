"""Train step time on the GPU for the presets, at full width.

    python benchmarks/bench_train_step.py [--batches 32,256]

One full train program per step (sampling → gather/preprocess → forward →
backward → Adam), plain JAX autodiff, from a random int16 device store made
on the device from a seed: config #1 (classifier) at each batch, config #2
(siamese, weighted_l1) at its batch 64, config #4 (log-mel 2-D CNN) at 32.
Prints one JSON line per (config, batch) with ms/step (median of waited
calls, ``utils.profiling.time_fn``). Runs on a GPU only.

(The custom-VJP block ops this script once compared against autodiff lost
on the H100 and were removed; see PERF.md.)
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from voicemap import backend
from voicemap.config import (ExperimentConfig, SiameseConfig, TrainConfig,
                             classifier_baseline, melspec_2d, siamese_verification)
from voicemap.train import steps as steps_mod
from voicemap.utils.profiling import time_fn


def random_store(n_utts: int = 1024, n_speakers: int = 64, seconds: float = 4.0,
                 sample_rate: int = 16000, seed: int = 0) -> steps_mod.DeviceStore:
    """A device store of random int16 audio, made on the device."""
    t = int(seconds * sample_rate)
    audio = jax.random.randint(jax.random.PRNGKey(seed), (n_utts, t), -8000, 8000,
                               jnp.int16)
    labels = np.arange(n_utts, dtype=np.int32) % n_speakers
    per = n_utts // n_speakers
    utts = np.arange(n_utts, dtype=np.int32).reshape(per, n_speakers).T
    return steps_mod.DeviceStore(
        audio=audio, lengths=jnp.full((n_utts,), t, jnp.int32),
        labels=jnp.asarray(labels), speaker_utts=jnp.asarray(utts),
        speaker_counts=jnp.full((n_speakers,), per, jnp.int32))


def build(cfg: ExperimentConfig, n_classes: int):
    from voicemap.train.loop import build_model, init_model_state, make_step

    model = build_model(cfg, num_classes=n_classes)
    step, _ = make_step(model, cfg)
    return init_model_state(model, cfg), step


def cases(batches):
    for b in batches:
        yield "classifier", classifier_baseline(train=TrainConfig(batch_size=b))
    yield "siamese_weighted_l1", siamese_verification(
        siamese=SiameseConfig(distance_metric="weighted_l1"))
    yield "melspec_2d", melspec_2d(train=TrainConfig(batch_size=32))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="32,256")
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    backend.enable_compile_cache()
    dev = backend.require_gpu()
    print(backend.nvidia_smi_line(), flush=True)
    key = jax.random.PRNGKey(1)
    stores = {}
    for name, cfg in cases([int(b) for b in args.batches.split(",")]):
        seconds = 4.0 if cfg.data.downsampling > 1 else 3.5
        if seconds not in stores:
            stores[seconds] = random_store(seconds=seconds)
        state, step = build(cfg, 64)
        t = time_fn(lambda s: step(s, stores[seconds], key)[1]["loss"], state,
                    iters=args.iters)
        print(json.dumps({"bench": "train_step", "config": name,
                          "batch": cfg.train.batch_size,
                          "p50_ms": t["p50_s"] * 1e3, "mean_ms": t["mean_s"] * 1e3,
                          "device": dev}), flush=True)


if __name__ == "__main__":
    main()
