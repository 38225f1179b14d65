"""Encoder block 0: the fused GPU kernel against the plain XLA block.

    python benchmarks/bench_kernels.py [--batch 2048] [--t 12000]

At the flagship width (EncoderConfig(): C=128, k=32, pool 4) and the serving
shape, checks the kernel against the plain block once (max |Δ| ≤
2e-2·max|ref|: bf16 operands, f32 accumulation), then times

- block 0 alone: the XLA block and the kernel over a (tq, num_warps) sweep;
- the whole serving forward (``fast_embed``) with block 0 on each path;
- the plain XLA ops that stand where hand-written kernels once did: the
  fragment gather + decimate + whiten chain (``ops/preprocess.py``) at the
  serving batch, the log-mel frontend (``ops/melspec.py``, 3 s at 16 kHz)
  at the training and serving batch, and the L1 / squared-euclidean score
  matrices (``ops/distance.py``) of 1,024 queries against 8,192 supports.

Each timing is ``utils.profiling.time_fn`` (every call waited for with
``block_until_ready``). Prints one JSON line per measurement; runs on a GPU
only.
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
from voicemap.config import EncoderConfig, MelConfig
from voicemap.models.encoder import ConvEncoder, _DTYPES
from voicemap.models.fast_infer import _xla_block, embed_tail, fast_embed
from voicemap.ops import distance, melspec, preprocess
from voicemap.ops.block0_kernel import block0_kernel
from voicemap.utils.profiling import time_fn


def random_variables(cfg: EncoderConfig, seed: int = 0) -> dict:
    """Random weights with non-trivial BatchNorm statistics."""
    v = ConvEncoder(cfg).init(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: a, v["batch_stats"])
    for name, blk in stats.items():
        c = blk["bn"]["mean"].shape[0]
        blk["bn"] = {"mean": jnp.asarray(r.uniform(0.0, 0.5, c), jnp.float32),
                     "var": jnp.asarray(r.uniform(0.5, 2.0, c), jnp.float32)}
    return {"params": v["params"], "batch_stats": stats}


def block0_args(v):
    blk, bst = v["params"]["block_0"], v["batch_stats"]["block_0"]["bn"]
    return (blk["conv"]["kernel"], blk["conv"]["bias"], blk["bn"]["scale"],
            blk["bn"]["bias"], bst["mean"], bst["var"])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--t", type=int, default=12000)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    backend.enable_compile_cache()
    dev = backend.require_gpu()
    print(backend.nvidia_smi_line(), flush=True)
    cfg = EncoderConfig(dropout=0.0)
    cdt = _DTYPES[cfg.compute_dtype]
    v = random_variables(cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (args.batch, args.t, 1))
    pool, eps = cfg.pool_sizes[0], cfg.bn_epsilon
    blk, bst = v["params"]["block_0"], v["batch_stats"]["block_0"]["bn"]

    xla = jax.jit(lambda x: _xla_block(x, blk, bst, pool, 1, eps, cdt))
    ref = np.asarray(xla(x).astype(jnp.float32))
    got = np.asarray(block0_kernel(x, *block0_args(v), pool=pool, eps=eps)
                     .astype(jnp.float32))
    err = float(np.abs(got - ref).max())
    tol = 2e-2 * float(np.abs(ref).max())
    print(json.dumps({"check": "block0_kernel_vs_xla", "max_abs_err": err,
                      "tol": tol, "ok": err <= tol}), flush=True)

    def report(name, fn, *a, **shape):
        t = time_fn(fn, *a, iters=args.iters)
        print(json.dumps({"bench": name, **(shape or {"batch": args.batch, "t": args.t}),
                          "p50_ms": t["p50_s"] * 1e3, "mean_ms": t["mean_s"] * 1e3,
                          "device": dev}), flush=True)
        return t["p50_s"]

    report("block0_xla", jax.jit(lambda x: xla(x).sum(dtype=jnp.float32)), x)
    best = None
    for tq in (32, 64, 128):
        for nw in (4, 8):
            f = jax.jit(lambda x, tq=tq, nw=nw: block0_kernel(
                x, *block0_args(v), pool=pool, eps=eps, tq=tq,
                num_warps=nw).sum(dtype=jnp.float32))
            t = report(f"block0_kernel_tq{tq}_w{nw}", f, x)
            if best is None or t < best[0]:
                best = (t, tq, nw)
    print(json.dumps({"best_block0_kernel": {"p50_ms": best[0] * 1e3,
                                              "tq": best[1], "num_warps": best[2]}}),
          flush=True)
    serve = {
        "xla": jax.jit(lambda v, x: embed_tail(v, cfg, _xla_block(
            x, v["params"]["block_0"], v["batch_stats"]["block_0"]["bn"],
            pool, 1, eps, cdt))),
        "kernel": jax.jit(lambda v, x: fast_embed(v, cfg, x)),
    }
    for mode in ("xla", "kernel", "xla", "kernel"):
        report(f"fast_embed_block0_{mode}", serve[mode], v, x)
    plain_ops(report, args.batch)


def plain_ops(report, batch: int) -> None:
    """Time the plain XLA ops that replaced hand-written kernels."""
    r = np.random.default_rng(2)
    frag, store_t = 48000, 56000  # 3 s at 16 kHz, with offset slack
    store = jnp.asarray(r.integers(-20000, 20000, (batch, store_t), dtype=np.int16))
    off = jnp.asarray(r.integers(0, store_t - frag, (batch,), dtype=np.int32))
    report("preprocess_xla", jax.jit(lambda s, o: preprocess.preprocess_batch(
        s, o, frag, 4).sum()), store, off, batch=batch, t=frag)
    mel = MelConfig()
    for b in (32, batch):
        wav = jax.random.normal(jax.random.PRNGKey(3), (b, frag))
        report("log_mel_xla", jax.jit(lambda w: melspec.log_mel_spectrogram(
            w, mel, 16000).sum()), wav, batch=b, t=frag)
    q = jax.random.normal(jax.random.PRNGKey(4), (1024, 64))
    sup = jax.random.normal(jax.random.PRNGKey(5), (8192, 64))
    w, bias = jnp.ones((64,)), jnp.zeros(())
    report("weighted_l1_xla", jax.jit(lambda q, s: distance.pairwise_weighted_l1(
        q, s, w, bias).sum()), q, sup, queries=1024, support=8192)
    report("sq_euclidean_xla", jax.jit(lambda q, s: distance.pairwise_sq_euclidean(
        q, s).sum()), q, sup, queries=1024, support=8192)


if __name__ == "__main__":
    main()
