"""int8 serving (models/quant_infer.py) against the bf16 serving forward.

    python benchmarks/bench_quant.py [--batches 1,8,64,256,2048]

On config #1 at full width (EncoderConfig(), T = 12,000):

1. ``check``: the int8 convolution of a mid block (``int8_conv``: one
   s8×s8→s32 ``dot_general`` per tap) equals a numpy int32 convolution bit
   for bit.
2. ``blocks``: blocks 1-3 at the serving batch, bf16 (``_xla_block``)
   against int8 (``_quant_block``).
3. ``embed``: ``quant_embed`` against ``fast_embed`` end to end per batch
   size, in turns, with the min cosine of the int8 embeddings against bf16.

Times are ``utils.profiling.time_fn`` medians (every call waited for).
Prints one JSON line per measurement; runs on a GPU only.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks.bench_kernels import random_variables
from voicemap import backend
from voicemap.config import EncoderConfig
from voicemap.models.encoder import _DTYPES
from voicemap.models.fast_infer import _xla_block, fast_embed
from voicemap.models.quant_infer import (_quant_block, int8_conv, quant_embed,
                                         quantize_encoder)
from voicemap.utils.profiling import time_fn


def numpy_conv_int32(x: np.ndarray, w: np.ndarray, dilation: int = 1) -> np.ndarray:
    """SAME 1-D conv of int8 (B, T, Cin) by (k, Cin, Cout) in exact int32."""
    k = w.shape[0]
    reach = (k - 1) * dilation
    lo = reach // 2
    xp = np.pad(x.astype(np.int32), ((0, 0), (lo, reach - lo), (0, 0)))
    T = x.shape[1]
    return sum(xp[:, m * dilation:m * dilation + T] @ w[m].astype(np.int32)
               for m in range(k))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="1,8,64,256,2048")
    p.add_argument("--t", type=int, default=12000)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    backend.enable_compile_cache()
    dev = backend.require_gpu()
    print(backend.nvidia_smi_line(), flush=True)
    cfg = EncoderConfig(dropout=0.0)
    cdt = _DTYPES[cfg.compute_dtype]
    v = random_variables(cfg)
    batches = [int(b) for b in args.batches.split(",")]
    bmax = max(batches)
    x = jax.random.normal(jax.random.PRNGKey(1), (bmax, args.t, 1))
    qvars = quantize_encoder(v, cfg, x[:256])

    # 1. exactness of the s8 conv
    r = np.random.default_rng(0)
    xq = r.integers(-127, 128, (4, 250, 128), dtype=np.int8)
    wq = np.asarray(qvars["blocks"][0]["w_q"])
    got = np.asarray(jax.jit(int8_conv)(xq, wq))
    ok = bool(np.array_equal(got, numpy_conv_int32(xq, wq)))
    print(json.dumps({"check": "int8_conv_bit_exact", "ok": ok}), flush=True)

    def report(name, fn, *a, **extra):
        t = time_fn(fn, *a, iters=args.iters)
        print(json.dumps({"bench": name, **extra, "p50_ms": t["p50_s"] * 1e3,
                          "mean_ms": t["mean_s"] * 1e3, "device": dev}), flush=True)

    # 2. blocks 1-3 alone at the largest batch
    params, stats = v["params"], v["batch_stats"]
    h = jax.jit(lambda x: _xla_block(x, params["block_0"], stats["block_0"]["bn"],
                                     cfg.pool_sizes[0], 1, cfg.bn_epsilon, cdt))(x)
    h_q = jnp.clip(jnp.round(h.astype(jnp.float32) / qvars["s0"]), -127, 127
                   ).astype(jnp.int8)
    n = len(cfg.filter_multipliers)

    def mids_bf16(h):
        for i in range(1, n):
            h = _xla_block(h, params[f"block_{i}"], stats[f"block_{i}"]["bn"],
                           cfg.pool_sizes[i], 1, cfg.bn_epsilon, cdt)
        return h.sum(dtype=jnp.float32)

    def mids_int8(h):
        for i in range(1, n):
            h = _quant_block(h, qvars["blocks"][i - 1], cfg.pool_sizes[i],
                             last=i == n - 1, out_dtype=cdt)
        return h.sum(dtype=jnp.float32)

    for name, fn, arg in [("mids_bf16", mids_bf16, h), ("mids_int8", mids_int8, h_q),
                          ("mids_int8", mids_int8, h_q), ("mids_bf16", mids_bf16, h)]:
        report(name, jax.jit(fn), arg, batch=bmax)

    # 3. end to end per batch size, in turns
    bf16 = jax.jit(lambda v, x: fast_embed(v, cfg, x))
    int8 = jax.jit(lambda v, q, x: quant_embed(v, q, cfg, x))
    for b in batches:
        xb = x[:b]
        e_ref = np.asarray(bf16(v, xb))
        e_q = np.asarray(int8(v, qvars, xb))
        cos = (e_ref * e_q).sum(-1) / (np.linalg.norm(e_ref, axis=-1)
                                       * np.linalg.norm(e_q, axis=-1) + 1e-12)
        for mode in ("bf16", "int8", "int8", "bf16"):
            if mode == "bf16":
                report("embed_bf16", bf16, v, xb, batch=b)
            else:
                report("embed_int8", int8, v, qvars, xb, batch=b,
                       min_cosine=float(cos.min()))


if __name__ == "__main__":
    main()
