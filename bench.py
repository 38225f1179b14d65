"""Headline benchmark: utterances/sec for the on-device embed pipeline.

Measures the BASELINE.json primary metric — throughput of (on-device
fragment-gather → stride-decimate → whiten → conv1d encoder → 64-d embedding)
over 3 s @ 16 kHz utterances — on the GPU (it refuses to run elsewhere),
prints the card's name and power limit, and then ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

``vs_baseline`` is measured against the CPU reference-pipeline baseline
recorded in BASELINE.md (measure/refresh it with ``python bench.py
--cpu-baseline``: host-numpy preprocessing + the same encoder on the CPU
backend at the reference's batch 32 — the rebuild of the reference's
Keras-CPU data path). North star: ≥50× (BASELINE.json).
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np


SECONDS = 3.0
SR = 16000
DOWNSAMPLING = 4
FRAG = int(SECONDS * SR)
STORE_T = FRAG + 8000  # slack so offsets exercise the dynamic-slice path

# CPU reference-pipeline baseline lives in a measurement record with its
# provenance (value + date + command + config fingerprint), written by
# `python bench.py --cpu-baseline`. The record is refused when the benched
# configuration changes, so vs_baseline can't silently go stale.
_HERE = os.path.dirname(os.path.abspath(__file__))
CPU_BASELINE_PATH = os.path.join(_HERE, "benchmarks", "cpu_baseline.json")
_BASELINE_BATCH = 32
_BASELINE_ITERS = 10


def _config_fingerprint() -> str:
    """Hash of everything that defines what both bench sides measure."""
    spec = (
        f"seconds={SECONDS};sr={SR};ds={DOWNSAMPLING};frag={FRAG};"
        f"store_t={STORE_T};encoder=filters128,embed64;"
        f"baseline_batch={_BASELINE_BATCH};baseline_iters={_BASELINE_ITERS}"
    )
    return hashlib.sha256(spec.encode()).hexdigest()[:16]


def write_cpu_baseline(utt_per_sec: float) -> None:
    os.makedirs(os.path.dirname(CPU_BASELINE_PATH), exist_ok=True)
    with open(CPU_BASELINE_PATH, "w") as f:
        json.dump(
            {
                "utt_per_sec": round(utt_per_sec, 2),
                "unit": "utterances/sec",
                "date": time.strftime("%Y-%m-%d %H:%M:%S"),
                "command": "python bench.py --cpu-baseline",
                "batch": _BASELINE_BATCH,
                "iters": _BASELINE_ITERS,
                "fingerprint": _config_fingerprint(),
            },
            f,
            indent=2,
        )
        f.write("\n")


def load_cpu_baseline() -> float:
    """The recorded CPU baseline; re-measures (subprocess, CPU backend) when
    no record exists; refuses a record whose config fingerprint is stale."""
    if not os.path.exists(CPU_BASELINE_PATH):
        print("# no CPU baseline record; measuring one now …", file=sys.stderr)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cpu-baseline"],
            env=env, cwd=_HERE, check=True, stdout=subprocess.DEVNULL,
        )
    with open(CPU_BASELINE_PATH) as f:
        rec = json.load(f)
    if rec.get("fingerprint") != _config_fingerprint():
        raise SystemExit(
            f"CPU baseline record {CPU_BASELINE_PATH} was measured under a "
            "different bench configuration (fingerprint mismatch); refresh "
            "it with: JAX_PLATFORMS=cpu python bench.py --cpu-baseline"
        )
    return float(rec["utt_per_sec"])


def make_model_and_params(compute_dtype: str):
    import jax

    from voicemap.config import EncoderConfig
    from voicemap.models.encoder import ConvEncoder

    cfg = EncoderConfig(filters=128, embedding_dim=64, dropout=0.0,
                        compute_dtype=compute_dtype)
    model = ConvEncoder(cfg)
    variables = model.init(jax.random.PRNGKey(0))
    return model, variables


# The int8 path is faithful when its embeddings match bf16 to this
# min-cosine on a held-out batch (disjoint store rows, fresh offsets). 0.999
# leaves the n-shot nearest-neighbor decisions bit-identical in every
# measured run (tests/test_quant_infer.py).
INT8_FIDELITY_GATE = 0.999


def int8_fidelity(variables, cfg, store, offsets, n_cal: int, seed: int = 1):
    """Calibrate on store rows [0, n_cal) and return (qvars, min cosine of
    int8 vs bf16 embeddings on the disjoint rows [n_cal, 2·n_cal) with fresh
    offsets) — measuring on the calibration rows would hide clipping."""
    import jax
    import jax.numpy as jnp

    from voicemap.models.fast_infer import fast_embed
    from voicemap.models.quant_infer import quant_embed, quantize_encoder
    from voicemap.ops import preprocess

    rng = np.random.default_rng(seed)
    x_cal = preprocess.preprocess_batch(store[:n_cal], offsets[:n_cal], FRAG,
                                        DOWNSAMPLING)
    qvars = quantize_encoder(variables, cfg, x_cal)
    off_fid = jnp.asarray(rng.integers(0, STORE_T - FRAG, (n_cal,), dtype=np.int32))
    x_fid = preprocess.preprocess_batch(store[n_cal:2 * n_cal], off_fid, FRAG,
                                        DOWNSAMPLING)
    ref = np.asarray(jax.jit(lambda x: fast_embed(variables, cfg, x))(x_fid),
                     np.float64)
    out = np.asarray(jax.jit(lambda x: quant_embed(variables, qvars, cfg, x))(x_fid),
                     np.float64)
    cos = (ref * out).sum(-1) / (np.linalg.norm(ref, axis=-1)
                                 * np.linalg.norm(out, axis=-1) + 1e-12)
    return qvars, float(cos.min())


def bench_device(batch_size: int = 2048, iters: int = 20, warmup: int = 5,
                 int8: bool = False) -> dict:
    """On-device pipeline throughput on the GPU: preprocessing
    (``ops/preprocess.py``) + the serving forward (``models/fast_infer.py``;
    ``models/quant_infer.py`` when int8 serves).

    ``int8``: serve through ``models/quant_infer.py`` instead of bf16 (not
    the default: slower than bf16 on the H100, see PERF.md); its min cosine
    vs bf16 on held-out rows is measured and reported against
    INT8_FIDELITY_GATE.
    """
    import jax
    import jax.numpy as jnp

    from voicemap import backend
    from voicemap.models.fast_infer import fast_embed
    from voicemap.models.quant_infer import quant_embed
    from voicemap.ops import preprocess
    from voicemap.utils import profiling

    device = backend.require_gpu()
    model, variables = make_model_and_params("bfloat16")
    cfg = model.cfg
    rng = np.random.default_rng(0)
    store = jnp.asarray(
        rng.integers(-20000, 20000, size=(batch_size, STORE_T), dtype=np.int16)
    )
    offsets = jnp.asarray(rng.integers(0, STORE_T - FRAG, size=(batch_size,), dtype=np.int32))

    qvars, fidelity, gate = None, None, None
    if int8:
        if batch_size < 2:
            raise SystemExit("--int8 needs --batch-size >= 2 (calibration "
                             "rows + disjoint held-out fidelity rows)")
        qvars, fidelity = int8_fidelity(variables, cfg, store, offsets,
                                        max(1, min(256, batch_size // 2)))
        gate = "pass" if fidelity >= INT8_FIDELITY_GATE else "fail"
        if gate == "fail":
            print(f"# int8 fidelity gate FAILED: min cosine {fidelity:.5f} < "
                  f"{INT8_FIDELITY_GATE}", file=sys.stderr)

    def forward(x):
        if int8:
            return quant_embed(variables, qvars, cfg, x)
        return fast_embed(variables, cfg, x)

    @jax.jit
    def embed(store, offsets):
        return forward(preprocess.preprocess_batch(store, offsets, FRAG, DOWNSAMPLING))

    @jax.jit
    def embed_one(store, offsets):
        x = preprocess.preprocess_batch(store, offsets, FRAG, DOWNSAMPLING)
        return fast_embed(variables, cfg, x)  # batch 1 serves bf16

    tp = profiling.throughput(embed, store, offsets, items_per_call=batch_size,
                              iters=iters, warmup=warmup)
    lat = profiling.time_fn(embed_one, store[:1], offsets[:1], iters=200)
    single = profiling.single_request_latency(embed_one, store[:1], offsets[:1],
                                              samples=50)
    return {"utt_per_sec": tp["items_per_sec"],
            "batch1_device_ms": lat["p50_s"] * 1e3,
            "single_request_p50_ms": single["p50_s"] * 1e3,
            "single_request_p95_ms": single["p95_s"] * 1e3,
            "batch": batch_size, "device": device,
            "int8": int8, "fidelity_gate": gate,
            "int8_min_cosine_vs_bf16": fidelity}


def bench_cpu_baseline(batch_size: int = 32, iters: int = 10) -> dict:
    """Reference-style CPU pipeline: host-numpy preprocess + CPU conv fwd."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    model, variables = make_model_and_params("float32")
    rng = np.random.default_rng(0)
    raw = rng.integers(-20000, 20000, size=(batch_size, STORE_T), dtype=np.int16)

    def host_preprocess(raw):
        offs = rng.integers(0, STORE_T - FRAG, size=(batch_size,))
        frags = np.stack([raw[i, o: o + FRAG] for i, o in enumerate(offs)])
        x = frags.astype(np.float32) / 32768.0
        x = x[:, ::DOWNSAMPLING]
        mean = x.mean(axis=1, keepdims=True)
        x = x - mean
        rms = np.sqrt((x ** 2).mean(axis=1, keepdims=True))
        x = x * (0.038021 / (rms + 1e-8))
        return x[..., None]

    fwd = jax.jit(lambda x: model.apply(variables, x))
    jax.block_until_ready(fwd(jnp.asarray(host_preprocess(raw))))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fwd(jnp.asarray(host_preprocess(raw)))
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return {"utt_per_sec": batch_size * iters / dt, "batch": batch_size}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu-baseline", action="store_true",
                   help="measure the CPU reference-pipeline baseline instead")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 PTQ path instead of bf16 (reports "
                        "its min cosine vs bf16 against the %.3f gate)"
                        % INT8_FIDELITY_GATE)
    args = p.parse_args()

    if args.cpu_baseline:
        r = bench_cpu_baseline(args.batch_size or _BASELINE_BATCH,
                               args.iters or _BASELINE_ITERS)
        if (args.batch_size or _BASELINE_BATCH) == _BASELINE_BATCH and (
            args.iters or _BASELINE_ITERS
        ) == _BASELINE_ITERS:
            write_cpu_baseline(r["utt_per_sec"])
        print(json.dumps({"metric": "cpu_baseline_utterances_per_sec",
                          "value": round(r["utt_per_sec"], 2),
                          "unit": "utterances/sec",
                          "vs_baseline": 1.0}))
        return

    # The CPU baseline child (if one must be measured) runs before this
    # process touches the GPU.
    baseline = load_cpu_baseline()
    from voicemap import backend

    backend.enable_compile_cache()
    print(backend.nvidia_smi_line(), file=sys.stderr)
    r = bench_device(args.batch_size or 2048, args.iters or 20, int8=args.int8)
    out = {
        "metric": "utterances_per_sec",
        "value": r["utt_per_sec"],
        "unit": "utterances/sec (3s @ 16kHz, embed pipeline)",
        "vs_baseline": r["utt_per_sec"] / baseline,
        "int8": r["int8"],
        "device": r["device"],
    }
    if r["fidelity_gate"] is not None:
        out["fidelity_gate"] = r["fidelity_gate"]
        out["int8_min_cosine_vs_bf16"] = r["int8_min_cosine_vs_bf16"]
    print(
        f"# batch-1 embed (bf16): device p50 {r['batch1_device_ms']:.3f} ms | "
        f"single-request p50 {r['single_request_p50_ms']:.3f} ms / p95 "
        f"{r['single_request_p95_ms']:.3f} ms (dispatch → result on the host)",
        file=sys.stderr,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
