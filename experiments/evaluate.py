"""Standalone n-shot k-way speaker-identification evaluation.

Rebuild of the reference's evaluation protocol (reference:
``voicemap/utils.py :: n_shot_task_evaluation`` — 500 sequential Python
tasks) as a batched entry point: restore a checkpoint (or evaluate a random
init), embed the whole subset once, score every task in one compiled call.
Reports accuracy with the Monte-Carlo stderr (SURVEY.md §7 hard part #5).
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voicemap import config as C


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=["dev-clean"])
    p.add_argument("--mode", default="classifier",
                   choices=["classifier", "siamese", "melspec2d"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="restore best (or latest) state from this dir")
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--distance-metric", default="uniform_euclidean")
    p.add_argument("--num-tasks", type=int, default=500)
    p.add_argument("--n-shot", type=int, default=1)
    p.add_argument("--k-way", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--max-store-seconds", type=float, default=30.0)
    p.add_argument("--fast", action="store_true",
                   help="embed with the serving forward (models/fast_infer.py)")
    p.add_argument("--int8", action="store_true",
                   help="embed through the int8 PTQ serving path (blocks 1+ "
                        "s8×s8→s32, calibrated on the eval store) — the "
                        "deployment accuracy-parity run; melspec2d runs the "
                        "full conv2d stack in int8 — models/quant_infer.py)")
    p.add_argument("--qvars", default=None, metavar="PATH",
                   help="load a saved int8 artifact (experiments/embed.py "
                        "--save-qvars) instead of calibrating; evaluates the "
                        "EXACT deployed quantization (implies --int8; ad-hoc "
                        "path only, not --protocol)")
    p.add_argument("--k-sweep", type=int, nargs=2, default=None,
                   metavar=("KMIN", "KMAX"),
                   help="sweep k-way over [KMIN, KMAX] from ONE embedding "
                        "table (the reference README's accuracy-vs-k results "
                        "figure); writes <sweep-out>.json + <sweep-out>.png "
                        "and prints one JSON line per point")
    p.add_argument("--sweep-n-shots", type=int, nargs="+", default=[1, 5],
                   help="n-shot curves to draw in the k sweep")
    p.add_argument("--sweep-out", default="accuracy_vs_k",
                   help="artifact path prefix for --k-sweep")
    p.add_argument("--verification", type=int, default=None, metavar="N",
                   help="also report threshold-free verification metrics "
                        "(EER / AUC) over N balanced same/different pairs "
                        "(siamese scoring policy; any mode embeds)")
    p.add_argument("--protocol", action="store_true",
                   help="run the frozen EVAL_PROTOCOL.json manifest (pinned "
                        "seeds/subsets/fragments, corpus-identity check, "
                        "JSON output) — the reference-parity command")
    p.add_argument("--allow-corpus-mismatch", action="store_true",
                   help="with --protocol: run anyway on a corpus that fails "
                        "the manifest identity check; results are marked "
                        "non-comparable")
    p.add_argument("--int8-gate", action="store_true",
                   help="with --protocol: run every entry twice (full "
                        "precision AND int8 serving) and z-test decision "
                        "agreement per metric — the deployment fidelity "
                        "statement; emits {int8_accuracy_gate: pass|fail} "
                        "with per-entry CI fields and exits non-zero on fail")
    return p.parse_args()


# Fixed-order categorical hues (validated: CVD-safe on the light surface) —
# one per n-shot curve; chance sits on a neutral dashed line, never a hue.
_SERIES_COLORS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]


def plot_sweep(results, out_png, subsets):
    """Accuracy-vs-k line figure (the reference README's results plot)."""
    from voicemap.utils.plotting import pyplot

    plt = pyplot()

    by_n = {}
    for r in results:
        if "accuracy" in r:
            by_n.setdefault(r["n_shot"], []).append(r)
    fig, ax = plt.subplots(figsize=(7, 4.5), dpi=150)
    fig.patch.set_facecolor("#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    ks_all = sorted({r["k_way"] for r in results})
    ax.plot(ks_all, [1.0 / k for k in ks_all], ls="--", lw=1.5,
            color="#52514e", label="chance (1/k)")
    for i, (n, pts) in enumerate(sorted(by_n.items())):
        pts = sorted(pts, key=lambda r: r["k_way"])
        ks = [r["k_way"] for r in pts]
        acc = [r["accuracy"] for r in pts]
        se = [r["stderr"] for r in pts]
        c = _SERIES_COLORS[i % len(_SERIES_COLORS)]
        ax.plot(ks, acc, lw=2, color=c, marker="o", ms=4,
                label=f"{n}-shot")
        ax.fill_between(ks, [a - 1.96 * s for a, s in zip(acc, se)],
                        [a + 1.96 * s for a, s in zip(acc, se)],
                        color=c, alpha=0.15, lw=0)
    ax.set_xlabel("k-way (speakers per task)", color="#0b0b0b")
    ax.set_ylabel("accuracy", color="#0b0b0b")
    ax.set_title(f"n-shot speaker ID accuracy vs k — {', '.join(subsets)}",
                 color="#0b0b0b", fontsize=11)
    ax.set_ylim(0.0, 1.02)
    from matplotlib.ticker import MaxNLocator

    ax.xaxis.set_major_locator(MaxNLocator(integer=True))
    ax.grid(True, color="#e6e5e1", lw=0.6)
    for spine in ax.spines.values():
        spine.set_color("#c3c2b7")
    ax.tick_params(colors="#52514e")
    ax.legend(frameon=False, loc="lower left")
    fig.tight_layout()
    fig.savefig(out_png, facecolor=fig.get_facecolor())
    plt.close(fig)


def main():
    args = parse_args()
    from voicemap import backend

    backend.enable_compile_cache()
    import jax

    from voicemap.data.dataset import dataset_from_config
    from voicemap.eval import nshot
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import build_model, init_model_state

    cfg = C.ExperimentConfig(
        mode=args.mode,
        data=C.DataConfig(
            data_root=args.data_root,
            subsets=tuple(args.subsets),
            seconds=args.seconds,
            downsampling=args.downsampling,
            stochastic=False,
        ),
        encoder=C.EncoderConfig(
            filters=args.filters,
            embedding_dim=args.embedding_dim,
            compute_dtype=args.compute_dtype,
        ),
        siamese=C.SiameseConfig(distance_metric=args.distance_metric),
        train=C.TrainConfig(
            num_eval_tasks=args.num_tasks, n_shot=args.n_shot, k_way=args.k_way,
        ),
    )
    ds = dataset_from_config(cfg.data)  # index only — no decode yet
    num_classes = ds.num_classes()

    mgr = None
    if args.checkpoint_dir:
        from voicemap.train.checkpoints import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir)
        num_classes = mgr.template_num_classes(args.which, num_classes)

    model = build_model(cfg, num_classes=num_classes)
    state = init_model_state(model, cfg)

    if mgr is not None:
        restored = (
            mgr.restore_best(state) if args.which == "best"
            else mgr.restore_latest(state)
        )
        if restored is None:
            raise SystemExit(f"no {args.which} checkpoint under {args.checkpoint_dir}")
        state = restored
        print(f"restored {args.which} checkpoint at step {int(state.step)}")
    else:
        print("WARNING: evaluating an untrained (random-init) model")

    # --int8 supports all three modes: blocks 1+ for the raw-waveform
    # encoders, the full conv2d stack for melspec2d (quant_embed_mel).
    if args.qvars and args.protocol:
        raise SystemExit(
            "--qvars is for the ad-hoc path; --protocol --int8 calibrates "
            "per manifest entry on that entry's store"
        )

    if args.int8_gate and not args.protocol:
        raise SystemExit("--int8-gate requires --protocol (the gate is a "
                         "statement about the frozen manifest entries)")

    if args.protocol:
        import json

        from voicemap.eval import protocol

        if args.k_sweep:
            raise SystemExit(
                "--protocol runs the manifest's pinned (n, k) entries; "
                "--k-sweep is the ad-hoc path — drop one of the two"
            )
        if args.int8_gate:
            verdict = protocol.int8_accuracy_gate(
                model, state, args.data_root, cfg,
                allow_corpus_mismatch=args.allow_corpus_mismatch,
                max_store_seconds=args.max_store_seconds, fast=args.fast,
            )
            print(json.dumps(verdict))
            if verdict["int8_accuracy_gate"] != "pass":
                raise SystemExit(2)
            return
        # One cache for both passes: corpus decode, device stores, and int8
        # calibration are shared between the accuracy and EER/AUC entries.
        store_cache = {}
        results = protocol.run_protocol(
            model, state, args.data_root, cfg,
            allow_corpus_mismatch=args.allow_corpus_mismatch,
            max_store_seconds=args.max_store_seconds, fast=args.fast,
            int8=args.int8, store_cache=store_cache,
        )
        # Protocol v2: the manifest also pins verification (EER/AUC) entries.
        results += protocol.run_verification_protocol(
            model, state, args.data_root, cfg,
            allow_corpus_mismatch=args.allow_corpus_mismatch,
            max_store_seconds=args.max_store_seconds, fast=args.fast,
            int8=args.int8, store_cache=store_cache,
        )
        for r in results:
            print(json.dumps(r))
        return

    # Decode + ship the corpus only for the ad-hoc path (run_protocol builds
    # its own per-entry stores with the manifest's pinned fragment settings).
    store = steps_mod.device_store_for(cfg, ds.to_store(args.max_store_seconds))
    qvars = None
    if args.qvars:
        from voicemap.models.quant_infer import load_qvars

        qvars = load_qvars(args.qvars)
        print(f"int8 serving path: loaded artifact {args.qvars}")
    elif args.int8:
        from voicemap.models.quant_infer import quantize_from_store

        qvars = quantize_from_store(state, cfg, store)
        print("int8 serving path: calibrated on the eval store")
    if args.k_sweep:
        import json

        kmin, kmax = args.k_sweep
        if kmin < 2 or kmax < kmin:
            raise SystemExit("--k-sweep needs 2 <= KMIN <= KMAX")
        results = nshot.evaluate_sweep(
            model, state, store, cfg, jax.random.PRNGKey(args.seed),
            n_shots=args.sweep_n_shots, k_values=range(kmin, kmax + 1),
            num_tasks=args.num_tasks, fast=args.fast, qvars=qvars,
        )
        for r in results:
            print(json.dumps(r))
        meta = {
            "subsets": args.subsets, "mode": args.mode,
            "checkpoint_dir": args.checkpoint_dir,
            "num_tasks": args.num_tasks, "seed": args.seed,
            "int8": bool(qvars is not None), "points": results,
        }
        with open(args.sweep_out + ".json", "w") as f:
            json.dump(meta, f, indent=1)
        plot_sweep(results, args.sweep_out + ".png", args.subsets)
        print(f"wrote {args.sweep_out}.json and {args.sweep_out}.png")
    else:
        acc = nshot.evaluate(
            model, state, store, cfg, jax.random.PRNGKey(args.seed),
            num_tasks=args.num_tasks, n=args.n_shot, k=args.k_way,
            fast=args.fast, qvars=qvars,
        )
        stderr = math.sqrt(max(acc * (1 - acc), 1e-12) / args.num_tasks)
        print(
            f"{args.n_shot}-shot {args.k_way}-way accuracy over "
            f"{args.num_tasks} tasks on {args.subsets}: "
            f"{acc:.4f} ± {stderr:.4f} (1σ)"
        )
    # --verification composes with both the single-point and --k-sweep paths
    # (the sweep reuses the store; EER/AUC embeds its own table).
    if args.verification:
        from voicemap.eval.verification import evaluate_verification

        v = evaluate_verification(
            model, state, store, cfg, jax.random.PRNGKey(args.seed + 1),
            num_pairs=args.verification, fast=args.fast, qvars=qvars,
        )
        print(
            f"verification over {v['num_pairs']} pairs: EER {v['eer']:.4f} "
            f"(threshold {v['eer_threshold']:.4f}), AUC {v['auc']:.4f}"
        )


if __name__ == "__main__":
    main()
