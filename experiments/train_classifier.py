"""Train the softmax speaker classifier (BASELINE.json config #1).

Rebuild of the reference entry point ``experiments/train_classifier.py``
(SURVEY.md §3.2). The reference used an editable constants block; here every
hyperparameter is an argparse flag over the same defaults.

With no LibriSpeech on disk, ``--synthetic`` generates a LibriSpeech-shaped
synthetic corpus first (see voicemap/data/synthetic.py).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voicemap import config as C


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=["dev-clean"])
    p.add_argument("--val-subsets", nargs="+", default=None,
                   help="held-out eval subsets (reference protocol gates on a "
                        "held-out subset, stochastic=False); default: "
                        "test-clean when available, else falls back to the "
                        "training store with a warning; pass 'none' to gate "
                        "on the training store explicitly (warns)")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--label", default="speaker", choices=["speaker", "sex"])
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--dropout", type=float, default=0.05)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num-steps", type=int, default=2000)
    p.add_argument("--evaluate-every", type=int, default=500)
    p.add_argument("--num-eval-tasks", type=int, default=500)
    p.add_argument("--n-shot", type=int, default=1)
    p.add_argument("--k-way", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-path", default=None)
    p.add_argument("--dilated", action="store_true",
                   help="use the deeper dilated conv stack (BASELINE config #3)")
    p.add_argument("--melspec", action="store_true",
                   help="log-mel frontend + 2D-CNN embedder (BASELINE config #4)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic corpus under --data-root first")
    p.add_argument("--synthetic-speakers", type=int, default=20)
    p.add_argument("--synthetic-utterances", type=int, default=10)
    p.add_argument("--synthetic-container", default="wav", choices=["wav", "flac"])
    p.add_argument("--pipeline", default="auto",
                   choices=["auto", "device", "streaming"],
                   help="device = corpus resident in device memory (fused "
                        "on-device sampling); streaming = prefetched "
                        "host pipeline for corpora larger than device memory; "
                        "auto picks by estimated store size")
    p.add_argument("--dp", default="auto", choices=["auto", "on", "off"],
                   help="data-parallel training over all attached devices "
                        "(auto = on for a multi-device accelerator)")
    p.add_argument("--max-store-seconds", type=float, default=30.0)
    p.add_argument("--profile", default=None,
                   help="trace N eval-interval steps to this TensorBoard logdir")
    args = p.parse_args()
    args.val_subsets = _resolve_val_subsets(args, ["test-clean"])
    return args


def _resolve_val_subsets(args, default):
    """Default held-out subsets only when they exist (or will — --synthetic
    generates them); a corpus without them falls back to training-store eval
    with a note instead of a hard FileNotFoundError. An EXPLICIT
    --val-subsets still fails loudly on a missing subset."""
    if args.val_subsets is None:
        if args.synthetic:
            return list(default)
        from voicemap.data.index import subset_available

        missing = [s for s in default
                   if not subset_available(args.data_root, s)]
        if missing:
            print(f"note: default val subset(s) {missing} not found under "
                  f"{args.data_root} — gating on the training store "
                  "(overstates accuracy; pass --val-subsets for the "
                  "held-out protocol)")
            return None
        return list(default)
    if [s.lower() for s in args.val_subsets] == ["none"]:
        return None
    return args.val_subsets


def main():
    args = parse_args()
    from voicemap import backend

    backend.enable_compile_cache()
    if args.synthetic:
        from voicemap.data import synthetic

        spec = synthetic.SyntheticSpec(
            n_speakers=args.synthetic_speakers,
            utterances_per_speaker=args.synthetic_utterances,
            container=args.synthetic_container,
        )
        subsets = list(args.subsets) + list(args.val_subsets or [])
        synthetic.generate_corpus(args.data_root, subsets=subsets, spec=spec)
        print(f"synthetic corpus written under {args.data_root}")

    if args.dilated:
        enc = C.dilated_4khz().encoder
        import dataclasses

        enc = dataclasses.replace(
            enc, filters=args.filters, embedding_dim=args.embedding_dim,
            dropout=args.dropout, compute_dtype=args.compute_dtype,
        )
    else:
        enc = C.EncoderConfig(
            filters=args.filters,
            embedding_dim=args.embedding_dim,
            dropout=args.dropout,
            compute_dtype=args.compute_dtype,
        )

    mode = "melspec2d" if args.melspec else "classifier"
    mel = C.MelConfig()
    cfg = C.ExperimentConfig(
        name=mode,
        mode=mode,
        mel=mel,
        data=C.DataConfig(
            data_root=args.data_root,
            subsets=tuple(args.subsets),
            val_subsets=tuple(args.val_subsets) if args.val_subsets else None,
            seconds=args.seconds,
            downsampling=1 if args.melspec else args.downsampling,
            label=args.label,
        ),
        encoder=enc,
        train=C.TrainConfig(
            batch_size=args.batch_size,
            learning_rate=args.lr,
            num_steps=args.num_steps,
            evaluate_every=args.evaluate_every,
            num_eval_tasks=args.num_eval_tasks,
            n_shot=args.n_shot,
            k_way=args.k_way,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
            log_path=args.log_path
            or os.path.join("logs", "classifier", "metrics.jsonl"),
        ),
    )
    print(f"experiment: {cfg.artifact_name()}")

    from voicemap.train.loop import fit

    if args.profile:
        import jax

        with jax.profiler.trace(args.profile):
            state, history = fit(cfg, max_store_seconds=args.max_store_seconds,
                                 dp=args.dp, pipeline=args.pipeline)
    else:
        state, history = fit(cfg, max_store_seconds=args.max_store_seconds,
                             dp=args.dp, pipeline=args.pipeline)
    if history:
        print("final:", history[-1])


if __name__ == "__main__":
    main()
