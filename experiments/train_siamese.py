"""Train the siamese verification network (BASELINE.json config #2).

Rebuild of the reference entry point ``experiments/train_siamese_net.py``
(SURVEY.md §3.1): siamese 1D-conv net on same/different speaker pairs,
binary cross-entropy (or Hadsell contrastive) loss, periodic n-shot k-way
evaluation gating checkpoints and the LR plateau schedule.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voicemap import config as C


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=["train-clean-100"])
    p.add_argument("--val-subsets", nargs="+", default=None,
                   help="held-out eval subsets (reference protocol: dev-clean, "
                        "stochastic=False); default: dev-clean when "
                        "available, else falls back to the training store "
                        "with a warning; pass 'none' to gate on the training "
                        "store explicitly (warns)")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--distance-metric", default="uniform_euclidean",
                   choices=["uniform_euclidean", "weighted_l1", "uniform_l1",
                            "dot_product", "cosine_distance"])
    p.add_argument("--loss", default="bce", choices=["bce", "contrastive"])
    p.add_argument("--contrastive-margin", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num-steps", type=int, default=5000)
    p.add_argument("--evaluate-every", type=int, default=500)
    p.add_argument("--num-eval-tasks", type=int, default=500)
    p.add_argument("--n-shot", type=int, default=1)
    p.add_argument("--k-way", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-path", default=None)
    p.add_argument("--synthetic", action="store_true")
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
    p.add_argument("--profile", default=None)
    args = p.parse_args()
    from experiments.train_classifier import _resolve_val_subsets

    args.val_subsets = _resolve_val_subsets(args, ["dev-clean"])
    return args


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

    cfg = C.ExperimentConfig(
        name="siamese",
        mode="siamese",
        data=C.DataConfig(
            data_root=args.data_root,
            subsets=tuple(args.subsets),
            val_subsets=tuple(args.val_subsets) if args.val_subsets else None,
            seconds=args.seconds,
            downsampling=args.downsampling,
        ),
        encoder=C.EncoderConfig(
            filters=args.filters,
            embedding_dim=args.embedding_dim,
            dropout=args.dropout,
            compute_dtype=args.compute_dtype,
        ),
        siamese=C.SiameseConfig(distance_metric=args.distance_metric),
        train=C.TrainConfig(
            batch_size=args.batch_size,
            learning_rate=args.lr,
            num_steps=args.num_steps,
            loss=args.loss,
            contrastive_margin=args.contrastive_margin,
            evaluate_every=args.evaluate_every,
            num_eval_tasks=args.num_eval_tasks,
            n_shot=args.n_shot,
            k_way=args.k_way,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
            log_path=args.log_path or os.path.join("logs", "siamese", "metrics.jsonl"),
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
