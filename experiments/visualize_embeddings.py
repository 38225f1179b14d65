"""Embedding-space visualization (the rebuild of the reference's analysis
notebooks — SURVEY.md §2.1 "Analysis notebooks": dimensionality reduction of
utterance embeddings, speaker clusters).

Embeds every utterance of a subset with a trained (or random-init) model,
projects to 2-D with PCA, and writes a speaker-colored scatter PNG + the raw
embeddings as .npz for further analysis.
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
    p.add_argument("--mode", default="classifier",
                   choices=["classifier", "siamese", "melspec2d"])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--out", default="embeddings")
    p.add_argument("--max-store-seconds", type=float, default=30.0)
    return p.parse_args()


def main():
    args = parse_args()
    from voicemap import backend

    backend.enable_compile_cache()
    import numpy as np

    from voicemap.data.dataset import dataset_from_config
    from voicemap.eval import nshot
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import build_model, init_model_state

    cfg = C.ExperimentConfig(
        mode=args.mode,
        data=C.DataConfig(
            data_root=args.data_root, subsets=tuple(args.subsets),
            seconds=args.seconds, downsampling=args.downsampling,
            stochastic=False,
        ),
        encoder=C.EncoderConfig(filters=args.filters,
                                embedding_dim=args.embedding_dim),
    )
    ds = dataset_from_config(cfg.data)
    store = steps_mod.device_store_for(cfg, ds.to_store(args.max_store_seconds))
    model = build_model(cfg, num_classes=ds.num_classes())
    state = init_model_state(model, cfg)
    if args.checkpoint_dir:
        from voicemap.train.checkpoints import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir)
        restored = (mgr.restore_best(state) if args.which == "best"
                    else mgr.restore_latest(state))
        if restored is not None:
            state = restored
            print(f"restored step {int(state.step)}")

    table = np.asarray(nshot.embed_all(model, state, store, cfg))
    labels = np.asarray(store.labels)

    # PCA to 2-D (numpy SVD — no sklearn dependency).
    centered = table - table.mean(axis=0, keepdims=True)
    _u, _s, vt = np.linalg.svd(centered, full_matrices=False)
    proj = centered @ vt[:2].T

    np.savez(f"{args.out}.npz", embeddings=table, labels=labels, pca2d=proj)
    from voicemap.utils.plotting import pyplot

    plt = pyplot()

    plt.figure(figsize=(8, 7))
    cmap = plt.cm.tab20
    for s in np.unique(labels):
        pts = proj[labels == s]
        plt.scatter(pts[:, 0], pts[:, 1], s=14, color=cmap(int(s) % 20),
                    label=str(ds.unique_speakers[int(s)]) if len(np.unique(labels)) <= 20 else None)
    if len(np.unique(labels)) <= 20:
        plt.legend(title="speaker", fontsize=7, markerscale=1.2)
    plt.title(f"Utterance embeddings (PCA) — {', '.join(args.subsets)}")
    plt.tight_layout()
    plt.savefig(f"{args.out}.png", dpi=140)
    print(f"wrote {args.out}.png and {args.out}.npz "
          f"({table.shape[0]} utterances, {ds.num_speakers} speakers)")


if __name__ == "__main__":
    main()
