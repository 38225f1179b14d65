"""Batch-embed audio files to a .npz of speaker embeddings (serving entry).

The inference-side counterpart of the training CLIs: point it at audio files
(or a whole indexed subset) and it writes ``embeddings`` (N, D) float32 +
``paths`` to an .npz, running the full production on-device pipeline —
gather → stride-decimate → whiten → conv encoder. The reference had no such tool (embeddings were pulled ad hoc inside
``voicemap/utils.py :: n_shot_task_evaluation`` and the analysis notebooks);
this makes the embedding function a first-class product surface.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voicemap import config as C


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("files", nargs="*",
                   help="audio files (.wav/.flac); or use --subsets")
    p.add_argument("--data-root", default=C.DATA_PATH)
    p.add_argument("--subsets", nargs="+", default=None,
                   help="embed every utterance of these indexed subsets "
                        "instead of explicit files")
    p.add_argument("--mode", default="classifier",
                   choices=["classifier", "siamese", "melspec2d"])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--downsampling", type=int, default=4)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--out", default="embeddings.npz")
    p.add_argument("--max-store-seconds", type=float, default=30.0)
    p.add_argument("--pipeline", default="auto",
                   choices=["auto", "device", "streaming"],
                   help="device = ship the corpus to HBM once (fastest); "
                        "streaming = corpus-order batches decoded on the "
                        "host, for corpora larger than HBM; auto picks by "
                        "estimated store size")
    p.add_argument("--int8", action="store_true",
                   help="serve blocks 1+ of the encoder int8-quantized "
                        "(post-training, calibrated on the first batch; "
                        "all modes — see models/quant_infer.py)")
    p.add_argument("--save-qvars", default=None, metavar="PATH",
                   help="persist the calibrated int8 artifact (.npz) for "
                        "calibration-free serving (implies --int8)")
    p.add_argument("--qvars", default=None, metavar="PATH",
                   help="load a saved int8 artifact instead of calibrating "
                        "(implies --int8)")
    return p.parse_args()


def _store_from_files(paths, cfg):
    """Build an in-memory AudioStore from explicit audio files."""
    import numpy as np

    from voicemap.data import audio
    from voicemap.data.dataset import AudioStore

    frag = cfg.data.fragment_length
    waves = []
    for p in paths:
        if p.endswith(".flac"):
            from voicemap.data import flac_ext

            data, sr = flac_ext.read(p)
        else:
            data, sr = audio.read_wav(p)
        if sr != cfg.data.sample_rate:
            raise SystemExit(
                f"{p}: sample rate {sr} != configured {cfg.data.sample_rate}"
            )
        if data.shape[0] < frag:
            data = np.pad(data, (0, frag - data.shape[0]))
        waves.append(data)
    t_store = max(w.shape[0] for w in waves)
    audio_arr = np.zeros((len(waves), t_store), np.int16)
    lengths = np.empty((len(waves),), np.int32)
    for i, w in enumerate(waves):
        audio_arr[i, : w.shape[0]] = w
        lengths[i] = w.shape[0]
    n = len(waves)
    return AudioStore(
        audio=audio_arr,
        lengths=lengths,
        labels=np.zeros((n,), np.int32),
        speaker_utts=np.arange(n, dtype=np.int32)[None, :],
        speaker_counts=np.asarray([n], np.int32),
        sample_rate=cfg.data.sample_rate,
        label_names=[0],
    )


def main():
    args = parse_args()
    from voicemap import backend

    backend.enable_compile_cache()
    if not args.files and not args.subsets:
        raise SystemExit("give audio files or --subsets")
    import numpy as np

    from voicemap.eval import nshot
    from voicemap.train import steps as steps_mod
    from voicemap.train.loop import build_model, init_model_state

    cfg = C.ExperimentConfig(
        mode=args.mode,
        data=C.DataConfig(
            data_root=args.data_root,
            subsets=tuple(args.subsets or ("dev-clean",)),
            seconds=args.seconds,
            downsampling=1 if args.mode == "melspec2d" else args.downsampling,
            stochastic=False,
        ),
        encoder=C.EncoderConfig(
            filters=args.filters, embedding_dim=args.embedding_dim,
            compute_dtype=args.compute_dtype,
        ),
    )
    ds = None
    if args.subsets:
        from voicemap.data.dataset import (
            STREAMING_THRESHOLD_BYTES,
            dataset_from_config,
            estimate_store_bytes,
        )

        ds = dataset_from_config(cfg.data)  # index only — decode depends on pipeline
        paths = [os.path.join(args.data_root, f) for f in ds.df.filepath]
        num_classes = ds.num_classes()
        pipeline = args.pipeline
        if pipeline == "auto":
            est = estimate_store_bytes(ds, args.max_store_seconds,
                                       cfg.data.sample_rate)
            pipeline = ("streaming" if est > STREAMING_THRESHOLD_BYTES
                        else "device")
            if pipeline == "streaming":
                print(f"pipeline=auto → streaming (est. store {est/1e9:.2f} GB)")
    else:
        if args.pipeline == "streaming":
            raise SystemExit(
                "--pipeline streaming needs --subsets (explicit files build "
                "an in-memory store and always embed device-resident)"
            )
        pipeline = "device"  # explicit files: always small enough
        paths = list(args.files)
        num_classes = 2  # head size is irrelevant for embeddings

    store = None
    if pipeline == "device":
        host = (ds.to_store(args.max_store_seconds) if ds is not None
                else _store_from_files(args.files, cfg))
        store = steps_mod.device_store_for(cfg, host)

    mgr = None
    if args.checkpoint_dir:
        from voicemap.train.checkpoints import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir)
        num_classes = mgr.template_num_classes(args.which, num_classes)

    model = build_model(cfg, num_classes=num_classes)
    state = init_model_state(model, cfg)
    if mgr is not None:
        restored = (mgr.restore_best(state) if args.which == "best"
                    else mgr.restore_latest(state))
        if restored is None:
            raise SystemExit(f"no {args.which} checkpoint under {args.checkpoint_dir}")
        state = restored
        print(f"restored {args.which} checkpoint at step {int(state.step)}")
    else:
        print("WARNING: embedding with an untrained (random-init) model")

    qvars = None
    if args.int8 or args.qvars or args.save_qvars:
        from voicemap.models.quant_infer import (
            load_qvars, quantize_from_store, save_qvars,
        )

        if args.qvars:
            qvars = load_qvars(args.qvars)
            print(f"int8 serving path: loaded artifact {args.qvars}")
        elif store is not None:
            qvars = quantize_from_store(state, cfg, store,
                                        n_cal=args.batch_size)
            print("int8 serving path: calibrated on the first "
                  f"{min(args.batch_size, int(store.labels.shape[0]))} "
                  "utterances")
        else:  # streaming: calibrate on the first corpus-order batch
            from voicemap.data.pipeline import iter_embed_batches
            from voicemap.models.quant_infer import quantize_from_frags

            frags, count = next(iter_embed_batches(ds, cfg, args.batch_size))
            qvars = quantize_from_frags(state, cfg, frags[:count])
            print(f"int8 serving path: calibrated on the first {count} "
                  "utterances (streamed)")
        if args.save_qvars:
            save_qvars(args.save_qvars, qvars)
            print(f"wrote int8 artifact {args.save_qvars}")

    if store is not None:
        table = np.asarray(
            nshot.embed_all(model, state, store, cfg,
                            batch_size=args.batch_size, qvars=qvars)
        )
    else:
        table = np.asarray(
            nshot.embed_all_streaming(model, state, cfg, ds,
                                      batch_size=args.batch_size, qvars=qvars)
        )
    np.savez(args.out, embeddings=table, paths=np.asarray(paths))
    print(f"wrote {args.out}: embeddings {table.shape}, {len(paths)} files")


if __name__ == "__main__":
    main()
