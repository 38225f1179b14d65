"""Streaming host→device data pipeline with prefetch.

The in-HBM ``DeviceStore`` path (train/steps.py) is the fast path for corpora
that fit device memory (dev-clean ≈ 0.6 GB). For LibriSpeech-scale training
sets (train-clean-100+360 ≈ 53 GB int16) this module streams instead:

    sampler (numpy RNG, seeded) → decode pool (C++ FLAC threads / RAM cache)
      → fragment assembly (B, frag) int16 → bounded queue → async device_put

Rebuild of the reference's ``fit_generator(workers=N, use_multiprocessing)``
pipeline (SURVEY.md §2.2 "Host data-loading parallelism") with the worker
processes replaced by one producer thread + the C++ decoder's internal thread
pool (GIL released for whole batches), and prefetch depth ≥ 2 so host
assembly and device compute overlap. Unlike the reference's forked workers
(whose numpy RNG seed duplication the reference never mitigated — SURVEY.md
§5 race detection), sampling here is a single seeded stream: deterministic.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from ..config import ExperimentConfig
from . import audio
from .dataset import SpeakerDataset


class DecodeCache:
    """Bounded LRU cache of decoded waveforms (int16), keyed by dataset id."""

    def __init__(self, dataset: SpeakerDataset, max_bytes: int = 2 << 30):
        self.dataset = dataset
        self.max_bytes = max_bytes
        self._cache: "collections.OrderedDict[int, np.ndarray]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        self._lock = threading.Lock()

    def get_many(self, ids: np.ndarray) -> list:
        out = [None] * len(ids)
        missing = []
        with self._lock:
            for i, did in enumerate(ids):
                wav = self._cache.get(int(did))
                if wav is not None:
                    self._cache.move_to_end(int(did))
                    out[i] = wav
                else:
                    missing.append(i)
        if missing:
            paths = []
            for i in missing:
                p = self.dataset.datasetid_to_filepath[int(ids[i])]
                import os

                paths.append(
                    p if os.path.isabs(p)
                    else os.path.join(self.dataset.data_root, p)
                )
            flac_paths = [p for p in paths if p.lower().endswith(".flac")]
            if len(flac_paths) == len(paths) and len(paths) > 1:
                # Parallel C++ batch decode (one GIL release for the batch).
                from . import flac_ext

                decoded = flac_ext.read_batch(paths)
            else:
                decoded = [audio.read(p)[0] for p in paths]
            with self._lock:
                for i, wav in zip(missing, decoded):
                    did = int(ids[i])
                    out[i] = wav
                    if did not in self._cache:
                        self._cache[did] = wav
                        self._bytes += wav.nbytes
                while self._bytes > self.max_bytes and self._cache:
                    _, old = self._cache.popitem(last=False)
                    self._bytes -= old.nbytes
        return out


Batch = Tuple[np.ndarray, ...]


def _cut_deterministic(wavs: list, frag: int, pad: bool) -> np.ndarray:
    """Offset-0 fragments (the eval protocol's stochastic=False semantics)."""
    out = np.zeros((len(wavs), frag), dtype=np.int16)
    for i, wav in enumerate(wavs):
        if len(wav) >= frag:
            out[i] = wav[:frag]
        elif pad:
            out[i, : len(wav)] = wav
        else:
            raise ValueError(
                f"file shorter than fragment ({len(wav)} < {frag}) with "
                "pad=False; enable DataConfig.pad or drop short files"
            )
    return out


def iter_embed_batches(
    dataset: SpeakerDataset,
    cfg: ExperimentConfig,
    batch_size: int,
    depth: int = 2,
    cache_bytes: int = 1 << 30,
) -> Iterator[Tuple[np.ndarray, int]]:
    """Deterministic corpus-order fragment batches for streaming embedding.

    The serving path for corpora whose int16 store exceeds HBM: yields
    ``(frags (B, frag) int16, valid_count)`` in dataset-id order (= store
    row order, so tables align row-for-row with the device-store path);
    the final batch is zero-padded with ``valid_count < B``. Decode rides
    the C++ threaded batch decoder; a producer thread overlaps host decode
    with device compute.
    """
    frag = cfg.data.fragment_length
    ids = np.asarray(dataset.df.id)
    cache = DecodeCache(dataset, cache_bytes)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce():
        try:
            for s in range(0, len(ids), batch_size):
                if stop.is_set():
                    return
                chunk = ids[s : s + batch_size]
                frags = _cut_deterministic(
                    cache.get_many(chunk), frag, cfg.data.pad
                )
                if len(chunk) < batch_size:
                    padded = np.zeros((batch_size, frag), np.int16)
                    padded[: len(chunk)] = frags
                    frags = padded
                while not stop.is_set():  # bounded put that honors stop
                    try:
                        q.put((frags, len(chunk)), timeout=0.2)
                        break
                    except queue.Full:
                        continue
            q.put(None)
        except BaseException as e:  # surfaced on the consumer side
            q.put(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("streaming embed producer failed") from item
            yield item
    finally:
        # Abandoned generators (GeneratorExit) and early exits release the
        # producer: signal stop, drain so a blocked put wakes, and join —
        # else the thread pins its DecodeCache for the process lifetime.
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5)


class StreamingPipeline:
    """Producer-thread pipeline yielding ready-to-device int16 batches.

    ``mode``: 'classifier' → (fragments (B, frag) int16, labels (B,) int32);
    'siamese' → (frag1, frag2, labels float32) with the half-alike/half-
    differing pair layout of the reference's ``build_verification_batch``.
    Fragments are cut host-side at sample granularity; only decimate+whiten
    remain for the device.
    """

    def __init__(
        self,
        dataset: SpeakerDataset,
        cfg: ExperimentConfig,
        mode: str = "classifier",
        depth: int = 3,
        seed: int = 0,
        cache_bytes: int = 2 << 30,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.cache = DecodeCache(dataset, cache_bytes)
        self.frag = cfg.data.fragment_length
        self.B = cfg.train.batch_size
        self._q: "queue.Queue[Optional[Batch]]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def _cut(self, wavs: list) -> np.ndarray:
        if not self.cfg.data.stochastic:
            return _cut_deterministic(wavs, self.frag, self.cfg.data.pad)
        out = np.zeros((len(wavs), self.frag), dtype=np.int16)
        for i, wav in enumerate(wavs):
            if len(wav) >= self.frag:
                start = int(self.rng.integers(0, len(wav) - self.frag + 1))
                out[i] = wav[start : start + self.frag]
            elif self.cfg.data.pad:
                out[i, : len(wav)] = wav  # zero-pad short files (pad mode)
            else:
                raise ValueError(
                    f"file shorter than fragment ({len(wav)} < {self.frag}) "
                    "with pad=False; enable DataConfig.pad or drop short files"
                )
        return out

    def _classifier_batch(self) -> Batch:
        ids = self.rng.choice(self.dataset.df.id, size=self.B)
        wavs = self.cache.get_many(ids)
        labels = np.asarray(
            [
                self.dataset.speaker_id_mapping[
                    self.dataset.datasetid_to_speaker_id[int(i)]
                ]
                if self.dataset.label == "speaker"
                else self.dataset.sex_to_label[self.dataset.datasetid_to_sex[int(i)]]
                for i in ids
            ],
            dtype=np.int32,
        )
        return self._cut(wavs), labels

    def _siamese_batch(self) -> Batch:
        half = self.B // 2
        # Reuse the dataset's pair samplers but with this pipeline's RNG.
        self.dataset.rng = self.rng
        alike = self.dataset.get_alike_pairs(half)
        differ = self.dataset.get_differing_pairs(self.B - half)
        ids1 = np.asarray([a for a, _ in alike + differ])
        ids2 = np.asarray([b for _, b in alike + differ])
        w1 = self.cache.get_many(ids1)
        w2 = self.cache.get_many(ids2)
        same = float(self.cfg.siamese.same_label)
        labels = np.concatenate(
            [
                np.full(half, same, np.float32),
                np.full(self.B - half, 1.0 - same, np.float32),
            ]
        )
        return self._cut(w1), self._cut(w2), labels

    def _produce(self):
        try:
            while not self._stop.is_set():
                batch = (
                    self._classifier_batch()
                    if self.mode == "classifier"
                    else self._siamese_batch()
                )
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface producer errors to the consumer
            self._exc = e
            self._q.put(None)

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        item = self._q.get()
        if item is None:
            raise RuntimeError("streaming producer failed") from self._exc
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
