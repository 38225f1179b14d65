"""Speaker dataset: fragment extraction, pair samplers, n-shot task builder.

Rebuild of the reference's ``voicemap/librispeech.py ::
LibriSpeechDataset`` (SURVEY.md §2.1). Two API surfaces:

1. **Host (reference-parity) API** — ``__getitem__``, ``build_verification_batch``,
   ``yield_verification_batches``, ``build_n_shot_task`` — numpy, generator
   based, matching the reference's public surface so a voicemap user can port
   scripts 1:1. Used for the CPU baseline and parity tests.

2. **Device-store export** — ``to_store()`` packs the whole (decoded) corpus
   into padded int16 arrays + per-speaker index matrices, from which the
   fully-on-device sampling/preprocess pipeline (``voicemap.ops.sampling``
   / ``voicemap.ops.preprocess``) draws batches with zero host
   involvement. This is the rebuild of the reference's multiprocessing
   generator pipeline (SURVEY.md §2.2 "Host data-loading parallelism").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DataConfig
from . import audio, index as index_mod


@dataclass
class AudioStore:
    """The decoded corpus as dense arrays, ready for ``jax.device_put``.

    ``audio`` is zero-padded int16 ``(N, T_store)``; ``lengths`` the true
    sample counts; ``labels`` contiguous class indices; ``speaker_utts`` an
    ``(S, max_utt)`` matrix of utterance ids per speaker (padded with 0 but
    masked by ``speaker_counts``) enabling on-device class-balanced sampling.
    """

    audio: np.ndarray  # (N, T_store) int16
    lengths: np.ndarray  # (N,) int32
    labels: np.ndarray  # (N,) int32 contiguous class ids
    speaker_utts: np.ndarray  # (S, max_utt) int32
    speaker_counts: np.ndarray  # (S,) int32
    sample_rate: int
    label_names: List  # class idx -> original label (speaker id or sex)


class SpeakerDataset:
    """Reference-parity dataset over a LibriSpeech-shaped tree.

    Reference: ``voicemap/librispeech.py :: LibriSpeechDataset(subsets,
    seconds, label='speaker', stochastic=True, pad=False, cache=True)``.
    """

    def __init__(
        self,
        subsets: Sequence[str],
        seconds: float,
        label: str = "speaker",
        stochastic: bool = True,
        pad: bool = False,
        data_root: Optional[str] = None,
        use_cache: bool = True,
        seed: int = 0,
        sample_rate: int = 16000,
    ):
        if label not in ("speaker", "sex"):
            # Reference validates label ∈ {'speaker','sex'} (SURVEY.md §3.3).
            raise ValueError("label must be 'speaker' or 'sex'")
        if isinstance(subsets, str):
            subsets = (subsets,)
        from .. import config as cfgmod

        self.subsets = tuple(subsets)
        self.seconds = float(seconds)
        self.sample_rate = int(sample_rate)
        self.fragment_length = int(self.seconds * self.sample_rate)
        self.label = label
        self.stochastic = stochastic
        self.pad = pad
        self.data_root = data_root or cfgmod.DATA_PATH
        self.rng = np.random.default_rng(seed)

        df = index_mod.load_index(self.data_root, self.subsets, use_cache=use_cache)
        # Reference: filter out files shorter than the fragment unless padding
        # (SURVEY.md §3.3 "short files DROPPED unless pad").
        if not pad:
            df = df[df.samples >= self.fragment_length]
        df["id"] = np.arange(len(df))
        if len(df) == 0:
            raise ValueError("no files long enough for requested fragment length")
        self.df = df

        self.datasetid_to_filepath: Dict[int, str] = dict(zip(df.id, df.filepath))
        self.datasetid_to_speaker_id: Dict[int, int] = dict(zip(df.id, df.speaker_id))
        self.datasetid_to_sex: Dict[int, str] = dict(zip(df.id, df.sex))
        # Reference: sex_to_label mapping for label='sex' mode.
        self.sex_to_label = {"M": 0, "F": 1}
        self.unique_speakers = np.unique(df.speaker_id).tolist()
        self.num_classes_ = (
            len(self.unique_speakers) if label == "speaker" else 2
        )
        # Reference-style speaker_id → contiguous index mapping for classifier
        # one-hot labels (voicemap/utils.py :: label_preprocessor).
        self.speaker_id_mapping = {s: i for i, s in enumerate(self.unique_speakers)}
        self._decode_cache: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    # Core fragment extraction
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.df)

    def num_classes(self) -> int:
        return self.num_classes_

    @property
    def num_speakers(self) -> int:
        return len(self.unique_speakers)

    def _decode(self, dataset_id: int) -> np.ndarray:
        wav = self._decode_cache.get(dataset_id)
        if wav is None:
            path = self.datasetid_to_filepath[dataset_id]
            import os

            full = path if os.path.isabs(path) else os.path.join(self.data_root, path)
            wav, sr = audio.read(full)
            if sr != self.sample_rate:
                raise ValueError(f"{full}: sample rate {sr} != {self.sample_rate}")
            self._decode_cache[dataset_id] = wav
        return wav

    def __getitem__(self, dataset_id: int) -> Tuple[np.ndarray, int]:
        """Extract one fragment → (float32 (fragment_length, 1), label).

        Reference: ``LibriSpeechDataset.__getitem__`` — random start offset
        when stochastic, start-of-file otherwise; zero-pad short files
        (random before/after split when stochastic) when ``pad=True``.
        """
        wav = audio.to_float(self._decode(dataset_id))
        T = self.fragment_length
        if len(wav) >= T:
            if self.stochastic:
                start = int(self.rng.integers(0, len(wav) - T + 1))
            else:
                start = 0
            frag = wav[start : start + T]
        elif self.pad:
            deficit = T - len(wav)
            before = int(self.rng.integers(0, deficit + 1)) if self.stochastic else 0
            frag = np.pad(wav, (before, deficit - before))
        else:
            raise ValueError(
                f"file {dataset_id} shorter than fragment and pad=False"
            )
        label = self._label_of(dataset_id)
        return frag[:, None].astype(np.float32), label

    def _label_of(self, dataset_id: int) -> int:
        if self.label == "speaker":
            return self.datasetid_to_speaker_id[dataset_id]
        return self.sex_to_label[self.datasetid_to_sex[dataset_id]]

    def _speakers_with(self, min_utts: int) -> "index_mod.Table":
        """Rows of the speakers that have at least ``min_utts`` utterances."""
        spk, counts = np.unique(self.df.speaker_id, return_counts=True)
        return self.df[np.isin(self.df.speaker_id, spk[counts >= min_utts])]

    # ------------------------------------------------------------------
    # Pair samplers (reference: get_alike_pairs / get_differing_pairs)
    # ------------------------------------------------------------------

    def get_alike_pairs(self, num: int) -> List[Tuple[int, int]]:
        """``num`` pairs of distinct dataset ids sharing a speaker."""
        eligible = self._speakers_with(2)
        speakers = np.unique(eligible.speaker_id)
        chosen = self.rng.choice(speakers, size=num, replace=True)
        pairs = []
        for s in chosen:
            ids = eligible.id[eligible.speaker_id == s]
            a, b = self.rng.choice(ids, size=2, replace=False)
            pairs.append((int(a), int(b)))
        return pairs

    def get_differing_pairs(self, num: int) -> List[Tuple[int, int]]:
        """``num`` pairs of dataset ids with different speakers."""
        pairs = []
        ids = self.df.id
        spk = self.df.speaker_id
        for _ in range(num):
            while True:
                a, b = self.rng.choice(len(ids), size=2, replace=False)
                if spk[a] != spk[b]:
                    pairs.append((int(ids[a]), int(ids[b])))
                    break
        return pairs

    # ------------------------------------------------------------------
    # Verification batches (reference: build_verification_batch)
    # ------------------------------------------------------------------

    def build_verification_batch(
        self, batchsize: int, same_label: int = 0
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Half alike / half differing pairs → ([x1, x2], labels).

        Label convention (reference sign flagged [MED] in SURVEY.md §2.1):
        ``same_label`` for alike pairs, ``1 - same_label`` for differing, so
        with the default same=0 a smaller sigmoid output ⇒ same speaker
        (argmin-consistent with n-shot eval).
        """
        half = batchsize // 2
        alike = self.get_alike_pairs(half)
        differ = self.get_differing_pairs(batchsize - half)
        x1, x2, y = [], [], []
        for a, b in alike:
            x1.append(self[a][0])
            x2.append(self[b][0])
            y.append(same_label)
        for a, b in differ:
            x1.append(self[a][0])
            x2.append(self[b][0])
            y.append(1 - same_label)
        return [np.stack(x1), np.stack(x2)], np.asarray(y, dtype=np.float32)

    def yield_verification_batches(
        self, batchsize: int, same_label: int = 0
    ) -> Iterator[Tuple[List[np.ndarray], np.ndarray]]:
        """Infinite generator (reference: yield_verification_batches)."""
        while True:
            yield self.build_verification_batch(batchsize, same_label)

    def build_classifier_batch(
        self, batchsize: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform random utterances → (instances, contiguous class labels)."""
        ids = self.rng.choice(self.df.id, size=batchsize, replace=True)
        xs, ys = [], []
        for i in ids:
            x, lab = self[int(i)]
            xs.append(x)
            if self.label == "speaker":
                lab = self.speaker_id_mapping[lab]
            ys.append(lab)
        return np.stack(xs), np.asarray(ys, dtype=np.int32)

    def yield_classifier_batches(
        self, batchsize: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.build_classifier_batch(batchsize)

    # ------------------------------------------------------------------
    # n-shot tasks (reference: build_n_shot_task)
    # ------------------------------------------------------------------

    def build_n_shot_task(
        self, k: int, n: int = 1
    ) -> Tuple[Tuple[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]:
        """Sample a 1-query, k-way, n-shot task.

        Reference invariant: the query's true speaker is support **class 0**
        (SURVEY.md §2.1 "arranged so the query's true speaker is support
        index 0") — the self-checking fixture the eval relies on.
        Returns ((query (T,1), query_label), (support (k*n, T, 1), labels (k*n,))).
        """
        eligible = self._speakers_with(n + 1)
        speakers = np.unique(eligible.speaker_id)
        if len(speakers) < k:
            raise ValueError(f"need ≥{k} speakers with ≥{n + 1} utterances")
        chosen = self.rng.choice(speakers, size=k, replace=False)
        # Query + n support from speaker 0 (distinct utterances).
        ids0 = eligible.id[eligible.speaker_id == chosen[0]]
        picks = self.rng.choice(ids0, size=n + 1, replace=False)
        query = self[int(picks[0])][0]
        support_x, support_y = [], []
        for ci, s in enumerate(chosen):
            if ci == 0:
                sel = picks[1:]
            else:
                ids = eligible.id[eligible.speaker_id == s]
                sel = self.rng.choice(ids, size=n, replace=False)
            for i in sel:
                support_x.append(self[int(i)][0])
                support_y.append(s)
        return (query, int(chosen[0])), (
            np.stack(support_x),
            np.asarray(support_y),
        )

    # ------------------------------------------------------------------
    # Device-store export for the on-device pipeline
    # ------------------------------------------------------------------

    def to_store(self, max_seconds: Optional[float] = None) -> AudioStore:
        """Decode everything into padded arrays for the on-device pipeline.

        ``max_seconds`` caps the stored length per utterance (files longer
        than the cap are truncated) so the store stays HBM-friendly; fragments
        are drawn from within the stored window.
        """
        T_cap = (
            int(max_seconds * self.sample_rate)
            if max_seconds is not None
            else int(self.df.samples.max())
        )
        N = len(self.df)
        lengths = np.minimum(self.df.samples, T_cap).astype(np.int32)
        T_store = int(lengths.max())
        store = np.zeros((N, T_store), dtype=np.int16)
        for i in self.df.id:
            wav = self._decode(int(i))[:T_store]
            store[i, : len(wav)] = wav
        if self.label == "speaker":
            labels = np.asarray(
                [self.speaker_id_mapping[s] for s in self.df.speaker_id],
                dtype=np.int32,
            )
            label_names = list(self.unique_speakers)
        else:
            labels = np.asarray(
                [self.sex_to_label[s] for s in self.df.sex], dtype=np.int32
            )
            label_names = ["M", "F"]
        # Per-class utterance index matrix for on-device sampling. Grouped by
        # *speaker* regardless of label mode — pairing/task semantics are
        # always speaker-level in the reference.
        groups = [
            self.df.id[self.df.speaker_id == s] for s in self.unique_speakers
        ]
        max_utt = max(len(g) for g in groups)
        speaker_utts = np.zeros((len(groups), max_utt), dtype=np.int32)
        speaker_counts = np.zeros(len(groups), dtype=np.int32)
        for gi, g in enumerate(groups):
            speaker_utts[gi, : len(g)] = g
            speaker_counts[gi] = len(g)
        return AudioStore(
            audio=store,
            lengths=lengths,
            labels=labels,
            speaker_utts=speaker_utts,
            speaker_counts=speaker_counts,
            sample_rate=self.sample_rate,
            label_names=label_names,
        )


STREAMING_THRESHOLD_BYTES = 4 << 30  # int16 store size above which to stream


def estimate_store_bytes(ds: SpeakerDataset, max_seconds, sample_rate) -> int:
    """int16 device-store footprint of ``ds.to_store(max_seconds)`` —
    the pipeline auto-selection estimate shared by fit() and the embed CLI
    (N × longest capped utterance × 2 bytes; to_store pads to the max)."""
    cap = max_seconds or float(ds.df.seconds.max())
    t_store = int(np.minimum(ds.df.samples, cap * sample_rate).max())
    return t_store * len(ds.df) * 2


def dataset_from_config(cfg: DataConfig, **kw) -> SpeakerDataset:
    return SpeakerDataset(
        subsets=cfg.subsets,
        seconds=cfg.seconds,
        label=cfg.label,
        stochastic=cfg.stochastic,
        pad=cfg.pad,
        data_root=cfg.data_root,
        use_cache=cfg.use_cache,
        sample_rate=cfg.sample_rate,
        **kw,
    )
