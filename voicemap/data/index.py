"""Dataset index builder with CSV cache.

Rebuild of the reference's index path (reference:
``voicemap/librispeech.py :: LibriSpeechDataset.__init__ / index_subset`` —
SURVEY.md §3.3): walk ``<root>/LibriSpeech/<subset>`` for audio files, join
speaker metadata from ``SPEAKERS.TXT``, probe each file's length, build a
table (filepath, speaker_id, sex, samples, sample_rate, seconds), and cache
it to ``<root>/<subset>.index.csv`` so the cold-start probe loop is paid
once. The CSV is the one pandas' ``to_csv(index=False)`` writes, byte for
byte, so caches written by either reader stay valid.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, List, Sequence

import numpy as np

from . import audio

AUDIO_EXTS = (".flac", ".wav")

# Column order and types of the cached index CSV.
INDEX_COLUMNS = (("filepath", str), ("speaker_id", int), ("sex", str),
                 ("samples", int), ("sample_rate", int), ("seconds", float))


class Table:
    """Named columns of equal length, each a numpy array.

    ``t.col`` / ``t["col"]`` is a column; ``t[mask]`` or ``t[indices]`` is a
    new table of the selected rows.
    """

    def __init__(self, columns: Dict[str, Iterable]):
        self._cols = {k: np.asarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: {lengths}")

    @classmethod
    def from_records(cls, records: List[Dict], columns: Sequence[str]) -> "Table":
        return cls({c: [r[c] for r in records] for c in columns})

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getattr__(self, name: str) -> np.ndarray:
        cols = self.__dict__.get("_cols", {})
        if name in cols:
            return cols[name]
        raise AttributeError(name)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        return Table({k: v[key] for k, v in self._cols.items()})

    def __setitem__(self, name: str, values) -> None:
        self._cols[name] = np.asarray(values)

    def assign(self, **columns) -> "Table":
        out = Table(self._cols)
        for k, v in columns.items():
            out[k] = np.broadcast_to(np.asarray(v), (len(self),)).copy()
        return out

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        cols = tables[0].columns
        return Table({c: np.concatenate([t[c] for t in tables]) for c in cols})

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            w.writerows(zip(*(self._cols[c].tolist() for c in self.columns)))


def read_index_csv(path: str) -> Table:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return Table({name: np.asarray([typ(r[name]) for r in rows],
                                   dtype=object if typ is str else None)
                  for name, typ in INDEX_COLUMNS})


def read_speakers_txt(path: str) -> Table:
    """Parse LibriSpeech's SPEAKERS.TXT ('|'-delimited, ';'-comment header).

    Reference: ``index_subset`` reads it with pandas ``delimiter='|'`` skipping
    the comment header (SURVEY.md §2.1 "Dataset index builder").
    """
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith(";") or not line.strip():
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) < 5:
                continue
            rows.append(
                {
                    "speaker_id": int(parts[0]),
                    "sex": parts[1],
                    "subset": parts[2],
                    "minutes": float(parts[3]),
                    "name": "|".join(parts[4:]),
                }
            )
    return Table.from_records(
        rows, ("speaker_id", "sex", "subset", "minutes", "name"))


def subset_available(data_root: str, subset: str) -> bool:
    """True when the subset can be indexed without error: its directory
    exists under ``<root>/LibriSpeech/`` or a cached index CSV does."""
    return os.path.isdir(
        os.path.join(data_root, "LibriSpeech", subset)
    ) or os.path.isfile(os.path.join(data_root, f"{subset}.index.csv"))


def index_subset(data_root: str, subset: str) -> Table:
    """Walk one subset tree and probe every audio file.

    ★ This is the reference's I/O-bound cold-start loop (SURVEY.md §3.1);
    the probe reads container headers only (no decode).
    """
    ls_root = os.path.join(data_root, "LibriSpeech")
    speakers = read_speakers_txt(os.path.join(ls_root, "SPEAKERS.TXT"))
    sex_map: Dict[int, str] = dict(zip(speakers.speaker_id, speakers.sex))
    records = []
    subset_dir = os.path.join(ls_root, subset)
    if not os.path.isdir(subset_dir):
        raise FileNotFoundError(f"subset directory not found: {subset_dir}")
    for dirpath, _dirnames, filenames in sorted(os.walk(subset_dir)):
        for fname in sorted(filenames):
            if not fname.lower().endswith(AUDIO_EXTS):
                continue
            fpath = os.path.join(dirpath, fname)
            speaker_id = int(fname.split("-")[0])
            n_samples, sr = audio.probe(fpath)
            records.append(
                {
                    "filepath": os.path.relpath(fpath, data_root),
                    "speaker_id": speaker_id,
                    "sex": sex_map.get(speaker_id, "?"),
                    "samples": n_samples,
                    "sample_rate": sr,
                    "seconds": n_samples / sr,
                }
            )
    if not records:
        raise FileNotFoundError(f"no audio files under {subset_dir}")
    return Table.from_records(records, [c for c, _ in INDEX_COLUMNS])


def load_index(
    data_root: str, subsets: Sequence[str], use_cache: bool = True
) -> Table:
    """Load (or build + cache) the concatenated index for the given subsets.

    Cache layout matches the reference: ``<root>/<subset>.index.csv``
    (reference: ``LibriSpeechDataset.__init__`` cache hit/miss logic).
    """
    frames = []
    for subset in subsets:
        cache_path = os.path.join(data_root, f"{subset}.index.csv")
        if use_cache and os.path.exists(cache_path):
            df = read_index_csv(cache_path)
        else:
            df = index_subset(data_root, subset)
            if use_cache:
                os.makedirs(data_root, exist_ok=True)
                df.to_csv(cache_path)
        frames.append(df.assign(subset=np.asarray(subset, dtype=object)))
    out = Table.concat(frames)
    out["id"] = np.arange(len(out))
    return out
