"""The pandas-free index (data/index.py): CSV cache layout byte for byte,
typed reads, and the small column table."""

import numpy as np
import pytest

from voicemap.data import index as index_mod
from voicemap.data.index import Table, read_index_csv

# What pandas' DataFrame.to_csv(index=False) writes for these rows.
GOLDEN = (
    "filepath,speaker_id,sex,samples,sample_rate,seconds\n"
    "LibriSpeech/dev-clean/19/100/19-100-0000.wav,19,F,40000,16000,2.5\n"
    "\"odd,name.wav\",22,M,33333,16000,2.0833125\n"
)
ROWS = [
    {"filepath": "LibriSpeech/dev-clean/19/100/19-100-0000.wav", "speaker_id": 19,
     "sex": "F", "samples": 40000, "sample_rate": 16000, "seconds": 2.5},
    {"filepath": "odd,name.wav", "speaker_id": 22, "sex": "M",
     "samples": 33333, "sample_rate": 16000, "seconds": 33333 / 16000},
]
COLUMNS = [c for c, _ in index_mod.INDEX_COLUMNS]


def test_to_csv_matches_pandas_layout(tmp_path):
    path = tmp_path / "dev-clean.index.csv"
    Table.from_records(ROWS, COLUMNS).to_csv(str(path))
    assert path.read_bytes() == GOLDEN.encode()


def test_read_index_csv_types(tmp_path):
    path = tmp_path / "x.index.csv"
    path.write_text(GOLDEN)
    t = read_index_csv(str(path))
    assert t.columns == COLUMNS
    assert t.speaker_id.dtype.kind == "i" and t.samples.dtype.kind == "i"
    assert t.seconds.dtype == np.float64
    assert list(t.filepath) == [r["filepath"] for r in ROWS]
    np.testing.assert_array_equal(t.seconds, [2.5, 33333 / 16000])


def test_cache_round_trip_is_stable(tmp_path):
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    a.write_text(GOLDEN)
    read_index_csv(str(a)).to_csv(str(b))
    assert b.read_bytes() == a.read_bytes()


def test_table_masks_and_attributes():
    t = Table({"x": [1, 2, 3], "y": ["a", "b", "c"]})
    sub = t[t.x >= 2]
    assert len(sub) == 2 and list(sub.y) == ["b", "c"]
    assert list(t[np.asarray([2, 0])].x) == [3, 1]
    with pytest.raises(AttributeError):
        t.z


def test_table_assign_concat_and_setitem():
    t = Table({"x": [1, 2]}).assign(subset="dev-clean")
    u = Table.concat([t, Table({"x": [3], "subset": ["test-clean"]})])
    u["id"] = np.arange(len(u))
    assert list(u.subset) == ["dev-clean", "dev-clean", "test-clean"]
    assert list(u.id) == [0, 1, 2]
    with pytest.raises(ValueError, match="unequal"):
        Table({"a": [1], "b": [1, 2]})


def test_load_index_reads_pandas_written_cache(corpus_root, tmp_path):
    """A cache file in the pandas layout is read as the index."""
    import shutil

    root = tmp_path / "root"
    shutil.copytree(corpus_root, root)
    (root / "dev-clean.index.csv").write_text(GOLDEN)
    df = index_mod.load_index(str(root), ["dev-clean"])
    assert len(df) == 2 and list(df.subset) == ["dev-clean"] * 2
    assert list(df.id) == [0, 1]
