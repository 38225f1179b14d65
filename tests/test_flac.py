"""FLAC codec tests: the first-party C++ decoder against the pure-Python
encoder, covering every subframe/residual path the decoder implements
(CONSTANT / VERBATIM / FIXED / LPC, Rice/Rice2, escape partitions, wasted
bits, stereo decorrelation), plus probe and batch decode."""

import numpy as np
import pytest

from voicemap.data import flac_enc, flac_ext


@pytest.fixture(scope="module", autouse=True)
def built():
    flac_ext.build()


def make_signal(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = (
        0.5 * np.sin(2 * np.pi * 220 * t)
        + 0.2 * np.sin(2 * np.pi * 931 * t)
        + 0.05 * rng.standard_normal(n)
    )
    return (x * 12000).astype(np.int16)


def roundtrip(tmp_path, data, name, **kw):
    p = str(tmp_path / f"{name}.flac")
    flac_ext.write(p, data, 16000, **kw)
    back, sr = flac_ext.read(p)
    assert sr == 16000
    return p, back


def test_verbatim_roundtrip(tmp_path):
    x = make_signal()
    _, back = roundtrip(tmp_path, x, "verbatim", mode="verbatim")
    np.testing.assert_array_equal(back, x)


def test_fixed_roundtrip(tmp_path):
    x = make_signal(seed=1)
    p, back = roundtrip(tmp_path, x, "fixed", mode="fixed")
    np.testing.assert_array_equal(back, x)
    # FIXED + Rice should actually compress vs verbatim.
    import os

    p2 = str(tmp_path / "vb.flac")
    flac_ext.write(p2, x, 16000, mode="verbatim")
    assert os.path.getsize(p) < os.path.getsize(p2)


def test_constant_roundtrip(tmp_path):
    x = np.full(10000, -123, dtype=np.int16)
    _, back = roundtrip(tmp_path, x, "const", mode="fixed")
    np.testing.assert_array_equal(back, x)


def test_lpc_roundtrip(tmp_path):
    x = make_signal(seed=2)
    _, back = roundtrip(tmp_path, x, "lpc", mode="lpc")
    np.testing.assert_array_equal(back, x)


def test_rice2_roundtrip(tmp_path):
    x = make_signal(seed=3)
    _, back = roundtrip(tmp_path, x, "rice2", mode="fixed", rice2=True)
    np.testing.assert_array_equal(back, x)


def test_partitioned_residual(tmp_path):
    x = make_signal(seed=4)
    _, back = roundtrip(tmp_path, x, "part", mode="fixed", partition_order=3)
    np.testing.assert_array_equal(back, x)


def test_escape_partitions(tmp_path):
    x = make_signal(seed=5)
    _, back = roundtrip(tmp_path, x, "escape", mode="fixed", force_escape=True)
    np.testing.assert_array_equal(back, x)


def test_wasted_bits(tmp_path):
    x = (make_signal(seed=6) & ~0x7).astype(np.int16)  # 3 trailing zero bits
    _, back = roundtrip(tmp_path, x, "wasted", mode="fixed", wasted_bits=3)
    np.testing.assert_array_equal(back, x)


def test_odd_tail_block(tmp_path):
    x = make_signal(n=4096 * 2 + 777, seed=7)
    _, back = roundtrip(tmp_path, x, "tail", mode="fixed")
    np.testing.assert_array_equal(back, x)


def test_small_block_size(tmp_path):
    x = make_signal(n=1000, seed=8)
    _, back = roundtrip(tmp_path, x, "smallblk", mode="fixed", block_size=256)
    np.testing.assert_array_equal(back, x)


def test_stereo_independent(tmp_path):
    L = make_signal(seed=9)
    R = make_signal(seed=10)
    x = np.stack([L, R], axis=1)
    p = str(tmp_path / "st.flac")
    flac_ext.write(p, x, 16000, mode="fixed")
    back, sr = flac_ext.read(p)
    expect = x.astype(np.int32).mean(axis=1).astype(np.int16)
    np.testing.assert_array_equal(back, expect)


def test_stereo_left_side(tmp_path):
    L = make_signal(seed=11)
    R = (L // 2 + make_signal(seed=12) // 4).astype(np.int16)
    x = np.stack([L, R], axis=1)
    p = str(tmp_path / "ls.flac")
    flac_ext.write(p, x, 16000, mode="fixed", stereo_mode="left_side")
    back, sr = flac_ext.read(p)
    expect = x.astype(np.int32).mean(axis=1).astype(np.int16)
    np.testing.assert_array_equal(back, expect)


def test_probe(tmp_path):
    x = make_signal(n=12345, seed=13)
    p = str(tmp_path / "probe.flac")
    flac_ext.write(p, x, 16000)
    n, sr = flac_ext.probe(p)
    assert (n, sr) == (12345, 16000)


def test_probe_via_audio_dispatch(tmp_path):
    from voicemap.data import audio

    x = make_signal(n=5000, seed=14)
    p = str(tmp_path / "d.flac")
    flac_ext.write(p, x, 16000)
    n, sr = audio.probe(p)
    assert (n, sr) == (5000, 16000)
    back, sr2 = audio.read(p)
    np.testing.assert_array_equal(back, x)


def test_batch_decode(tmp_path):
    xs = [make_signal(n=8000 + 117 * i, seed=20 + i) for i in range(12)]
    paths = []
    for i, x in enumerate(xs):
        p = str(tmp_path / f"b{i}.flac")
        flac_ext.write(p, x, 16000)
        paths.append(p)
    outs = flac_ext.read_batch(paths, n_threads=4)
    assert len(outs) == 12
    for x, o in zip(xs, outs):
        np.testing.assert_array_equal(o, x)


def test_corrupt_file_rejected(tmp_path):
    x = make_signal(n=6000, seed=30)
    p = str(tmp_path / "c.flac")
    flac_ext.write(p, x, 16000)
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0xFF  # flip bits mid-frame → CRC-16 must trip
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        flac_ext.read(p)


def test_not_flac_rejected(tmp_path):
    p = str(tmp_path / "junk.flac")
    open(p, "wb").write(b"RIFFnotflacdata" * 10)
    with pytest.raises(IOError):
        flac_ext.read(p)


def test_flac_synthetic_corpus(tmp_path):
    """End-to-end: FLAC-container synthetic corpus → index → dataset."""
    from voicemap.data import synthetic
    from voicemap.data.dataset import SpeakerDataset

    spec = synthetic.SyntheticSpec(
        n_speakers=3, utterances_per_speaker=3, min_seconds=1.0,
        max_seconds=2.0, seed=5, container="flac",
    )
    root = str(tmp_path / "flac_corpus")
    synthetic.generate_corpus(root, subsets=("dev-clean",), spec=spec)
    ds = SpeakerDataset(
        subsets=("dev-clean",), seconds=0.8, data_root=root, seed=1
    )
    frag, label = ds[0]
    assert frag.shape == (ds.fragment_length, 1)
    store = ds.to_store()
    assert store.audio.shape[0] == 9

def test_stereo_batch_matches_single(tmp_path):
    # DecodeCache picks between read() and read_batch() by batch size; a
    # stereo file must yield the identical downmixed-mono waveform on both.
    L = make_signal(seed=40)
    R = make_signal(seed=41)
    st = np.stack([L, R], axis=1)
    mono = make_signal(n=7000, seed=42)
    p_st = str(tmp_path / "sb.flac")
    p_mo = str(tmp_path / "mb.flac")
    flac_ext.write(p_st, st, 16000, mode="fixed")
    flac_ext.write(p_mo, mono, 16000)
    single, _ = flac_ext.read(p_st)
    batch = flac_ext.read_batch([p_st, p_mo], n_threads=2)
    np.testing.assert_array_equal(batch[0], single)
    np.testing.assert_array_equal(batch[1], mono)
    assert len(single) == len(L)  # per-channel duration, not interleaved/2


def test_byte_fuzz_no_crash(tmp_path):
    # Corrupt streams must produce a clean IOError (or decode), never heap
    # corruption: exercises the order>part_len / order>block_size /
    # interleaved-capacity guards in flac_decoder.cpp.
    x = make_signal(n=5000, seed=50)
    p = str(tmp_path / "fz.flac")
    flac_ext.write(p, x, 16000)
    orig = open(p, "rb").read()
    rng = np.random.default_rng(7)
    q = str(tmp_path / "fz2.flac")
    for _ in range(60):
        buf = bytearray(orig)
        for _ in range(int(rng.integers(1, 6))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        open(q, "wb").write(bytes(buf))
        try:
            flac_ext.read(q)
        except IOError:
            pass
