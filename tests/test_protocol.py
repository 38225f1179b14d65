"""Frozen eval-protocol manifest tests (EVAL_PROTOCOL.json + eval/protocol.py)."""

import json

import jax
import numpy as np
import pytest

from voicemap.config import (
    DataConfig, EncoderConfig, ExperimentConfig, TrainConfig,
)
from voicemap.data import synthetic
from voicemap.data.dataset import SpeakerDataset
from voicemap.eval import protocol
from voicemap.models.classifier import SpeakerClassifier
from voicemap.train.loop import init_model_state


@pytest.fixture(scope="module")
def proto_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("proto_corpus")
    spec = synthetic.SyntheticSpec(
        n_speakers=12, utterances_per_speaker=7,
        min_seconds=3.2, max_seconds=4.0, seed=5,
    )
    synthetic.generate_corpus(str(root), subsets=("dev-clean", "test-clean"),
                              spec=spec)
    return str(root)


def _model_and_cfg(proto_corpus):
    cfg = ExperimentConfig(
        mode="classifier",
        data=DataConfig(data_root=proto_corpus, subsets=("dev-clean",)),
        encoder=EncoderConfig(filters=4, embedding_dim=8, dropout=0.0,
                              compute_dtype="float32"),
        train=TrainConfig(),
    )
    model = SpeakerClassifier(cfg.encoder, num_classes=12)
    state = init_model_state(model, cfg)
    return model, state, cfg


def test_manifest_loads_and_is_frozen():
    m = protocol.load_manifest()
    assert m["version"] == 2
    assert m["task_seed"] == 1906
    assert m["fragment"]["whiten_rms"] == 0.038021
    assert m["fragment"]["stochastic"] is False
    names = [e["name"] for e in m["entries"]]
    assert "dev-clean_1shot_5way" in names
    assert m["corpus_identity"]["dev-clean"]["n_utterances"] == 2703
    assert m["corpus_identity"]["test-clean"]["n_utterances"] == 2620
    # v2: verification metrics are pinned (VERDICT r3 next #7)
    v = m["verification"]
    assert v["pair_seed"] == 7919
    assert v["same_label"] == 0
    assert [e["name"] for e in v["entries"]] == [
        "dev-clean_verification", "test-clean_verification"]
    assert all(e["num_pairs"] == 2000 for e in v["entries"])
    assert v["acceptance"]["z"] == 1.96


def test_fingerprint_deterministic(proto_corpus):
    ds1 = SpeakerDataset(subsets=("dev-clean",), seconds=3.0,
                         data_root=proto_corpus, seed=0)
    ds2 = SpeakerDataset(subsets=("dev-clean",), seconds=3.0,
                         data_root=proto_corpus, seed=9)
    assert protocol.corpus_fingerprint(ds1) == protocol.corpus_fingerprint(ds2)
    ds3 = SpeakerDataset(subsets=("test-clean",), seconds=3.0,
                         data_root=proto_corpus, seed=0)
    assert protocol.corpus_fingerprint(ds1) != protocol.corpus_fingerprint(ds3)


def test_protocol_refuses_wrong_corpus(proto_corpus):
    model, state, cfg = _model_and_cfg(proto_corpus)
    with pytest.raises(ValueError, match="EVAL_PROTOCOL"):
        protocol.run_protocol(model, state, proto_corpus, cfg)


def test_protocol_runs_with_mismatch_override(proto_corpus):
    model, state, cfg = _model_and_cfg(proto_corpus)
    results = protocol.run_protocol(
        model, state, proto_corpus, cfg, allow_corpus_mismatch=True,
        max_store_seconds=5.0,
    )
    m = protocol.load_manifest()
    assert len(results) == len(m["entries"])
    for r in results:
        assert 0.0 <= r["accuracy"] <= 1.0
        assert r["ci95"][0] <= r["accuracy"] <= r["ci95"][1]
        assert r["corpus_verified"] is False
        assert r["comparable_to_reference"] is False
        assert r["task_seed"] == 1906
        json.dumps(r)  # machine-readable


def test_protocol_int8_flag(proto_corpus):
    """run_protocol(int8=True) calibrates per entry on that entry's store,
    embeds through the quantized serving path, and tags its results."""
    model, state, cfg = _model_and_cfg(proto_corpus)
    m = protocol.load_manifest()
    m["entries"] = [dict(m["entries"][0], num_tasks=50)]
    results = protocol.run_protocol(
        model, state, proto_corpus, cfg, manifest=m,
        allow_corpus_mismatch=True, max_store_seconds=5.0, int8=True,
    )
    assert len(results) == 1
    assert results[0]["int8"] is True
    assert 0.0 <= results[0]["accuracy"] <= 1.0
    # f32 results carry the tag too (false) so runs are distinguishable.
    r32 = protocol.run_protocol(
        model, state, proto_corpus, cfg, manifest=m,
        allow_corpus_mismatch=True, max_store_seconds=5.0,
    )
    assert r32[0]["int8"] is False
    assert abs(r32[0]["accuracy"] - results[0]["accuracy"]) <= 0.10


def test_int8_accuracy_gate_integration(proto_corpus):
    """The decision-agreement gate (r4 verdict #6) runs both precision
    passes on every entry (accuracy AND verification metrics), applies the
    manifest z-test per metric, and passes on a model whose int8 PTQ is
    faithful (any model: identical pinned seeds score the same tasks)."""
    model, state, cfg = _model_and_cfg(proto_corpus)
    m = protocol.load_manifest()
    m["entries"] = [dict(m["entries"][0], num_tasks=50)]
    m["verification"]["entries"] = [
        dict(m["verification"]["entries"][0], num_pairs=200)]
    verdict = protocol.int8_accuracy_gate(
        model, state, proto_corpus, cfg, manifest=m,
        allow_corpus_mismatch=True, max_store_seconds=5.0,
    )
    assert verdict["int8_accuracy_gate"] == "pass"
    assert [c["metric"] for c in verdict["checks"]] == [
        "accuracy", "eer", "auc"]
    for c in verdict["checks"]:
        assert c["agree"] and c["diff"] <= c["tolerance"]
        assert 0.0 <= c["base"] <= 1.0 and 0.0 <= c["int8"] <= 1.0
    # synthetic corpus fails the identity check → marked non-comparable
    assert verdict["comparable_to_reference"] is False
    json.dumps(verdict)  # machine-readable


def test_int8_accuracy_gate_fails_on_disagreement(proto_corpus, monkeypatch):
    """z-test logic: a metric gap beyond z·sqrt(se²+se²) flips the verdict."""
    model, state, cfg = _model_and_cfg(proto_corpus)
    m = protocol.load_manifest()

    def fake_run(model, state, data_root, cfg_base, int8=False, **kw):
        return [{"entry": "e", "accuracy": 0.90 if int8 else 0.70,
                 "stderr": 0.02, "comparable_to_reference": True}]

    monkeypatch.setattr(protocol, "run_protocol", fake_run)
    monkeypatch.setattr(protocol, "run_verification_protocol",
                        lambda *a, **kw: [])
    verdict = protocol.int8_accuracy_gate(
        model, state, proto_corpus, cfg, manifest=m)
    assert verdict["int8_accuracy_gate"] == "fail"
    assert verdict["checks"][0]["agree"] is False
    assert verdict["comparable_to_reference"] is True


def test_protocol_seed_pinned_reproducible(proto_corpus):
    """Same manifest seeds ⇒ bit-identical accuracy across runs."""
    model, state, cfg = _model_and_cfg(proto_corpus)
    m = protocol.load_manifest()
    m["entries"] = m["entries"][:1]
    r1 = protocol.run_protocol(model, state, proto_corpus, cfg, manifest=m,
                               allow_corpus_mismatch=True,
                               max_store_seconds=5.0)
    r2 = protocol.run_protocol(model, state, proto_corpus, cfg, manifest=m,
                               allow_corpus_mismatch=True,
                               max_store_seconds=5.0)
    assert r1[0]["accuracy"] == r2[0]["accuracy"]
    assert r1[0]["corpus_fingerprint"] == r2[0]["corpus_fingerprint"]


def test_verification_protocol_runs_and_is_reproducible(proto_corpus):
    """v2 verification entries: pinned pair seed ⇒ bit-identical EER/AUC
    across runs; results carry acceptance-rule stderrs and CIs."""
    model, state, cfg = _model_and_cfg(proto_corpus)
    m = protocol.load_manifest()
    m["verification"]["entries"] = [
        dict(m["verification"]["entries"][0], num_pairs=200)]
    kw = dict(manifest=m, allow_corpus_mismatch=True, max_store_seconds=5.0)
    r1 = protocol.run_verification_protocol(
        model, state, proto_corpus, cfg, **kw)
    r2 = protocol.run_verification_protocol(
        model, state, proto_corpus, cfg, **kw)
    assert len(r1) == 1
    v = r1[0]
    assert v["entry"] == "dev-clean_verification"
    assert 0.0 <= v["eer"] <= 1.0 and 0.0 <= v["auc"] <= 1.0
    assert v["n_same"] == 100 and v["n_diff"] == 100
    assert v["eer_ci95"][0] <= v["eer"] <= v["eer_ci95"][1]
    assert v["auc_ci95"][0] <= v["auc"] <= v["auc_ci95"][1]
    assert v["pair_seed"] == 7919 and v["comparable"] is False
    assert (v["eer"], v["auc"]) == (r2[0]["eer"], r2[0]["auc"])
    json.dumps(v)


def test_protocol_store_cache_shared(proto_corpus, monkeypatch):
    """One store_cache across the accuracy and verification passes ⇒ the
    corpus is indexed/decoded/shipped once per subset, not once per pass."""
    import voicemap.data.dataset as dsmod

    model, state, cfg = _model_and_cfg(proto_corpus)
    m = protocol.load_manifest()
    m["entries"] = [dict(m["entries"][0], num_tasks=20)]  # dev-clean
    m["verification"]["entries"] = [
        dict(m["verification"]["entries"][0], num_pairs=50)]  # dev-clean
    calls = []
    real = dsmod.dataset_from_config
    monkeypatch.setattr(dsmod, "dataset_from_config",
                        lambda c: (calls.append(1), real(c))[1])
    import voicemap.eval.nshot as nshot_mod

    embeds = []
    real_embed = nshot_mod.embed_all
    monkeypatch.setattr(
        nshot_mod, "embed_all",
        lambda *a, **kw: (embeds.append(1), real_embed(*a, **kw))[1])
    cache = {}
    kw = dict(manifest=m, allow_corpus_mismatch=True, max_store_seconds=5.0,
              store_cache=cache)
    r_acc = protocol.run_protocol(model, state, proto_corpus, cfg, **kw)
    assert len(calls) == 1
    assert len(embeds) == 1
    r_ver = protocol.run_verification_protocol(
        model, state, proto_corpus, cfg, **kw)
    assert len(calls) == 1  # verification reused the cached store
    assert len(embeds) == 1  # ... and the cached embedding table
    assert len(r_acc) == 1 and len(r_ver) == 1
    assert ("dev-clean",) in cache
    # Table keys fold id(state) in (r4 advice: checkpoint sweeps over one
    # cache must not collide) — match on the stable parts.
    assert ("table", id(state), False, False, "dev-clean") in cache


def test_verification_protocol_v1_manifest_is_noop(proto_corpus):
    model, state, cfg = _model_and_cfg(proto_corpus)
    m = protocol.load_manifest()
    del m["verification"]
    assert protocol.run_verification_protocol(
        model, state, proto_corpus, cfg, manifest=m,
        allow_corpus_mismatch=True, max_store_seconds=5.0) == []


def test_verification_stderr_helpers():
    from voicemap.eval import verification as V

    # Hanley-McNeil at A=0.5 with n_s=n_d=n reduces to ~sqrt((1/12)(2n-1)/n^2)
    n = 1000
    se = V.auc_stderr(0.5, n, n)
    import math
    expect = math.sqrt((0.25 + (n - 1) * (1 / 3 - 0.25) * 2) / (n * n))
    assert abs(se - expect) < 1e-12
    # stderr shrinks with more pairs, grows toward chance
    assert V.auc_stderr(0.9, 100, 100) > V.auc_stderr(0.9, 1000, 1000)
    assert V.eer_stderr(0.5, 100, 100) > V.eer_stderr(0.05, 100, 100)
    assert V.eer_stderr(0.1, 100, 100) > V.eer_stderr(0.1, 1000, 1000)


def test_check_corpus_per_subset_on_combined_dataset(proto_corpus):
    """A combined multi-subset dataset must be checked subset-by-subset
    against the manifest pins (not with the combined totals)."""
    m = protocol.load_manifest()
    ident = {}
    for s in ("dev-clean", "test-clean"):
        ds = SpeakerDataset(subsets=(s,), seconds=3.0,
                            data_root=proto_corpus, seed=0)
        ident[s] = {
            "n_speakers": len(np.unique(ds.df.speaker_id)),
            "n_utterances": int(len(ds.df)),
            "fingerprint": protocol.corpus_fingerprint(ds),
        }
    m["corpus_identity"] = ident
    both = SpeakerDataset(subsets=("dev-clean", "test-clean"), seconds=3.0,
                          data_root=proto_corpus, seed=0)
    fps = {}
    for s in ("dev-clean", "test-clean"):
        assert protocol.check_corpus(both, s, m, fingerprints=fps) == []
    # fingerprints were cached (computed once per subset, reusable)
    assert set(fps) == {"dev-clean", "test-clean"}
    # and a genuinely wrong pin is still caught per-subset
    m["corpus_identity"]["dev-clean"]["n_speakers"] += 1
    assert protocol.check_corpus(both, "dev-clean", m) != []
