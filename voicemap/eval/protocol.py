"""Frozen eval-protocol runner (EVAL_PROTOCOL.json).

The reference's defining metric is n-shot k-way accuracy under a fixed
evaluation protocol (reference: ``voicemap/utils.py ::
n_shot_task_evaluation`` + the validation settings of
``experiments/train_siamese_net.py``). The real LibriSpeech corpus is not
available in-sandbox, so accuracy PARITY cannot be measured yet — this
module makes it a one-command affair for the day it can: load the manifest,
verify the corpus is the corpus the manifest pins (speaker/utterance counts
+ an index fingerprint), run every pinned entry with the pinned seeds, and
emit machine-readable JSON with confidence intervals and the acceptance
rule applied.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

MANIFEST_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "EVAL_PROTOCOL.json",
)


def load_manifest(path: Optional[str] = None) -> Dict:
    with open(path or MANIFEST_PATH) as f:
        return json.load(f)


def corpus_fingerprint(ds_or_df) -> str:
    """sha256 over the sorted '<relpath>|<speaker_id>|<seconds:.3f>' lines.

    Identifies the exact file set + durations without hashing audio bytes
    (probe-only — runs off the cached index). Accepts a dataset or a bare
    index table (for per-subset views).
    """
    df = getattr(ds_or_df, "df", ds_or_df)
    lines = sorted(
        f"{fp}|{spk}|{sec:.3f}"
        for fp, spk, sec in zip(df.filepath.tolist(), df.speaker_id.tolist(),
                                df.seconds.tolist())
    )
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


def _subset_frame(ds, subset: str):
    """The rows of ``ds.df`` belonging to one subset (a combined multi-subset
    dataset must be checked subset-by-subset against the manifest pins)."""
    df = ds.df
    if "subset" in df.columns:
        return df[df.subset == subset]
    # Index filepaths are data_root-relative: "LibriSpeech/<subset>/…"
    # (data/index.py :: os.path.relpath(fpath, data_root)).
    return df[np.char.startswith(df.filepath.astype(str), f"LibriSpeech/{subset}/")]


def check_corpus(
    ds, subset: str, manifest: Dict,
    fingerprints: Optional[Dict[str, str]] = None,
) -> List[str]:
    """Mismatches between this dataset's ``subset`` rows and the manifest's
    pinned identity (empty = verified; fingerprint null = recorded-on-trust).

    ``fingerprints``: optional cache dict — computed per-subset fingerprints
    are stored under their subset name so callers never hash an index twice.
    """
    ident = manifest["corpus_identity"].get(subset)
    if ident is None:
        return [f"subset {subset} not pinned in the manifest"]
    problems = []
    df = _subset_frame(ds, subset)
    n_spk = len(np.unique(df.speaker_id))
    n_utt = int(len(df))
    if n_spk != ident["n_speakers"]:
        problems.append(
            f"{subset}: {n_spk} speakers, manifest pins {ident['n_speakers']}"
        )
    if n_utt != ident["n_utterances"]:
        problems.append(
            f"{subset}: {n_utt} utterances, manifest pins {ident['n_utterances']}"
        )
    if ident.get("fingerprint"):
        fp = (fingerprints or {}).get(subset)
        if fp is None:
            fp = corpus_fingerprint(df)
            if fingerprints is not None:
                fingerprints[subset] = fp
        if fp != ident["fingerprint"]:
            problems.append(f"{subset}: index fingerprint {fp[:16]}… != pinned")
    return problems


def _entry_store(
    cfg_base,
    data_root: str,
    subsets,
    manifest: Dict,
    allow_corpus_mismatch: bool,
    max_store_seconds: Optional[float],
    cache: Optional[Dict] = None,
):
    """(cfg, ds, store, problems, fps) for one entry's subsets.

    ``cache`` (keyed by the subsets tuple) lets the accuracy and
    verification passes of one protocol run share corpus decode +
    host→device shipping — the fragment settings are manifest-global, so
    the same subsets always yield the same store within a run.
    """
    import dataclasses

    from ..data.dataset import dataset_from_config
    from ..train import steps as steps_mod

    key = tuple(subsets)
    if cache is not None and key in cache:
        return cache[key]
    frag = manifest["fragment"]
    data_cfg = dataclasses.replace(
        cfg_base.data,
        data_root=data_root,
        subsets=key,
        seconds=frag["seconds"],
        sample_rate=frag["sample_rate"],
        downsampling=frag["downsampling"],
        stochastic=frag["stochastic"],
        pad=frag["pad"],
        whiten_rms=frag["whiten_rms"],
    )
    cfg = cfg_base.replace(data=data_cfg)
    ds = dataset_from_config(cfg.data)
    problems: List[str] = []
    fps: Dict[str, str] = {}
    for subset in key:
        problems += check_corpus(ds, subset, manifest, fingerprints=fps)
    if problems and not allow_corpus_mismatch:
        raise ValueError(
            "corpus does not match EVAL_PROTOCOL.json: " + "; ".join(problems)
        )
    store = steps_mod.device_store_for(cfg, ds.to_store(max_store_seconds))
    out = (cfg, ds, store, problems, fps)
    if cache is not None:
        cache[key] = out
    return out


def _entry_qvars(state, cfg, store, subsets, cache: Optional[Dict]):
    """Calibrated int8 qvars for one entry, shared across protocol passes
    via ``cache`` (keyed ('qvars', *subsets) — disjoint from store keys)."""
    from ..models.quant_infer import quantize_from_store

    key = ("qvars", id(state)) + tuple(subsets)
    if cache is not None and key in cache:
        return cache[key]
    qvars = quantize_from_store(state, cfg, store)
    if cache is not None:
        cache[key] = qvars
    return qvars


def _entry_table(model, state, cfg, store, subsets, fast, qvars,
                 cache: Optional[Dict]):
    """Embedding table for one entry's store, shared across protocol passes.

    Fragments are deterministic (stochastic=False) and (cfg, fast, qvars)
    are constant within one protocol run, so the table the accuracy pass
    builds is bit-identical to what the verification pass would recompute —
    the full-corpus encoder forward is the dominant device cost per entry.
    Keyed ('table', int8?, fast?, *subsets); disjoint from store/qvars keys.
    """
    from . import nshot

    key = ("table", id(state), qvars is not None, bool(fast)) + tuple(subsets)
    if cache is not None and key in cache:
        return cache[key]
    table = nshot.embed_all(model, state, store, cfg, fast=fast, qvars=qvars)
    if cache is not None:
        cache[key] = table
    return table


def run_protocol(
    model,
    state,
    data_root: str,
    cfg_base,
    manifest: Optional[Dict] = None,
    allow_corpus_mismatch: bool = False,
    max_store_seconds: Optional[float] = None,
    fast: bool = False,
    int8: bool = False,
    store_cache: Optional[Dict] = None,
) -> List[Dict]:
    """Run every manifest entry; returns one result dict per entry.

    ``cfg_base``: an ExperimentConfig whose encoder/mode match the model —
    fragment settings are OVERRIDDEN from the manifest (the protocol owns
    them). Raises on corpus-identity mismatch unless
    ``allow_corpus_mismatch`` (for synthetic smoke runs, which mark their
    results non-comparable).

    ``int8``: embed through the quantized serving path
    (models/quant_infer), calibrated per entry on that entry's store — the
    deployment accuracy-parity run; results carry ``"int8": true``.

    ``store_cache``: pass the same dict to ``run_verification_protocol``
    to share per-subset corpus decode, device stores, int8 calibration,
    and embedding tables across both passes. Lifetime: one (cfg_base,
    corpus) pair — stores are keyed by subsets only, so reusing a cache
    across different configs/corpora returns stale stores. Model-dependent
    entries (qvars, tables) additionally fold ``id(state)`` into their
    keys, so sweeping checkpoints over one cache is safe (r4 advice).
    """
    import jax

    from . import nshot

    manifest = manifest or load_manifest()
    results = []
    for entry in manifest["entries"]:
        cfg, ds, store, problems, fps = _entry_store(
            cfg_base, data_root, entry["subsets"], manifest,
            allow_corpus_mismatch, max_store_seconds, cache=store_cache,
        )
        qvars = _entry_qvars(state, cfg, store, entry["subsets"],
                             store_cache) if int8 else None
        table = _entry_table(model, state, cfg, store, entry["subsets"],
                             fast, qvars, store_cache)
        acc = nshot.evaluate(
            model, state, store, cfg,
            jax.random.PRNGKey(int(manifest["task_seed"])),
            num_tasks=entry["num_tasks"], n=entry["n_shot"],
            k=entry["k_way"], fast=fast, qvars=qvars, table=table,
        )
        stderr = math.sqrt(max(acc * (1 - acc), 1e-12) / entry["num_tasks"])
        z = float(manifest["acceptance"]["z"])
        results.append({
            "entry": entry["name"],
            "accuracy": round(float(acc), 4),
            "stderr": round(stderr, 4),
            "ci95": [round(float(acc) - z * stderr, 4),
                     round(float(acc) + z * stderr, 4)],
            "num_tasks": entry["num_tasks"],
            "n_shot": entry["n_shot"],
            "k_way": entry["k_way"],
            "subsets": entry["subsets"],
            "task_seed": manifest["task_seed"],
            "corpus_fingerprint": (
                fps[entry["subsets"][0]]
                if len(entry["subsets"]) == 1 and entry["subsets"][0] in fps
                else corpus_fingerprint(ds)
            ),
            "corpus_verified": not problems,
            "corpus_problems": problems,
            "comparable_to_reference": not problems,
            "int8": int8,
        })
    return results


def int8_accuracy_gate(
    model,
    state,
    data_root: str,
    cfg_base,
    manifest: Optional[Dict] = None,
    allow_corpus_mismatch: bool = False,
    max_store_seconds: Optional[float] = None,
    fast: bool = False,
    store_cache: Optional[Dict] = None,
) -> Dict:
    """Decision-agreement gate: does int8 serving reproduce bf16/f32
    accuracy under the frozen protocol? (round-4 verdict #6)

    Runs every manifest entry (n-shot accuracy AND verification EER/AUC)
    twice — once through the full-precision forward, once through the int8
    PTQ serving path calibrated per entry on that entry's store — and
    applies the manifest's own acceptance z-test to each pair:
    ``agree iff |m_int8 − m_base| ≤ z·sqrt(se_base² + se_int8²)``.

    This is the deployment-relevant fidelity statement (the bench's
    min-cosine-on-noise gate is a proxy): identical task/pair seeds mean
    both passes score the SAME decisions, so a disagreement beyond
    sampling noise is quantization error, not protocol variance. Corpus
    decode + device stores are shared across all four passes via
    ``store_cache``; embedding tables are cached per (state, int8) pair.

    Returns ``{"int8_accuracy_gate": "pass"|"fail", "z": z, "checks":
    [per-entry-metric dicts], "comparable_to_reference": bool}``.
    """
    manifest = manifest or load_manifest()
    cache: Dict = {} if store_cache is None else store_cache
    kw = dict(
        manifest=manifest, allow_corpus_mismatch=allow_corpus_mismatch,
        max_store_seconds=max_store_seconds, fast=fast, store_cache=cache,
    )
    base = (run_protocol(model, state, data_root, cfg_base, int8=False, **kw)
            + run_verification_protocol(
                model, state, data_root, cfg_base, int8=False, **kw))
    quant = (run_protocol(model, state, data_root, cfg_base, int8=True, **kw)
             + run_verification_protocol(
                 model, state, data_root, cfg_base, int8=True, **kw))
    z = float(manifest["acceptance"]["z"])
    checks: List[Dict] = []
    for b, q in zip(base, quant):
        assert b["entry"] == q["entry"], "protocol pass order diverged"
        if "accuracy" in b:
            metrics = [("accuracy", "stderr")]
        else:  # verification entry: gate both pinned metrics
            metrics = [("eer", "eer_stderr"), ("auc", "auc_stderr")]
        for mkey, skey in metrics:
            diff = abs(float(q[mkey]) - float(b[mkey]))
            tol = z * math.sqrt(float(b[skey]) ** 2 + float(q[skey]) ** 2)
            checks.append({
                "entry": b["entry"], "metric": mkey,
                "base": float(b[mkey]), "int8": float(q[mkey]),
                "diff": round(diff, 4), "tolerance": round(tol, 4),
                "agree": diff <= tol,
            })
    return {
        "int8_accuracy_gate": (
            "pass" if all(c["agree"] for c in checks) else "fail"),
        "z": z,
        "checks": checks,
        "comparable_to_reference": all(
            r.get("comparable_to_reference", r.get("comparable", False))
            for r in base),
    }


def run_verification_protocol(
    model,
    state,
    data_root: str,
    cfg_base,
    manifest: Optional[Dict] = None,
    allow_corpus_mismatch: bool = False,
    max_store_seconds: Optional[float] = None,
    fast: bool = False,
    int8: bool = False,
    store_cache: Optional[Dict] = None,
) -> List[Dict]:
    """Run the manifest's pinned verification entries (protocol v2).

    EER/AUC over ``num_pairs`` balanced same/different pairs sampled from
    ``PRNGKey(pair_seed)``, scored with ``eval/verification.py``'s policy
    (trained head for BCE-siamese, embedding euclidean otherwise —
    reference scoring surface: ``voicemap/train.py`` verification batches).
    Results carry the acceptance-rule standard errors so two runs of this
    function are directly comparable under the manifest's z-test.

    The manifest's ``same_label`` pins only the PAIR-LABEL convention of
    the reported counts/metrics; the trained head's sign convention stays
    the checkpoint's own ``cfg.siamese.same_label`` (verification_scores
    separates the two — overriding the cfg here would flip score
    orientation for heads trained with the other convention).
    """
    import jax

    from . import verification as V

    manifest = manifest or load_manifest()
    ver = manifest.get("verification")
    if ver is None:
        return []  # v1 manifest: nothing pinned
    same_label = int(ver["same_label"])
    results = []
    for entry in ver["entries"]:
        cfg, ds, store, problems, fps = _entry_store(
            cfg_base, data_root, entry["subsets"], manifest,
            allow_corpus_mismatch, max_store_seconds, cache=store_cache,
        )
        qvars = _entry_qvars(state, cfg, store, entry["subsets"],
                             store_cache) if int8 else None
        table = _entry_table(model, state, cfg, store, entry["subsets"],
                             fast, qvars, store_cache)
        scores, labels = V.verification_scores(
            model, state, store, cfg,
            jax.random.PRNGKey(int(ver["pair_seed"])),
            num_pairs=entry["num_pairs"], fast=fast, qvars=qvars,
            same_label=same_label, table=table,
        )
        n_same = int((labels == same_label).sum())
        n_diff = int(len(labels) - n_same)
        eer, thr = V.eer_from_scores(scores, labels, same_label)
        auc = V.auc_from_scores(scores, labels, same_label)
        z = float(ver["acceptance"]["z"])
        se_eer = V.eer_stderr(eer, n_same, n_diff)
        se_auc = V.auc_stderr(auc, n_same, n_diff)
        results.append({
            "entry": entry["name"],
            "eer": round(eer, 4),
            "eer_threshold": round(thr, 4),
            "eer_stderr": round(se_eer, 4),
            "eer_ci95": [round(eer - z * se_eer, 4), round(eer + z * se_eer, 4)],
            "auc": round(auc, 4),
            "auc_stderr": round(se_auc, 4),
            "auc_ci95": [round(auc - z * se_auc, 4), round(auc + z * se_auc, 4)],
            "num_pairs": int(len(labels)),
            "n_same": n_same,
            "n_diff": n_diff,
            "pair_seed": int(ver["pair_seed"]),
            "same_label": same_label,
            "subsets": entry["subsets"],
            "corpus_verified": not problems,
            "corpus_problems": problems,
            "comparable": not problems,
            "int8": int8,
        })
    return results
