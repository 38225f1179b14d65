"""Batched n-shot k-way speaker-identification evaluation.

Rebuild of the reference's evaluation (reference:
``voicemap/utils.py :: n_shot_task_evaluation`` — SURVEY.md §3.4), whose hot
loop ran 500 sequential Python tasks with k·n FLAC decodes and a device
round-trip each. Here (BASELINE.json: "pairwise n-shot evaluation becomes a
single batched matmul-distance kernel"):

1. **Embed the whole evaluation corpus once** — deterministic fragments
   (stochastic=False ⇒ embedding per utterance id is a pure function), chunked
   through one jitted embed call → an (N, D) embedding table. This is also
   BASELINE.json config #5's "batched embedding of the full speaker set".
2. **Sample every task's indices on-device** (``ops.sampling.sample_nshot_tasks``;
   true class at index 0, the reference's self-checking invariant).
3. **One batched distance/score computation** over all tasks:
   - classifier mode: squared-euclidean in matmul form per task,
     n>1 averaged per class, argmin over classes;
   - siamese mode: verification-head scores in matrix form (lower ⇒ same,
     argmin-consistent with the same=0 label convention).
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ExperimentConfig
from ..ops import distance as dist_ops
from ..ops import sampling
from ..train.steps import DeviceStore, fetch_batch
from ..train.state import TrainState


@functools.lru_cache(maxsize=32)
def _embed_chunk_fn(model, cfg: ExperimentConfig, fast: bool = False):
    """Build-once jitted chunk embedder (the frozen model and config dataclasses
    are hashable, so the jit cache survives across evaluate() calls — a fresh
    closure per call would re-trace and re-compile at every periodic eval).

    ``fast=True`` uses the serving forward (models/fast_infer.fast_embed)
    for raw-waveform encoders — bf16-level deviation from the training
    graph, with the block-0 GPU kernel on the card.
    """

    @jax.jit
    def embed_chunk(st: TrainState, sto: DeviceStore, indices: jnp.ndarray):
        x = fetch_batch(sto, indices, jax.random.PRNGKey(0), cfg, stochastic=False)
        variables = {"params": st.params, "batch_stats": st.batch_stats}
        if fast and cfg.mode in ("classifier", "siamese"):
            from ..models.fast_infer import fast_embed

            enc_vars = {
                "params": variables["params"]["encoder"],
                "batch_stats": variables["batch_stats"]["encoder"],
            }
            return fast_embed(enc_vars, cfg.encoder, x)
        return model.embed(variables, x)

    return embed_chunk


def _quant_embed_chunk_fn(cfg: ExperimentConfig, qvars):
    """int8 serving chunk embedder (models/quant_infer). Unlike
    `_embed_chunk_fn` this closes over the quantized arrays, so the jit cache
    lives per-qvars — fine for the one-shot serving CLIs it exists for."""
    from ..models.quant_infer import quant_embed, quant_embed_mel

    @jax.jit
    def embed_chunk(st: TrainState, sto: DeviceStore, indices: jnp.ndarray):
        x = fetch_batch(sto, indices, jax.random.PRNGKey(0), cfg, stochastic=False)
        enc_vars = {
            "params": st.params["encoder"],
            "batch_stats": st.batch_stats["encoder"],
        }
        if cfg.mode == "melspec2d":
            return quant_embed_mel(enc_vars, qvars, cfg.encoder, cfg.mel, x,
                                   sample_rate=cfg.data.sample_rate)
        return quant_embed(enc_vars, qvars, cfg.encoder, x)

    return embed_chunk


def embed_all(
    model,
    state: TrainState,
    store: DeviceStore,
    cfg: ExperimentConfig,
    batch_size: int = 256,
    fast: bool = False,
    qvars=None,
) -> jnp.ndarray:
    """Embed every utterance in the store → (N, D) table (chunked, jitted).

    ``qvars`` (from ``models/quant_infer.quantize_encoder`` /
    ``quantize_mel_encoder``) switches the encoder's conv blocks to the
    s8×s8→s32 serving path (blocks 1+ for raw-waveform modes, all conv2d
    blocks for melspec2d).
    """
    if qvars is not None:
        from ..models.quant_infer import check_qvars_mode

        check_qvars_mode(cfg, qvars)
        embed_chunk = _quant_embed_chunk_fn(cfg, qvars)
    else:
        embed_chunk = _embed_chunk_fn(model, cfg, fast)
    N = store.labels.shape[0]
    chunks = []
    for start in range(0, N, batch_size):
        # Static chunk shape: pad the final chunk by clamping indices.
        idx = np.minimum(np.arange(start, start + batch_size), N - 1)
        chunks.append(embed_chunk(state, store, jnp.asarray(idx)))
    return jnp.concatenate(chunks, axis=0)[:N]


def _embed_frags_fn(model, cfg: ExperimentConfig, fast: bool, qvars):
    """Chunk embedder over host-cut int16 fragments (streaming serving path):
    device work = decimate→whiten→encode; same model dispatch as
    `_embed_chunk_fn`/`_quant_embed_chunk_fn`."""
    from ..train.steps import preprocess_fragments

    if qvars is not None:
        from ..models.quant_infer import quant_embed, quant_embed_mel

        @jax.jit
        def embed_chunk(st: TrainState, frags: jnp.ndarray):
            x = preprocess_fragments(frags, cfg)
            enc_vars = {
                "params": st.params["encoder"],
                "batch_stats": st.batch_stats["encoder"],
            }
            if cfg.mode == "melspec2d":
                return quant_embed_mel(enc_vars, qvars, cfg.encoder, cfg.mel,
                                       x, sample_rate=cfg.data.sample_rate)
            return quant_embed(enc_vars, qvars, cfg.encoder, x)

        return embed_chunk

    @jax.jit
    def embed_chunk(st: TrainState, frags: jnp.ndarray):
        x = preprocess_fragments(frags, cfg)
        variables = {"params": st.params, "batch_stats": st.batch_stats}
        if fast and cfg.mode in ("classifier", "siamese"):
            from ..models.fast_infer import fast_embed

            enc_vars = {
                "params": variables["params"]["encoder"],
                "batch_stats": variables["batch_stats"]["encoder"],
            }
            return fast_embed(enc_vars, cfg.encoder, x)
        return model.embed(variables, x)

    return embed_chunk


def embed_all_streaming(
    model,
    state: TrainState,
    cfg: ExperimentConfig,
    dataset,
    batch_size: int = 256,
    fast: bool = False,
    qvars=None,
) -> jnp.ndarray:
    """(N, D) embedding table streamed from disk in corpus order.

    The serving path for corpora whose int16 store exceeds HBM (the
    device-store `embed_all` ships the whole corpus to the chip first):
    threaded FLAC decode overlaps device compute, rows align with the
    device-store table (both embed deterministic offset-0 fragments).
    """
    if qvars is not None:
        from ..models.quant_infer import check_qvars_mode

        check_qvars_mode(cfg, qvars)  # _embed_frags_fn serves all 3 modes
    from ..data.pipeline import iter_embed_batches

    embed_chunk = _embed_frags_fn(model, cfg, fast, qvars)
    chunks = []
    for frags, count in iter_embed_batches(dataset, cfg, batch_size):
        emb = embed_chunk(state, jnp.asarray(frags))
        chunks.append(np.asarray(emb[:count]))
    return jnp.asarray(np.concatenate(chunks, axis=0))


@partial(jax.jit, static_argnames=("num_tasks", "n", "k"))
def classifier_nshot_accuracy(
    table: jnp.ndarray,
    speaker_utts: jnp.ndarray,
    speaker_counts: jnp.ndarray,
    key: jax.Array,
    num_tasks: int,
    n: int,
    k: int,
) -> jnp.ndarray:
    """Nearest-embedding n-shot accuracy from an embedding table.

    Reference semantics: euclidean nearest neighbor on penultimate-layer
    embeddings; n>1 averages distances per class (SURVEY.md §2.1).
    """
    tasks = sampling.sample_nshot_tasks(
        key, speaker_utts, speaker_counts, num_tasks, n, k
    )
    q = table[tasks.query_idx]  # (tasks, D)
    s = table[tasks.support_idx]  # (tasks, k, n, D)
    # Batched squared euclidean in matmul form: ‖q‖² + ‖s‖² − 2 q·s.
    qn = jnp.sum(q * q, axis=-1)[:, None, None]
    sn = jnp.sum(s * s, axis=-1)
    cross = jnp.einsum("td,tknd->tkn", q, s, preferred_element_type=jnp.float32)
    sq = jnp.maximum(qn + sn - 2.0 * cross, 0.0)  # (tasks, k, n)
    # Reference n>1 semantics: average *euclidean* distances per class
    # (not squared — the two orderings differ for n>1).
    class_dist = jnp.sqrt(sq + 1e-12).mean(axis=-1)  # (tasks, k)
    pred = jnp.argmin(class_dist, axis=-1)
    return jnp.mean((pred == 0).astype(jnp.float32))


@partial(jax.jit, static_argnames=("num_tasks", "n", "k", "metric", "same_label"))
def siamese_nshot_accuracy(
    table: jnp.ndarray,
    head_w: jnp.ndarray,
    head_b: jnp.ndarray,
    speaker_utts: jnp.ndarray,
    speaker_counts: jnp.ndarray,
    key: jax.Array,
    num_tasks: int,
    n: int,
    k: int,
    metric: str = "uniform_euclidean",
    same_label: int = 0,
) -> jnp.ndarray:
    """Verification-head n-shot accuracy (argmin/argmax of head logits).

    Matrix form of the reference's ``model.predict([tile(query, k·n),
    support])`` + argmin loop. ``head_w``/``head_b`` are the Dense(1) params.
    With ``same_label=0`` (reference convention) a lower logit means "same
    speaker" → argmin; with ``same_label=1`` higher means same → argmax.
    """
    tasks = sampling.sample_nshot_tasks(
        key, speaker_utts, speaker_counts, num_tasks, n, k
    )
    q = table[tasks.query_idx]  # (tasks, D)
    s = table[tasks.support_idx].reshape(num_tasks, k * n, -1)  # (tasks, kn, D)
    scores = dist_ops.head_scores(q, s, head_w, head_b, metric)
    class_scores = dist_ops.class_distances(scores, n, k)  # (tasks, k)
    if same_label == 0:
        pred = jnp.argmin(class_scores, axis=-1)
    else:
        pred = jnp.argmax(class_scores, axis=-1)
    return jnp.mean((pred == 0).astype(jnp.float32))


def evaluate(
    model,
    state: TrainState,
    store: DeviceStore,
    cfg: ExperimentConfig,
    key: jax.Array,
    num_tasks: Optional[int] = None,
    n: Optional[int] = None,
    k: Optional[int] = None,
    embed_batch: int = 256,
    fast: bool = False,
    qvars=None,
    table: Optional[jnp.ndarray] = None,
) -> float:
    """Full n-shot evaluation: embed table once, score all tasks at once.

    ``qvars`` (models/quant_infer) embeds through the int8 serving path —
    the accuracy-parity check for quantized deployment.

    ``table``: a precomputed ``embed_all`` table for this exact
    (store, cfg, fast, qvars) — skips the embedding pass (the protocol
    runner shares one table between its accuracy and EER/AUC passes).
    """
    t = cfg.train
    num_tasks = num_tasks or t.num_eval_tasks
    n = n or t.n_shot
    k = k or t.k_way
    counts = np.asarray(store.speaker_counts)
    if k > counts.shape[0]:
        raise ValueError(
            f"k_way={k} exceeds the {counts.shape[0]} speakers in the eval store"
        )
    if int(counts.min()) < n + 1:
        raise ValueError(
            f"n_shot={n} needs ≥{n + 1} utterances per speaker; "
            f"minimum in the eval store is {int(counts.min())}"
        )
    if table is None:
        table = embed_all(model, state, store, cfg, batch_size=embed_batch,
                          fast=fast, qvars=qvars)
    return score_table(table, state, store, cfg, key, num_tasks, n, k)


def score_table(
    table: jnp.ndarray,
    state: TrainState,
    store: DeviceStore,
    cfg: ExperimentConfig,
    key: jax.Array,
    num_tasks: int,
    n: int,
    k: int,
) -> float:
    """Score one (n, k) setting against a precomputed embedding table.

    The scoring half of :func:`evaluate`, split out so sweeps (accuracy vs k —
    the reference ``README.md`` results-figure family) embed the corpus ONCE
    and re-score cheaply per setting.
    """
    # Contrastive training optimizes embedding euclidean distances and never
    # trains the Dense(1) head — scoring with the (random-init) head could
    # even invert rankings, so evaluate by embedding distance instead.
    use_head = (
        cfg.mode == "siamese"
        and cfg.train.loss != "contrastive"
        and cfg.siamese.distance_metric in dist_ops.SIAMESE_METRICS
    )
    if use_head:
        head = state.params["head"]
        acc = siamese_nshot_accuracy(
            table,
            head["kernel"],
            head["bias"][0],
            store.speaker_utts,
            store.speaker_counts,
            key,
            num_tasks,
            n,
            k,
            metric=cfg.siamese.distance_metric,
            same_label=cfg.siamese.same_label,
        )
    else:
        acc = classifier_nshot_accuracy(
            table,
            store.speaker_utts,
            store.speaker_counts,
            key,
            num_tasks,
            n,
            k,
        )
    return float(acc)


def evaluate_sweep(
    model,
    state: TrainState,
    store: DeviceStore,
    cfg: ExperimentConfig,
    key: jax.Array,
    n_shots,
    k_values,
    num_tasks: int = 500,
    embed_batch: int = 256,
    fast: bool = False,
    qvars=None,
):
    """Accuracy over a grid of (n_shot, k_way) settings from ONE embedding table.

    Rebuild of the reference ``README.md`` accuracy-vs-k results figures
    (the reference re-ran its sequential 500-task eval per point; here the
    corpus is embedded once and each point is one compiled scoring call).
    Task keys are folded per (n, k) so every point draws independent tasks;
    the same (key, n, k, num_tasks) always reproduces the same point.

    Returns a list of dicts: ``{n_shot, k_way, num_tasks, accuracy, stderr,
    chance}`` in (n, k) grid order. Settings the store cannot support
    (k > #speakers, n+1 > min utterances/speaker) are skipped with a
    ``skipped`` reason instead of raising, so wide sweeps survive small
    validation stores.
    """
    counts = np.asarray(store.speaker_counts)
    num_speakers = int(counts.shape[0])
    min_utts = int(counts.min())
    table = embed_all(model, state, store, cfg, batch_size=embed_batch,
                      fast=fast, qvars=qvars)
    results = []
    for n in n_shots:
        for k in k_values:
            point = {"n_shot": int(n), "k_way": int(k),
                     "num_tasks": int(num_tasks), "chance": 1.0 / int(k)}
            if k > num_speakers:
                point["skipped"] = (
                    f"k_way={k} exceeds the {num_speakers} eval-store speakers"
                )
            elif min_utts < n + 1:
                point["skipped"] = (
                    f"n_shot={n} needs ≥{n + 1} utterances per speaker; "
                    f"store minimum is {min_utts}"
                )
            else:
                acc = score_table(
                    table, state, store, cfg,
                    jax.random.fold_in(key, int(n) * 1009 + int(k)),
                    num_tasks, int(n), int(k),
                )
                point["accuracy"] = acc
                point["stderr"] = float(
                    np.sqrt(max(acc * (1.0 - acc), 1e-12) / num_tasks)
                )
            results.append(point)
    return results
