"""Pod-scale n-shot evaluation (BASELINE.json config #5, complete).

"Batched embedding of the full test-clean speaker set with sharded distance
matrix": both halves run over the mesh —

1. **sharded embedding**: utterance indices sharded over the ``data`` axis;
   every device runs the fused fetch→preprocess→encode pipeline on its shard
   of the corpus-store rows, then the table is all_gathered (the table is
   tiny — N×64 floats — vs the audio that never moves);
2. **sharded task scoring**: the n-shot tasks are sharded over the same axis
   and each device scores its task shard against the replicated table; the
   per-task correctness bits are ``psum``-reduced into the global accuracy —
   the pod-scale form of ``eval/nshot.py``.

Mesh-size agnostic; tested on the faked CPU mesh against the single-device
evaluator.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import ExperimentConfig
from ..ops import distance as dist_ops
from ..ops import sampling
from ..train.state import TrainState
from ..train.steps import DeviceStore, fetch_batch


def make_sharded_embed_table_fn(model, cfg: ExperimentConfig, mesh: Mesh,
                                axis: str = "data", qvars=None):
    """jit(shard_map): (state, store, indices (N_pad,)) → (N_pad, D) table.

    ``indices`` must be padded to a multiple of the axis size (clamp-pad with
    any valid id; callers slice the result). ``qvars`` (models/quant_infer)
    runs each device's embed shard through the int8 serving path — the
    pod-scale form of ``eval/nshot.embed_all(qvars=...)``; the quantized
    weights close over the program and replicate like the model params.
    """
    if qvars is not None:
        from ..models.quant_infer import check_qvars_mode

        check_qvars_mode(cfg, qvars)

    def device_embed(state: TrainState, store: DeviceStore, indices):
        x = fetch_batch(store, indices, jax.random.PRNGKey(0), cfg,
                        stochastic=False)
        if qvars is not None:
            from ..models.quant_infer import quant_embed, quant_embed_mel

            enc_vars = {"params": state.params["encoder"],
                        "batch_stats": state.batch_stats["encoder"]}
            if cfg.mode == "melspec2d":
                local = quant_embed_mel(enc_vars, qvars, cfg.encoder, cfg.mel,
                                        x, sample_rate=cfg.data.sample_rate)
            else:
                local = quant_embed(enc_vars, qvars, cfg.encoder, x)
        else:
            variables = {"params": state.params,
                         "batch_stats": state.batch_stats}
            local = model.embed(variables, x)
        return jax.lax.all_gather(local, axis, axis=0, tiled=True)

    return jax.jit(
        jax.shard_map(
            device_embed,
            mesh=mesh,
            in_specs=(P(), P(), P(axis)),
            out_specs=P(),
            check_vma=False,
        )
    )


def make_sharded_task_scorer(mesh: Mesh, num_tasks: int, n: int, k: int,
                             axis: str = "data"):
    """jit(shard_map): (table, speaker_utts, counts, key) → scalar accuracy.

    Tasks are sampled identically on every device (same key), then each
    device scores its own shard of the task list; correctness bits psum up.
    ``num_tasks`` must divide by the axis size.
    """
    n_dev = mesh.shape[axis]
    if num_tasks % n_dev:
        raise ValueError(f"num_tasks {num_tasks} must divide mesh axis {n_dev}")
    local_tasks = num_tasks // n_dev

    def device_score(table, speaker_utts, counts, key):
        tasks = sampling.sample_nshot_tasks(
            key, speaker_utts, counts, num_tasks, n, k
        )
        me = jax.lax.axis_index(axis)
        sl = me * local_tasks
        q_idx = jax.lax.dynamic_slice(tasks.query_idx, (sl,), (local_tasks,))
        s_idx = jax.lax.dynamic_slice(
            tasks.support_idx, (sl, 0, 0), (local_tasks, k, n)
        )
        q = table[q_idx]  # (lt, D)
        s = table[s_idx]  # (lt, k, n, D)
        qn = jnp.sum(q * q, axis=-1)[:, None, None]
        sn = jnp.sum(s * s, axis=-1)
        cross = jnp.einsum("td,tknd->tkn", q, s,
                           preferred_element_type=jnp.float32)
        sq = jnp.maximum(qn + sn - 2.0 * cross, 0.0)
        # Average euclidean (not squared) distances per class — reference
        # n>1 semantics, matching eval/nshot.py.
        dist = jnp.sqrt(sq + 1e-12).mean(axis=-1)  # (lt, k)
        correct = (jnp.argmin(dist, axis=-1) == 0).astype(jnp.float32)
        return jax.lax.psum(jnp.sum(correct), axis) / num_tasks

    return jax.jit(
        jax.shard_map(
            device_score,
            mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        )
    )


def make_sharded_siamese_scorer(
    mesh: Mesh,
    num_tasks: int,
    n: int,
    k: int,
    metric: str,
    same_label: int = 0,
    axis: str = "data",
):
    """jit(shard_map): (table, head_w, head_b, speaker_utts, counts, key) →
    scalar accuracy — the pod form of ``eval/nshot.siamese_nshot_accuracy``.

    Tasks are sampled identically on every device (same key); each device
    scores its task shard's verification-head logits against the replicated
    table via the shared ``ops.distance.head_scores`` (so pod and
    single-device scores agree exactly); correctness bits psum-reduce.
    """
    n_dev = mesh.shape[axis]
    if num_tasks % n_dev:
        raise ValueError(f"num_tasks {num_tasks} must divide mesh axis {n_dev}")
    local_tasks = num_tasks // n_dev

    def device_score(table, head_w, head_b, speaker_utts, counts, key):
        tasks = sampling.sample_nshot_tasks(
            key, speaker_utts, counts, num_tasks, n, k
        )
        me = jax.lax.axis_index(axis)
        sl = me * local_tasks
        q_idx = jax.lax.dynamic_slice(tasks.query_idx, (sl,), (local_tasks,))
        s_idx = jax.lax.dynamic_slice(
            tasks.support_idx, (sl, 0, 0), (local_tasks, k, n)
        )
        q = table[q_idx]  # (lt, D)
        s = table[s_idx].reshape(local_tasks, k * n, -1)  # (lt, kn, D)
        scores = dist_ops.head_scores(q, s, head_w, head_b, metric)
        class_scores = dist_ops.class_distances(scores, n, k)  # (lt, k)
        if same_label == 0:
            pred = jnp.argmin(class_scores, axis=-1)
        else:
            pred = jnp.argmax(class_scores, axis=-1)
        correct = (pred == 0).astype(jnp.float32)
        return jax.lax.psum(jnp.sum(correct), axis) / num_tasks

    return jax.jit(
        jax.shard_map(
            device_score,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        )
    )


def pod_evaluate(
    model,
    state: TrainState,
    store: DeviceStore,
    cfg: ExperimentConfig,
    mesh: Mesh,
    key: jax.Array,
    num_tasks: Optional[int] = None,
    n: Optional[int] = None,
    k: Optional[int] = None,
    axis: str = "data",
    qvars=None,
) -> float:
    """Full pod-scale n-shot evaluation.

    Mirrors ``eval/nshot.evaluate``'s mode selection: siamese configs with a
    trained verification head score through the sharded head-logit matrix
    (``make_sharded_siamese_scorer``); classifier / contrastive configs score
    by embedding euclidean distance. ``qvars`` builds the table through the
    int8 serving path (deterministic per index, so the table — and therefore
    the accuracy at a given key — is bit-identical to single-device int8).
    """
    t = cfg.train
    num_tasks = num_tasks or t.num_eval_tasks
    n = n or t.n_shot
    k = k or t.k_way
    n_dev = mesh.shape[axis]
    num_tasks = (num_tasks // n_dev) * n_dev or n_dev

    N = int(store.labels.shape[0])
    pad = (-N) % n_dev
    indices = jnp.asarray(
        np.concatenate([np.arange(N), np.zeros(pad, np.int64)]).astype(np.int32)
    )
    embed_fn = make_sharded_embed_table_fn(model, cfg, mesh, axis, qvars=qvars)
    table = embed_fn(state, store, indices)[:N]
    use_head = (
        cfg.mode == "siamese"
        and cfg.train.loss != "contrastive"
        and cfg.siamese.distance_metric in dist_ops.SIAMESE_METRICS
        and "head" in state.params
    )
    if use_head:
        head = state.params["head"]
        scorer = make_sharded_siamese_scorer(
            mesh, num_tasks, n, k,
            metric=cfg.siamese.distance_metric,
            same_label=cfg.siamese.same_label,
            axis=axis,
        )
        return float(
            scorer(table, head["kernel"], head["bias"][0],
                   store.speaker_utts, store.speaker_counts, key)
        )
    scorer = make_sharded_task_scorer(mesh, num_tasks, n, k, axis)
    return float(scorer(table, store.speaker_utts, store.speaker_counts, key))
