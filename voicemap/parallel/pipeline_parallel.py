"""Pipeline parallelism (GPipe-style microbatching over a ``pp`` mesh axis).

SURVEY.md §2.2 marks PP as unnecessary for the 4-block encoder (it fits one
chip thousands of times over), so this module is the demonstration-scale
implementation that completes the parallelism matrix: S homogeneous stages
sharded over the ``pp`` axis (stacked parameters, one slice per device), a
``lax.scan`` over ``n_micro + S − 1`` ticks, activations hopping stage→stage
with ``ppermute`` each tick (the pipeline bubble is the standard S−1 ticks).

Works for any ``stage_fn`` whose input/output activations have the same
shape (e.g. a residual conv block or a square dense layer). Property-tested
against the sequential application on the faked CPU mesh, and exercised by
``__graft_entry__.dryrun_multichip``.

The pipeline is fully differentiable: every op in the tick loop (``scan``,
``ppermute``, ``dynamic_update_slice``, ``psum``) has a transpose rule, so
the GPipe BACKWARD is plain ``jax.grad`` through the forward — XLA inverts
the ppermute ring for the cotangent hops (activations flow stage s→s+1,
cotangents s+1→s), exactly GPipe's 1F-then-1B schedule at program level.
``make_gpipe_train_step`` packages that: loss + grads for the stacked stage
parameters, property-tested equal to sequential autodiff
(tests/test_parallel.py::test_gpipe_grads_match_sequential).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def make_gpipe_fn(
    mesh: Mesh,
    stage_fn: Callable,
    n_microbatches: int,
    axis: str = "pp",
):
    """Returns jitted ``(stacked_params, x) → y``.

    ``stacked_params``: pytree whose leaves have a leading stage dim of size
    ``S = mesh.shape[axis]`` (sharded over the axis — each device holds its
    stage's slice). ``x``: (n_microbatches, mb, …) microbatched input,
    replicated; output has the same shape, replicated, equal to applying the
    S stages sequentially to every microbatch.
    """
    S = mesh.shape[axis]

    def device_fn(params_local, x_micro):
        # params_local leaves: (1, …) — this stage's parameters.
        my_params = jax.tree.map(lambda p: p[0], params_local)
        s = jax.lax.axis_index(axis)
        n_ticks = n_microbatches + S - 1
        shift_perm = [(i, i + 1) for i in range(S - 1)]

        def tick(carry, t):
            act_in, outputs = carry
            # Stage 0 injects microbatch t (clamped once the feed drains —
            # those ticks only push bubbles through).
            inject = x_micro[jnp.minimum(t, n_microbatches - 1)]
            act_in = jnp.where(s == 0, inject, act_in)
            y = stage_fn(my_params, act_in)
            # The last stage's tick-t output is microbatch t − (S − 1).
            out_t = t - (S - 1)
            take = jnp.logical_and(s == S - 1, out_t >= 0)
            outputs = jax.lax.dynamic_update_slice(
                outputs,
                jnp.where(take, y, outputs[jnp.maximum(out_t, 0)])[None],
                (jnp.maximum(out_t, 0),) + (0,) * y.ndim,
            )
            # Hop the activation to the next stage.
            next_in = jax.lax.ppermute(y, axis, shift_perm)
            return (next_in, outputs), None

        init = (jnp.zeros_like(x_micro[0]), jnp.zeros_like(x_micro))
        (_, outputs), _ = jax.lax.scan(
            tick, init, jnp.arange(n_ticks)
        )
        # Replicate the last stage's collected outputs to every device.
        mask = (s == S - 1).astype(outputs.dtype)
        return jax.lax.psum(outputs * mask, axis)

    return jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P(axis), P()),
            out_specs=P(),
            check_vma=False,
        )
    )


def make_gpipe_real_encoder_fn(
    cfg,
    mesh: Mesh,
    variables: dict,
    mb: int,
    T: int,
    n_microbatches: int,
    axis: str = "pp",
    train: bool = False,
):
    """GPipe over the REAL ConvEncoder (heterogeneous stages).

    The homogeneous scheme above needs same-shape stage maps, but every real
    encoder block changes shape (T ÷pool, C ×mult) — so this pipelines the
    actual model with the two techniques the shapes force:

    - **Padded union activations**: each hop carries one flat f32 buffer of
      size ``A = max(stage boundary sizes)``; every stage statically slices
      its input shape out and pads its output back in. Static shapes keep
      XLA happy; the pad is dead lanes, not dynamic shapes.
    - **Static per-stage programs under SPMD**: all devices run one program
      containing both stage bodies; ``lax.switch(axis_index(pp), …)``
      executes only the local stage's branch each tick (branches are pure
      compute — no collectives — so a device-varying predicate is legal).

    Split: stage 0 = conv block 0 (the HBM-bound half); stage 1 = blocks 1+
    (compute-bound) + global max-pool + embed head. Both stages run
    ``models/fast_infer._xla_block`` — the ONE shared eval-forward trunk.
    Parameters travel as per-stage ``ravel_pytree`` flats padded to a common
    length and stacked (S, P_max), sharded over ``axis`` — each device holds
    only its stage's slice, as in the homogeneous pipeline.

    ``train=False`` (inference-mode BN, running stats — every serving
    forward): returns ``(fn, pack)`` with ``fn(stacked_flat (S, P_max),
    x_micro (n_micro, mb, T, 1)) → (n_micro, mb, E)`` jitted over the mesh,
    equal to the sequential eval forward; ``pack(variables) →
    stacked_flat``.

    ``train=True`` (production training semantics, round-4 verdict item 7):
    every block normalizes with its OWN microbatch's batch statistics —
    GPipe's standard per-microbatch BN, identical to feeding each
    microbatch through ``ConvEncoder.apply(train=True)`` — and the pipeline
    additionally emits the raw per-microbatch (mean, var) so running stats
    can be updated. Returns ``(fn, pack, apply_stats)`` where ``fn(…) →
    ((n_micro, mb, E), stats)`` and ``apply_stats(variables, stats) →
    new batch_stats pytree`` applies the sequential per-microbatch EMA
    (``r ← m·r + (1−m)·stat_t`` in microbatch order, m = cfg.bn_momentum)
    — property-tested equal to chaining ``apply(train=True)`` over the
    microbatches
    (tests/test_parallel.py). Fully differentiable either way — see
    ``make_gpipe_real_train_step``.
    """
    from jax.flatten_util import ravel_pytree

    from ..models.encoder import _DTYPES, conv_block
    from ..models.fast_infer import _xla_block

    S = mesh.shape[axis]
    if S != 2:
        raise ValueError(f"real-encoder pipeline is a 2-stage split; pp={S}")
    n_blocks = len(cfg.filter_multipliers)
    if n_blocks < 2:
        raise ValueError("need ≥2 conv blocks to split")
    cdt = _DTYPES[cfg.compute_dtype]
    t1 = T // cfg.pool_sizes[0]
    c0 = cfg.filters * cfg.filter_multipliers[0]
    E = cfg.embedding_dim
    A = max(mb * T, mb * t1 * c0, mb * E)

    def _split(v):
        p, st = v["params"], v["batch_stats"]
        v0 = {"params": {"block_0": p["block_0"]},
              "batch_stats": {"block_0": st["block_0"]}}
        v1 = {"params": {k: q for k, q in p.items() if k != "block_0"},
              "batch_stats": {k: q for k, q in st.items() if k != "block_0"}}
        return v0, v1

    v0_t, v1_t = _split(variables)
    flat0_t, unravel0 = ravel_pytree(v0_t)
    flat1_t, unravel1 = ravel_pytree(v1_t)
    P0, P1 = flat0_t.shape[0], flat1_t.shape[0]
    P_max = max(P0, P1)

    # Per-stage batch-stat payload (train mode): stage 0 emits block 0's
    # (mean, var), stage 1 the concat over blocks 1+ — padded to a common
    # lane G so the lax.switch branches return one shape.
    chans = [cfg.filters * m for m in cfg.filter_multipliers]
    g0 = 2 * chans[0]
    g1 = 2 * sum(chans[1:])
    G = max(g0, g1)

    def pack(v):
        f0, _ = ravel_pytree(_split(v)[0])
        f1, _ = ravel_pytree(_split(v)[1])
        stacked = jnp.stack([
            jnp.pad(f0.astype(jnp.float32), (0, P_max - P0)),
            jnp.pad(f1.astype(jnp.float32), (0, P_max - P1)),
        ])
        # Place on THIS pipeline's mesh, stage-sharded: v's leaves may live
        # on a different (e.g. full-DP) mesh, and jit refuses mixed device
        # sets between arguments and the inner shard_map.
        return jax.device_put(
            stacked, jax.sharding.NamedSharding(mesh, P(axis))
        )

    def _block(x, v, i):
        """One conv block, train (per-microbatch batch stats + raw (mean,
        var) out) or eval (running stats, empty stats) — the train math is
        ``encoder.conv_block`` with momentum=0 so its "new EMA" IS the raw
        microbatch statistic."""
        blk = v["params"][f"block_{i}"]
        bst = v["batch_stats"][f"block_{i}"]["bn"]
        if train:
            h, new = conv_block(
                blk, v["batch_stats"][f"block_{i}"], x, pool=cfg.pool_sizes[i],
                dilation=cfg.dilations[i], dropout=0.0, train=True, rng=None,
                momentum=0.0, eps=cfg.bn_epsilon, dtype=cdt,
            )
            return h, [new["bn"]["mean"].astype(jnp.float32),
                       new["bn"]["var"].astype(jnp.float32)]
        h = _xla_block(x, blk, bst, cfg.pool_sizes[i], cfg.dilations[i],
                       cfg.bn_epsilon, cdt)
        return h, []

    def _pack_stats(parts):
        if not train:
            return jnp.zeros((G,), jnp.float32)
        st = jnp.concatenate(parts)
        return jnp.pad(st, (0, G - st.shape[0]))

    def stage0_fn(flat, act):
        v = unravel0(flat[:P0])
        x = act[: mb * T].reshape(mb, T, 1)
        h, st = _block(x, v, 0)
        out = h.astype(jnp.float32).reshape(-1)
        return jnp.pad(out, (0, A - out.shape[0])), _pack_stats(st)

    def stage1_fn(flat, act):
        v = unravel1(flat[:P1])
        h = act[: mb * t1 * c0].reshape(mb, t1, c0)
        st = []
        for i in range(1, n_blocks):
            h, st_i = _block(h, v, i)
            st += st_i
        h = jnp.max(h, axis=1)
        emb = v["params"]["embed"]
        out = (h @ emb["kernel"].astype(cdt) + emb["bias"].astype(cdt)
               ).astype(jnp.float32).reshape(-1)
        return jnp.pad(out, (0, A - out.shape[0])), _pack_stats(st)

    def device_fn(flat_local, x_micro):
        my_flat = flat_local[0]
        s = jax.lax.axis_index(axis)
        n_ticks = n_microbatches + S - 1
        shift_perm = [(i, i + 1) for i in range(S - 1)]

        def tick(carry, t):
            act_in, outputs = carry
            inject = x_micro[jnp.minimum(t, n_microbatches - 1)].reshape(-1)
            inject = jnp.pad(inject, (0, A - inject.shape[0]))
            act_in = jnp.where(s == 0, inject, act_in)
            y, st = jax.lax.switch(
                jnp.minimum(s, S - 1), (stage0_fn, stage1_fn), my_flat, act_in
            )
            out_t = t - (S - 1)
            take = jnp.logical_and(s == S - 1, out_t >= 0)
            emb_t = y[: mb * E].reshape(mb, E)
            outputs = jax.lax.dynamic_update_slice(
                outputs,
                jnp.where(take, emb_t, outputs[jnp.maximum(out_t, 0)])[None],
                (jnp.maximum(out_t, 0), 0, 0),
            )
            next_in = jax.lax.ppermute(y, axis, shift_perm)
            return (next_in, outputs), st

        init = (
            jnp.zeros((A,), jnp.float32),
            jnp.zeros((n_microbatches, mb, E), jnp.float32),
        )
        (_, outputs), st_ys = jax.lax.scan(tick, init, jnp.arange(n_ticks))
        mask = (s == S - 1).astype(outputs.dtype)
        out = jax.lax.psum(outputs * mask, axis)
        if not train:
            return out
        # Stage s saw microbatch t at tick s + t: its real-statistic rows
        # are st_ys[s : s + n_micro] (everything else is bubble recompute).
        stats_loc = jax.lax.dynamic_slice(
            st_ys, (s, 0), (n_microbatches, G)
        )
        return out, stats_loc[None]

    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P(axis), P()),
            out_specs=(P(), P(axis)) if train else P(),
            check_vma=False,
        )
    )
    if not train:
        return fn, pack

    def apply_stats(v, stats):
        """Sequential per-microbatch EMA over the pipeline's raw stats.

        ``stats``: (S, n_micro, G) from ``fn``. Returns a new batch_stats
        pytree — identical to chaining ``apply(train=True)`` microbatch
        by microbatch (running stats
        never feed the train-mode forward, so only the EMA chains)."""
        import numpy as np

        # stats lives on this pipeline's sub-mesh while v may live on a
        # different (e.g. full-DP) mesh; the EMA is O(channels) — do it on
        # the host rather than mixing jit device sets.
        stats = np.asarray(jax.device_get(stats))
        m = cfg.bn_momentum
        cur = {
            k: {"bn": {"mean": v["batch_stats"][k]["bn"]["mean"],
                       "var": v["batch_stats"][k]["bn"]["var"]}}
            for k in v["batch_stats"]
        }
        for t in range(n_microbatches):
            row0 = stats[0, t]
            upd = {"block_0": (row0[: chans[0]],
                               row0[chans[0]: 2 * chans[0]])}
            row1, off = stats[1, t], 0
            for i in range(1, n_blocks):
                upd[f"block_{i}"] = (row1[off: off + chans[i]],
                                     row1[off + chans[i]: off + 2 * chans[i]])
                off += 2 * chans[i]
            for k, (mu, var) in upd.items():
                bn = cur[k]["bn"]
                cur[k] = {"bn": {
                    "mean": m * bn["mean"] + (1.0 - m) * mu,
                    "var": m * bn["var"] + (1.0 - m) * var,
                }}
        return cur

    return fn, pack, apply_stats


def make_gpipe_real_train_step(
    cfg,
    mesh: Mesh,
    variables: dict,
    mb: int,
    T: int,
    n_microbatches: int,
    loss_fn: Callable,
    axis: str = "pp",
):
    """Jitted ``(stacked_flat, x_micro, y) → (loss, grads, stats)`` through
    the real-encoder pipeline with PRODUCTION train semantics: per-microbatch
    batch-stat BN in the forward (``train=True`` per microbatch — the
    standard GPipe BN discipline) and raw per-microbatch (mean, var) out for
    the running-stat EMA. Grads arrive in the same stacked per-stage flat
    layout (sharded over ``axis``); the backward rides the transposed
    pipeline (inverted ppermute ring) — property-tested equal to sequential
    train-mode autodiff in tests/test_parallel.py. Returns ``(step,
    pack, apply_stats)``; after the optimizer update, refresh running stats
    with ``apply_stats(variables, stats)``."""
    gpipe, pack, apply_stats = make_gpipe_real_encoder_fn(
        cfg, mesh, variables, mb, T, n_microbatches, axis=axis, train=True
    )

    @jax.jit
    def step(stacked_flat, x_micro, y):
        def objective(p):
            out, stats = gpipe(p, x_micro)
            return loss_fn(out, y), stats

        (loss, stats), grads = jax.value_and_grad(
            objective, has_aux=True)(stacked_flat)
        return loss, grads, stats

    return step, pack, apply_stats


def make_gpipe_train_step(
    mesh: Mesh,
    stage_fn: Callable,
    loss_fn: Callable,
    n_microbatches: int,
    axis: str = "pp",
):
    """Returns jitted ``(stacked_params, x, y) → (loss, grads)``.

    ``loss_fn(outputs, y) → scalar`` consumes the pipeline's microbatched
    outputs. ``grads`` has the same stacked-stage structure as
    ``stacked_params`` (leading dim S, sharded over ``axis``); feed it to any
    optax update. The backward pass rides the transposed pipeline (inverted
    ppermute ring) inside the same compiled program — no separate schedule
    code.
    """
    gpipe = make_gpipe_fn(mesh, stage_fn, n_microbatches, axis=axis)

    @jax.jit
    def step(stacked_params, x, y):
        def objective(p):
            return loss_fn(gpipe(p, x), y)

        return jax.value_and_grad(objective)(stacked_params)

    return step
