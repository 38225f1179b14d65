"""Train state + optimizer construction.

Reference optimizer: ``Adam(clipnorm=1.)`` (SURVEY.md §2.1 siamese script) →
optax chain clip_by_global_norm + adam, with the learning rate injected as a
runtime scalar so the host-side ReduceLROnPlateau equivalent can anneal it
without recompilation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    batch_stats: Any
    opt_state: Any
    lr: jnp.ndarray  # current learning rate (annealed on plateau)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def make_optimizer(clipnorm: float = 1.0) -> optax.GradientTransformation:
    """clip_by_global_norm(clipnorm) → Adam with injected learning rate."""
    return optax.chain(
        optax.clip_by_global_norm(clipnorm),
        optax.scale_by_adam(),
        # Multiply by -lr at apply time; lr arrives via TrainState.lr.
        optax.scale_by_learning_rate(1.0, flip_sign=True),
    )


def init_state(
    params: Any,
    batch_stats: Any,
    tx: optax.GradientTransformation,
    learning_rate: float,
) -> TrainState:
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=batch_stats,
        opt_state=tx.init(params),
        lr=jnp.asarray(learning_rate, jnp.float32),
    )


def apply_updates(
    state: TrainState, grads: Any, tx: optax.GradientTransformation, new_batch_stats: Any
) -> TrainState:
    updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
    # scale_by_learning_rate(1.0) handled the sign; scale by the runtime lr.
    updates = jax.tree.map(lambda u: u * state.lr, updates)
    new_params = optax.apply_updates(state.params, updates)
    return state.replace(
        step=state.step + 1,
        params=new_params,
        opt_state=new_opt_state,
        batch_stats=new_batch_stats,
    )
