"""Mixed precision for training.

The reference ships an fp16 ``MixedPrecisionWrapper`` with an fp32 master
copy and nan/inf-triggered dynamic loss scaling (``libs/tools/optim.py``).
Here the low-precision format is bfloat16, whose fp32-sized exponent
makes loss scaling unnecessary — so the design is:
params and optimizer state stay fp32, compute (activations + grads) runs
bf16, losses reduce in fp32. A dynamic loss-scale transform is still
provided for parity/fp16 experiments.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax


def cast_floating(tree, dtype):
    """Cast floating leaves of a pytree to ``dtype``."""
    def cast(x):
        if jnp.issubdtype(jnp.result_type(x), jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree_util.tree_map(cast, tree)


def bf16_compute(loss_fn):
    """Wrap a ``loss_fn(params, *args)`` so the forward/backward runs with
    bf16 params while gradients accumulate into fp32 (param tree dtype)."""

    def wrapped(params, *args, **kwargs):
        return loss_fn(cast_floating(params, jnp.bfloat16), *args, **kwargs)

    return wrapped


class LossScaleState(NamedTuple):
    scale: jax.Array
    good_steps: jax.Array


def dynamic_loss_scale(
    init_scale: float = 512.0,
    growth_interval: int = 2000,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,
) -> optax.GradientTransformation:
    """Dynamic loss scaling as an optax transform: unscales incoming
    grads, skips the update (zeroes it) and decays the scale on
    nonfinite grads, grows the scale after ``growth_interval`` clean
    steps (reference ``optim.py:30-100`` semantics)."""

    def init_fn(params):
        del params
        return LossScaleState(
            jnp.asarray(init_scale, jnp.float32), jnp.zeros((), jnp.int32)
        )

    def update_fn(updates, state, params=None):
        del params
        unscaled = jax.tree_util.tree_map(
            lambda g: g / state.scale, updates
        )
        finite = jnp.all(
            jnp.asarray(
                [
                    jnp.all(jnp.isfinite(g))
                    for g in jax.tree_util.tree_leaves(unscaled)
                ]
            )
        )
        new_scale = jnp.where(
            finite,
            jnp.where(
                state.good_steps + 1 >= growth_interval,
                state.scale * growth_factor,
                state.scale,
            ),
            state.scale * backoff_factor,
        )
        new_good = jnp.where(
            finite,
            jnp.where(
                state.good_steps + 1 >= growth_interval,
                0,
                state.good_steps + 1,
            ),
            0,
        )
        out = jax.tree_util.tree_map(
            lambda g: jnp.where(finite, g, jnp.zeros_like(g)), unscaled
        )
        return out, LossScaleState(new_scale, new_good)

    return optax.GradientTransformation(init_fn, update_fn)
