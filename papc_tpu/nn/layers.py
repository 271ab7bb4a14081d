"""Shared building-block modules (:mod:`papc_tpu.nn.core`).

The reference expresses per-point MLPs as paddle ``Conv1D(kernel=1)`` /
``Conv2D(1x1)`` stacks over a channel-first layout. A 1x1 conv IS a
matmul, so here every shared MLP is a ``nn.Dense`` over the LAST axis of a
channel-last tensor — one GEMM per layer, with XLA fusing the BN + ReLU
chains around it.

Parameter registration is by construction (module trees), fixing the
reference's unregistered-params bug (its SA layers keep convs in plain
python lists — ``pointnet2_basic_layers.py:185-191`` — so those weights
never train).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn

# Paddle nn.BatchNorm defaults (momentum=0.9, epsilon=1e-5) — kept for
# training-dynamics parity with the reference.
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class PointMLP(nn.Module):
    """Dense→BN→ReLU stack applied along the last (channel) axis.

    Equivalent to the reference's ``Conv1D(k=1)+BatchNorm+ReLU`` sequences
    (e.g. ``classify/pointnet_base/pointnet_base.py:8-26``) and its
    ``Conv2D(1x1)+BatchNorm2D+ReLU`` stacks over grouped neighborhoods —
    the layout makes them the same module here.

    ``pool_max=True`` additionally takes the max over axis 2 (the
    K-neighborhood axis of a grouped ``[B, S, K, C]`` tensor) — the SA
    symmetric function.

    Input: ``[..., C_in]`` → Output: ``[..., features[-1]]``
    (``[B, S, C_out]`` when ``pool_max``).
    """

    features: Sequence[int]
    pool_max: bool = False

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = True) -> jax.Array:
        for i, f in enumerate(self.features):
            x = nn.Dense(f, name=f"Dense_{i}")(x)
            x = nn.BatchNorm(
                use_running_average=not train,
                momentum=BN_MOMENTUM,
                epsilon=BN_EPS,
                name=f"BatchNorm_{i}",
            )(x)
            x = nn.relu(x)
        return jnp.max(x, axis=2) if self.pool_max else x


class MLPHead(nn.Module):
    """Classifier head: Dense→ReLU(→Dropout) stack + final Dense.

    ``dropout_rate`` applies before the final layer only (reference heads:
    ``...512→ReLU→256→ReLU→Dropout(0.7)→classes``).
    ``bn`` inserts BatchNorm after each hidden Dense (PointNet++ heads use
    Dense→BN→ReLU→Dropout per stage, ``classify/pointnet2/pointnet2.py:36-39``).
    ``per_layer_dropout`` applies dropout after every hidden stage instead
    of only before the final layer.
    """

    hidden: Sequence[int]
    out: int
    dropout_rate: float = 0.0
    bn: bool = False
    per_layer_dropout: bool = False

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = True) -> jax.Array:
        for h in self.hidden:
            x = nn.Dense(h)(x)
            if self.bn:
                x = nn.BatchNorm(
                    use_running_average=not train,
                    momentum=BN_MOMENTUM,
                    epsilon=BN_EPS,
                )(x)
            x = nn.relu(x)
            if self.per_layer_dropout and self.dropout_rate > 0:
                x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        if not self.per_layer_dropout and self.dropout_rate > 0:
            x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        return nn.Dense(self.out)(x)


class SegHead(nn.Module):
    """Per-point segmentation head: PointMLP stack + final Dense to classes.

    Reference: the five-layer ``seg_net`` pattern
    (``segment/pointnet_base/pointnet_base.py:9-24``).
    """

    hidden: Sequence[int]
    out: int

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = True) -> jax.Array:
        x = PointMLP(self.hidden)(x, train)
        return nn.Dense(self.out)(x)


def global_max_pool(x: jax.Array, axis: int = 1) -> jax.Array:
    """Max over the points axis — the PointNet symmetric function."""
    return jnp.max(x, axis=axis)


class TNet(nn.Module):
    """Spatial/feature transform net predicting a ``[k, k]`` matrix.

    Reference: ``classify/pointnet/pointnet_Conv1D.py:8-28`` — a
    64→128→1024 PointMLP, global max pool, then an FC stack whose final
    layer is ZERO-initialized with an identity bias so the initial
    transform is I (same trick as the reference's Assign initializers).
    """

    k: int

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = True) -> jax.Array:
        # x: [B, N, k]
        h = PointMLP((64, 128, 1024))(x, train)
        h = global_max_pool(h)  # [B, 1024]
        h = nn.relu(nn.Dense(512)(h))
        h = nn.relu(nn.Dense(256)(h))
        eye = jnp.eye(self.k, dtype=x.dtype).reshape(-1)
        h = nn.Dense(
            self.k * self.k,
            kernel_init=nn.initializers.zeros,
            bias_init=lambda key, shape, dtype=jnp.float32: eye.astype(dtype),
        )(h)
        return h.reshape(-1, self.k, self.k)
