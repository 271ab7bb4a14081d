"""Full PointNet classifier with input/feature transform nets.

Reference parity: ``PAPC/models/classify/pointnet/pointnet_Conv1D.py``
(input T-Net 3x3 with identity-init, mlp 3→64→64, feature T-Net 64x64,
mlp 64→64→128→1024, global max, FC 1024→512→256→Dropout(0.7)→classes).
The T-Net matmul transforms are batched ``[B,N,k] @ [B,k,k]`` einsums;
no layout transposes are needed in channel-last form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.nn import MLPHead, PointMLP, TNet, global_max_pool


class PointNetClas(nn.Module):
    num_classes: int = 16
    max_point: int = 2048  # kept for API parity; unused (pooling is global)

    @nn.compact
    def __call__(self, points: jax.Array, train: bool = True) -> jax.Array:
        """points: ``[B, N, 3]`` → logits ``[B, num_classes]``."""
        t_in = TNet(k=3, name="input_tnet")(points, train)
        x = jnp.einsum("bnk,bkj->bnj", points, t_in)
        x = PointMLP((64, 64))(x, train)
        t_feat = TNet(k=64, name="feature_tnet")(x, train)
        x = jnp.einsum("bnk,bkj->bnj", x, t_feat)
        x = PointMLP((64, 128, 1024))(x, train)
        x = global_max_pool(x)  # [B, 1024]
        return MLPHead((512, 256), self.num_classes, dropout_rate=0.7)(
            x, train
        )


class PointNetConv2DClas(nn.Module):
    """The reference's Conv2D-flavored PointNet classifier.

    Reference parity: ``PAPC/models/classify/pointnet/pointnet_Conv2D.py``
    — identical network to the Conv1D variant (a 1x1 Conv2D over
    ``[B,C,N,1]`` IS the channel-last Dense used here) except that the
    head ends in LogSoftmax (:75), so this model returns log-probabilities
    rather than raw logits. The reference never exports this class
    (``classify/__init__.py`` imports only the Conv1D variant); we export
    and test it. Deviation: the feature T-Net keeps the identity-init of
    our shared :class:`TNet` (the reference leaves its 256→64·64 layer
    default-initialized — an omission, not a design choice).
    """

    num_classes: int = 16
    max_point: int = 2048  # kept for API parity; unused (pooling is global)

    @nn.compact
    def __call__(self, points: jax.Array, train: bool = True) -> jax.Array:
        """points: ``[B, N, 3]`` → log-probabilities ``[B, num_classes]``."""
        t_in = TNet(k=3, name="input_tnet")(points, train)
        x = jnp.einsum("bnk,bkj->bnj", points, t_in)
        x = PointMLP((64, 64))(x, train)
        t_feat = TNet(k=64, name="feature_tnet")(x, train)
        x = jnp.einsum("bnk,bkj->bnj", x, t_feat)
        x = PointMLP((64, 128, 1024))(x, train)
        x = global_max_pool(x)
        logits = MLPHead((512, 256), self.num_classes, dropout_rate=0.7)(
            x, train
        )
        return jax.nn.log_softmax(logits, axis=-1)
