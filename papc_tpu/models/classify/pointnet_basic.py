"""PointNet-Basic classifier.

Reference parity: ``PAPC/models/classify/pointnet_base/pointnet_base.py``
(mlp 3→64→64, 64→64→128→max_points, global max pool, FC
max_points→512→256→Dropout(0.7)→classes). Channel-last here; the two conv
stacks become Dense stacks over the point cloud's feature axis.
"""

from __future__ import annotations

import jax

from papc_tpu.nn import core as nn
from papc_tpu.nn import MLPHead, PointMLP, global_max_pool


class PointNetBasicClas(nn.Module):
    num_classes: int = 16
    max_points: int = 1024

    @nn.compact
    def __call__(self, points: jax.Array, train: bool = True) -> jax.Array:
        """points: ``[B, N, 3]`` → logits ``[B, num_classes]``."""
        x = PointMLP((64, 64))(points, train)
        x = PointMLP((64, 128, self.max_points))(x, train)
        x = global_max_pool(x)  # [B, max_points]
        return MLPHead((512, 256), self.num_classes, dropout_rate=0.7)(
            x, train
        )
