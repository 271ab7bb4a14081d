"""VFE (VoxelNet-style voxel feature encoder) used as a classifier.

Reference parity: ``PAPC/models/classify/vfe/vfe.py`` — PointNet_Basic
(3→…→256) trunk, global-max tiled back and concatenated per point (the
VFE trick), second trunk (512→…→max_points), global max, FC head.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.nn import MLPHead, PointMLP, global_max_pool


class VFEBlock(nn.Module):
    """Two-stage point MLP with the global-feature concat in between.

    Returns per-point features after stage-1 concat (``x1``) and the
    global pooled stage-2 feature (``x2``) so the segmentation variant can
    reuse both (reference ``segment/vfe/vfe.py:79-99``).
    """

    feature_channels: int = 256
    max_points: int = 1024

    @nn.compact
    def __call__(self, points: jax.Array, train: bool = True):
        # stage 1: [B, N, 3] → [B, N, F]
        x1 = PointMLP((64, 64))(points, train)
        x1 = PointMLP((64, 128, self.feature_channels))(x1, train)
        # global max, tiled and concatenated onto every point: [B, N, 2F]
        g = jnp.max(x1, axis=1, keepdims=True)
        g = jnp.broadcast_to(g, x1.shape)
        x1 = jnp.concatenate([x1, g], axis=-1)
        # stage 2: [B, N, 2F] → [B, N, max_points]
        x2 = PointMLP((64, 64))(x1, train)
        x2 = PointMLP((64, 128, self.max_points))(x2, train)
        return x1, x2


class VFEClas(nn.Module):
    num_classes: int = 16
    max_points: int = 1024

    @nn.compact
    def __call__(self, points: jax.Array, train: bool = True) -> jax.Array:
        """points: ``[B, N, 3]`` → logits ``[B, num_classes]``."""
        _, x2 = VFEBlock(max_points=self.max_points)(points, train)
        x = global_max_pool(x2)  # [B, max_points]
        return MLPHead((512, 256), self.num_classes, dropout_rate=0.7)(
            x, train
        )
