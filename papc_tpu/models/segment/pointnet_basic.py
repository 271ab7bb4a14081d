"""PointNet-Basic part segmentation.

Reference parity: ``PAPC/models/segment/pointnet_base/pointnet_base.py`` —
trunk returns (low feats 64ch, high feats max_points ch); global max of
the high feats is tiled back onto each point, concatenated with the low
feats, and pushed through a 5-layer seg head to per-point logits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.nn import PointMLP, SegHead


class PointNetBasicSeg(nn.Module):
    num_classes: int = 50  # num parts
    max_points: int = 1024

    @nn.compact
    def __call__(
        self,
        points: jax.Array,
        cls_label: jax.Array | None = None,
        train: bool = True,
    ) -> jax.Array:
        """points ``[B, N, 3]`` → per-point logits ``[B, N, num_classes]``.
        ``cls_label`` accepted for interface uniformity; unused (reference
        ignores it too)."""
        x1 = PointMLP((64, 64))(points, train)  # [B, N, 64]
        x2 = PointMLP((64, 128, self.max_points))(x1, train)
        g = jnp.max(x2, axis=1, keepdims=True)  # [B, 1, max_points]
        g = jnp.broadcast_to(g, (*x1.shape[:2], x2.shape[-1]))
        x = jnp.concatenate([x1, g], axis=-1)  # [B, N, 64+max_points]
        return SegHead((512, 256, 128, 128), self.num_classes)(x, train)
