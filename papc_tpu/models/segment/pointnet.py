"""Full PointNet part segmentation with T-Nets.

Reference parity: ``PAPC/models/segment/pointnet/pointnet.py`` — input
T-Net, mlp to 64, feature T-Net, mlp to 1024, global max tiled back and
concatenated with the 64-ch point features, 5-layer seg head.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.nn import PointMLP, SegHead, TNet


class PointNetSeg(nn.Module):
    num_classes: int = 50  # num parts
    max_point: int = 2048  # kept for API parity; pooling is global

    @nn.compact
    def __call__(
        self,
        points: jax.Array,
        cls_label: jax.Array | None = None,
        train: bool = True,
    ) -> jax.Array:
        """points ``[B, N, 3]`` → per-point logits ``[B, N, num_classes]``."""
        t_in = TNet(k=3, name="input_tnet")(points, train)
        x = jnp.einsum("bnk,bkj->bnj", points, t_in)
        x = PointMLP((64, 64))(x, train)
        t_feat = TNet(k=64, name="feature_tnet")(x, train)
        x = jnp.einsum("bnk,bkj->bnj", x, t_feat)
        point_feat = x  # [B, N, 64]
        x = PointMLP((64, 128, 1024))(x, train)
        g = jnp.max(x, axis=1, keepdims=True)  # [B, 1, 1024]
        g = jnp.broadcast_to(g, (*point_feat.shape[:2], 1024))
        x = jnp.concatenate([point_feat, g], axis=-1)  # [B, N, 1088]
        return SegHead((512, 256, 128, 128), self.num_classes)(x, train)
