"""VFE part segmentation.

Reference parity: ``PAPC/models/segment/vfe/vfe.py`` — VFE trunk returns
(per-point concat feats x1 [2F ch], global pooled x2 [max_points ch]);
x2 tiled back, concatenated, 5-layer seg head.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.models.classify.vfe import VFEBlock
from papc_tpu.nn import SegHead


class VFESeg(nn.Module):
    num_classes: int = 50  # num parts
    feature_channels: int = 256
    max_points: int = 1024

    @nn.compact
    def __call__(
        self,
        points: jax.Array,
        cls_label: jax.Array | None = None,
        train: bool = True,
    ) -> jax.Array:
        """points ``[B, N, 3]`` → per-point logits ``[B, N, num_classes]``."""
        x1, x2 = VFEBlock(
            feature_channels=self.feature_channels,
            max_points=self.max_points,
        )(points, train)
        g = jnp.max(x2, axis=1, keepdims=True)  # [B, 1, max_points]
        g = jnp.broadcast_to(g, (*x1.shape[:2], x2.shape[-1]))
        x = jnp.concatenate([x1, g], axis=-1)  # [B, N, 2F+max_points]
        return SegHead((512, 256, 128, 128), self.num_classes)(x, train)
