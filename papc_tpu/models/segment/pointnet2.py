"""PointNet++ part segmentation (SSG and MSG).

Reference parity: ``PAPC/models/segment/pointnet2/pointnet2.py`` — SSG/MSG
encoders, three FeaturePropagation decoders; the object-class one-hot is
tiled over points and injected at the last FP stage; head
conv(128)→BN→ReLU→Dropout(0.5)→conv(num_parts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.nn import (
    FeaturePropagation,
    SetAbstraction,
    SetAbstractionMsg,
)


class _SegHead2(nn.Module):
    num_parts: int

    @nn.compact
    def __call__(self, x, train: bool = True):
        x = nn.Dense(128)(x)
        x = nn.BatchNorm(
            use_running_average=not train, momentum=0.9, epsilon=1e-5
        )(x)
        x = nn.relu(x)
        x = nn.Dropout(0.5, deterministic=not train)(x)
        return nn.Dense(self.num_parts)(x)


class PointNet2SSGSeg(nn.Module):
    num_classes: int = 16  # object categories (one-hot injected)
    num_parts: int = 50
    normal_channel: bool = False
    # reference sizes (segment/pointnet2/pointnet2.py:14-16); override
    # for tiny-shape CI runs, like the clas twin
    npoints: tuple = (512, 128)
    nsamples: tuple = (32, 64)

    @nn.compact
    def __call__(
        self, points: jax.Array, cls_label: jax.Array, train: bool = True
    ) -> jax.Array:
        """points ``[B, N, 3(+3)]``, cls_label ``[B]`` int →
        per-point logits ``[B, N, num_parts]``."""
        B, N, _ = points.shape
        if self.normal_channel:
            l0_xyz = points[..., :3]
        else:
            l0_xyz = points
        l0_points = points  # reference feeds xyz as the initial features
        l1_xyz, l1_points = SetAbstraction(
            self.npoints[0], 0.2, self.nsamples[0], (64, 64, 128)
        )(l0_xyz, l0_points, train)
        l2_xyz, l2_points = SetAbstraction(
            self.npoints[1], 0.4, self.nsamples[1], (128, 128, 256)
        )(l1_xyz, l1_points, train)
        l3_xyz, l3_points = SetAbstraction(
            None, None, None, (256, 512, 1024), group_all=True
        )(l2_xyz, l2_points, train)
        l2_points = FeaturePropagation((256, 256))(
            l2_xyz, l3_xyz, l2_points, l3_points, train
        )
        l1_points = FeaturePropagation((256, 128))(
            l1_xyz, l2_xyz, l1_points, l2_points, train
        )
        one_hot = jax.nn.one_hot(cls_label.reshape(B), self.num_classes)
        one_hot = jnp.broadcast_to(
            one_hot[:, None, :], (B, N, self.num_classes)
        )
        l0_in = jnp.concatenate([one_hot, l0_xyz, l0_points], axis=-1)
        l0_points = FeaturePropagation((128, 128, 128))(
            l0_xyz, l1_xyz, l0_in, l1_points, train
        )
        return _SegHead2(self.num_parts)(l0_points, train)


class PointNet2MSGSeg(nn.Module):
    num_classes: int = 16
    num_parts: int = 50
    normal_channel: bool = False

    @nn.compact
    def __call__(
        self, points: jax.Array, cls_label: jax.Array, train: bool = True
    ) -> jax.Array:
        """points ``[B, N, 3(+3)]``, cls_label ``[B]`` int →
        per-point logits ``[B, N, num_parts]``."""
        B, N, _ = points.shape
        if self.normal_channel:
            l0_xyz = points[..., :3]
        else:
            l0_xyz = points
        l0_points = points
        l1_xyz, l1_points = SetAbstractionMsg(
            512,
            (0.1, 0.2, 0.4),
            (32, 64, 128),
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
        )(l0_xyz, l0_points, train)
        l2_xyz, l2_points = SetAbstractionMsg(
            128,
            (0.4, 0.8),
            (64, 128),
            ((128, 128, 256), (128, 196, 256)),
        )(l1_xyz, l1_points, train)
        l3_xyz, l3_points = SetAbstraction(
            None, None, None, (256, 512, 1024), group_all=True
        )(l2_xyz, l2_points, train)
        l2_points = FeaturePropagation((256, 256))(
            l2_xyz, l3_xyz, l2_points, l3_points, train
        )
        l1_points = FeaturePropagation((256, 128))(
            l1_xyz, l2_xyz, l1_points, l2_points, train
        )
        one_hot = jax.nn.one_hot(cls_label.reshape(B), self.num_classes)
        one_hot = jnp.broadcast_to(
            one_hot[:, None, :], (B, N, self.num_classes)
        )
        l0_in = jnp.concatenate([one_hot, l0_xyz, l0_points], axis=-1)
        l0_points = FeaturePropagation((128, 128))(
            l0_xyz, l1_xyz, l0_in, l1_points, train
        )
        return _SegHead2(self.num_parts)(l0_points, train)
