"""PointNet++ classifiers (single-scale and multi-scale grouping).

Reference parity: ``PAPC/models/classify/pointnet2/pointnet2.py``
(SSG: SA(512,0.2,32,[64,64,128]) → SA(128,0.4,64,[128,128,256]) →
SA(group_all,[256,512,1024]) → FC 1024→512→256→classes with BN+Dropout;
MSG: two multi-scale SA stages then group_all).
"""

from __future__ import annotations

import jax

from papc_tpu.nn import core as nn
from papc_tpu.nn import MLPHead, SetAbstraction, SetAbstractionMsg


class PointNet2SSGClas(nn.Module):
    num_classes: int = 16
    normal_channel: bool = False
    # reference sizes (npoint, nsample per SA stage); overridable so tiny
    # dry-run shapes stay cheap
    npoints: tuple = (512, 128)
    nsamples: tuple = (32, 64)

    @nn.compact
    def __call__(self, points: jax.Array, train: bool = True) -> jax.Array:
        """points: ``[B, N, 3(+3)]`` → logits ``[B, num_classes]``."""
        if self.normal_channel:
            xyz, norm = points[..., :3], points[..., 3:]
        else:
            xyz, norm = points, None
        l1_xyz, l1_points = SetAbstraction(
            self.npoints[0], 0.2, self.nsamples[0], (64, 64, 128)
        )(xyz, norm, train)
        l2_xyz, l2_points = SetAbstraction(
            self.npoints[1], 0.4, self.nsamples[1], (128, 128, 256)
        )(l1_xyz, l1_points, train)
        _, l3_points = SetAbstraction(
            None, None, None, (256, 512, 1024), group_all=True
        )(l2_xyz, l2_points, train)
        x = l3_points.reshape(points.shape[0], 1024)
        return MLPHead(
            (512, 256),
            self.num_classes,
            dropout_rate=0.4,
            bn=True,
            per_layer_dropout=True,
        )(x, train)


class PointNet2MSGClas(nn.Module):
    num_classes: int = 16
    normal_channel: bool = False

    @nn.compact
    def __call__(self, points: jax.Array, train: bool = True) -> jax.Array:
        """points: ``[B, N, 3(+3)]`` → logits ``[B, num_classes]``."""
        if self.normal_channel:
            xyz, norm = points[..., :3], points[..., 3:]
        else:
            xyz, norm = points, None
        l1_xyz, l1_points = SetAbstractionMsg(
            512,
            (0.1, 0.2, 0.4),
            (16, 32, 128),
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
        )(xyz, norm, train)
        l2_xyz, l2_points = SetAbstractionMsg(
            128,
            (0.2, 0.4, 0.8),
            (32, 64, 128),
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)),
        )(l1_xyz, l1_points, train)
        _, l3_points = SetAbstraction(
            None, None, None, (256, 512, 1024), group_all=True
        )(l2_xyz, l2_points, train)
        x = l3_points.reshape(points.shape[0], 1024)
        # reference uses Dropout(0.4) after fc1 and Dropout(0.5) after fc2;
        # a single rate is used per head stage here via two sub-heads is
        # overkill — 0.4/0.5 difference is preserved explicitly:
        x = nn.Dense(512)(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        x = nn.relu(x)
        x = nn.Dropout(0.4, deterministic=not train)(x)
        x = nn.Dense(256)(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        x = nn.relu(x)
        x = nn.Dropout(0.5, deterministic=not train)(x)
        return nn.Dense(self.num_classes)(x)
