"""PointNet++ set-abstraction / feature-propagation modules.

Reference parity: ``PAPC/models/layers/pointnet2_basic_layers.py:179-335``.
All tensors are channel-last: positions ``[B, N, 3]``, features
``[B, N, D]``. Grouped neighborhoods are ``[B, S, K, C]`` and the shared
MLP is a Dense over the last axis — one matmul per layer over the
whole (S*K) super-batch, with max over K as the symmetric pooling.

The reference's SA layers keep their convs in plain python lists (so those
parameters never register / never train — its ``:185-191`` bug); module
registration fixes that by construction.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.nn.layers import PointMLP
from papc_tpu.ops import (
    index_points,
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
    three_nn_interpolate,
)
from papc_tpu.ops.sampling import farthest_point_sample


class SetAbstraction(nn.Module):
    """FPS → ball query → grouped shared-MLP → max over neighborhood.

    Reference: ``PointNetSetAbstraction`` (:179-221).
    ``__call__(xyz [B,N,3], points [B,N,D] | None)`` →
    ``(new_xyz [B,S,3], new_points [B,S,mlp[-1]])``.
    """

    npoint: int | None
    radius: float | None
    nsample: int | None
    mlp: Sequence[int]
    group_all: bool = False

    @nn.compact
    def __call__(self, xyz, points, train: bool = True):
        if self.group_all:
            new_xyz, grouped = sample_and_group_all(xyz, points)
        else:
            new_xyz, grouped = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points
            )
        # Dense→BN→ReLU stack + max over K
        with jax.named_scope("sa_mlp"):
            new_points = PointMLP(self.mlp, pool_max=True)(grouped, train)
        return new_xyz, new_points


class SetAbstractionMsg(nn.Module):
    """Multi-scale grouping SA: one FPS, several (radius, nsample, mlp)
    branches, concatenated along channels.

    Reference: ``PointNetSetAbstractionMsg`` (:224-281).
    """

    npoint: int
    radius_list: Sequence[float]
    nsample_list: Sequence[int]
    mlp_list: Sequence[Sequence[int]]

    @nn.compact
    def __call__(self, xyz, points, train: bool = True):
        B, N, C = xyz.shape
        S = self.npoint
        fps_idx = farthest_point_sample(xyz, S)
        new_xyz = index_points(xyz, fps_idx)  # [B, S, 3]
        outs = []
        combined = (
            None
            if points is None
            else jnp.concatenate([points, xyz], axis=-1)
        )
        for i, radius in enumerate(self.radius_list):
            K = self.nsample_list[i]
            idx = query_ball_point(radius, K, xyz, new_xyz)
            if combined is not None:
                # reference concat order (features, rel_xyz) — :262 —
                # realized as ONE gather of the pre-concatenated
                # (features, xyz) + center subtraction on the xyz
                # channels (see ops.grouping.sample_and_group)
                grouped = index_points(combined, idx)
                grouped = grouped.at[..., -3:].add(
                    -new_xyz[:, :, None, :]
                )
            else:
                grouped = (
                    index_points(xyz, idx) - new_xyz[:, :, None, :]
                )
            outs.append(
                PointMLP(self.mlp_list[i], pool_max=True)(grouped, train)
            )  # [B, S, C_i]
        return new_xyz, jnp.concatenate(outs, axis=-1)


class FeaturePropagation(nn.Module):
    """Upsample sparse features to a dense set by 3-NN inverse-distance
    interpolation, concat skip features, shared MLP.

    Reference: ``PointNetFeaturePropagation`` (:284-335).
    ``__call__(xyz1 [B,N,3], xyz2 [B,S,3], points1 [B,N,D1] | None,
    points2 [B,S,D2])`` → ``[B, N, mlp[-1]]``.
    """

    mlp: Sequence[int]

    @nn.compact
    def __call__(self, xyz1, xyz2, points1, points2, train: bool = True):
        B, N, _ = xyz1.shape
        S = xyz2.shape[1]
        if S == 1:
            interpolated = jnp.broadcast_to(
                points2, (B, N, points2.shape[-1])
            )
        else:
            interpolated = three_nn_interpolate(xyz1, xyz2, points2)
        if points1 is not None:
            new_points = jnp.concatenate([points1, interpolated], axis=-1)
        else:
            new_points = interpolated
        return PointMLP(self.mlp)(new_points, train)
