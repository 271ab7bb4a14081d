"""VoxNet: 3D CNN over a 32^3 occupancy grid.

Reference parity: ``PAPC/models/classify/voxnet/voxnet.py``
(Conv3D(1→32,k5,s2)+BN+LeakyReLU → Conv3D(32→32,k3)+MaxPool3D(2) →
FC 32·6^3→128→LeakyReLU→Dropout(0.2)→classes). Channel-last NDHWC.
"""

from __future__ import annotations

import jax

from papc_tpu.nn import core as nn
from papc_tpu.nn.layers import BN_EPS, BN_MOMENTUM


class VoxNet(nn.Module):
    num_classes: int = 10

    @nn.compact
    def __call__(self, voxels: jax.Array, train: bool = True) -> jax.Array:
        """voxels: ``[B, 32, 32, 32, 1]`` occupancy → logits."""
        x = nn.Conv(32, (5, 5, 5), strides=2, padding="VALID")(voxels)
        x = nn.BatchNorm(
            use_running_average=not train, momentum=BN_MOMENTUM, epsilon=BN_EPS
        )(x)
        x = nn.leaky_relu(x)
        x = nn.Conv(32, (3, 3, 3), padding="VALID")(x)
        x = nn.max_pool(x, (2, 2, 2), strides=(2, 2, 2))
        x = x.reshape(x.shape[0], -1)  # [B, 6*6*6*32]
        x = nn.leaky_relu(nn.Dense(128)(x))
        x = nn.Dropout(0.2, deterministic=not train)(x)
        return nn.Dense(self.num_classes)(x)
