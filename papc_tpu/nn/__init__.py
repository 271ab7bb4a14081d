"""papc_tpu.nn — modules on the in-repo linen subset (`core`): shared-MLP
blocks, T-Nets, PointNet++ set-abstraction/propagation layers."""

from papc_tpu.nn.layers import (
    BN_EPS,
    BN_MOMENTUM,
    MLPHead,
    PointMLP,
    SegHead,
    TNet,
    global_max_pool,
)
from papc_tpu.nn.pointnet2 import (
    FeaturePropagation,
    SetAbstraction,
    SetAbstractionMsg,
)

__all__ = [
    "PointMLP",
    "MLPHead",
    "SegHead",
    "TNet",
    "global_max_pool",
    "SetAbstraction",
    "SetAbstractionMsg",
    "FeaturePropagation",
    "BN_MOMENTUM",
    "BN_EPS",
]
