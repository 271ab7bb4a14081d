"""Model registry: (model_name, mode) → model module + input kind.

Mirrors the reference trainer's ``init_model`` dispatch table
(``PAPC/train.py:8-60``): the same 13 model/mode combos, same default
hyperparameters. ``input_kind`` tells the data layer which loader family
feeds the model ('points' = ShapeNet clouds, 'kd' = kd-tree leaves +
split dims, 'voxel' = 32^3 occupancy grids), matching the reference's
``DataLoader`` dispatch (``PAPC/datasets/dataloader.py:5-40``).

The tables are module-level factory dicts so the combo list is
enumerable (:func:`registry_combos`) — tests iterate the registry
itself rather than a hand-copied list that can drift (the reference's
Conv2D PointNet was constructible but unreachable through its loader
table precisely because of such drift).
"""

from __future__ import annotations

import dataclasses

from papc_tpu.nn import core as nn
from papc_tpu.models import classify, segment


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model: nn.Module
    input_kind: str  # 'points' | 'kd' | 'voxel'
    mode: str  # 'clas' | 'seg'


# mode → name → (factory(num_classes, num_parts, max_point), input_kind)
_TABLES = {
    "clas": {
        "voxnet": (
            lambda nc, np_, mp: classify.VoxNet(num_classes=nc),
            "voxel",
        ),
        "kdnet": (
            lambda nc, np_, mp: classify.KDNet(num_classes=nc),
            "kd",
        ),
        "pointnet_basic": (
            lambda nc, np_, mp: classify.PointNetBasicClas(
                num_classes=nc, max_points=mp
            ),
            "points",
        ),
        "pointnet": (
            lambda nc, np_, mp: classify.PointNetClas(
                num_classes=nc, max_point=mp
            ),
            "points",
        ),
        # the reference ships (but never exports) a Conv2D-flavored
        # PointNet with a LogSoftmax head; here it is a first-class
        # registry entry (pointnet_Conv2D.py)
        "pointnet_conv2d": (
            lambda nc, np_, mp: classify.PointNetConv2DClas(
                num_classes=nc, max_point=mp
            ),
            "points",
        ),
        "vfe": (
            lambda nc, np_, mp: classify.VFEClas(
                num_classes=nc, max_points=mp
            ),
            "points",
        ),
        "pointnet2_ssg": (
            lambda nc, np_, mp: classify.PointNet2SSGClas(num_classes=nc),
            "points",
        ),
        "pointnet2_msg": (
            lambda nc, np_, mp: classify.PointNet2MSGClas(num_classes=nc),
            "points",
        ),
    },
    "seg": {
        "kdunet": (
            lambda nc, np_, mp: segment.KDUNet(num_classes=np_),
            "kd",
        ),
        "pointnet_basic": (
            lambda nc, np_, mp: segment.PointNetBasicSeg(
                num_classes=np_, max_points=mp
            ),
            "points",
        ),
        "pointnet": (
            lambda nc, np_, mp: segment.PointNetSeg(
                num_classes=np_, max_point=mp
            ),
            "points",
        ),
        "vfe": (
            lambda nc, np_, mp: segment.VFESeg(
                num_classes=np_, max_points=mp
            ),
            "points",
        ),
        "pointnet2_ssg": (
            lambda nc, np_, mp: segment.PointNet2SSGSeg(
                num_classes=nc, num_parts=np_
            ),
            "points",
        ),
        "pointnet2_msg": (
            lambda nc, np_, mp: segment.PointNet2MSGSeg(
                num_classes=nc, num_parts=np_
            ),
            "points",
        ),
    },
}


def registry_combos() -> tuple[tuple[str, str], ...]:
    """Every (model_name, mode) combo the registry can construct."""
    return tuple(
        (name, mode) for mode, table in _TABLES.items() for name in table
    )


def init_model(
    model_name: str = "pointnet_basic",
    mode: str = "clas",
    num_classes: int = 16,
    num_parts: int = 50,
    max_point: int = 1024,
) -> ModelSpec:
    if mode == "detect":
        raise SystemExit(
            "Error: use papc_tpu.models.detect / the detection CLI for "
            "detection models"
        )
    if mode not in _TABLES:
        raise SystemExit('Error: mode should be "clas", "detect" or "seg"')
    table = _TABLES[mode]
    if model_name not in table:
        raise SystemExit("Error: model is incorrect")
    factory, kind = table[model_name]
    model = factory(num_classes, num_parts, max_point)
    return ModelSpec(model=model, input_kind=kind, mode=mode)
