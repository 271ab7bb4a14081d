"""Loader dispatch: (mode, model_name) → loader, mirroring the
reference's ``PAPC/datasets/dataloader.py:5-40`` table.

Unlike the reference's hand-written name lists (which drifted: its
Conv2D PointNet is constructible but unreachable through the loader
table), the loader family here is derived from the model registry's
``input_kind`` — every registered model is loadable by construction.
"""

from __future__ import annotations

from papc_tpu.data.kd import KDLoader
from papc_tpu.data.shapenet import ShapeNetLoader
from papc_tpu.data.voxel import VoxelLoader
from papc_tpu.models.registry import init_model


def make_dataloader(
    model_name: str,
    max_point: int,
    batchsize: int,
    path: str = "./data/",
    mode1: str = "clas",
    mode2: str = "train",
    seed: int = 0,
):
    if mode1 not in ("clas", "seg"):
        raise SystemExit('Error: mode should be "clas", "detect" or "seg"')
    # registry lookup raises the reference's exact "model is incorrect"
    # SystemExit for unknown names (modules are cheap dataclasses —
    # no params are created here)
    kind = init_model(model_name, mode1, max_point=max_point).input_kind
    if kind == "voxel":
        return VoxelLoader(path, mode2, max_point, batchsize, seed=seed)
    if kind == "kd":
        return KDLoader(
            path, mode2, max_point, batchsize,
            with_pid=(mode1 == "seg"), seed=seed,
        )
    if kind == "points":
        return ShapeNetLoader(
            path, mode2, max_point, batchsize,
            with_pid=(mode1 == "seg"), seed=seed,
        )
    raise SystemExit("Error: model is incorrect")
