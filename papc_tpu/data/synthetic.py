"""Synthetic ShapeNet-format datasets for tests, smoke runs and benches.

Generates ``.h5`` shards with the exact schema the reference consumes
(``data`` [S, N, 3] float, ``label`` [S, 1] int, ``pid`` [S, N] int —
see ``PAPC/datasets/pnloader.py``), with geometrically separable classes
so a real model can demonstrably learn (loss decreases, accuracy rises).
"""

from __future__ import annotations

import os

import numpy as np

from papc_tpu.data.shapenet import TEST_LIST, TRAIN_LIST, VAL_LIST


def _make_cloud(rng, label: int, n_points: int, num_classes: int):
    """A class-dependent gaussian blob mixture: classes are separable by
    centroid offset + anisotropic scale, parts by octant."""
    offset = np.array(
        [
            np.cos(2 * np.pi * label / num_classes),
            np.sin(2 * np.pi * label / num_classes),
            (label / num_classes) - 0.5,
        ]
    )
    scale = 0.1 + 0.5 * (label + 1) / num_classes
    pts = rng.randn(n_points, 3) * scale + offset
    # part id: octant sign pattern, offset by label to spread part usage
    octant = (
        (pts[:, 0] > offset[0]).astype(int)
        + 2 * (pts[:, 1] > offset[1]).astype(int)
        + 4 * (pts[:, 2] > offset[2]).astype(int)
    )
    return pts.astype(np.float32), octant.astype(np.int32)


def make_batch(
    batch: int, n_points: int, num_classes: int, seed: int = 0
) -> dict:
    """One in-memory classification batch of :func:`_make_cloud` clouds:
    ``points [B, N, 3]`` f32, ``label [B]`` i32, ``mask [B]`` bool."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(num_classes, size=batch).astype(np.int32)
    points = np.stack(
        [_make_cloud(rng, int(y), n_points, num_classes)[0] for y in labels]
    )
    return {
        "points": points,
        "label": labels,
        "mask": np.ones((batch,), bool),
    }


def write_shapenet_h5(
    path: str,
    *,
    n_train: int = 64,
    n_test: int = 16,
    n_val: int = 16,
    n_points: int = 128,
    num_classes: int = 4,
    num_parts: int = 8,
    seed: int = 0,
) -> str:
    """Write a miniature ShapeNet-format dataset into ``path``.

    Every shard file of the reference's fixed file lists is created (train
    samples are split over the 6 train shards, etc.).
    """
    from papc_tpu.data.shapenet import _h5py

    h5py = _h5py()

    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)

    def write_shards(file_list, total):
        per = -(-total // len(file_list))
        for fname in file_list:
            k = min(per, total)
            total -= k
            data = np.zeros((k, n_points, 3), np.float32)
            label = np.zeros((k, 1), np.int64)
            pid = np.zeros((k, n_points), np.int64)
            for i in range(k):
                y = rng.randint(num_classes)
                pts, parts = _make_cloud(rng, y, n_points, num_classes)
                data[i], label[i, 0] = pts, y
                pid[i] = parts % num_parts
            with h5py.File(os.path.join(path, fname), "w") as f:
                f.create_dataset("data", data=data)
                f.create_dataset("label", data=label)
                f.create_dataset("pid", data=pid)

    write_shards(TRAIN_LIST, n_train)
    write_shards(TEST_LIST, n_test)
    write_shards(VAL_LIST, n_val)
    return path
