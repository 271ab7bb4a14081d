"""ShapeNet ``.h5`` loaders (classification + part segmentation).

Reference parity: ``PAPC/datasets/pnloader.py`` + ``datalist.py`` — same
shard file lists, whole-split-in-RAM, shuffled fixed-size batches.
Differences (deliberate, static-shape discipline):
  * batches are channel-LAST ``[B, N, 3]`` (the reference transposes to
    ``[B, 3, N]`` for paddle convs — unnecessary here);
  * the final partial batch is padded up to ``batchsize`` with a validity
    mask instead of being emitted ragged (ragged batches would retrigger
    XLA compilation every epoch end).
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

TRAIN_LIST = [f"ply_data_train{i}.h5" for i in range(6)]
TEST_LIST = [f"ply_data_test{i}.h5" for i in range(2)]
VAL_LIST = ["ply_data_val0.h5"]


class Batch(NamedTuple):
    points: np.ndarray  # [B, N, 3] float32
    label: np.ndarray  # [B] int32 — object category
    pid: np.ndarray | None  # [B, N] int32 — per-point part label (seg)
    mask: np.ndarray  # [B] bool — False for padding rows


def _file_list(mode: str) -> list[str]:
    return {"train": TRAIN_LIST, "test": TEST_LIST}.get(mode, VAL_LIST)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "ShapeNet .h5 files need the h5py package, which is not "
            "installed; train from in-memory batches "
            "(papc_tpu.data.synthetic.make_batch) or install h5py"
        ) from e
    return h5py


def load_split(
    path: str, mode: str, max_point: int, with_pid: bool = False
):
    """Read every shard of a split into RAM. Returns (data, label[, pid])."""
    h5py = _h5py()

    datas, labels, pids = [], [], []
    for fname in _file_list(mode):
        with h5py.File(os.path.join(path, fname), "r") as f:
            datas.append(np.asarray(f["data"][:, :max_point, :]))
            labels.append(np.asarray(f["label"]))
            if with_pid:
                pids.append(np.asarray(f["pid"][:, :max_point]))
    data = np.concatenate(datas).astype(np.float32)
    label = np.concatenate(labels).reshape(len(data)).astype(np.int32)
    if with_pid:
        return data, label, np.concatenate(pids).astype(np.int32)
    return data, label


class ShapeNetLoader:
    """Epoch iterator yielding fixed-shape :class:`Batch` objects."""

    def __init__(
        self,
        path: str,
        mode: str = "train",
        max_point: int = 1024,
        batchsize: int = 32,
        with_pid: bool = False,
        seed: int = 0,
    ):
        self.mode = mode
        self.batchsize = batchsize
        self.with_pid = with_pid
        self._rng = np.random.RandomState(seed)
        if with_pid:
            self.data, self.label, self.pid = load_split(
                path, mode, max_point, with_pid=True
            )
        else:
            self.data, self.label = load_split(path, mode, max_point)
            self.pid = None

    def __len__(self) -> int:
        return -(-len(self.data) // self.batchsize)  # ceil

    @property
    def num_samples(self) -> int:
        return len(self.data)

    def __call__(self) -> Iterator[Batch]:
        n = len(self.data)
        order = np.arange(n)
        if self.mode == "train":
            self._rng.shuffle(order)
        bs = self.batchsize
        for start in range(0, n, bs):
            idx = order[start : start + bs]
            valid = len(idx)
            if valid < bs:  # pad final batch to static shape
                pad = np.resize(idx, bs)
                mask = np.zeros(bs, dtype=bool)
                mask[:valid] = True
                idx = pad
            else:
                mask = np.ones(bs, dtype=bool)
            yield Batch(
                points=self.data[idx],
                label=self.label[idx],
                pid=None if self.pid is None else self.pid[idx],
                mask=mask,
            )
