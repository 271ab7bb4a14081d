"""Indexed checkpoint manager with max-to-keep GC and latest-restore.

Reference parity: ``libs/tools/checkpoint.py`` — a ``checkpoints.json``
index mapping model name → latest + all checkpoint paths (:52-113),
``latest_checkpoint`` (:25), ``try_restore_latest_checkpoints`` (:142).

A checkpoint is a directory holding ``state.npz``: every leaf of the
state pytree as a numpy array, keyed by its pytree path. Restoring
reads the keys of a target pytree of the same structure. The JSON index
keeps the reference's on-disk contract.
"""

from __future__ import annotations

import json
import os
import shutil
import signal

import jax
import numpy as np

_FILE = "state.npz"


def write(path: str, tree) -> None:
    """Write ``tree`` to the checkpoint directory ``path``, replacing
    any checkpoint there only once the new one is complete."""
    flat = {
        jax.tree_util.keystr(k): np.asarray(jax.device_get(v))
        for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _FILE), "wb") as f:
        np.savez(f, **flat)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)


def read(path: str, target):
    """Read the checkpoint at ``path`` into the structure of ``target``;
    every leaf must be there with the target leaf's shape."""
    with np.load(os.path.join(path, _FILE)) as data:
        leaves = []
        paths, treedef = jax.tree_util.tree_flatten_with_path(target)
        for k, ref in paths:
            key = jax.tree_util.keystr(k)
            if key not in data:
                raise KeyError(f"checkpoint {path} has no leaf {key}")
            value = data[key]
            ref = np.asarray(ref)
            if value.shape != ref.shape:
                raise ValueError(
                    f"checkpoint {path}: {key} has shape {value.shape}, "
                    f"expected {ref.shape}"
                )
            leaves.append(value.astype(ref.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


class DelayedKeyboardInterrupt:
    """Make a checkpoint write SIGINT-atomic: Ctrl-C during the block is
    deferred until it completes (reference ``checkpoint.py:10-22``)."""

    def __enter__(self):
        self._received = None
        try:
            self._old = signal.signal(signal.SIGINT, self._handler)
        except ValueError:  # not the main thread — nothing to defer
            self._old = None
        return self

    def _handler(self, sig, frame):
        self._received = (sig, frame)

    def __exit__(self, *exc):
        if self._old is not None:
            signal.signal(signal.SIGINT, self._old)
            if self._received is not None:
                self._old(*self._received)
        return False


def _index_path(model_dir: str) -> str:
    return os.path.join(model_dir, "checkpoints.json")


def _load_index(model_dir: str) -> dict:
    p = _index_path(model_dir)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {"latest_ckpt": {}, "all_ckpts": {}}


def _save_index(model_dir: str, index: dict):
    with open(_index_path(model_dir), "w") as f:
        json.dump(index, f, indent=2)


def latest_checkpoint(model_dir: str, model_name: str) -> str | None:
    index = _load_index(model_dir)
    ckpt = index["latest_ckpt"].get(model_name)
    if ckpt is None:
        return None
    path = os.path.join(model_dir, ckpt)
    return path if os.path.exists(path) else None


def save(
    model_dir: str,
    model_name: str,
    state_dict: dict,
    global_step: int,
    max_to_keep: int = 8,
    keep_latest: bool = True,
):
    """Write a checkpoint and update the JSON index, GC'ing old
    checkpoints beyond ``max_to_keep`` (keep-latest policy by default,
    keep-largest-step otherwise — reference :52-113)."""
    os.makedirs(model_dir, exist_ok=True)
    name = f"{model_name}-{global_step}"
    path = os.path.abspath(os.path.join(model_dir, name))
    with DelayedKeyboardInterrupt():
        write(path, state_dict)

    index = _load_index(model_dir)
    all_ckpts = index["all_ckpts"].setdefault(model_name, [])
    all_ckpts.append(name)
    index["latest_ckpt"][model_name] = name
    if len(all_ckpts) > max_to_keep:
        if keep_latest:
            drop = all_ckpts[: len(all_ckpts) - max_to_keep]
            keep = all_ckpts[len(all_ckpts) - max_to_keep :]
        else:
            by_step = sorted(
                all_ckpts, key=lambda n: int(n.rsplit("-", 1)[1])
            )
            drop = by_step[: len(by_step) - max_to_keep]
            keep = [n for n in all_ckpts if n not in drop]
        for name_ in drop:
            p = os.path.join(model_dir, name_)
            if os.path.exists(p):
                shutil.rmtree(p)
        index["all_ckpts"][model_name] = keep
    _save_index(model_dir, index)
    return path


def try_restore_latest(model_dir: str, model_name: str, target: dict):
    """Restore the newest checkpoint into ``target`` structure; returns
    (restored_dict | None)."""
    path = latest_checkpoint(model_dir, model_name)
    if path is None:
        return None
    return read(path, target)
