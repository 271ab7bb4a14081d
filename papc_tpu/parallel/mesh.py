"""Device mesh + sharding helpers.

The reference has NO parallelism (single device only — SURVEY §2.3). Here
data-parallelism is first-class from day one: a 1-D ``Mesh('data')`` over
all local devices, batches sharded along it, parameters replicated.
XLA inserts the gradient all-reduce (NCCL between GPUs); the same
program runs unchanged on 1 device or many. A second, optional ``model`` axis is used
by the tensor-parallel configs (see ``papc_tpu.parallel.tp``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: int | None = None, n_model: int = 1, devices=None
) -> Mesh:
    """Build a ``(data, model)`` mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_model
    dev = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(dev, ("data", "model"))


def make_mesh_for_batch(batch_size: int, devices=None) -> Mesh:
    """1-D data mesh using the largest device count that divides the
    batch (falls back to 1 device for indivisible small batches)."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return make_mesh(n_data=n, n_model=1, devices=devices[:n])


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding over the 'data' mesh axis."""
    return NamedSharding(mesh, P("data"))


def stacked_data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch sharding for K-stacked batches ``[K, B, ...]`` (the scanned
    train step): axis 0 is the scan axis (replicated), axis 1 the batch."""
    return NamedSharding(mesh, P(None, "data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch):
    """Device-put every array of a pytree batch-sharded on axis 0."""
    sh = data_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), batch)


def replicate(mesh: Mesh, tree):
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
