"""Tensor-parallel parameter sharding over the 'model' mesh axis.

The zoo's FLOPs concentrate in wide Dense layers (e.g. the 128→1024
shared-MLP stage, the 1024→512 head, PointNet++ SA mlps); the detection
stack's in the RPN conv pyramid (64/128/256-channel 3×3 convs,
``detect/model.py``). Both shard the same way: split the OUTPUT-channel
(last) axis of the kernel over 'model' — the matmul / conv contraction
is then column-parallel, each chip produces its slice of the output
channels, and XLA inserts the collectives (an all-gather where a
replicated consumer needs the full activation; a psum of the input
gradient, which sums partial ``dx`` contributions across the column
shards, in the backward). This is applied as a post-init device_put of
the parameter tree — no model-code changes — which keeps the whole zoo
and the detection stack TP-capable with one rule set.

A bias (or any other 1-D vector) is sharded ONLY when its sibling
``kernel`` in the same module sharded: the bias add follows the column
split. Free-standing wide vectors — BatchNorm's ``bias``/``scale``,
GroupNorm params — stay replicated; they are elementwise over an
activation whose channel layout the kernel rule alone decides (the
pre-r5 rule sharded any wide ``bias``, including BatchNorm's while its
``scale`` stayed replicated — harmless under jit but layout-noise).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _path_keys(path: tuple) -> tuple:
    return tuple(
        p.key if hasattr(p, "key") else str(p) for p in path
    )


def _kernel_spec(shape, n_model: int, min_dim: int) -> P:
    """Column-shard the output-channel (last) axis of a kernel.

    Covers Dense ``[in, out]``, Conv1D ``[k, cin, cout]``, Conv2D /
    ConvTranspose ``[kh, kw, cin, cout]`` — ``nn.core`` puts output channels
    last in all of them.
    """
    if (
        len(shape) >= 2
        and shape[-1] >= min_dim
        and shape[-1] % n_model == 0
    ):
        return P(*([None] * (len(shape) - 1) + ["model"]))
    return P()


def param_spec(
    path: tuple,
    leaf,
    n_model: int,
    min_dim: int = 256,
    kernel_sharded: bool | None = None,
) -> P:
    """Sharding rule for one parameter.

    ``kernel`` arrays (rank ≥ 2) with ``out % n_model == 0`` and
    ``out >= min_dim`` get their last axis sharded; a ``bias`` gets
    ``P('model')`` only when ``kernel_sharded`` says its sibling kernel
    sharded (:func:`shard_params` passes this; direct callers that
    don't know the sibling leave it None and the bias stays replicated
    — correct either way, the add broadcasts). Everything else
    (BatchNorm/GroupNorm vectors, embeddings, scalars) is replicated.
    """
    if n_model <= 1:
        return P()
    name = _path_keys(path[-1:])[0] if path else ""
    shape = np.shape(leaf)
    if name == "kernel":
        return _kernel_spec(shape, n_model, min_dim)
    if name == "bias" and kernel_sharded and len(shape) == 1 and (
        shape[0] % n_model == 0
    ):
        return P("model")
    return P()


def shard_params(mesh: Mesh, params, min_dim: int = 256):
    """Apply the TP rule set to a parameter pytree (device_put)."""
    n_model = mesh.shape.get("model", 1)

    # first pass: which modules' kernels shard (so the bias rule can
    # key off its sibling, not off its own width)
    sharded_kernel_modules = set()

    def mark(path, leaf):
        keys = _path_keys(path)
        if keys and keys[-1] == "kernel" and n_model > 1:
            if _kernel_spec(np.shape(leaf), n_model, min_dim) != P():
                sharded_kernel_modules.add(keys[:-1])
        return leaf

    jax.tree_util.tree_map_with_path(mark, params)

    def put(path, leaf):
        keys = _path_keys(path)
        spec = param_spec(
            path,
            leaf,
            n_model,
            min_dim,
            kernel_sharded=keys[:-1] in sharded_kernel_modules,
        )
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(put, params)
