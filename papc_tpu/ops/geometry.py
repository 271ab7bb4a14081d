"""Pairwise-distance and batched-gather primitives.

Functional equivalents of the reference's hot helpers
(``PAPC/models/layers/pointnet2_basic_layers.py:26-62``), built to stay on
device: ``square_distance`` is a single matmul expansion, ``index_points``
is one on-device row gather instead of the reference's ``.numpy()``
round-trip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def square_distance(src: jax.Array, dst: jax.Array) -> jax.Array:
    """Pairwise squared euclidean distance.

    Args:
      src: ``[B, N, C]`` source points.
      dst: ``[B, M, C]`` target points.

    Returns:
      ``[B, N, M]`` squared distances.

    Reference parity: ``pointnet2_basic_layers.py:26-40`` (same
    ``-2*src@dstT + |src|^2 + |dst|^2`` expansion; the cross term is the only
    O(N*M*C) work and it is one matmul).

    The matmul runs at ``Precision.HIGHEST``: a default-precision f32
    matmul may run in TF32 on the GPU, which keeps about three decimal
    digits and at cloud scale perturbs pairwise distances enough to flip
    ball-query membership near the radius (the reference computes this
    in full f32). K=3 makes the extra passes free.
    """
    cross = jnp.einsum(
        "bnc,bmc->bnm",
        src,
        dst,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    s2 = jnp.sum(src * src, axis=-1)[:, :, None]
    d2 = jnp.sum(dst * dst, axis=-1)[:, None, :]
    return s2 - 2.0 * cross + d2


def index_points(points: jax.Array, idx: jax.Array) -> jax.Array:
    """Batched gather: for each batch item select rows of ``points`` by ``idx``.

    Args:
      points: ``[B, N, C]``.
      idx: integer indices ``[B, ...]`` with values in ``[0, N)``
        (out-of-range values are clamped, like the previous
        ``take_along_axis(mode="clip")`` formulation).

    Returns:
      ``[B, ..., C]`` gathered points.

    Reference parity: ``pointnet2_basic_layers.py:43-62`` — which gathers
    via a numpy round-trip; here it is one on-device row gather.

    The gather is flattened to a single row gather over ``[B*N, C]``
    with absolute row ids; its gradient is XLA's scatter-add over rows,
    which runs on atomics on the GPU, so its summation order (and the
    last bits of a gradient) can change from run to run.
    """
    B = points.shape[0]
    N = points.shape[1]
    C = points.shape[-1]
    batch_shape = idx.shape
    with jax.named_scope("gather"):
        flat_idx = jnp.clip(
            idx.reshape(B, -1).astype(jnp.int32), 0, N - 1
        )
        rows = flat_idx + (jnp.arange(B, dtype=jnp.int32) * N)[:, None]
        gathered = points.reshape(B * N, C)[rows.reshape(-1)]
        return gathered.reshape(*batch_shape, C)


def pc_normalize(pc: jax.Array) -> jax.Array:
    """Center a single cloud ``[N, C]`` and scale to the unit sphere.

    Reference parity: ``pointnet2_basic_layers.py:17-23``.
    """
    centroid = jnp.mean(pc, axis=0)
    pc = pc - centroid
    m = jnp.max(jnp.sqrt(jnp.sum(pc**2, axis=1)))
    return pc / m
