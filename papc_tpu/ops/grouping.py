"""Neighborhood grouping: ball query, kNN, sample-and-group.

Reference parity: ``pointnet2_basic_layers.py:98-176``. The reference builds
the full ``[B, S, N]`` index matrix, masks it through TWO numpy round-trips
and runs a full sort. Here the "first ``nsample`` indices inside the radius"
semantics are realized with a masked ``lax.top_k`` over negated indices — no
sort, no host sync, identical results.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from papc_tpu.ops.geometry import index_points, square_distance
from papc_tpu.ops.sampling import farthest_point_sample


def query_ball_point(
    radius: float,
    nsample: int,
    xyz: jax.Array,
    new_xyz: jax.Array,
) -> jax.Array:
    """For each query, the first ``nsample`` point indices within ``radius``.

    Args:
      radius: ball radius.
      nsample: neighbors per ball (static).
      xyz: ``[B, N, 3]`` all points.
      new_xyz: ``[B, S, 3]`` query centers.

    Returns:
      ``[B, S, nsample]`` int32 indices. Slots beyond the in-radius count are
      filled with the first in-radius index (reference semantics,
      ``pointnet2_basic_layers.py:119-126``).
    """
    N = xyz.shape[1]
    with jax.named_scope("ball_query"):
        sqrdists = square_distance(new_xyz, xyz)  # [B, S, N]
        idx = jnp.arange(N, dtype=jnp.int32)
        # Out-of-radius points get sentinel N; reference masks with
        # `> radius**2`.
        cand = jnp.where(sqrdists > radius**2, N, idx[None, None, :])
        # nsample smallest indices == nsample largest of the negation.
        neg_top, _ = lax.top_k(-cand, nsample)
        group_idx = -neg_top  # ascending indices, sentinel N at the tail
        group_first = group_idx[..., :1]
        group_idx = jnp.where(group_idx == N, group_first, group_idx)
        # Degenerate all-empty ball (cannot happen when new_xyz ⊆ xyz):
        # clamp.
        return jnp.minimum(group_idx, N - 1)


def query_ball_point_tiled(
    radius: float,
    nsample: int,
    xyz: jax.Array,
    new_xyz: jax.Array,
    query_chunk: int = 256,
) -> jax.Array:
    """Memory-bounded ball query for LARGE clouds.

    Identical semantics to :func:`query_ball_point`, but the
    ``[B, S, N]`` distance matrix is streamed in query chunks via
    ``lax.map`` so peak memory is ``O(B * query_chunk * N)`` — the
    blockwise treatment of the reference's O(S*N) memory pain point
    (SURVEY §5.7; reference ``pointnet2_basic_layers.py:110-117``).
    """
    B, S, C = new_xyz.shape
    pad = (-S) % query_chunk
    q = jnp.pad(new_xyz, ((0, 0), (0, pad), (0, 0)))
    n_chunks = (S + pad) // query_chunk
    q = q.reshape(B, n_chunks, query_chunk, C).transpose(1, 0, 2, 3)

    def chunk_fn(qc):  # [B, query_chunk, 3]
        return query_ball_point(radius, nsample, xyz, qc)

    out = lax.map(chunk_fn, q)  # [n_chunks, B, query_chunk, nsample]
    out = out.transpose(1, 0, 2, 3).reshape(B, S + pad, nsample)
    return out[:, :S]


def knn(k: int, xyz: jax.Array, new_xyz: jax.Array):
    """k nearest neighbors of each query.

    Returns ``(dists, idx)``: ``[B, S, k]`` squared distances (ascending) and
    int32 indices. Used by feature propagation (3-NN interpolation,
    reference ``pointnet2_basic_layers.py:305-309``).

    In every FP call the candidate set is the coarse level (128–512
    points), so the ``[B, S, N_cand]`` matrix stays small even when the
    query side is the full cloud.
    """
    sqrdists = square_distance(new_xyz, xyz)  # [B, S, N]
    neg_d, idx = lax.top_k(-sqrdists, k)
    return -neg_d, idx.astype(jnp.int32)


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: jax.Array,
    points: jax.Array | None,
    *,
    key: jax.Array | None = None,
    return_fps: bool = False,
):
    """FPS + ball query + gather + center-normalize.

    Args:
      xyz: ``[B, N, 3]`` positions; points: ``[B, N, D]`` features or None.

    Returns:
      ``new_xyz [B, npoint, 3]``, ``new_points [B, npoint, nsample, 3+D]``
      (relative xyz concatenated before features — reference
      ``pointnet2_basic_layers.py:129-158``).
    """
    B, N, C = xyz.shape
    fps_idx = farthest_point_sample(xyz, npoint, key=key)
    new_xyz = index_points(xyz, fps_idx)  # [B, npoint, 3]
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    if points is not None:
        # ONE row gather of the pre-concatenated (xyz, features): one
        # gather and one scatter-add backward instead of two. The center
        # subtraction lands on the xyz channels post-gather (XLA fuses
        # it into the gather consumer) — values identical.
        combined = jnp.concatenate([xyz, points], axis=-1)
        grouped = index_points(combined, idx)  # [B, S, K, 3+D]
        grouped_xyz = grouped[..., :3]
        new_points = grouped.at[..., :3].add(
            -new_xyz[:, :, None, :]
        )
    else:
        grouped_xyz = index_points(xyz, idx)  # [B, S, K, 3]
        new_points = grouped_xyz - new_xyz[:, :, None, :]
    if return_fps:
        return new_xyz, new_points, grouped_xyz, fps_idx
    return new_xyz, new_points


def sample_and_group_all(xyz: jax.Array, points: jax.Array | None):
    """Single group containing every point (global abstraction stage).

    Reference ``pointnet2_basic_layers.py:160-176``: new_xyz is the origin,
    grouped xyz is NOT normalized.
    """
    B, N, C = xyz.shape
    new_xyz = jnp.zeros((B, 1, C), dtype=xyz.dtype)
    grouped_xyz = xyz[:, None, :, :]  # [B, 1, N, C]
    if points is not None:
        new_points = jnp.concatenate(
            [grouped_xyz, points[:, None, :, :]], axis=-1
        )
    else:
        new_points = grouped_xyz
    return new_xyz, new_points
