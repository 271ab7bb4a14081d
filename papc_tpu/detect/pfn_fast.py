"""Transposed-layout PillarFeatureNet forward (single PFN layer).

Reference parity: same math as ``PillarFeatureNet`` + one ``PFNLayer``
(``models/bones/pillars.py:9-108``) — decorate points with cluster/center
offsets, mask padded slots, Linear(no bias) -> BatchNorm -> ReLU -> max
over points — but computed in another layout:

* **Layout** ``[B, D, V, P]``: the point axis P is minor and the tiny
  feature axis D (9/10) rides a leading dim, instead of the classic
  ``[B, V, P, D]`` with a minor axis of 9.

* **BN folded into the Dense**: BatchNorm statistics of ``h = W f`` are
  derived WITHOUT materializing ``h`` —

      mean_h = W^T mean_f,      var_h[o] = w_o^T Cov_f w_o

  where ``Cov_f`` is the (C x C = 10 x 10) second moment of the
  (mean-centered) decorated features, one tiny matmul over the 2.4M
  slots. The BN affine then folds into the Dense
  (``W' = W diag(gamma/sigma)``, ``b' = beta - mean_h gamma/sigma``) so
  the only big pass is ``max_P relu(f W' + b')``, wrapped in
  ``jax.checkpoint`` so the backward re-derives it from ``f`` instead of
  storing the ``[B, O, V, P]`` intermediate.

Centering before the second moment (``Cov = E[(f-mu)(f-mu)^T]`` rather
than ``E[ff^T] - mu mu^T``) avoids the classic catastrophic cancellation;
the stats matmuls run at ``Precision.HIGHEST`` (trivial FLOPs).

The transposed ``pfn_forward_t`` lost to the classic layout in the
earlier accelerator build's A/B and is kept as the parity-tested record of that
experiment (not measured on the GPU); the production fast path is
:func:`pfn_forward_flat` below, which removes the padded slots
instead of re-laying them out.

Padded point slots are zeroed in ``f`` exactly like the classic path, so
they contribute ``relu(b')`` to the max — byte-identical semantics to
the classic PFNLayer, whose BN also sees the padded zeros
(``pillars.py:30-40``). Running stats follow the same
``momentum * ra + (1 - momentum) * batch`` update as
:class:`papc_tpu.nn.core.BatchNorm`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def decorate_points_t(
    voxels_t: jax.Array,  # [B, D, V, P] raw point features (xyz first)
    num_points: jax.Array,  # [B, V]
    coords: jax.Array,  # [B, V, 3] (z, y, x) cell indices
    *,
    voxel_size,
    pc_range,
    with_distance: bool = False,
) -> jax.Array:
    """[B, D, V, P] -> [B, C, V, P] decorated + padded-slot-masked
    features (C = D + 5 (+1 with distance)); the transposed twin of
    ``PillarFeatureNet.__call__``'s decoration (reference
    ``pillars.py:62-101``)."""
    B, D, V, P = voxels_t.shape
    dt = voxels_t.dtype
    denom = jnp.maximum(num_points, 1).astype(dt)  # [B, V]
    mean3 = (
        jnp.sum(voxels_t[:, :3], axis=3) / denom[:, None, :]
    )  # [B, 3, V]
    f_cluster = voxels_t[:, :3] - mean3[..., None]  # [B, 3, V, P]

    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    x_offset = vx / 2 + float(pc_range[0])
    y_offset = vy / 2 + float(pc_range[1])
    px = coords[..., 2].astype(dt) * vx + x_offset  # [B, V]
    py = coords[..., 1].astype(dt) * vy + y_offset
    f_center = jnp.stack(
        [
            voxels_t[:, 0] - px[..., None],
            voxels_t[:, 1] - py[..., None],
        ],
        axis=1,
    )  # [B, 2, V, P]
    feats = [voxels_t, f_cluster, f_center]
    if with_distance:
        feats.append(
            jnp.sqrt(jnp.sum(jnp.square(voxels_t[:, :3]), axis=1))[
                :, None
            ]
        )
    f = jnp.concatenate(feats, axis=1)  # [B, C, V, P]

    slot = jnp.arange(P)[None, None, :]
    mask = (slot < num_points[..., None]).astype(dt)  # [B, V, P]
    return f * mask[:, None]


def pfn_forward_t(
    kernel: jax.Array,  # [C, O] Dense kernel (no bias)
    scale: jax.Array,  # [O] BN gamma
    bias: jax.Array,  # [O] BN beta
    running: tuple,  # (mean [O], var [O]) f32 running stats
    voxels_t: jax.Array,  # [B, D, V, P]
    num_points: jax.Array,  # [B, V]
    coords: jax.Array,  # [B, V, 3]
    *,
    voxel_size,
    pc_range,
    with_distance: bool = False,
    train: bool = True,
    momentum: float = 0.01,
    eps: float = 1e-3,
):
    """Returns ``(out [B, V, O], new_running)``; ``new_running is
    running`` in eval mode."""
    f = decorate_points_t(
        voxels_t,
        num_points,
        coords,
        voxel_size=voxel_size,
        pc_range=pc_range,
        with_distance=with_distance,
    )
    B, C, V, P = f.shape
    O = kernel.shape[1]
    f2 = f.reshape(B, C, V * P)

    if train:
        n = B * V * P
        s1 = jnp.sum(f2, axis=(0, 2), dtype=jnp.float32) / n  # [C]
        fc = f2.astype(jnp.float32) - s1[None, :, None]
        cov = (
            jnp.einsum(
                "bcm,bdm->cd", fc, fc, precision=lax.Precision.HIGHEST
            )
            / n
        )  # [C, C]
        k32 = kernel.astype(jnp.float32)
        mean_h = s1 @ k32  # [O]
        var_h = jnp.einsum(
            "co,cd,do->o", k32, cov, k32, precision=lax.Precision.HIGHEST
        )
        var_h = jnp.maximum(var_h, 0.0)
        new_running = (
            momentum * running[0]
            + (1.0 - momentum) * lax.stop_gradient(mean_h),
            momentum * running[1]
            + (1.0 - momentum) * lax.stop_gradient(var_h),
        )
    else:
        mean_h, var_h = running
        new_running = running

    inv = scale.astype(jnp.float32) * lax.rsqrt(var_h + eps)  # [O]
    w_f = kernel.astype(jnp.float32) * inv[None, :]  # [C, O]
    b_f = bias.astype(jnp.float32) - mean_h * inv  # [O]

    @jax.checkpoint
    def second_pass(f2, w_f, b_f):
        h = (
            jnp.einsum("bcm,co->bom", f2, w_f.astype(f2.dtype))
            + b_f.astype(f2.dtype)[None, :, None]
        )
        h = nnrelu(h).reshape(B, O, V, P)
        return jnp.max(h, axis=3)  # [B, O, V]

    out = second_pass(f2, w_f, b_f)
    return out.transpose(0, 2, 1), new_running  # [B, V, O]


def nnrelu(x):
    return jnp.maximum(x, 0)


# Row space of pfn_forward_flat's segment scatters. True assumes every
# producer of (points, point_pillar) emits points GROUPED BY PILLAR in
# ascending id order with the padding tail last — guaranteed by the
# C++ streamer's stable counting sort (papc_cc.cpp
# points_to_voxel_flat_epoch) and by flatten_pillars (voxel-major by
# construction); pinned by tests. The rows then use a per-sample dump
# slot (b·(V+1)+V) so they are GLOBALLY non-decreasing and the
# scatter-add/scatter-max can carry indices_are_sorted=True (XLA
# serializes unpromised duplicate writes; cf. the unique_indices win
# on the BEV scatter, ops/voxelize.py).
FLAT_ROWS_SORTED = False


def pfn_forward_flat(
    kernel: jax.Array,  # [C, O] Dense kernel (no bias)
    scale: jax.Array,  # [O] BN gamma
    bias: jax.Array,  # [O] BN beta
    running: tuple,  # (mean [O], var [O]) f32 running stats
    points: jax.Array,  # [B, N] x [D] flat real points, zero-pad rows
    point_pillar: jax.Array,  # [B, N] pillar row in [0, V); -1 padding
    num_points: jax.Array,  # [B, V] valid points per pillar
    coords: jax.Array,  # [B, V, 3] (z, y, x); -1 invalid
    max_points_per_pillar: int,  # P of the classic [B, V, P, D] layout
    *,
    voxel_size,
    pc_range,
    with_distance: bool = False,
    train: bool = True,
    momentum: float = 0.01,
    eps: float = 1e-3,
):
    """Flat-points PFN: identical math to the classic PillarFeatureNet
    (decorate → Linear → BN → ReLU → max-per-pillar) computed on the
    ~N real points instead of the V·P padded slot grid (60x fewer slots
    at the KITTI workload: ~20k points vs 1.2M slots).

    Exact classic-semantics preservation (the reference BN sees the
    padded zero slots, ``pillars.py:30-40``):

    * BN statistics divide by the FULL slot population
      ``n = B·V·P`` — the padded slots contribute zeros to the sums, so
      only the normalizer changes.
    * After folding BN into the Dense (see module docstring), a padded
      slot's activation is ``a0 = relu(b')``; the per-pillar max takes
      ``max(segment_max, a0)`` for pillars with ``count < P`` and the
      pure segment max when ``count == P``. Empty/invalid pillars give
      ``a0``, exactly like the classic all-zero row.

    The segment max is ONE flat row-indexed ``.at[].max`` (batch folded
    into the row index — the sanctioned scatter form, see
    ``ops.voxelize.scatter_to_bev_batched``) and every per-point lookup
    is a flat row gather.

    Returns ``(out [B, V, O], new_running)``.
    """
    B, N, D = points.shape
    V = num_points.shape[1]
    O = kernel.shape[1]
    P = int(max_points_per_pillar)
    dt = points.dtype
    valid = point_pillar >= 0  # [B, N]
    if FLAT_ROWS_SORTED:
        # per-sample dump slot keeps the flat rows globally sorted
        # (see the flag docstring); canvases live in the [B*(V+1)]
        # row space with slot V a per-sample scratch row
        Vp = V + 1
        rows = jnp.where(
            valid,
            jnp.arange(B, dtype=jnp.int32)[:, None] * Vp
            + point_pillar,
            jnp.arange(B, dtype=jnp.int32)[:, None] * Vp + V,
        ).reshape(B * N)
        scat = dict(mode="drop", indices_are_sorted=True)
    else:
        Vp = None
        rows = jnp.where(
            valid,
            jnp.arange(B, dtype=jnp.int32)[:, None] * V + point_pillar,
            B * V,
        ).reshape(B * N)
        scat = {}

    # per-pillar xyz mean: flat segment-sum over the real points
    xyz = jnp.where(valid[..., None], points[..., :3], 0.0)
    if FLAT_ROWS_SORTED:
        sums = jnp.zeros((B * Vp, 3), dt)
        sums = sums.at[rows].add(xyz.reshape(B * N, 3), **scat)
        denom = jnp.pad(
            jnp.maximum(num_points, 1), ((0, 0), (0, 1)),
            constant_values=1,
        ).astype(dt).reshape(B * Vp, 1)
        mean_pp = sums / denom  # [B*Vp, 3]
        grows = rows  # dump slot is a real (scratch) canvas row
    else:
        sums = jnp.zeros((B * V + 1, 3), dt)
        sums = sums.at[rows].add(xyz.reshape(B * N, 3))
        denom = jnp.maximum(num_points, 1).astype(dt).reshape(B * V, 1)
        mean_pp = sums[: B * V] / denom  # [B*V, 3]
        grows = jnp.minimum(rows, B * V - 1)  # clamp dump row

    # per-point gathers (flat row form)
    mean_pt = mean_pp[grows].reshape(B, N, 3)
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    x_offset = vx / 2 + float(pc_range[0])
    y_offset = vy / 2 + float(pc_range[1])
    centers = jnp.stack(
        [
            coords[..., 2].astype(dt) * vx + x_offset,
            coords[..., 1].astype(dt) * vy + y_offset,
        ],
        axis=-1,
    )  # [B, V, 2]
    if FLAT_ROWS_SORTED:
        centers = jnp.pad(centers, ((0, 0), (0, 1), (0, 0)))
    centers = centers.reshape(-1, 2)
    center_pt = centers[grows].reshape(B, N, 2)

    feats = [
        points,
        points[..., :3] - mean_pt,
        points[..., :2] - center_pt,
    ]
    if with_distance:
        feats.append(
            jnp.linalg.norm(points[..., :3], axis=-1, keepdims=True)
        )
    f = jnp.concatenate(feats, axis=-1)  # [B, N, C]
    f = f * valid[..., None].astype(dt)
    C = f.shape[-1]
    f2 = f.reshape(B * N, C)

    if train:
        # classic BN population = every [B, V, P] slot; the padded
        # slots are zeros, so sums over real points + this normalizer
        # reproduce the classic statistics exactly
        n = B * V * P
        s1 = jnp.sum(f2, axis=0, dtype=jnp.float32) / n  # [C]
        f32 = f2.astype(jnp.float32)
        # uncentered second moment: the zero slots contribute nothing
        # to sums but DO belong to the population, so center via
        # M2 - mu mu^T (the zero slots make exact pre-centering
        # impossible without materializing them)
        m2 = (
            jnp.einsum(
                "mc,md->cd", f32, f32,
                precision=lax.Precision.HIGHEST,
            )
            / n
        )
        cov = m2 - s1[:, None] * s1[None, :]
        k32 = kernel.astype(jnp.float32)
        mean_h = s1 @ k32  # [O]
        var_h = jnp.einsum(
            "co,cd,do->o", k32, cov, k32,
            precision=lax.Precision.HIGHEST,
        )
        var_h = jnp.maximum(var_h, 0.0)
        new_running = (
            momentum * running[0]
            + (1.0 - momentum) * lax.stop_gradient(mean_h),
            momentum * running[1]
            + (1.0 - momentum) * lax.stop_gradient(var_h),
        )
    else:
        mean_h, var_h = running
        new_running = running

    inv = scale.astype(jnp.float32) * lax.rsqrt(var_h + eps)  # [O]
    w_f = (kernel.astype(jnp.float32) * inv[None, :]).astype(dt)
    b_f = (bias.astype(jnp.float32) - mean_h * inv).astype(dt)

    h = nnrelu(f2 @ w_f + b_f[None, :])  # [B*N, O]
    neg = jnp.asarray(-jnp.inf, dt)
    if FLAT_ROWS_SORTED:
        seg = jnp.full((B * Vp, O), neg, dt)
        seg = seg.at[rows].max(
            jnp.where(valid.reshape(B * N, 1), h, neg), **scat
        )
        seg = seg.reshape(B, Vp, O)[:, :V]
    else:
        seg = jnp.full((B * V + 1, O), neg, dt)
        seg = seg.at[rows].max(
            jnp.where(valid.reshape(B * N, 1), h, neg)
        )
        seg = seg[: B * V].reshape(B, V, O)

    # padded-slot activation joins the max iff the pillar has padding
    a0 = nnrelu(b_f)  # [O]
    has_pad = (num_points < P)[..., None]  # [B, V, 1]
    out = jnp.where(has_pad, jnp.maximum(seg, a0), seg)
    # count==P pillars never saw -inf (all P slots real); count==0
    # pillars resolve to a0 through the where
    return out, new_running


def flatten_pillars(voxels, num_points, coords, n_max=None):
    """Host/test helper: classic ``[B, V, P, D]`` pillars → flat
    ``(points [B, N, D], point_pillar [B, N])`` in (v, p) order, padded
    with zeros / -1. ``n_max`` defaults to the tightest static bound
    actually needed by the batch (tests); production loaders size it
    from config."""
    import numpy as np

    voxels = np.asarray(voxels)
    num_points = np.asarray(num_points)
    B, V, P, D = voxels.shape
    counts = [int(num_points[b].sum()) for b in range(B)]
    if n_max is None:
        n_max = max(counts)
    points = np.zeros((B, n_max, D), voxels.dtype)
    owner = np.full((B, n_max), -1, np.int32)
    for b in range(B):
        slot = np.arange(P)[None, :] < num_points[b][:, None]  # [V, P]
        v_idx, p_idx = np.nonzero(slot)
        v_idx, p_idx = v_idx[:n_max], p_idx[:n_max]
        n = len(v_idx)
        points[b, :n] = voxels[b, v_idx, p_idx]
        owner[b, :n] = v_idx
    return points, owner
