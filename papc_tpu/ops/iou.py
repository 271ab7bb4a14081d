"""Device-side (jnp, jittable) box IoU — axis-aligned and exact rotated.

Computes the same exact quad-intersection areas as the reference's
numba-CUDA ``devRotateIoU`` suite (``non_max_suppression/nms_gpu.py:
179-414``), but shaped for XLA: Sutherland–Hodgman halfplane clipping over a
doubling-slot masked ring — pure elementwise math and static rolls, no
per-pair sort, no gather, no arctan2 — so the whole [N, K] pair matrix
compiles to one fused XLA kernel. Everything is static-shape and
vmappable; no host sync. (The reference's candidate-vertex + angle-sort
construction is kept in the C++ twin's spirit only: its per-pair sort and
gather are slow paths for XLA.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def iou_2d(boxes: jax.Array, query: jax.Array, eps: float = 0.0) -> jax.Array:
    """Axis-aligned IoU matrix: [N, 4] x [K, 4] → [N, K]."""
    b = boxes[:, None, :]
    q = query[None, :, :]
    iw = jnp.minimum(b[..., 2], q[..., 2]) - jnp.maximum(b[..., 0], q[..., 0]) + eps
    ih = jnp.minimum(b[..., 3], q[..., 3]) - jnp.maximum(b[..., 1], q[..., 1]) + eps
    inter = jnp.clip(iw, 0) * jnp.clip(ih, 0)
    area_b = (b[..., 2] - b[..., 0] + eps) * (b[..., 3] - b[..., 1] + eps)
    area_q = (q[..., 2] - q[..., 0] + eps) * (q[..., 3] - q[..., 1] + eps)
    out = inter / (area_b + area_q - inter)
    return jnp.where((iw > 0) & (ih > 0), out, 0.0)


def box5_to_corners(boxes: jax.Array) -> jax.Array:
    """[..., 5] (x, y, w, l, yaw) → [..., 4, 2] corners (same winding as
    the host ``center_to_corner_box2d``)."""
    x, y, w, l, r = (boxes[..., i] for i in range(5))
    c, s = jnp.cos(r), jnp.sin(r)
    # relative corners before rotation, clockwise from min
    rel = jnp.stack(
        [
            jnp.stack([-w / 2, -l / 2], -1),
            jnp.stack([-w / 2, l / 2], -1),
            jnp.stack([w / 2, l / 2], -1),
            jnp.stack([w / 2, -l / 2], -1),
        ],
        axis=-2,
    )  # [..., 4, 2]
    rot = jnp.stack(
        [jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], axis=-2
    )  # [..., 2, 2] — row-vector p @ [[c,-s],[s,c]]
    rotated = jnp.einsum("...ki,...ij->...kj", rel, rot)
    return rotated + jnp.stack([x, y], -1)[..., None, :]


def _fill_invalid_with_left(vx, vy, m, slots: int):
    """Replace invalid ring slots with the nearest valid slot to the
    LEFT (cyclically) — a Hillis–Steele doubling scan of pure rolls and
    selects. Duplicated vertices are harmless to both clipping (zero-
    length edges can't cross a halfplane boundary) and the shoelace sum
    (duplicates contribute zero area)."""
    k = 1
    while k < slots:
        take = ~m
        vx = jnp.where(take, jnp.roll(vx, k, axis=-1), vx)
        vy = jnp.where(take, jnp.roll(vy, k, axis=-1), vy)
        m = m | jnp.roll(m, k, axis=-1)
        k *= 2
    return vx, vy, m


def _clip_halfplane(vx, vy, ax, ay, dx, dy, orient):
    """One Sutherland–Hodgman clip of the ring ``(vx, vy) [..., S]``
    against the halfplane left/right (per ``orient``) of the directed
    edge ``(ax, ay) + t(dx, dy)``. Emits interleaved slots
    ``[..., 2S]``: slot 2i keeps vertex i when inside, slot 2i+1 the
    edge-boundary intersection when edge (i, i+1) crosses. Slot order
    preserves ring order, so no sorting is ever needed."""
    cr = (dx * (vy - ay) - dy * (vx - ax)) * orient
    inside = cr >= 0
    nvx = jnp.roll(vx, -1, axis=-1)
    nvy = jnp.roll(vy, -1, axis=-1)
    ncr = jnp.roll(cr, -1, axis=-1)
    ninside = jnp.roll(inside, -1, axis=-1)
    denom = cr - ncr
    t = cr / jnp.where(denom == 0, 1.0, denom)
    ix = vx + t * (nvx - vx)
    iy = vy + t * (nvy - vy)
    crossing = (inside != ninside) & (denom != 0)
    out_x = jnp.stack([vx, ix], axis=-1)
    out_y = jnp.stack([vy, iy], axis=-1)
    out_m = jnp.stack([inside, crossing], axis=-1)
    S2 = vx.shape[-1] * 2
    return (
        out_x.reshape(*vx.shape[:-1], S2),
        out_y.reshape(*vx.shape[:-1], S2),
        out_m.reshape(*vx.shape[:-1], S2),
    )


def rotated_intersection_area(ca: jax.Array, cb: jax.Array) -> jax.Array:
    """Intersection area of two convex quads given corners [..., 4, 2].

    Sutherland–Hodgman clipping of A against B's four halfplanes with a
    doubling-slot masked ring (4 → 8 → 16 → 32 → 64 slots): pure
    elementwise ops and STATIC rolls — no per-pair argsort, no batched
    gather, no arctan2 — so XLA fuses the whole pair computation into
    one kernel. The candidate-vertex formulation (matching the
    reference's ``devRotateIoU`` construction) needs a per-pair
    ``argsort`` + ``take_along_axis``; this form computes the same area
    (same f32-tolerance oracle tests) without them and scales to the NMS
    1000×1000 matrix. C++ twin: ``papc_cc.cpp`` rbbox_iou
    (same clipping algorithm, scalar loops).
    """
    batch = jnp.broadcast_shapes(ca.shape[:-2], cb.shape[:-2])
    ca = jnp.broadcast_to(ca, batch + ca.shape[-2:])
    cb = jnp.broadcast_to(cb, batch + cb.shape[-2:])

    # clip winding: sign of B's shoelace (rotation-invariant; handled
    # per pair so callers may pass either winding)
    bx, by = cb[..., 0], cb[..., 1]
    nbx = jnp.roll(bx, -1, axis=-1)
    nby = jnp.roll(by, -1, axis=-1)
    orient = jnp.sign(jnp.sum(bx * nby - nbx * by, axis=-1))[..., None]

    vx, vy = ca[..., 0], ca[..., 1]
    m = jnp.ones(vx.shape, bool)
    slots = 4
    for e in range(4):
        ax = cb[..., e, 0][..., None]
        ay = cb[..., e, 1][..., None]
        dx = cb[..., (e + 1) % 4, 0][..., None] - ax
        dy = cb[..., (e + 1) % 4, 1][..., None] - ay
        vx, vy, m = _fill_invalid_with_left(vx, vy, m, slots)
        any_valid = m[..., :1]  # all-true after fill iff ring nonempty
        vx, vy, m = _clip_halfplane(vx, vy, ax, ay, dx, dy, orient)
        m = m & any_valid
        slots *= 2

    vx, vy, m = _fill_invalid_with_left(vx, vy, m, slots)
    nvx = jnp.roll(vx, -1, axis=-1)
    nvy = jnp.roll(vy, -1, axis=-1)
    area2 = jnp.sum(vx * nvy - nvx * vy, axis=-1)
    return jnp.where(m[..., 0], 0.5 * jnp.abs(area2), 0.0)


def rotate_iou(
    rbboxes: jax.Array, qrbboxes: jax.Array, criterion: int = -1
) -> jax.Array:
    """Exact rotated BEV IoU matrix [N, K] for [*, 5] (x, y, w, l, yaw).

    ``criterion``: -1 IoU, 0 inter/area_boxes, 1 inter/area_query,
    anything else raw intersection area — matching the reference eval
    kernel (``nms_gpu.py:618-653``).
    """
    ca = box5_to_corners(rbboxes)  # [N, 4, 2]
    cb = box5_to_corners(qrbboxes)  # [K, 4, 2]
    inter = rotated_intersection_area(
        ca[:, None, :, :], cb[None, :, :, :]
    )  # [N, K]
    area_a = (rbboxes[:, 2] * rbboxes[:, 3])[:, None]
    area_b = (qrbboxes[:, 2] * qrbboxes[:, 3])[None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = jnp.broadcast_to(area_a, inter.shape)
    elif criterion == 1:
        denom = jnp.broadcast_to(area_b, inter.shape)
    else:
        denom = jnp.ones_like(inter)
    return jnp.where(denom > 0, inter / denom, 0.0)
