"""Device-side (jnp, jittable) non-maximum suppression.

Replaces the reference's CUDA bitmask kernels + host bitmask walk
(``cc/nms/nms_kernel.cu.cc``, ``nms_gpu.py:71-164,417-488``) and its
``.cpu().numpy()`` round-trips (``box_paddle_ops.py:394-442``) with a
fully on-device greedy pass: one [K, K] IoU matrix (K bounded by the
pre-NMS top-k, 1000 in the reference config) + a ``fori_loop`` masked
suppression sweep. Inputs must be score-sorted descending.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from papc_tpu.ops.iou import iou_2d, rotate_iou


def greedy_suppress(
    iou: jax.Array,
    valid: jax.Array,
    iou_threshold: float,
) -> jax.Array:
    """Greedy NMS keep-mask from a precomputed [K, K] IoU matrix.

    Rows/cols are score-ordered (best first). ``valid`` masks real boxes.
    The sweep is ``K`` sequential rounds of one ``[K]`` mask update.
    """
    K = iou.shape[0]
    idx = jnp.arange(K)
    overlap = iou > iou_threshold

    def body(i, keep):
        keep_i = keep[i]
        suppress = overlap[i] & (idx > i) & keep_i
        return keep & ~suppress

    return lax.fori_loop(0, K, body, valid)


def nms(
    boxes: jax.Array,
    valid: jax.Array | None = None,
    iou_threshold: float = 0.5,
) -> jax.Array:
    """Standup NMS over score-sorted [K, 4] (x1, y1, x2, y2) boxes.

    Returns a [K] bool keep-mask (static shape — callers gather/mask with
    it rather than compacting).
    """
    K = boxes.shape[0]
    if valid is None:
        valid = jnp.ones((K,), bool)
    return greedy_suppress(iou_2d(boxes, boxes), valid, iou_threshold)


def rotate_nms(
    rbboxes: jax.Array,
    valid: jax.Array | None = None,
    iou_threshold: float = 0.5,
) -> jax.Array:
    """Rotated NMS over score-sorted [K, 5] (x, y, w, l, yaw) boxes:
    the ``[K, K]`` rotated-IoU matrix, then the greedy sweep."""
    K = rbboxes.shape[0]
    if valid is None:
        valid = jnp.ones((K,), bool)
    with jax.named_scope("nms"):
        return greedy_suppress(
            rotate_iou(rbboxes, rbboxes), valid, iou_threshold
        )
