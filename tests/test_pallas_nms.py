"""Greedy NMS sweeps (the plain ``fori_loop`` path) vs the numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from papc_tpu.detect.box_np import rotate_iou_cpu
from papc_tpu.ops.iou import rotate_iou
from papc_tpu.ops.nms import greedy_suppress, rotate_nms
from tests.oracles import greedy_nms_np


def _random_iou(rng, K):
    """Symmetric [K, K] matrix with unit diagonal and clustered overlaps."""
    m = rng.rand(K, K).astype(np.float32)
    m = np.maximum(m, m.T)
    np.fill_diagonal(m, 1.0)
    return m


@pytest.mark.parametrize("K", [7, 128, 300])
def test_matches_jnp_reference(rng, K):
    iou = _random_iou(rng, K)
    valid = np.ones((K,), bool)
    for thr in (0.3, 0.5, 0.9):
        got = np.asarray(
            greedy_suppress(jnp.asarray(iou), jnp.asarray(valid), thr)
        )
        np.testing.assert_array_equal(got, greedy_nms_np(iou, valid, thr))


def test_valid_mask_respected(rng):
    K = 64
    iou = _random_iou(rng, K)
    valid = rng.rand(K) > 0.3
    got = np.asarray(
        greedy_suppress(jnp.asarray(iou), jnp.asarray(valid), 0.5)
    )
    np.testing.assert_array_equal(got, greedy_nms_np(iou, valid, 0.5))
    # invalid rows stay invalid
    assert not np.any(got[~valid])


def test_suppressed_box_cannot_suppress(rng):
    """Box 1 overlaps 0 (suppressed); box 2 overlaps 1 but not 0, so a
    kept-mask-unaware sweep would wrongly drop 2."""
    iou = jnp.asarray(
        np.array(
            [
                [1.0, 0.9, 0.0],
                [0.9, 1.0, 0.9],
                [0.0, 0.9, 1.0],
            ],
            np.float32,
        )
    )
    valid = jnp.ones((3,), bool)
    got = np.asarray(greedy_suppress(iou, valid, 0.5))
    np.testing.assert_array_equal(got, [True, False, True])


def _random_rboxes(rng, K):
    """Clustered rotated boxes so real suppression happens."""
    centers = rng.uniform(0, 40, size=(max(K // 4, 1), 2))
    pick = centers[rng.randint(0, len(centers), K)]
    return np.stack(
        [
            pick[:, 0] + rng.randn(K) * 0.8,
            pick[:, 1] + rng.randn(K) * 0.8,
            rng.uniform(1.5, 2.0, K),
            rng.uniform(3.5, 4.5, K),
            rng.uniform(-np.pi, np.pi, K),
        ],
        axis=1,
    ).astype(np.float32)


@pytest.mark.parametrize("K", [5, 64, 200])
def test_rotate_nms_fused_matches_matrix_path(rng, K):
    """``rotate_nms`` = the numpy sweep over its rotated-IoU matrix, and
    that matrix agrees with the host polygon-clipping oracle."""
    boxes = _random_rboxes(rng, K)
    valid = np.ones((K,), bool)
    iou = np.asarray(rotate_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    np.testing.assert_allclose(
        iou, rotate_iou_cpu(boxes, boxes), rtol=1e-3, atol=1e-3
    )
    for thr in (0.1, 0.5):
        got = np.asarray(
            rotate_nms(jnp.asarray(boxes), jnp.asarray(valid), thr)
        )
        np.testing.assert_array_equal(got, greedy_nms_np(iou, valid, thr))
        if K >= 64:  # big cases must exercise both outcomes
            assert 0 < got.sum() < K


def test_rotate_nms_fused_valid_mask(rng):
    K = 48
    boxes = _random_rboxes(rng, K)
    valid = rng.rand(K) > 0.3
    iou = np.asarray(rotate_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    got = np.asarray(
        rotate_nms(jnp.asarray(boxes), jnp.asarray(valid), 0.3)
    )
    np.testing.assert_array_equal(got, greedy_nms_np(iou, valid, 0.3))
    assert not np.any(got[~valid])
