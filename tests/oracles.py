"""Slow, obviously-correct numpy oracles mirroring the reference algorithms
(PAPC/models/layers/pointnet2_basic_layers.py) for kernel equivalence tests."""

import numpy as np


def square_distance_np(src, dst):
    B, N, _ = src.shape
    _, M, _ = dst.shape
    out = np.zeros((B, N, M), dtype=np.float64)
    for b in range(B):
        for n in range(N):
            out[b, n] = np.sum((dst[b] - src[b, n]) ** 2, axis=-1)
    return out


def index_points_np(points, idx):
    B = points.shape[0]
    out = np.stack([points[b][idx[b]] for b in range(B)])
    return out


def farthest_point_sample_np(xyz, npoint, start_idx=0):
    """Reference FPS with deterministic start index."""
    B, N, _ = xyz.shape
    centroids = np.zeros((B, npoint), dtype=np.int64)
    distance = np.full((B, N), np.inf)
    farthest = np.full((B,), start_idx, dtype=np.int64)
    for i in range(npoint):
        centroids[:, i] = farthest
        for b in range(B):
            centroid = xyz[b, farthest[b]]
            d = np.sum((xyz[b] - centroid) ** 2, axis=-1)
            distance[b] = np.minimum(distance[b], d)
            farthest[b] = np.argmax(distance[b])
    return centroids


def query_ball_point_np(radius, nsample, xyz, new_xyz):
    """Reference semantics: first nsample in-radius indices (by index
    order), empty slots filled with the first in-radius index."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    group_idx = np.tile(np.arange(N), (B, S, 1))
    sqrdists = square_distance_np(new_xyz, xyz)
    group_idx[sqrdists > radius**2] = N
    group_idx = np.sort(group_idx, axis=-1)[:, :, :nsample]
    group_first = np.tile(group_idx[:, :, :1], (1, 1, nsample))
    mask = group_idx == N
    group_idx[mask] = group_first[mask]
    return group_idx


def three_nn_interpolate_np(xyz1, xyz2, points2, eps=1e-8):
    B, N, _ = xyz1.shape
    dists = square_distance_np(xyz1, xyz2)  # [B, N, S]
    idx = np.argsort(dists, axis=-1)[:, :, :3]
    d3 = np.take_along_axis(dists, idx, axis=-1)
    recip = 1.0 / (d3 + eps)
    w = recip / recip.sum(-1, keepdims=True)
    out = np.zeros((B, N, points2.shape[-1]))
    for b in range(B):
        for n in range(N):
            out[b, n] = (points2[b][idx[b, n]] * w[b, n][:, None]).sum(0)
    return out


def greedy_nms_np(iou, valid, threshold):
    """Reference greedy sweep over a score-ordered IoU matrix: each kept
    box, best first, drops every later box it overlaps above
    ``threshold``; suppressed boxes suppress nothing."""
    keep = np.asarray(valid, bool).copy()
    for i in range(len(keep)):
        if keep[i]:
            keep[i + 1:] &= ~(np.asarray(iou[i, i + 1:]) > threshold)
    return keep


def gather_rows_grad_np(g, idx, n_rows):
    """Gradient of a row gather ``points[b, idx[b, s]]``: scatter-add of
    the output cotangent ``g [B, S, C]`` into ``[B, n_rows, C]``."""
    B, S, C = g.shape
    out = np.zeros((B, n_rows, C), np.float64)
    for b in range(B):
        for s in range(S):
            out[b, idx[b, s]] += g[b, s]
    return out
