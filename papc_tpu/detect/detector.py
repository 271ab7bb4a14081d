"""Detection loss assembly and prediction post-processing (pure jnp).

Reference parity: ``models/detectors/pointpillars.py`` —
``prepare_loss_weights`` (:468-506), ``create_loss`` (:508-549),
``add_sin_difference`` (:551-557), ``get_direction_target`` (:575-585),
``_get_pos_neg_loss`` (:559-573) and the ``predict`` eval branch
(:218-398). Everything here is jittable with static output shapes: the
prediction path returns fixed-size top-``post_max_size`` detections with
a validity mask instead of ragged per-sample lists.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from papc_tpu.detect import losses as L
from papc_tpu.ops.iou import box5_to_corners
from papc_tpu.ops.nms import greedy_suppress, iou_2d, rotate_nms


def prepare_loss_weights(
    labels: jax.Array,
    pos_cls_weight: float = 1.0,
    neg_cls_weight: float = 1.0,
    loss_norm_type: str = "NormByNumPositives",
):
    """labels [B, A] (-1 ignore / 0 bg / >0 class) → cls_weights [B, A],
    reg_weights [B, A], cared [B, A] bool."""
    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    f32 = jnp.float32
    cls_weights = neg_cls_weight + pos_cls_weight * positives.astype(f32)
    reg_weights = positives.astype(f32)
    if loss_norm_type == "NormByNumExamples":
        num_examples = jnp.clip(
            cared.astype(f32).sum(1, keepdims=True), 1.0, None
        )
        cls_weights = cls_weights / num_examples
        bbox_norm = jnp.clip(
            positives.astype(f32).sum(1, keepdims=True), 1.0, None
        )
        reg_weights = reg_weights / bbox_norm
    elif loss_norm_type == "NormByNumPositives":
        pos_norm = jnp.clip(
            positives.astype(f32).sum(1, keepdims=True), 1.0, None
        )
        reg_weights = reg_weights / pos_norm
        cls_weights = cls_weights / pos_norm
    elif loss_norm_type == "NormByNumPosNeg":
        pos_neg = jnp.stack([positives, negatives], -1).astype(f32)
        normalizer = pos_neg.sum(1, keepdims=True)  # [B, 1, 2]
        cls_normalizer = jnp.clip((pos_neg * normalizer).sum(-1), 1.0, None)
        normalizer = jnp.clip(normalizer, 1.0, None)
        reg_weights = reg_weights / normalizer[:, 0:1, 0]
        cls_weights = cls_weights / cls_normalizer
    else:
        raise ValueError(f"unknown loss norm type {loss_norm_type}")
    return cls_weights, reg_weights, cared


def add_sin_difference(boxes1, boxes2):
    """Replace the angle dims with sin(a)cos(b) / cos(a)sin(b) so the loss
    sees sin(a-b) (reference :551-557)."""
    rad_pred = jnp.sin(boxes1[..., -1:]) * jnp.cos(boxes2[..., -1:])
    rad_tg = jnp.cos(boxes1[..., -1:]) * jnp.sin(boxes2[..., -1:])
    b1 = jnp.concatenate([boxes1[..., :-1], rad_pred], axis=-1)
    b2 = jnp.concatenate([boxes2[..., :-1], rad_tg], axis=-1)
    return b1, b2


def get_direction_target(anchors, reg_targets, one_hot: bool = True):
    """Direction-classifier target: 1 where the GT yaw is positive
    (reference :575-585). anchors [B, A, 7], reg_targets [B, A, C]."""
    rot_gt = reg_targets[..., -1] + anchors[..., -1]
    t = (rot_gt > 0).astype(jnp.int32)
    if one_hot:
        return jax.nn.one_hot(t, 2, dtype=reg_targets.dtype)
    return t


def get_pos_neg_loss(cls_loss, labels):
    """Split the (already-weighted) cls loss into pos/neg means
    (reference :559-573)."""
    B = cls_loss.shape[0]
    if cls_loss.ndim == 2 or cls_loss.shape[-1] == 1:
        flat = cls_loss.reshape(B, -1)
        pos = ((labels > 0) * flat).sum() / B
        neg = ((labels == 0) * flat).sum() / B
    else:
        pos = cls_loss[..., 1:].sum() / B
        neg = cls_loss[..., 0].sum() / B
    return pos, neg


@dataclasses.dataclass(frozen=True)
class LossConfig:
    num_class: int = 1
    encode_background_as_zeros: bool = True
    encode_rad_error_by_sin: bool = True
    box_code_size: int = 7
    pos_cls_weight: float = 1.0
    neg_cls_weight: float = 1.0
    loss_norm_type: str = "NormByNumPositives"
    cls_loss_weight: float = 1.0
    loc_loss_weight: float = 2.0
    direction_loss_weight: float = 2.0
    use_direction_classifier: bool = True
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_sigma: float = 3.0
    code_weights: tuple = (1.0,) * 7


def compute_loss_bac(
    preds: dict,
    labels: jax.Array,  # [B, A]
    reg_targets: jax.Array,  # [B, A, code]
    anchors: jax.Array,  # [B, A, 7]
    cfg: LossConfig,
):
    """Reference-layout loss assembly over ``[B, A, C]`` tensors.

    This is the direct transcription of the reference's ``create_loss``
    (``detectors/pointpillars.py:508-549``) and serves as the layout
    ORACLE for :func:`compute_loss` (the production path, which runs the
    same math in the ``[B, C, A]`` layout). Keep byte-level
    semantics in sync; ``tests/test_detect_model.py`` asserts parity.

    Returns (total_loss, metrics_dict)."""
    B = labels.shape[0]
    box_preds = preds["box_preds"].reshape(B, -1, cfg.box_code_size)
    ncls = (
        cfg.num_class
        if cfg.encode_background_as_zeros
        else cfg.num_class + 1
    )
    cls_preds = preds["cls_preds"].reshape(B, -1, ncls)

    cls_weights, reg_weights, cared = prepare_loss_weights(
        labels,
        cfg.pos_cls_weight,
        cfg.neg_cls_weight,
        cfg.loss_norm_type,
    )
    cls_targets = labels * cared.astype(labels.dtype)
    one_hot = jax.nn.one_hot(
        cls_targets, cfg.num_class + 1, dtype=box_preds.dtype
    )
    if cfg.encode_background_as_zeros:
        one_hot = one_hot[..., 1:]

    bp, rt = box_preds, reg_targets
    if cfg.encode_rad_error_by_sin:
        bp, rt = add_sin_difference(bp, rt)
    loc_loss = L.weighted_smooth_l1_localization_loss(
        bp, rt, weights=reg_weights, sigma=cfg.smooth_l1_sigma,
        code_weights=list(cfg.code_weights),
    )
    cls_loss = L.sigmoid_focal_classification_loss(
        cls_preds, one_hot, weights=cls_weights,
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha,
    )
    loc_loss_reduced = loc_loss.sum() / B * cfg.loc_loss_weight
    cls_loss_reduced = cls_loss.sum() / B * cfg.cls_loss_weight
    loss = loc_loss_reduced + cls_loss_reduced

    cls_pos, cls_neg = get_pos_neg_loss(cls_loss, labels)
    metrics = {
        "loc_loss": loc_loss_reduced,
        "cls_loss": cls_loss_reduced,
        "cls_pos_loss": cls_pos / cfg.pos_cls_weight,
        "cls_neg_loss": cls_neg / cfg.neg_cls_weight,
        "num_pos": (labels > 0).sum(),
        "num_neg": (labels == 0).sum(),
    }

    if cfg.use_direction_classifier and "dir_cls_preds" in preds:
        dir_targets = get_direction_target(anchors, reg_targets)
        dir_logits = preds["dir_cls_preds"].reshape(B, -1, 2)
        weights = (labels > 0).astype(dir_logits.dtype)
        weights = weights / jnp.clip(
            weights.sum(-1, keepdims=True), 1.0, None
        )
        dir_loss = L.weighted_softmax_classification_loss(
            dir_logits, dir_targets, weights
        )
        dir_loss = dir_loss.sum() / B
        loss = loss + dir_loss * cfg.direction_loss_weight
        metrics["dir_loss"] = dir_loss
    metrics["loss"] = loss
    return loss, metrics


def _heads_to_ca(head: jax.Array, B: int, c: int) -> jax.Array:
    """``[B, H, W, na·c]`` head map (or pre-flattened ``[B, A, c]``) →
    ``[B, c, A]`` with anchor order (h, w, a) — matching
    ``compute_loss_bac``'s ``reshape(B, -1, c)``."""
    if head.ndim == 4:
        Bh, H, W, nac = head.shape
        x = head.reshape(B, H * W, nac // c, c)
    else:
        x = head.reshape(B, -1, 1, c)
    # [B, HW, na, c] → [B, c, HW, na] → [B, c, A]
    x = x.transpose(0, 3, 1, 2)
    return x.reshape(B, c, -1)


def compute_loss(
    preds: dict,
    labels: jax.Array,  # [B, A]
    reg_targets: jax.Array,  # [B, A, code]
    anchors: jax.Array,  # [B, A, 7]
    cfg: LossConfig,
):
    """Assemble the total detection loss from RPN head maps.

    Same math as :func:`compute_loss_bac` (the reference-layout oracle,
    ``detectors/pointpillars.py:508-549``) but computed in the
    channel-major layout ``[B, C, A]``, with the anchor dim minor
    instead of the small channel dims (code=7, ncls, 2) — a layout
    choice of the earlier accelerator build whose A/B on the GPU is
    pending; results differ from the oracle only by reduction order.

    Returns (total_loss, metrics_dict)."""
    B, A = labels.shape
    code = cfg.box_code_size
    ncls = (
        cfg.num_class
        if cfg.encode_background_as_zeros
        else cfg.num_class + 1
    )
    box_preds = _heads_to_ca(preds["box_preds"], B, code)  # [B, code, A]
    cls_preds = _heads_to_ca(preds["cls_preds"], B, ncls)  # [B, ncls, A]
    rt = reg_targets.transpose(0, 2, 1)  # [B, code, A]

    cls_weights, reg_weights, cared = prepare_loss_weights(
        labels,
        cfg.pos_cls_weight,
        cfg.neg_cls_weight,
        cfg.loss_norm_type,
    )
    cls_targets = labels * cared.astype(labels.dtype)
    # one-hot with background dropped (encode_background_as_zeros) is
    # (cls_targets == c) over the class axis
    first_cls = 1 if cfg.encode_background_as_zeros else 0
    cls_ids = jnp.arange(first_cls, first_cls + ncls)[None, :, None]
    one_hot = (cls_targets[:, None, :] == cls_ids).astype(
        box_preds.dtype
    )  # [B, ncls, A]

    bp = box_preds
    if cfg.encode_rad_error_by_sin:
        rad_pred = jnp.sin(bp[:, -1:, :]) * jnp.cos(rt[:, -1:, :])
        rad_tg = jnp.cos(bp[:, -1:, :]) * jnp.sin(rt[:, -1:, :])
        bp = jnp.concatenate([bp[:, :-1, :], rad_pred], axis=1)
        rt = jnp.concatenate([rt[:, :-1, :], rad_tg], axis=1)

    # smooth-L1 over the code axis
    diff = jnp.asarray(list(cfg.code_weights))[None, :, None] * (bp - rt)
    abs_diff = jnp.abs(diff)
    cut = 1.0 / (cfg.smooth_l1_sigma**2)
    lt = (abs_diff <= cut).astype(diff.dtype)
    loc_loss = (
        lt * 0.5 * jnp.square(abs_diff * cfg.smooth_l1_sigma)
        + (abs_diff - 0.5 * cut) * (1.0 - lt)
    ) * reg_weights[:, None, :]

    # sigmoid focal over the class axis
    ce = L.sigmoid_cross_entropy_with_logits(cls_preds, one_hot)
    prob = jax.nn.sigmoid(cls_preds)
    p_t = one_hot * prob + (1 - one_hot) * (1 - prob)
    modulating = (
        jnp.power(1.0 - p_t, cfg.focal_gamma) if cfg.focal_gamma else 1.0
    )
    if cfg.focal_alpha is not None:
        alpha_w = one_hot * cfg.focal_alpha + (1 - one_hot) * (
            1 - cfg.focal_alpha
        )
    else:
        alpha_w = 1.0
    cls_loss = modulating * alpha_w * ce * cls_weights[:, None, :]

    loc_loss_reduced = loc_loss.sum() / B * cfg.loc_loss_weight
    cls_loss_reduced = cls_loss.sum() / B * cfg.cls_loss_weight
    loss = loc_loss_reduced + cls_loss_reduced

    # pos/neg split (get_pos_neg_loss semantics in [B, C, A] layout)
    if ncls == 1:
        flat = cls_loss[:, 0, :]
        cls_pos = ((labels > 0) * flat).sum() / B
        cls_neg = ((labels == 0) * flat).sum() / B
    else:
        cls_pos = cls_loss[:, 1:, :].sum() / B
        cls_neg = cls_loss[:, 0, :].sum() / B
    metrics = {
        "loc_loss": loc_loss_reduced,
        "cls_loss": cls_loss_reduced,
        "cls_pos_loss": cls_pos / cfg.pos_cls_weight,
        "cls_neg_loss": cls_neg / cfg.neg_cls_weight,
        "num_pos": (labels > 0).sum(),
        "num_neg": (labels == 0).sum(),
    }

    if cfg.use_direction_classifier and "dir_cls_preds" in preds:
        dir_logits = _heads_to_ca(preds["dir_cls_preds"], B, 2)
        rot_gt = reg_targets[..., -1] + anchors[..., -1]  # [B, A]
        t = (rot_gt > 0).astype(jnp.int32)
        dir_targets = (
            jnp.arange(2)[None, :, None] == t[:, None, :]
        ).astype(dir_logits.dtype)  # [B, 2, A]
        weights = (labels > 0).astype(dir_logits.dtype)
        weights = weights / jnp.clip(
            weights.sum(-1, keepdims=True), 1.0, None
        )
        logp = jax.nn.log_softmax(dir_logits, axis=1)
        dir_loss = (-(dir_targets * logp).sum(axis=1) * weights).sum() / B
        loss = loss + dir_loss * cfg.direction_loss_weight
        metrics["dir_loss"] = dir_loss
    metrics["loss"] = loss
    return loss, metrics


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    num_class: int = 1
    encode_background_as_zeros: bool = True
    use_direction_classifier: bool = True
    use_rotate_nms: bool = True
    multiclass_nms: bool = False
    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 300
    nms_score_threshold: float = 0.15
    nms_iou_threshold: float = 0.5
    box_code_size: int = 7


def decode_raw(
    preds: dict,
    anchors: jax.Array,  # [B, A, 7]
    decode_fn: Callable,
    cfg: PredictConfig,
):
    """Shared head of both NMS paths: decoded boxes ``[B, A, 7]``,
    per-class sigmoid scores ``[B, A, num_class]``, direction labels
    ``[B, A]`` (reference ``detectors/pointpillars.py:236-268``)."""
    B, A = anchors.shape[:2]
    box_preds = preds["box_preds"].reshape(B, A, cfg.box_code_size)
    ncls = (
        cfg.num_class
        if cfg.encode_background_as_zeros
        else cfg.num_class + 1
    )
    cls_preds = preds["cls_preds"].reshape(B, A, ncls)
    boxes = decode_fn(box_preds, anchors)  # [B, A, 7]

    if cfg.encode_background_as_zeros:
        total_scores = jax.nn.sigmoid(cls_preds)
    else:
        total_scores = jax.nn.sigmoid(cls_preds)[..., 1:]

    if cfg.use_direction_classifier:
        dir_labels = jnp.argmax(
            preds["dir_cls_preds"].reshape(B, A, 2), axis=-1
        )
    else:
        dir_labels = jnp.zeros((B, A), jnp.int32)
    return boxes, total_scores, dir_labels


def apply_direction_flip(boxes7: jax.Array, dir_labels: jax.Array):
    """Opposite-direction fix: add pi to the yaw exactly where
    ``(yaw > 0) XOR dir_label`` (reference :369-374 — strict ``> 0``, so
    yaw exactly 0 counts as the non-positive side)."""
    opp = (boxes7[..., -1] > 0) ^ (dir_labels.astype(bool))
    return boxes7.at[..., -1].add(jnp.where(opp, jnp.pi, 0.0))


def predict(
    preds: dict,
    anchors: jax.Array,  # [B, A, 7]
    decode_fn: Callable,  # (encodings, anchors) -> boxes7, jnp
    cfg: PredictConfig,
    anchors_mask: jax.Array | None = None,  # [B, A] bool
):
    """Batched post-processing → fixed-size detections.

    Returns dict of ``box3d_lidar [B, post, 7]``, ``scores [B, post]``,
    ``label_preds [B, post]``, ``valid [B, post]`` (all static shapes).
    """
    B, A = anchors.shape[:2]
    boxes, total_scores, dir_labels = decode_raw(
        preds, anchors, decode_fn, cfg
    )

    top_scores = jnp.max(total_scores, axis=-1)  # [B, A]
    top_labels = jnp.argmax(total_scores, axis=-1)
    valid = top_scores >= cfg.nms_score_threshold
    if anchors_mask is not None:
        valid = valid & anchors_mask

    K = min(cfg.nms_pre_max_size, A)

    def per_sample(boxes_i, scores_i, labels_i, dirs_i, valid_i):
        scores_masked = jnp.where(valid_i, scores_i, -1.0)
        top_s, top_idx = jax.lax.top_k(scores_masked, K)
        b = boxes_i[top_idx]
        lab = labels_i[top_idx]
        d = dirs_i[top_idx]
        ok = top_s > 0
        bev = b[:, jnp.asarray([0, 1, 3, 4, 6])]
        if cfg.use_rotate_nms:
            keep = rotate_nms(bev, ok, cfg.nms_iou_threshold)
        else:
            corners = box5_to_corners(bev)
            standup = jnp.concatenate(
                [corners.min(1), corners.max(1)], axis=-1
            )
            keep = greedy_suppress(
                iou_2d(standup, standup), ok, cfg.nms_iou_threshold
            )
        # compact kept detections to the front, cap at post_max_size
        rank = jnp.cumsum(keep) - 1
        P = cfg.nms_post_max_size
        slot = jnp.where(keep & (rank < P), rank, P)
        out_boxes = jnp.zeros((P + 1, b.shape[-1]), b.dtype).at[slot].set(b)
        out_scores = jnp.zeros((P + 1,), top_s.dtype).at[slot].set(top_s)
        out_labels = jnp.zeros((P + 1,), lab.dtype).at[slot].set(lab)
        out_dirs = jnp.zeros((P + 1,), d.dtype).at[slot].set(d)
        out_valid = jnp.zeros((P + 1,), bool).at[slot].set(keep)
        return (
            out_boxes[:P],
            out_scores[:P],
            out_labels[:P],
            out_dirs[:P],
            out_valid[:P],
        )

    b, s, lab, d, v = jax.vmap(per_sample)(
        boxes, top_scores, top_labels, dir_labels, valid
    )
    if cfg.use_direction_classifier:
        b = apply_direction_flip(b, d)
    return {
        "box3d_lidar": b,
        "scores": s,
        "label_preds": lab,
        "valid": v,
    }


def predict_multiclass(
    boxes,
    total_scores,
    dir_labels,
    cfg: PredictConfig,
    anchors_mask=None,
):
    """Host-side per-class NMS — the reference's ``multiclass_nms``
    predict branch (``detectors/pointpillars.py:279-316``), selected by
    the ``PREDICT.multiclass_nms`` config key (reference yaml
    ``pointpillars_kitti_car_xy16.yaml:126``).

    Args are numpy (or np-convertible): ``boxes [B, A, 7]`` decoded,
    ``total_scores [B, A, num_class]``, ``dir_labels [B, A]``. Per class
    the shared class-agnostic BEV boxes are NMS'd with the native C++
    kernels (:mod:`papc_tpu.detect.nms_extra`); selections concatenate
    in class order like the reference, then pad to the static
    ``[B, post_max_size]`` layout of :func:`predict` so downstream
    (kitti annos) is path-agnostic.
    """
    import numpy as np

    from papc_tpu.detect.nms_extra import multiclass_nms, standard_nms_func

    boxes = np.asarray(boxes)
    total_scores = np.asarray(total_scores)
    dir_labels = np.asarray(dir_labels)
    B, A = boxes.shape[:2]
    P = cfg.nms_post_max_size
    nms_func = standard_nms_func(rotated=cfg.use_rotate_nms)
    out_boxes = np.zeros((B, P, boxes.shape[-1]), np.float32)
    out_scores = np.zeros((B, P), np.float32)
    out_labels = np.zeros((B, P), np.int32)
    out_valid = np.zeros((B, P), bool)
    for b in range(B):
        scores_b = total_scores[b]
        if anchors_mask is not None:
            scores_b = np.where(
                np.asarray(anchors_mask)[b][:, None], scores_b, 0.0
            )
        bev = boxes[b][:, [0, 1, 3, 4, 6]]
        selected_per_class = multiclass_nms(
            nms_func,
            bev[:, None, :],
            scores_b,
            pre_max_size=cfg.nms_pre_max_size,
            post_max_size=cfg.nms_post_max_size,
            score_thresh=cfg.nms_score_threshold,
            iou_threshold=cfg.nms_iou_threshold,
        )
        sel_b, sel_s, sel_l, sel_d = [], [], [], []
        for class_idx, selected in enumerate(selected_per_class):
            if selected is None or len(selected) == 0:
                continue
            sel_b.append(boxes[b][selected])
            sel_s.append(scores_b[selected, class_idx])
            sel_l.append(np.full(len(selected), class_idx, np.int32))
            sel_d.append(dir_labels[b][selected])
        if not sel_b:
            continue
        cb = np.concatenate(sel_b)[:P]
        cs = np.concatenate(sel_s)[:P]
        cl = np.concatenate(sel_l)[:P]
        cd = np.concatenate(sel_d)[:P]
        if cfg.use_direction_classifier:
            # opposite-direction fix, identical to the jitted path
            opp = (cb[:, -1] > 0) ^ cd.astype(bool)
            cb[:, -1] += np.where(opp, np.pi, 0.0)
        n = len(cb)
        out_boxes[b, :n] = cb
        out_scores[b, :n] = cs
        out_labels[b, :n] = cl
        out_valid[b, :n] = True
    return {
        "box3d_lidar": out_boxes,
        "scores": out_scores,
        "label_preds": out_labels,
        "valid": out_valid,
    }
