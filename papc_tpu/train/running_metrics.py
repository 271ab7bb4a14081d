"""Stateful running metrics for detection training.

Reference parity: ``libs/tools/metrics.py`` — buffer-backed ``Scalar``
(:7), ``Accuracy`` (:27, sigmoid-threshold + background-as-zeros aware),
``Precision``/``Recall`` (:76, :124) and multi-threshold
``PrecisionRecall`` (:191-274). Implemented as pure pytree states +
update functions (jit-friendly: the state is explicit instead of paddle
buffers)."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ScalarState(NamedTuple):
    total: jax.Array
    count: jax.Array

    @classmethod
    def create(cls):
        return cls(jnp.zeros(()), jnp.zeros(()))

    def update(self, value):
        return ScalarState(self.total + value, self.count + 1.0)

    @property
    def value(self):
        return self.total / jnp.maximum(self.count, 1.0)


def _scores_and_labels(
    preds,
    labels,
    use_sigmoid_score=True,
    encode_background_as_zeros=True,
    channel_axis=-1,
):
    """preds logits → (score, pred_label) with background = 0
    (reference metrics.py:27-75 semantics).

    ``channel_axis=1`` accepts the ``[B, C, A]`` layout of the
    detection train step (see ``detector.compute_loss``)."""
    ax = channel_axis
    if encode_background_as_zeros:
        scores = (
            jax.nn.sigmoid(preds)
            if use_sigmoid_score
            else jax.nn.softmax(preds, ax)
        )
        score = jnp.max(scores, axis=ax)
        pred_label = jnp.argmax(preds, axis=ax) + 1
    else:
        fg = jax.lax.slice_in_dim(preds, 1, preds.shape[ax], axis=ax)
        scores = (
            jax.nn.sigmoid(fg)
            if use_sigmoid_score
            else jax.lax.slice_in_dim(
                jax.nn.softmax(preds, ax), 1, preds.shape[ax], axis=ax
            )
        )
        score = jnp.max(scores, axis=ax)
        pred_label = jnp.argmax(fg, axis=ax) + 1
    return score, pred_label


class AccuracyState(NamedTuple):
    total: jax.Array
    count: jax.Array

    @classmethod
    def create(cls):
        return cls(jnp.zeros(()), jnp.zeros(()))

    def update(
        self,
        labels,
        preds,
        weights=None,
        threshold=0.5,
        use_sigmoid_score=True,
        encode_background_as_zeros=True,
        channel_axis=-1,
    ):
        score, pred_label = _scores_and_labels(
            preds, labels, use_sigmoid_score,
            encode_background_as_zeros, channel_axis,
        )
        pred_label = jnp.where(score > threshold, pred_label, 0)
        correct = (pred_label == labels).astype(jnp.float32)
        if weights is None:
            w = (labels >= 0).astype(jnp.float32)
        else:
            w = weights.astype(jnp.float32)
        return AccuracyState(
            self.total + jnp.sum(correct * w), self.count + jnp.sum(w)
        )

    @property
    def value(self):
        return self.total / jnp.maximum(self.count, 1.0)


class PrecisionRecallState(NamedTuple):
    """Multi-threshold running TP/FP/FN/TN (reference :191-274)."""

    tp: jax.Array  # [T]
    fp: jax.Array
    fn: jax.Array
    tn: jax.Array
    thresholds: jax.Array

    @classmethod
    def create(cls, thresholds=(0.1, 0.3, 0.5, 0.7, 0.8, 0.9, 0.95)):
        t = jnp.asarray(thresholds)
        z = jnp.zeros_like(t)
        return cls(z, z, z, z, t)

    def update(
        self,
        labels,
        preds,
        weights=None,
        use_sigmoid_score=True,
        encode_background_as_zeros=True,
        channel_axis=-1,
    ):
        score, _ = _scores_and_labels(
            preds, labels, use_sigmoid_score,
            encode_background_as_zeros, channel_axis,
        )
        if weights is None:
            w = (labels >= 0).astype(jnp.float32)
        else:
            w = weights.astype(jnp.float32)
        pos = (labels > 0).astype(jnp.float32) * w
        neg = (labels == 0).astype(jnp.float32) * w

        def per_threshold(thresh):
            pred_pos = (score > thresh).astype(jnp.float32) * w
            tp = jnp.sum(pred_pos * pos)
            fp = jnp.sum(pred_pos * neg)
            fn = jnp.sum((1 - pred_pos) * pos)
            tn = jnp.sum((1 - pred_pos) * neg)
            return tp, fp, fn, tn

        tp, fp, fn, tn = jax.vmap(per_threshold)(self.thresholds)
        return PrecisionRecallState(
            self.tp + tp, self.fp + fp, self.fn + fn, self.tn + tn,
            self.thresholds,
        )

    @property
    def precision(self):
        return self.tp / jnp.maximum(self.tp + self.fp, 1.0)

    @property
    def recall(self):
        return self.tp / jnp.maximum(self.tp + self.fn, 1.0)
