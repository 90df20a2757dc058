"""Losses (the port's counterpart of ``mxnet_tpu/gluon/loss.py``).

A loss returns one value per sample: the mean over every axis but
``batch_axis``.  ``SoftmaxCrossEntropyLoss`` takes its log-softmax in
f32 whatever the prediction's dtype (``log_softmax`` is on AMP's f32
list), and reads float labels as class indices, clipped to range, as
the JAX package's ``pick`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .block import HybridBlock


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis % loss.dim())
    return loss.mean(dim=axes) if axes else loss


class Loss(HybridBlock):
    """Base loss (parity: loss.Loss)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            self.__class__.__name__, self._batch_axis, self._weight)


class SoftmaxCrossEntropyLoss(Loss):
    """Parity: loss.SoftmaxCrossEntropyLoss (``axis``, ``sparse_label``,
    ``from_logits``)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis % pred.dim()
        if self._from_logits:
            pred = pred.float()
        else:
            pred = F.log_softmax(pred, dim=axis, dtype=torch.float32)
        if self._sparse_label:
            idx = label.long().clamp(0, pred.shape[axis] - 1)
            loss = -pred.gather(axis, idx.unsqueeze(axis))
        else:
            label = label.reshape(pred.shape).to(pred.dtype)
            loss = -(pred * label).sum(dim=axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
