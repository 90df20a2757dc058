"""Losses (the port's counterpart of ``mxnet_tpu/gluon/loss.py``).

Each loss is the JAX package's formula on tensors, with its ``weight``
(a number), ``sample_weight`` (broadcast against the loss) and
``batch_axis``.  Most return one value per sample: the mean over every
axis but ``batch_axis``; as in the JAX package, ``TripletLoss`` sums one
axis, ``PoissonNLLLoss`` returns the mean over everything and
``CTCLoss`` one value per sequence.  ``SoftmaxCrossEntropyLoss`` takes
its log-softmax in f32 whatever the prediction's dtype (``log_softmax``
is on AMP's f32 list), and reads float labels as class indices, clipped
to range, as the JAX package's ``pick`` does.  ``CTCLoss`` runs the
registered ``CTCLoss`` op (``ops/nn.py``) with the blank last, as the
JAX package's loss does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ops import nn as _nn_ops
from .block import HybridBlock


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number, got %r" % (weight,))
        loss = loss * weight
    return loss


def _like(x, y):
    """``x`` reshaped to ``y``'s shape (the JAX package's
    ``_reshape_like``)."""
    return x.reshape(y.shape)


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


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2`` (parity: loss.L2Loss)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(_like(label, pred) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L1Loss(Loss):
    """``|pred - label|`` (parity: loss.L1Loss)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(_like(label, pred) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy on logits (the stable
    ``max(x, 0) - x*z + log(1 + exp(-|x|))``) or, with
    ``from_sigmoid``, on probabilities; ``pos_weight`` weighs the
    positive term (parity: loss.SigmoidBinaryCrossEntropyLoss)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _like(label, pred)
        if not self._from_sigmoid:
            soft = F.softplus(-torch.abs(pred))
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + soft
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = torch.relu(pred) - pred * label \
                    + log_weight * (soft + torch.relu(-pred))
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities unless
    ``from_logits`` is off (parity: loss.KLDivLoss)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification (parity: loss.CTCLoss):
    ``pred`` in ``layout`` (``NTC`` or ``TNC``) holds logits, ``label``
    in ``label_layout`` class indices padded with -1; the blank is the
    last class.  ``pred_lengths`` and ``label_lengths`` give each
    sequence's lengths where they are shorter."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise MXNetError("CTCLoss: layout must be NTC or TNC, got %r"
                             % (layout,))
        if label_layout not in ("NT", "TN"):
            raise MXNetError("CTCLoss: label_layout must be NT or TN, got "
                             "%r" % (label_layout,))
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss, _ = _nn_ops._ctc_loss(
            pred, label, pred_lengths, label_lengths,
            use_data_lengths=pred_lengths is not None,
            use_label_lengths=label_lengths is not None, blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|d| - rho/2`` where ``|d| > rho``, else ``d^2 / (2 rho)``
    (parity: loss.HuberLoss)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(_like(label, pred) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    """``max(0, margin - pred*label)`` (parity: loss.HingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _hinge(self, pred, label):
        return torch.relu(self._margin - pred * _like(label, pred))

    def forward(self, pred, label, sample_weight=None):
        loss = _apply_weighting(self._hinge(pred, label), self._weight,
                                sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(HingeLoss):
    """``max(0, margin - pred*label)^2`` (parity:
    loss.SquaredHingeLoss)."""

    def _hinge(self, pred, label):
        return torch.square(super()._hinge(pred, label))


class LogisticLoss(Loss):
    """Logistic loss on ``signed`` (-1/1) or ``binary`` (0/1) labels
    (parity: loss.LogisticLoss)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise MXNetError("label_format can only be signed or binary, "
                             "got %s" % label_format)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label \
            + F.softplus(-torch.abs(pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    """``max(0, |pos - pred|^2 - |neg - pred|^2 + margin)``, the squares
    summed over the axis after ``batch_axis`` (parity:
    loss.TripletLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        d = torch.square(_like(positive, pred) - pred) \
            - torch.square(_like(negative, pred) - pred)
        loss = d.sum(dim=self._batch_axis + 1) if pred.dim() > 1 \
            else d.sum()
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, with Stirling's term where
    ``compute_full``; the mean over every element (parity:
    loss.PoissonNLLLoss)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _like(target, pred)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + epsilon) - target \
                + 0.5 * torch.log(2 * math.pi * (target + epsilon))
            loss = loss + stirling * (target > 1)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``max(0, cos - margin)`` otherwise
    (parity: loss.CosineEmbeddingLoss)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = _like(input1, input2)
        cos = self._cosine_similarity(input1, input2)
        label = label.reshape(-1, 1)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)

    @staticmethod
    def _cosine_similarity(x, y, axis=-1):
        x_norm = torch.linalg.vector_norm(x, dim=axis).reshape(-1, 1)
        y_norm = torch.linalg.vector_norm(y, dim=axis).reshape(-1, 1)
        xy = (x * y).sum(dim=axis).reshape(-1, 1)
        return xy / torch.clamp(x_norm * y_norm, min=1e-12)


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss (parity: loss.SDMLLoss): row i
    of ``x1`` pairs with row i of ``x2`` and every other row is a
    negative; the softmax of the negated squared distances is pulled
    toward a label-smoothed identity by KL divergence, times the batch
    size."""

    def __init__(self, smoothing_parameter=0.3, weight=1., batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def forward(self, x1, x2):
        b = x1.shape[0]
        gold = torch.eye(b, dtype=x1.dtype, device=x1.device)
        s = self.smoothing_parameter
        labels = gold * (1 - s) + (1 - gold) * s / (b - 1)
        dist = torch.square(x1[:, None, :] - x2[None, :, :]).sum(dim=2)
        return self.kl_loss(F.log_softmax(-dist, dim=1), labels) * b
