"""Online evaluation metrics (the port's copy of ``mxnet_tpu/metric.py``,
re-pointed to the port's NDArrays and torch tensors).

Capability parity with the reference's ``python/mxnet/metric.py``
(``EvalMetric:68``, registry ``:40``, Accuracy:438, TopKAccuracy:511,
F1:745, MCC:839, Perplexity:954, MAE/MSE/RMSE:1078-1207, CrossEntropy:1272,
PearsonCorrelation:1416, Loss, Custom, CompositeEvalMetric:301).

Sync discipline: the per-batch metrics ``Accuracy``, ``Loss`` and
``Perplexity`` (without ``ignore_label``) reduce on the arrays' device in
``update()`` (a few small kernels on the current stream, no host pull)
and queue the resulting scalar; ``get()`` sums the queue and pulls once.
The branchy long-tail metrics (F1, MCC, PCC, ...) pull per ``update()``:
their math is host-shaped.  ``_as_numpy`` takes NDArrays (bf16 as f32),
torch tensors and array-likes.
"""
from __future__ import annotations

import math

import numpy
import torch

from . import registry
from .base import MXNetError  # noqa: F401 (re-export parity)

__all__ = [
    'EvalMetric', 'CompositeEvalMetric', 'Accuracy', 'TopKAccuracy',
    'F1', 'MCC', 'Perplexity', 'MAE', 'MSE', 'RMSE', 'CrossEntropy',
    'NegativeLogLikelihood', 'PearsonCorrelation', 'PCC', 'Loss', 'Torch',
    'Caffe', 'CustomMetric', 'np', 'create', 'register', 'get',
]


def _as_numpy(x):
    if hasattr(x, 'asnumpy'):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return numpy.asarray(x)


def _device_tensor(x):
    """The tensor of an NDArray or a tensor (the device path), else None."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if hasattr(x, 'asnumpy') and hasattr(x, '_data'):
        return x._data.detach()
    return None


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Parity: metric.py check_label_shapes — validate label/pred pairing."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(label_shape, pred_shape))
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


class EvalMetric:
    """Base class for all evaluation metrics (parity: metric.py:68)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        # device-side accumulation queue: (scalar device array, host count)
        # pairs appended by update(), drained by ONE pull in get()
        self._pending = []
        self._pending_inst = 0
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = dict(self._kwargs)
        config.update({
            'metric': self.__class__.__name__,
            'name': self.name,
            'output_names': self.output_names,
            'label_names': self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):  # pragma: no cover - abstract
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        self._pending = []
        self._pending_inst = 0

    def reset_local(self):
        # flush first: queued device sums predate the reset and must still
        # land in the *global* accumulators
        self._flush()
        self.num_inst = 0
        self.sum_metric = 0.0

    def _device_accumulate(self, value, n):
        """Queue a device-side partial sum (no sync): ``value`` is a scalar
        device array, ``n`` the instance count (host metadata)."""
        self._pending.append(value)
        self._pending_inst += int(n)

    def _flush(self):
        """Drain the device queue with ONE host pull."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        n, self._pending_inst = self._pending_inst, 0
        total = pending[0]
        for v in pending[1:]:
            total = total + v  # device-side adds, still async
        total = float(total)  # the one pull
        self.sum_metric += total
        self.global_sum_metric += total
        self.num_inst += n
        self.global_num_inst += n

    def get(self):
        self._flush()
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        self._flush()
        if self.global_num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_global_name_value(self):
        name, value = self.get_global()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


# the metric registry (parity: metric.py:40-66 register/create/get)
register = registry.get_register_func(EvalMetric, 'metric')
alias = registry.get_alias_func(EvalMetric, 'metric')
_create = registry.get_create_func(EvalMetric, 'metric')


def create(metric, *args, **kwargs):
    """Create a metric from name / callable / list of names."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _create(metric, *args, **kwargs)


def get(name, *args, **kwargs):
    return create(name, *args, **kwargs)


@register
@alias('composite')
class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (parity: metric.py:301)."""

    def __init__(self, metrics=None, name='composite',
                 output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(m) for m in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            raise ValueError("Metric index {} is out of range 0..{}".format(
                index, len(self.metrics)))

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, 'metrics', []):
            metric.reset()

    def reset_local(self):
        for metric in getattr(self, 'metrics', []):
            metric.reset_local()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_global(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get_global()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register
@alias('acc')
class Accuracy(EvalMetric):
    """Classification accuracy (parity: metric.py:438)."""

    def __init__(self, axis=1, name='accuracy',
                 output_names=None, label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pd, ld = _device_tensor(pred), _device_tensor(label)
            if pd is not None and ld is not None:
                # device path: enqueue the reduction, pull nothing — the
                # correct-count lands in the pending queue and is pulled
                # once per get() (see module docstring)
                ld = ld.to(pd.device, non_blocking=True)
                if pd.dim() > ld.dim():
                    pd = pd.argmax(dim=self.axis)
                correct = (pd.to(torch.int32).reshape(-1)
                           == ld.to(torch.int32).reshape(-1)).sum()
                self._device_accumulate(correct, ld.numel())
                continue
            pred, label = _as_numpy(pred), _as_numpy(label)
            if pred.ndim > label.ndim:
                pred = numpy.argmax(pred, axis=self.axis)
            pred = pred.astype('int32').flat
            label = label.astype('int32').flat
            check_label_shapes(label, pred)
            correct = (numpy.asarray(pred) == numpy.asarray(label)).sum()
            self.sum_metric += correct
            self.global_sum_metric += correct
            self.num_inst += len(numpy.asarray(label))
            self.global_num_inst += len(numpy.asarray(label))


@register
@alias('top_k_accuracy', 'top_k_acc')
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (parity: metric.py:511)."""

    def __init__(self, top_k=1, name='top_k_accuracy',
                 output_names=None, label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Use Accuracy for top_k=1")
        self.name += '_%d' % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred, label = _as_numpy(pred), _as_numpy(label)
            assert pred.ndim == 2, 'Predictions should be 2 dims'
            # argpartition is O(n) vs argsort O(n log n): same trick as ref
            index = numpy.argpartition(pred.astype('float32'),
                                       -self.top_k)[:, -self.top_k:]
            label = label.astype('int32')
            num_samples = pred.shape[0]
            hits = (index == label.reshape(-1, 1)).any(axis=1).sum()
            self.sum_metric += hits
            self.global_sum_metric += hits
            self.num_inst += num_samples
            self.global_num_inst += num_samples


class _BinaryClassificationStats:
    """Accumulated TP/FP/TN/FN (parity: metric.py _BinaryClassificationMetrics)."""

    def __init__(self):
        self.reset_stats()

    def reset_stats(self):
        self.true_positives = 0
        self.false_positives = 0
        self.true_negatives = 0
        self.false_negatives = 0
        self.global_true_positives = 0
        self.global_false_positives = 0
        self.global_true_negatives = 0
        self.global_false_negatives = 0

    def update_binary_stats(self, label, pred):
        pred = _as_numpy(pred)
        label = _as_numpy(label).astype('int32')
        pred_label = numpy.argmax(pred, axis=1) if pred.ndim > 1 else \
            (pred > 0.5).astype('int32')
        check_label_shapes(label.flat, pred_label.flat)
        if len(numpy.unique(label)) > 2:
            raise ValueError("%s currently only supports binary"
                             " classification." % self.__class__.__name__)
        pred_true = pred_label == 1
        pred_false = ~pred_true
        label_true = label.reshape(pred_label.shape) == 1
        label_false = ~label_true
        tp = (pred_true & label_true).sum()
        fp = (pred_true & label_false).sum()
        fn = (pred_false & label_true).sum()
        tn = (pred_false & label_false).sum()
        self.true_positives += tp
        self.false_positives += fp
        self.false_negatives += fn
        self.true_negatives += tn
        self.global_true_positives += tp
        self.global_false_positives += fp
        self.global_false_negatives += fn
        self.global_true_negatives += tn

    @property
    def precision(self):
        denom = self.true_positives + self.false_positives
        return self.true_positives / denom if denom > 0 else 0.

    @property
    def recall(self):
        denom = self.true_positives + self.false_negatives
        return self.true_positives / denom if denom > 0 else 0.

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / \
                (self.precision + self.recall)
        return 0.

    @property
    def global_fscore(self):
        gp = self.global_true_positives + self.global_false_positives
        gr = self.global_true_positives + self.global_false_negatives
        precision = self.global_true_positives / gp if gp > 0 else 0.
        recall = self.global_true_positives / gr if gr > 0 else 0.
        if precision + recall > 0:
            return 2 * precision * recall / (precision + recall)
        return 0.

    def matthewscc(self, use_global=False):
        if use_global:
            tp, fp = self.global_true_positives, self.global_false_positives
            tn, fn = self.global_true_negatives, self.global_false_negatives
        else:
            tp, fp = self.true_positives, self.false_positives
            tn, fn = self.true_negatives, self.false_negatives
        if not tp + fp or not tp + fn or not tn + fp or not tn + fn:
            return 0.
        terms = [tp + fp, tp + fn, tn + fp, tn + fn]
        denom = 1.
        for t in terms:
            denom *= t
        return (tp * tn - fp * fn) / math.sqrt(denom)

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives +
                self.true_negatives + self.true_positives)

    @property
    def global_total_examples(self):
        return (self.global_false_negatives + self.global_false_positives +
                self.global_true_negatives + self.global_true_positives)


@register
class F1(EvalMetric):
    """Binary F1 score (parity: metric.py:745)."""

    def __init__(self, name='f1', output_names=None, label_names=None,
                 average='macro'):
        self.average = average
        self.metrics = _BinaryClassificationStats()
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == 'macro':
            self.sum_metric += self.metrics.fscore
            self.global_sum_metric += self.metrics.global_fscore
            self.num_inst += 1
            self.global_num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * \
                self.metrics.total_examples
            self.global_sum_metric = self.metrics.global_fscore * \
                self.metrics.global_total_examples
            self.num_inst = self.metrics.total_examples
            self.global_num_inst = self.metrics.global_total_examples

    def reset(self):
        self.sum_metric = 0.
        self.num_inst = 0.
        self.global_sum_metric = 0.
        self.global_num_inst = 0.
        getattr(self, 'metrics', _BinaryClassificationStats()).reset_stats()

    def reset_local(self):
        self.sum_metric = 0.
        self.num_inst = 0.
        self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (parity: metric.py:839)."""

    def __init__(self, name='mcc', output_names=None, label_names=None,
                 average='macro'):
        self._average = average
        self._metrics = _BinaryClassificationStats()
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(label, pred)
        if self._average == 'macro':
            self.sum_metric += self._metrics.matthewscc()
            self.global_sum_metric += self._metrics.matthewscc(
                use_global=True)
            self.num_inst += 1
            self.global_num_inst += 1
            self._metrics.reset_stats()
        else:
            self.sum_metric = self._metrics.matthewscc() * \
                self._metrics.total_examples
            self.global_sum_metric = self._metrics.matthewscc(True) * \
                self._metrics.global_total_examples
            self.num_inst = self._metrics.total_examples
            self.global_num_inst = self._metrics.global_total_examples

    def reset(self):
        self.sum_metric = 0.
        self.num_inst = 0.
        self.global_sum_metric = 0.
        self.global_num_inst = 0.
        getattr(self, '_metrics', _BinaryClassificationStats()).reset_stats()

    def reset_local(self):
        self.sum_metric = 0.
        self.num_inst = 0.
        self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """Perplexity (parity: metric.py:954)."""

    def __init__(self, ignore_label=None, axis=-1, name='perplexity',
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.
        num = 0
        for label, pred in zip(labels, preds):
            pd, ld = _device_tensor(pred), _device_tensor(label)
            if pd is not None and ld is not None \
                    and self.ignore_label is None:
                # device path: the picked probabilities' log-sum queued,
                # pulled once per get()
                ld = ld.to(pd.device, non_blocking=True).reshape(-1).long()
                probs = pd.reshape(ld.shape[0], -1).gather(
                    1, ld.unsqueeze(1)).reshape(-1)
                self._device_accumulate(
                    -torch.log(probs.clamp(min=1e-10)).sum(), ld.numel())
                continue
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            label = label.reshape(-1).astype('int64')
            pred = pred.reshape(label.shape[0], -1)
            probs = pred[numpy.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = numpy.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.shape[0]
        self.sum_metric += loss
        self.global_sum_metric += loss
        self.num_inst += num
        self.global_num_inst += num

    def get(self):
        self._flush()
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, math.exp(self.sum_metric / self.num_inst))

    def get_global(self):
        self._flush()
        if self.global_num_inst == 0:
            return (self.name, float('nan'))
        return (self.name,
                math.exp(self.global_sum_metric / self.global_num_inst))


@register
class MAE(EvalMetric):
    """Mean absolute error (parity: metric.py:1078)."""

    def __init__(self, name='mae', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            mae = numpy.abs(label - pred).mean()
            self.sum_metric += mae
            self.global_sum_metric += mae
            self.num_inst += 1
            self.global_num_inst += 1


@register
class MSE(EvalMetric):
    """Mean squared error (parity: metric.py:1139)."""

    def __init__(self, name='mse', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            mse = ((label - pred) ** 2.0).mean()
            self.sum_metric += mse
            self.global_sum_metric += mse
            self.num_inst += 1
            self.global_num_inst += 1


@register
class RMSE(MSE):
    """Root mean squared error (parity: metric.py:1207)."""

    def __init__(self, name='rmse', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float('nan'))
        return (self.name,
                math.sqrt(self.global_sum_metric / self.global_num_inst))


@register
@alias('ce')
class CrossEntropy(EvalMetric):
    """Cross-entropy of predicted distribution vs label (metric.py:1272)."""

    def __init__(self, eps=1e-12, name='cross-entropy',
                 output_names=None, label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), label.astype('int64')]
            loss = (-numpy.log(prob + self.eps)).sum()
            self.sum_metric += loss
            self.global_sum_metric += loss
            self.num_inst += label.shape[0]
            self.global_num_inst += label.shape[0]


@register
@alias('nll_loss')
class NegativeLogLikelihood(EvalMetric):
    """NLL over predicted probabilities (parity: metric.py:1344)."""

    def __init__(self, eps=1e-12, name='nll-loss',
                 output_names=None, label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples
            prob = pred[numpy.arange(num_examples), label.astype('int64')]
            nll = (-numpy.log(prob + self.eps)).sum()
            self.sum_metric += nll
            self.global_sum_metric += nll
            self.num_inst += num_examples
            self.global_num_inst += num_examples


@register
@alias('pearsonr')
class PearsonCorrelation(EvalMetric):
    """Streaming Pearson correlation (parity: metric.py:1416).

    Uses running co-moment accumulation so the estimate is over ALL samples
    seen, not a mean of per-batch correlations.
    """

    def __init__(self, name='pearsonr', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def reset(self):
        self._sse_p = 0
        self._mean_p = 0
        self._sse_l = 0
        self._mean_l = 0
        self._pred_nums = 0
        self._label_nums = 0
        self._conv = 0
        super().reset()

    def update_variance(self, new_values, *aggregate):
        count, mean, m2 = aggregate
        count += len(new_values)
        delta = new_values - mean
        mean += numpy.sum(delta / count)
        delta2 = new_values - mean
        m2 += numpy.sum(delta * delta2)
        return count, mean, m2

    def update_cov(self, label, pred):
        self._conv += numpy.sum(
            (label - self._mean_l) * (pred - self._mean_p))

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype('float64')
            pred = _as_numpy(pred).ravel().astype('float64')
            self._label_nums, self._mean_l, self._sse_l = \
                self.update_variance(label, self._label_nums, self._mean_l,
                                     self._sse_l)
            self.update_cov(label, pred)
            self._pred_nums, self._mean_p, self._sse_p = \
                self.update_variance(pred, self._pred_nums, self._mean_p,
                                     self._sse_p)

    def get(self):
        if self._sse_p == 0 or self._sse_l == 0:
            return (self.name, float('nan'))
        n = self._label_nums
        corr = self._conv / ((n - 1) * numpy.sqrt(self._sse_p / (n - 1)) *
                             numpy.sqrt(self._sse_l / (n - 1)))
        return (self.name, float(corr))


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation via confusion matrix (metric.py:1549)."""

    def __init__(self, name='pcc', output_names=None, label_names=None):
        self.k = 2
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)

    def _grow(self, inc):
        self.lcm = numpy.pad(self.lcm, ((0, inc), (0, inc)), 'constant')
        self.gcm = numpy.pad(self.gcm, ((0, inc), (0, inc)), 'constant')
        self.k += inc

    @staticmethod
    def _calc_mcc(cmat):
        n = cmat.sum()
        x = cmat.sum(axis=1)
        y = cmat.sum(axis=0)
        cov_xx = numpy.sum(x * (n - x))
        cov_yy = numpy.sum(y * (n - y))
        if cov_xx == 0 or cov_yy == 0:
            return float('nan')
        i = cmat.diagonal()
        cov_xy = numpy.sum(i * n - x * y)
        return cov_xy / (cov_xx * cov_yy) ** 0.5

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype('int32', copy=False).ravel()
            pred = _as_numpy(pred)
            if pred.ndim > 1:
                pred = numpy.argmax(pred, axis=1)
            pred = pred.astype('int32', copy=False).ravel()
            n = int(max(pred.max(), label.max()))
            if n >= self.k:
                self._grow(n + 1 - self.k)
            bcm = numpy.zeros((self.k, self.k))
            for i, j in zip(pred, label):
                bcm[i, j] += 1
            self.lcm += bcm
            self.gcm += bcm
        self.num_inst += 1
        self.global_num_inst += 1

    @property
    def sum_metric(self):
        return self._calc_mcc(self.lcm) * self.num_inst

    @property
    def global_sum_metric(self):
        return self._calc_mcc(self.gcm) * self.global_num_inst

    @sum_metric.setter
    def sum_metric(self, _):
        pass

    @global_sum_metric.setter
    def global_sum_metric(self, _):
        pass

    def reset(self):
        self.global_num_inst = 0
        self.gcm = numpy.zeros((self.k, self.k))
        self.reset_local()

    def reset_local(self):
        self.num_inst = 0
        self.lcm = numpy.zeros((self.k, self.k))


@register
class Loss(EvalMetric):
    """Dummy metric averaging a loss output (parity: metric.py:1659)."""

    def __init__(self, name='loss', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        if isinstance(preds, (list, tuple)) and not hasattr(preds, 'shape'):
            pred_list = list(preds)
        else:
            pred_list = [preds]
        for pred in pred_list:
            t = _device_tensor(pred)
            if t is not None:
                # device path: async sum now, one pull per get()
                self._device_accumulate(t.sum(), t.numel())
                continue
            pred = _as_numpy(pred)
            loss = float(numpy.sum(pred))
            self.sum_metric += loss
            self.global_sum_metric += loss
            self.num_inst += pred.size
            self.global_num_inst += pred.size


@register
class Torch(Loss):
    """Legacy alias (parity: metric.py:1699)."""

    def __init__(self, name='torch', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)


@register
class Caffe(Loss):
    """Legacy alias (parity: metric.py:1708)."""

    def __init__(self, name='caffe', output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)


@register
class CustomMetric(EvalMetric):
    """Metric from a ``feval(label, pred)`` function (metric.py:1717)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find('<') != -1:
                name = 'custom(%s)' % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.global_sum_metric += sum_metric
                self.num_inst += num_inst
                self.global_num_inst += num_inst
            else:
                self.sum_metric += reval
                self.global_sum_metric += reval
                self.num_inst += 1
                self.global_num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy eval function as a metric (parity: metric.py:1810)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
