"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``, reduced to what the training
slice uses: ``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``,
``CrossEntropy``, ``Perplexity`` and ``create``.  Predictions stay on
their device: each update reduces a batch there and reads back only
the batch's sum and count (one small host read per update), instead of
copying the (rows, classes) probabilities to the host as the JAX
package's eager path does.

Device accumulation (the fused fit step, ``module/fused_fit.py``):
``Accuracy``, ``CrossEntropy`` and ``Perplexity`` describe their batch
reduction as ``device_fn()``, which the step runs inside its CUDA graph
into a device accumulator (``_dev_sum``, ``_dev_num``); the host reads
it only in ``get()``.  A batch the step has folded in is marked, and
``consume_device_batch`` makes the fit loop's ``update_metric`` skip
it.  ``HOST_SYNCS`` counts every read of a reduced value to the host
that the metrics make (per-batch reads of the host path, ``get()``-time
folds of the device path); on the card each is a blocking sync.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "CrossEntropy",
           "Perplexity", "create", "register", "consume_device_batch",
           "HOST_SYNCS"]

_METRIC_REGISTRY = {}


def register(*names):
    """Register a metric class under its lower-case name and ``names``."""
    def deco(klass):
        _METRIC_REGISTRY[klass.__name__.lower()] = klass
        for n in names:
            _METRIC_REGISTRY[n] = klass
        return klass
    return deco


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    key = str(metric).lower()
    if key not in _METRIC_REGISTRY:
        raise MXNetError("metric '%s' is not in the PyTorch port yet "
                         "(ROADMAP A.5, metrics)" % metric)
    return _METRIC_REGISTRY[key](*args, **kwargs)


class _SyncCount:
    """A count of blocking device-to-host reads (``value``)."""

    def __init__(self):
        self.value = 0

    def increment(self):
        self.value += 1


HOST_SYNCS = _SyncCount()


def _read(t):
    """``t``'s value as a Python number, counted in ``HOST_SYNCS`` (on
    the card, a blocking read; on the CPU, the same read in the same
    place)."""
    HOST_SYNCS.increment()
    return t.item()


def consume_device_batch(metric):
    """True, and the mark cleared, when the fused fit step already
    folded the current batch into ``metric``'s device accumulator; the
    caller then skips the host update of this batch."""
    if getattr(metric, "_device_consumed", False):
        metric._device_consumed = False
        return True
    return False


def _pair(label, pred):
    """(label, pred) as tensors on the prediction's device."""
    pred = pred._data if isinstance(pred, NDArray) else torch.as_tensor(pred)
    label = label._data if isinstance(label, NDArray) \
        else torch.as_tensor(label)
    return label.to(pred.device), pred.detach()


def _check_lengths(labels, preds):
    if len(labels) != len(preds):
        raise MXNetError("%d labels for %d predictions"
                         % (len(labels), len(preds)))


class EvalMetric:
    # the device accumulator the fused fit step adds to (0-d f32
    # tensors, None while nothing is pending), and the mark of a batch
    # it has folded in
    _dev_sum = None
    _dev_num = None
    _device_consumed = False

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._dev_sum = None
        self._dev_num = None
        self._device_consumed = False

    def update(self, labels, preds):
        raise NotImplementedError

    def device_fn(self):
        """``fn(labels, preds) -> (batch_sum, batch_num)`` on tensors,
        the batch reduction of :meth:`update` with no host read, or None
        when this metric accumulates on the host."""
        return None

    def device_sig(self):
        """Hashable configuration of :meth:`device_fn` (part of the key
        of the fit step's captured programs)."""
        return None

    def _totals(self):
        """``(sum, num)`` with the device accumulator folded in: a
        blocking read only while device values are pending."""
        if self._dev_sum is None:
            return self.sum_metric, self.num_inst
        HOST_SYNCS.increment()
        return (self.sum_metric + self._dev_sum.item(),
                self.num_inst + self._dev_num.item())

    def update_dict(self, label, pred):
        if consume_device_batch(self):
            return
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names
                     if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        total, num = self._totals()
        if num == 0:
            return (self.name, float("nan"))
        return (self.name, total / num)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


@register("composite")
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        self.metrics = [create(m) for m in (metrics or [])]
        super().__init__(name, output_names, label_names)

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def reset(self):
        for metric in self.metrics:
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            for n, v in metric.get_name_value():
                names.append(n)
                values.append(v)
        return names, values


@register("acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        _check_lengths(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            label = label.long()
            if pred.dim() > label.dim():
                pred = pred.argmax(dim=self.axis)
            label, pred = label.reshape(-1), pred.long().reshape(-1)
            self.sum_metric += int(_read((label == pred).sum()))
            self.num_inst += label.numel()

    def device_fn(self):
        axis = self.axis

        def fn(labels, preds):
            s, n = 0.0, 0
            for label, pred in zip(labels, preds):
                label = label.long()
                if pred.dim() > label.dim():
                    pred = pred.argmax(dim=axis)
                label, pred = label.reshape(-1), pred.long().reshape(-1)
                s = s + (label == pred).sum().float()
                n += label.numel()
            return s, float(n)
        return fn

    def device_sig(self):
        return ("accuracy", self.axis)


@register("crossentropy", "ce")
class CrossEntropy(EvalMetric):
    """Mean of -log(p[label] + eps) over the rows."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        _check_lengths(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            label = label.reshape(-1).long()
            prob = pred.gather(1, label[:, None])[:, 0]
            self.sum_metric += _read((-torch.log(prob + self.eps)).sum())
            self.num_inst += label.numel()

    def device_fn(self):
        eps = self.eps

        def fn(labels, preds):
            s, n = 0.0, 0
            for label, pred in zip(labels, preds):
                label = label.reshape(-1).long()
                prob = pred.gather(1, label[:, None])[:, 0]
                s = s + (-torch.log(prob + eps)).sum().float()
                n += label.numel()
            return s, float(n)
        return fn

    def device_sig(self):
        return ("cross-entropy", self.eps)


@register()
class Perplexity(EvalMetric):
    """exp of the mean of -log(max(p[label], 1e-10)); rows whose label
    is ``ignore_label`` are skipped."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss, num = 0.0, 0
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            label = label.reshape(-1).long()
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred.gather(1, label[:, None])[:, 0]
            if self.ignore_label is not None:
                ignore = label == int(self.ignore_label)
                probs = torch.where(ignore, torch.ones_like(probs), probs)
                num -= int(_read(ignore.sum()))
            loss -= _read(torch.log(torch.clamp(probs, min=1e-10)).sum())
            num += label.numel()
        self.sum_metric += loss
        self.num_inst += num

    def device_fn(self):
        ignore_label = self.ignore_label

        def fn(labels, preds):
            loss, num = 0.0, 0.0
            for label, pred in zip(labels, preds):
                label = label.reshape(-1).long()
                pred = pred.reshape(-1, pred.shape[-1])
                probs = pred.gather(1, label[:, None])[:, 0]
                num = num + float(label.numel())
                if ignore_label is not None:
                    ignore = label == int(ignore_label)
                    probs = torch.where(ignore, torch.ones_like(probs), probs)
                    num = num - ignore.sum().float()
                loss = loss - torch.log(torch.clamp(probs, min=1e-10)) \
                    .sum().float()
            return loss, num
        return fn

    def device_sig(self):
        return ("perplexity", self.ignore_label)

    def get(self):
        total, num = self._totals()
        if num == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(total / num))
