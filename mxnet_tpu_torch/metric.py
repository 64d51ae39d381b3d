"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``, reduced to what the training
slice uses: ``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``,
``CrossEntropy``, ``Perplexity`` and ``create``.  Predictions stay on
their device: each update reduces a batch there and reads back only
the batch's sum and count (one small host read per update), instead of
copying the (rows, classes) probabilities to the host as the JAX
package's eager path does.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "CrossEntropy",
           "Perplexity", "create", "register"]

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
        raise MXNetError("metric '%s' is not in the PyTorch port yet"
                         % metric)
    return _METRIC_REGISTRY[key](*args, **kwargs)


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
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
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
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

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
            self.sum_metric += int((label == pred).sum())
            self.num_inst += label.numel()


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
            self.sum_metric += float((-torch.log(prob + self.eps)).sum())
            self.num_inst += label.numel()


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
                num -= int(ignore.sum())
            loss -= float(torch.log(torch.clamp(probs, min=1e-10)).sum())
            num += label.numel()
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))
