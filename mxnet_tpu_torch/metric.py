"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference metric.py):
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MCC``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``NegativeLogLikelihood``, ``PearsonCorrelation``,
``Loss`` (and its aliases ``Torch`` and ``Caffe``), ``CustomMetric``,
``np``, ``check_label_shapes`` and ``create`` (a callable makes a
``CustomMetric``).  Accuracy, TopKAccuracy, cross-entropy, perplexity,
MAE, MSE and Loss keep predictions on their device: each update reduces
a batch there and reads back only the batch's sum and count (a small
host read per update), instead of copying the (rows, classes)
probabilities to the host as the JAX package's eager path does; F1,
MCC, Pearson and custom metrics read the batch to numpy, as there.

Device accumulation (the fused fit step, ``module/fused_fit.py``):
``Accuracy``, ``TopKAccuracy``, ``CrossEntropy``, ``Perplexity``,
``MAE``, ``MSE`` (and ``RMSE``) and ``Loss`` describe their batch
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

import numpy as _np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register",
           "check_label_shapes", "consume_device_batch", "HOST_SYNCS"]

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
    if callable(metric) and not isinstance(metric, type):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    key = str(metric).lower()
    if key not in _METRIC_REGISTRY:
        raise MXNetError("unknown metric '%s'" % metric)
    return _METRIC_REGISTRY[key](*args, **kwargs)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise ValueError when ``labels`` and ``preds`` differ in count
    (or, with ``shape``, in shape); with ``wrap`` a lone array becomes a
    one-element list."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = tuple(labels.shape), tuple(preds.shape)
    if label_shape != pred_shape:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (label_shape, pred_shape))
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


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


def _asnp(x):
    """``x`` (an NDArray, tensor, numpy or list) as numpy, counted in
    ``HOST_SYNCS`` when it was a tensor."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        HOST_SYNCS.increment()
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return _np.asarray(x)


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


@register("topkaccuracy", "top_k_accuracy")
class TopKAccuracy(EvalMetric):
    """The share of rows whose label is among the ``top_k`` largest
    predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__("%s_%d" % (name, top_k), output_names, label_names,
                         top_k=top_k)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        fn = self.device_fn()
        s, n = fn([_pair(lab, pred)[0] for lab, pred in zip(labels, preds)],
                  [_pair(lab, pred)[1] for lab, pred in zip(labels, preds)])
        self.sum_metric += int(_read(s))
        self.num_inst += int(n)

    def device_fn(self):
        top_k = self.top_k

        def fn(labels, preds):
            s, n = 0.0, 0
            for label, pred in zip(labels, preds):
                label = label.reshape(-1).long()
                pred = pred.reshape(label.numel(), -1)
                topk = pred.topk(min(top_k, pred.shape[-1]), dim=-1).indices
                s = s + (topk == label[:, None]).sum().float()
                n += label.numel()
            return s, float(n)
        return fn

    def device_sig(self):
        return ("top_k_accuracy", self.top_k)


def _binary_counts(label, pred, check_binary=False, metric_name=""):
    """(tp, fp, fn, tn) of one batch (a pred of several columns is
    argmax'ed)."""
    label = _asnp(label).flatten().astype("int32")
    pred = _asnp(pred)
    if pred.ndim > 1 and pred.shape[-1] > 1:
        pred = pred.argmax(axis=-1)
    pred = pred.flatten().astype("int32")
    if check_binary and _np.unique(label).size > 2:
        raise ValueError("%s currently only supports binary "
                         "classification." % metric_name)
    return (((pred == 1) & (label == 1)).sum(),
            ((pred == 1) & (label == 0)).sum(),
            ((pred == 0) & (label == 1)).sum(),
            ((pred == 0) & (label == 0)).sum())


@register()
class F1(EvalMetric):
    """Binary F1 over the counts accumulated since the last reset."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            tp, fp, fn, _ = _binary_counts(label, pred)
            self._tp += tp
            self._fp += fp
            self._fn += fn
            precision = self._tp / max(self._tp + self._fp, 1e-12)
            recall = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * precision * recall / max(precision + recall, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register()
class MCC(EvalMetric):
    """Matthews correlation coefficient of binary labels: ``macro`` the
    mean of per-batch values, ``micro`` one value over every batch."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self._tp = self._fp = self._tn = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._tn = self._fn = 0.0

    def _mcc(self):
        terms = ((self._tp + self._fp) * (self._tp + self._fn)
                 * (self._tn + self._fp) * (self._tn + self._fn))
        denom = terms ** 0.5 if terms > 0 else 1.0
        return (self._tp * self._tn - self._fp * self._fn) / denom

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            tp, fp, fn, tn = _binary_counts(label, pred, check_binary=True,
                                            metric_name="MCC")
            self._tp += tp
            self._fp += fp
            self._fn += fn
            self._tn += tn
            if self.average == "macro":
                self.sum_metric += self._mcc()
                self.num_inst += 1
                self._tp = self._fp = self._tn = self._fn = 0.0
            else:
                self.sum_metric = self._mcc()
                self.num_inst = 1


def _as_columns(label, pred):
    """1-D labels and predictions as (n, 1) columns."""
    if label.dim() == 1:
        label = label.reshape(label.shape[0], 1)
    if pred.dim() == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label.float(), pred.float()


class _MeanError(EvalMetric):
    """The mean over batches of a batch's mean elementwise error
    (``_error(label - pred)``)."""

    @staticmethod
    def _error(diff):
        raise NotImplementedError

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        s, n = self.device_fn()(*zip(*[_pair(lab, pred)
                                       for lab, pred in zip(labels, preds)]))
        self.sum_metric += _read(s)
        self.num_inst += int(n)

    def device_fn(self):
        error = self._error

        def fn(labels, preds):
            s, n = 0.0, 0
            for label, pred in zip(labels, preds):
                label, pred = _as_columns(label, pred)
                s = s + error(label - pred).mean()
                n += 1
            return s, float(n)
        return fn

    def device_sig(self):
        return (type(self).__name__,)


@register()
class MAE(_MeanError):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _error(diff):
        return diff.abs()


@register()
class MSE(_MeanError):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _error(diff):
        return diff ** 2.0


@register()
class RMSE(MSE):
    """The square root of :class:`MSE`'s value."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)

    def get(self):
        total, num = self._totals()
        if num == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(total / num))


@register("nll_loss", "negativeloglikelihood")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        CrossEntropy.__init__(self, eps, name, output_names, label_names)


@register("pearsonr", "pearsoncorrelation")
class PearsonCorrelation(EvalMetric):
    """The mean over batches of the Pearson correlation of predictions
    and labels."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _asnp(label).ravel(), _asnp(pred).ravel()
            self.sum_metric += _np.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register()
class Loss(EvalMetric):
    """The mean of the outputs' elements (a loss head's values)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        s, n = self.device_fn()(None, [_pair(p, p)[1] for p in preds])
        self.sum_metric += _read(s)
        self.num_inst += int(n)

    def device_fn(self):
        def fn(_labels, preds):
            s, n = 0.0, 0
            for pred in preds:
                s = s + pred.float().sum()
                n += pred.numel()
            return s, float(n)
        return fn

    def device_sig(self):
        return ("loss",)


@register()
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        Loss.__init__(self, name, output_names, label_names)


@register()
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        Loss.__init__(self, name, output_names, label_names)


@register()
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a
    value or a ``(sum, count)`` pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__ if hasattr(feval, "__name__") \
                else "custom"
        super().__init__("custom(%s)" % name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            reval = self._feval(_asnp(label), _asnp(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` over a numpy ``feval`` (reference
    metric.np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name or getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)
