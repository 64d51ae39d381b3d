"""BaseModule: the train and score loops.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``: ``fit`` :399, ``score`` :168),
with the same signatures and log lines.  The port runs eagerly: a fit
step is ``forward_backward`` then ``update`` (the JAX package's eager
pair; its single-launch fused step has no counterpart yet), and the
metric reads each batch back at the step's end.  ``fit`` arguments that
belong to later slices (``monitor``, step checkpointing, sparse row
pulls) raise instead of being ignored.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..initializer import Uniform
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _callbacks(spec):
    """A callback spec (None, a callable or a list) as a tuple."""
    if spec is None:
        return ()
    if callable(spec):
        return (spec,)
    return tuple(spec)


class BaseModule:
    """The train/eval surface; Module implements the bind, forward,
    backward and update primitives and inherits the loops."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def fit_step(self, data_batch, eval_metric=None):
        """One training step, the eager pair: forward and backward, then
        the optimizer update."""
        self.forward_backward(data_batch)
        self.update()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, checkpoint_every=None,
            checkpoint_prefix=None):
        """Train for ``num_epoch`` epochs (reference base_module.py:399)."""
        later = [name for name, value in (
            ("monitor", monitor), ("sparse_row_id_fn", sparse_row_id_fn),
            ("checkpoint_every", checkpoint_every),
            ("checkpoint_prefix", checkpoint_prefix)) if value is not None]
        if later:
            raise MXNetError("fit(%s=...) comes with a later slice of the "
                             "PyTorch port (ROADMAP)" % ", ".join(later))
        if num_epoch is None:
            raise MXNetError("please specify number of epochs")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        train_metric = metric_mod.create(eval_metric)
        val_metric = validation_metric or train_metric
        on_batch = _callbacks(batch_end_callback)
        on_epoch = _callbacks(epoch_end_callback)
        for epoch in range(begin_epoch, num_epoch):
            t0 = time.time()
            train_metric.reset()
            for nbatch, batch in enumerate(train_data):
                self.fit_step(batch, train_metric)
                self.update_metric(train_metric, batch.label)
                for cb in on_batch:
                    cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                     eval_metric=train_metric,
                                     locals=None))
            for name, val in train_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - t0)
            if on_epoch:
                arg_now, aux_now = self.get_params()
                for cb in on_epoch:
                    cb(epoch, self.symbol, arg_now, aux_now)
            if eval_data is not None:
                for name, val in self.score(
                        eval_data, val_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Run ``eval_data`` through the inference forward and return
        ``eval_metric``'s name-value pairs."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("score() requires bind() and init_params()")
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            for cb in _callbacks(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=eval_metric, locals=None))
            seen += 1
        for cb in _callbacks(score_end_callback):
            cb(BatchEndParam(epoch=epoch, nbatch=seen,
                             eval_metric=eval_metric, locals=None))
        return eval_metric.get_name_value()
