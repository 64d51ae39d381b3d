"""BaseModule: the train and score loops.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``: ``fit`` :399, ``score`` :168),
with the same signatures and log lines.  A fit step is ``fit_step``:
here the eager pair, ``forward_backward`` then ``update``; ``Module``
runs eligible configurations as its single-launch fused step, whose
metric accumulates on the device, so the loop's ``update_metric`` is a
no-op for those batches (``metric.consume_device_batch``).
``MXNET_FIT_SYNC_EVERY=n`` waits for the device every ``n`` batches
(0, the default, never: the host runs ahead of the card as far as the
steps' input staging lets it).  ``checkpoint_every=n`` (or
``MXNET_CHECKPOINT_EVERY``) with ``checkpoint_prefix`` (or
``MXNET_CHECKPOINT_PREFIX``) saves the full training state every ``n``
steps through ``mx.checkpoint`` (the training thread waits only for the
device-to-host copy; other steps pay one counter), and a SIGTERM makes
an emergency save and ends ``fit``; a prefix alone warns and arms
nothing, as in the JAX package.  ``save_params``/``load_params`` write
and read the reference's ``arg:``/``aux:`` parameter file.  ``fit``
arguments that belong to later slices (``monitor``, sparse row pulls)
raise instead of being ignored.
"""
from __future__ import annotations

import logging
import os
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
        the optimizer update.  Returns False: the metric is not updated
        (a subclass that folds it into the step returns True)."""
        self.forward_backward(data_batch)
        self.update()
        return False

    def _fit_sync(self):
        """Wait for the device's in-flight work (``MXNET_FIT_SYNC_EVERY``);
        nothing to wait for here."""

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
        later = ["%s=... (ROADMAP %s)" % (name, item)
                 for name, value, item in (
                     ("monitor", monitor, "A.9"),
                     ("sparse_row_id_fn", sparse_row_id_fn, "A.6"))
                 if value is not None]
        if later:
            raise MXNetError("fit(%s) comes with a later slice of the "
                             "PyTorch port" % ", ".join(later))
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
        sync_every = int(os.environ.get("MXNET_FIT_SYNC_EVERY", "0") or 0)
        ckpt = self._make_checkpointer(checkpoint_every, checkpoint_prefix)
        try:
            for epoch in range(begin_epoch, num_epoch):
                if self._train_epoch(epoch, train_data, train_metric,
                                     on_batch, sync_every, ckpt):
                    self.logger.warning(
                        "Epoch[%d] preempted: emergency checkpoint "
                        "committed, stopping fit", epoch)
                    return
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
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                train_data.reset()
        finally:
            if ckpt is not None:
                ckpt.close()        # drain pending writes, restore signals

    def _train_epoch(self, epoch, train_data, train_metric, on_batch,
                     sync_every, ckpt):
        """One epoch of steps; the checkpoint manager ``ckpt`` ticks
        after each.  Returns True when a preemption stopped it (the
        emergency checkpoint is committed)."""
        t0 = time.time()
        train_metric.reset()
        for nbatch, batch in enumerate(train_data):
            # a fused step already folded the batch into the metric's
            # device accumulator: update_metric then consumes it
            self.fit_step(batch, train_metric)
            self.update_metric(train_metric, batch.label)
            for cb in on_batch:
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=train_metric, locals=None))
            if sync_every and (nbatch + 1) % sync_every == 0:
                self._fit_sync()
            # last: the step is fully enqueued, so a snapshot sees it
            if ckpt is not None and ckpt.tick(epoch=epoch):
                return True
        for name, val in train_metric.get_name_value():
            self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
        self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - t0)
        return False

    def _make_checkpointer(self, checkpoint_every, checkpoint_prefix):
        """A CheckpointManager when step checkpoints are asked for (by
        argument or environment), else None (reference-side
        base_module.py:239)."""
        every = checkpoint_every if checkpoint_every is not None \
            else int(os.environ.get("MXNET_CHECKPOINT_EVERY", "0") or 0)
        if not every:
            if checkpoint_prefix \
                    or os.environ.get("MXNET_CHECKPOINT_PREFIX"):
                self.logger.warning(
                    "checkpoint prefix given but checkpoint_every/"
                    "MXNET_CHECKPOINT_EVERY is unset: checkpointing is "
                    "NOT armed")
            return None
        prefix = checkpoint_prefix \
            or os.environ.get("MXNET_CHECKPOINT_PREFIX") or "checkpoint"
        from ..checkpoint import CheckpointManager
        return CheckpointManager(prefix, module=self, every=every,
                                 logger=self.logger)

    def save_params(self, fname):
        """Save the parameters in the reference's ``arg:``/``aux:``
        layout."""
        from .. import ndarray as nd
        arg_params, aux_params = self.get_params()
        blob = {"arg:%s" % k: v for k, v in arg_params.items()}
        blob.update({"aux:%s" % k: v for k, v in aux_params.items()})
        nd.save(fname, blob)

    def load_params(self, fname):
        """Load parameters saved by :meth:`save_params` (either
        package's file)."""
        from .. import ndarray as nd
        arg_params, aux_params = {}, {}
        for key, value in nd.load(fname).items():
            kind, _, name = key.partition(":")
            if kind == "arg":
                arg_params[name] = value
            elif kind == "aux":
                aux_params[name] = value
            else:
                raise MXNetError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

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
