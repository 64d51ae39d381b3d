"""Shared training harness of the image-classification examples, on the
PyTorch port (``mxnet_tpu_torch``).

The port's copy of ``example/image-classification/common/fit.py``
(reference example/image-classification/common/fit.py): the argument
groups every ``train_*.py`` script shares, the synthetic ``--benchmark``
iterator and the ``Module.fit`` glue.  It trains on the card
(``mx.gpu(0)``, or ``--gpus`` ids; several ids wait for the port's
multi-GPU slice) unless ``--ctx cpu`` asks for the CPU.  The train
metric is accuracy beside the cross-entropy loss; the run fails when
the last metrics shown (the epoch's, or the Speedometer's last before it
reset them) or a weight are not finite.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                ".."))

import numpy as np

import mxnet_tpu_torch as mx


def add_fit_args(parser):
    """(reference fit.py add_fit_args)"""
    train = parser.add_argument_group("Training")
    train.add_argument("--network", type=str, default="resnet")
    train.add_argument("--num-layers", type=int, default=50)
    train.add_argument("--ctx", type=str, default="gpu",
                       choices=["gpu", "cpu"],
                       help="gpu = the card(s) of --gpus, cpu = the CPU")
    train.add_argument("--gpus", type=str, default=None,
                       help="card ids, e.g. '0' (default 0)")
    train.add_argument("--kv-store", type=str, default="device")
    train.add_argument("--num-epochs", type=int, default=10)
    train.add_argument("--lr", type=float, default=0.1)
    train.add_argument("--lr-factor", type=float, default=0.1)
    train.add_argument("--lr-step-epochs", type=str, default="30,60")
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--mom", type=float, default=0.9)
    train.add_argument("--wd", type=float, default=1e-4)
    train.add_argument("--batch-size", type=int, default=128)
    train.add_argument("--disp-batches", type=int, default=20)
    train.add_argument("--model-prefix", type=str, default=None)
    train.add_argument("--load-epoch", type=int, default=None)
    train.add_argument("--top-k", type=int, default=0)
    train.add_argument("--dtype", type=str, default="float32",
                       choices=["float32", "bfloat16", "float16"])
    train.add_argument("--benchmark", type=int, default=0,
                       help="1 = train on synthetic data (no IO)")
    train.add_argument("--num-examples", type=int, default=50000)
    return train


def devices(args):
    """The training context: ``mx.cpu()`` under ``--ctx cpu``, else
    ``mx.gpu(i)`` for each ``--gpus`` id (one context for one id)."""
    if args.ctx == "cpu":
        return mx.cpu()
    ids = [int(i) for i in args.gpus.split(",")] if args.gpus else [0]
    devs = [mx.gpu(i) for i in ids]
    return devs[0] if len(devs) == 1 else devs


def _lr_scheduler(args, epoch_size):
    steps = [int(e) for e in args.lr_step_epochs.split(",") if e]
    begin = args.load_epoch or 0
    steps = [epoch_size * (s - begin) for s in steps
             if s - begin > 0]
    if not steps:
        return args.lr, None
    return args.lr, mx.lr_scheduler.MultiFactorScheduler(
        step=steps, factor=args.lr_factor)


class SyntheticDataIter(mx.io.DataIter):
    """The same random batch ``max_iter`` times an epoch (reference
    common/fit.py ``--benchmark``), made once from a numpy seed and kept
    on ``ctx`` (float32: a 16-bit symbol casts its data itself)."""

    def __init__(self, num_classes, data_shape, max_iter, dtype="float32",
                 ctx=None):
        self.batch_size = data_shape[0]
        self.cur_iter = 0
        self.max_iter = max_iter
        self.dtype = dtype
        rng = np.random.RandomState(0)
        label = rng.randint(0, num_classes, (self.batch_size,))
        data = rng.uniform(-1, 1, data_shape)
        ctx = ctx if ctx is not None else mx.cpu()
        self.data = mx.nd.array(data.astype(np.float32), ctx=ctx)
        self.label = mx.nd.array(label.astype(np.float32), ctx=ctx)
        self.provide_data = [mx.io.DataDesc("data", data_shape)]
        self.provide_label = [mx.io.DataDesc("softmax_label",
                                             (self.batch_size,))]

    def next(self):
        self.cur_iter += 1
        if self.cur_iter > self.max_iter:
            raise StopIteration
        return mx.io.DataBatch(data=[self.data], label=[self.label], pad=0)

    def __next__(self):
        return self.next()

    def reset(self):
        self.cur_iter = 0


def fit(args, network, data_loader, **kwargs):
    """Train ``network`` with the iterators from ``data_loader(args,
    kv)`` (reference common/fit.py fit).  Returns the module."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    logging.info("start with arguments %s", args)

    kv = mx.kvstore.create(args.kv_store)
    epoch_size = max(args.num_examples // args.batch_size // kv.num_workers,
                     1)
    train, val = data_loader(args, kv)

    devs = devices(args)
    lr, lr_sched = _lr_scheduler(args, epoch_size)
    optimizer_params = {"learning_rate": lr, "wd": args.wd}
    if lr_sched is not None:
        optimizer_params["lr_scheduler"] = lr_sched
    if args.optimizer in ("sgd", "nag", "signum"):
        optimizer_params["momentum"] = args.mom
    if args.dtype != "float32":
        optimizer_params["multi_precision"] = True

    arg_params = aux_params = None
    if args.model_prefix and args.load_epoch is not None:
        network, arg_params, aux_params = mx.model.load_checkpoint(
            args.model_prefix, args.load_epoch)

    mod = mx.Module(network, context=devs)
    eval_metric = ["accuracy", "ce"]
    if args.top_k > 0:
        eval_metric.append(mx.metric.create("top_k_accuracy",
                                            top_k=args.top_k))
    eval_metric = mx.metric.create(eval_metric)
    checkpoint = (mx.callback.do_checkpoint(args.model_prefix)
                  if args.model_prefix else None)
    shown = {}

    def keep_metrics(param):
        # the values the Speedometer is about to show (and reset)
        if param.nbatch % args.disp_batches == 0:
            shown.update(param.eval_metric.get_name_value())

    mod.fit(train,
            begin_epoch=args.load_epoch or 0,
            num_epoch=args.num_epochs,
            eval_data=val,
            eval_metric=eval_metric,
            kvstore=kv,
            optimizer=args.optimizer,
            optimizer_params=optimizer_params,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            arg_params=arg_params,
            aux_params=aux_params,
            batch_end_callback=[keep_metrics,
                                mx.callback.Speedometer(args.batch_size,
                                                        args.disp_batches)],
            epoch_end_callback=checkpoint,
            allow_missing=True)
    final = {k: v for k, v in eval_metric.get_name_value()
             if not math.isnan(v)} or shown
    weights = mod.get_params()[0]
    finite = all(math.isfinite(v) for v in final.values()) and all(
        np.isfinite(w.asnumpy()).all() for w in weights.values())
    logging.info("final train metrics %s, finite %s", final, finite)
    if not finite:
        raise SystemExit("fit: a final metric or a weight is not finite")
    return mod
