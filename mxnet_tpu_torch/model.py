"""Model helpers for the fit loop: the kvstore-driven updates.

Counterpart of ``mxnet_tpu/model.py:21-131`` (reference
python/mxnet/model.py: ``_create_kvstore`` :54, ``_initialize_kvstore``
:116, ``_update_params_on_kvstore`` :145, ``_update_params`` :163) with
the JAX package's rules.  A store object is used as given; with one
device the strings ``'local'`` and ``'device'`` give no store at all, so
nothing is compressed: pass ``mx.kv.create('device')`` to train through
the store.  The distributed, ``'tpu'`` and ``'nccl'`` stores come with
the multi-GPU slice.  ``save_checkpoint``, ``load_checkpoint`` and
``load_params`` (reference model.py:384-430) write and read the
reference's ``prefix-symbol.json`` and ``prefix-%04d.params`` files,
the JAX package's files.
"""
from __future__ import annotations

from collections import namedtuple

from . import kvstore as kvs
from .base import MXNetError

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device):
    """(reference model.py:54) Returns ``(kv, update_on_kvstore)``.
    The reference's rule that a ``'local'`` store made from the string
    over several devices updates on the workers when a parameter passes
    16 M elements comes with the multi-GPU slice, with those stores."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if "dist" in kvstore or kvstore.startswith("tpu") \
                or kvstore == "nccl":
            raise MXNetError("kvstore %r comes with the multi-GPU slice of "
                             "the PyTorch port (ROADMAP A.8)" % kvstore)
        if num_device != 1:
            raise MXNetError("kvstore %r over %d devices comes with the "
                             "multi-GPU slice of the PyTorch port"
                             % (kvstore, num_device))
        kv = None
    else:
        raise TypeError("kvstore must be KVStore, str, or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """(reference model.py:116) Init every key from ``arg_params``; with
    updates on the store, pull the stored weights into the executor."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _batched_push(kvstore, param_names, grad_arrays, push_order):
    """ONE push of every key with a gradient, in ``push_order``
    (backward order: the bucket engine's streaming flush dispatches the
    first full buckets while the push is still walking the rest), with
    priority ``-index``.  Returns (names, grads) pushed, in push
    order."""
    order = list(push_order) if push_order is not None \
        else list(range(len(grad_arrays)))
    names, grads, prios = [], [], []
    for index in order:
        if grad_arrays[index][0] is None:
            continue
        names.append(param_names[index])
        grads.append(grad_arrays[index])
        prios.append(-index)
    if names:
        kvstore.push(names, grads, priority=prios)
    return names, grads


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore, param_names,
                              push_order=None):
    """(reference model.py:145) Push the gradients, then pull the
    updated weights back, in forward order."""
    names, _ = _batched_push(kvstore, param_names, grad_arrays, push_order)
    if not names:
        return
    pull_names, pull_args = [], []
    for index in range(len(param_arrays)):
        if grad_arrays[index][0] is None:
            continue
        pull_names.append(param_names[index])
        pull_args.append(param_arrays[index])
    kvstore.pull(pull_names, out=pull_args)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None, push_order=None):
    """(reference model.py:163) Update on the worker through the local
    updater; with a store, the gradients are first reduced through it
    (pushed, then pulled back into the gradient arrays).  The key of
    parameter ``i`` on device ``k`` is ``i * num_device + k``."""
    if kvstore:
        names, grads = _batched_push(kvstore, param_names, grad_arrays,
                                     push_order)
        if names:
            kvstore.pull(names, out=grads)
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(i * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """(reference model.py:384) ``prefix-symbol.json`` (when ``symbol``
    is given) and ``prefix-%04d.params`` with ``arg:``/``aux:`` keys."""
    from . import ndarray as nd
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_checkpoint(prefix, epoch):
    """(reference model.py:414) ``(symbol, arg_params, aux_params)``,
    the parameters as NDArrays on the CPU."""
    from . import symbol as sym
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


def load_params(prefix, epoch):
    """``(arg_params, aux_params)`` of ``prefix-%04d.params``."""
    from . import ndarray as nd
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params
