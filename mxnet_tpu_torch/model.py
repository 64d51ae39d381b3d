"""Model helpers for the fit loop.

Counterpart of ``mxnet_tpu/model.py``, reduced to what the training
slice uses: ``BatchEndParam``, ``_create_kvstore`` and
``_update_params`` with the local updater.  On one device the reference
uses no kvstore for ``'local'``/``'device'`` (model.py:33-39), and
neither does the port; the distributed, ``'tpu'`` and ``'nccl'`` stores
come with the kvstore and multi-GPU slices.  Checkpoint files come with
the checkpoint slice.
"""
from __future__ import annotations

from collections import namedtuple

from .base import MXNetError

__all__ = ["BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device):
    """(reference model.py:54) Returns ``(kv, update_on_kvstore)``:
    ``(None, False)`` for no store, or for ``'local'``/``'device'`` on
    one device; every store object or other type raises."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str):
        if "dist" in kvstore or kvstore.startswith("tpu") \
                or kvstore == "nccl":
            raise MXNetError("kvstore %r comes with the multi-GPU slice of "
                             "the PyTorch port" % kvstore)
        if num_device != 1:
            raise MXNetError("kvstore %r over %d devices comes with the "
                             "multi-GPU slice of the PyTorch port"
                             % (kvstore, num_device))
        return None, False
    raise MXNetError("kvstore objects come with the kvstore slice of the "
                     "PyTorch port; pass 'local' or None")


def _update_params(param_arrays, grad_arrays, updater, num_device=1):
    """(reference model.py:163) Update on the worker through the local
    updater; the key of parameter ``i`` on device ``k`` is ``i *
    num_device + k``."""
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(i * num_device + k, g, w)
