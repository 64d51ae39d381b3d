"""The executor group of a Module, on one device.

Counterpart of ``mxnet_tpu/module/executor_group.py``
``DataParallelExecutorGroup``, on exactly one context: one executor,
with gradients for every parameter that is not fixed (data and label
inputs get none unless ``inputs_need_grad``, which gives the data
inputs theirs), and the auxiliary states beside them.  A group made by
:meth:`reshape` binds new input shapes with ``shared_exec``: it holds
the first group's parameters, gradients and auxiliary states (the same
NDArrays) and allocates only its inputs.  Several contexts (data
parallelism over GPUs) come with the multi-GPU slice.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import cpu
from ..io.io import DataDesc
from ..metric import consume_device_batch
from ..ndarray.ndarray import array

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, fixed_param_names=None,
                 grad_req="write", inputs_need_grad=False,
                 shared_group=None):
        if len(contexts) != 1:
            raise MXNetError("a Module over %d contexts comes with the "
                             "multi-GPU slice of the PyTorch port"
                             % len(contexts))
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.aux_names = symbol.list_auxiliary_states()
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = list(fixed_param_names or [])
        self._grad_req_arg = grad_req
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [d.name for d in (label_shapes or [])]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        fixed = set(fixed_param_names or [])
        req = {}
        for name in symbol.list_arguments():
            if name in self.data_names or name in self.label_names \
                    or name in fixed \
                    or not for_training:
                req[name] = "null"
            else:
                req[name] = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(name, "write")
        if inputs_need_grad:
            for name in self.data_names:
                req[name] = "write"
        shapes = {d.name: d.shape
                  for d in list(data_shapes) + list(label_shapes or [])}
        self._exec = symbol.simple_bind(
            contexts[0], req,
            shared_exec=shared_group._exec if shared_group else None,
            **shapes)
        exe = self._exec
        # Module-facing views: one entry per device (one device here)
        self.param_arrays = [[exe.arg_dict[n]] for n in param_names]
        self.grad_arrays = [[exe.grad_dict.get(n)] for n in param_names]
        self.aux_arrays = [[exe.aux_dict[n]] for n in self.aux_names]

    @property
    def push_order(self):
        """``param_arrays`` indices in backward gradient-availability
        order: the arguments list in forward order, so backward produces
        the last parameters' gradients first (the bucketed kvstore's
        streaming flush dispatches buckets in this order)."""
        return list(range(len(self.param_arrays)))[::-1]

    def forward(self, data_batch, is_train=None):
        feeds = dict(zip(self.data_names, data_batch.data))
        if self.label_names and data_batch.label:
            feeds.update(zip(self.label_names, data_batch.label))
        self._exec.forward(
            is_train=self.for_training if is_train is None else is_train,
            **feeds)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to call "
                             "backward")
        self._exec.backward(out_grads)

    def get_outputs(self):
        return list(self._exec.outputs)

    def get_input_grads(self):
        """The data inputs' gradients of the last backward (bound with
        ``inputs_need_grad``)."""
        return [self._exec.grad_dict.get(n) for n in self.data_names]

    def reshape(self, data_shapes, label_shapes):
        """A group over new input shapes sharing this one's parameters,
        gradients and auxiliary states (reference executor_group.py
        reshape)."""
        return DataParallelExecutorGroup(
            self.symbol, self.contexts, data_shapes, label_shapes,
            self.param_names, self.for_training,
            fixed_param_names=self.fixed_param_names,
            grad_req=self._grad_req_arg,
            inputs_need_grad=self.inputs_need_grad, shared_group=self)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self._exec.copy_params_from(arg_params, aux_params, allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters and auxiliary states into host (CPU)
        NDArrays."""
        for name in self.param_names:
            arg_params[name] = array(self._exec.arg_dict[name], ctx=cpu())
        for name in self.aux_names:
            aux_params[name] = array(self._exec.aux_dict[name], ctx=cpu())

    def update_metric(self, eval_metric, labels):
        if consume_device_batch(eval_metric):
            # the fused step folded this batch into the metric's device
            # accumulator
            return
        eval_metric.update_dict(
            dict(zip(self.label_names, labels or [])),
            dict(zip(self.symbol.list_outputs(), self._exec.outputs)))


def as_descs(shapes):
    """A list of ``(name, shape)`` pairs or DataDescs as DataDescs; None
    or empty as None."""
    return DataDesc.get_list(shapes) if shapes else None
