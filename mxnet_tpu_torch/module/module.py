"""Module: symbol + executor group + optimizer on one device.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
python/mxnet/module/module.py: bind :364, init_params :270,
init_optimizer :465, forward :570, update :643).  The parameters and
auxiliary states live on the bound device; ``get_params`` copies them
to host NDArrays.  ``Module(sym)`` with no context runs on ``gpu(0)``
and raises without a card.

With a kvstore instance (``mx.kv.create('device')``), ``update`` pushes
every gradient in one batched call in backward order and pulls the
updated weights back (``update_on_kvstore``); ``compression_params``
(``{'type': '2bit', 'threshold': t}``) is handed to that store.  With
one device the strings ``'local'`` and ``'device'`` give no store, so
nothing is compressed (the JAX package's rule).  Several contexts,
checkpoint files and the fused fit step come with later slices.
"""
from __future__ import annotations

import logging

from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore)
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup, as_descs

__all__ = ["Module"]


class Module(BaseModule):
    """Bind a Symbol on one context and drive train and eval steps."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        contexts = [context] if isinstance(context, Context) \
            else list(context)
        if len(contexts) != 1:
            raise MXNetError("a Module over %d contexts comes with the "
                             "multi-GPU slice of the PyTorch port"
                             % len(contexts))
        contexts[0].torch_device            # raises when the card is missing
        self._context = contexts
        self._symbol = symbol
        args = symbol.list_arguments()
        self._data_names = list(data_names or [])
        self._label_names = [n for n in (label_names or []) if n in args]
        missing = [n for n in self._data_names if n not in args]
        if missing:
            raise MXNetError("Module: data name(s) %s are not arguments of "
                             "the symbol" % missing)
        self._fixed_param_names = list(fixed_param_names or [])
        inputs = set(self._data_names + self._label_names)
        self._param_names = [a for a in args if a not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._compression_params = compression_params
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    # -- parameters -----------------------------------------------------
    def get_params(self):
        """``(arg_params, aux_params)`` as host (CPU) NDArrays, copied
        from the device."""
        if not self.params_initialized:
            raise MXNetError("get_params() before init_params()")
        arg_params, aux_params = {}, {}
        self._exec_group.get_params(arg_params, aux_params)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill every parameter and auxiliary state on the device: from
        ``arg_params`` / ``aux_params`` where given, else (when
        ``allow_missing`` or none are given) by ``initializer`` with the
        variable's attributes (moving means zero, moving variances
        one)."""
        if self.params_initialized and not force_init:
            self.logger.warning("Parameters already initialized and "
                                "force_init=False; init_params ignored")
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        exe = self._exec_group._exec
        if not allow_extra:
            extra = sorted([n for n in (arg_params or {})
                            if n not in self._param_names]
                           + [n for n in (aux_params or {})
                              if n not in self._aux_names])
            if extra:
                raise MXNetError("set_params/init_params got extra "
                                 "parameter(s) %s (pass allow_extra=True to "
                                 "ignore)" % extra)
        attrs = self._symbol.attr_dict()
        for names, bound, given in (
                (self._param_names, exe.arg_dict, arg_params),
                (self._aux_names, exe.aux_dict, aux_params)):
            for name in sorted(names):
                target = bound[name]
                if given is not None and name in given:
                    value = given[name]
                    if tuple(value.shape) != target.shape:
                        raise MXNetError("shape mismatch for %s: %s vs %s"
                                         % (name, tuple(value.shape),
                                            target.shape))
                    target[:] = value
                elif given is not None and not allow_missing:
                    raise MXNetError("%s is not presented" % name)
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), target)
        self.params_initialized = True

    # -- binding --------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if shared_module is not None:
            raise MXNetError("bind(shared_module=...) comes with the "
                             "bucketing slice of the PyTorch port")
        if inputs_need_grad:
            raise MXNetError("bind(inputs_need_grad=True) comes with a "
                             "later slice of the PyTorch port")
        if force_rebind:
            self.binded = False
            self.params_initialized = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self._data_shapes = as_descs(data_shapes)
        self._label_shapes = as_descs(label_shapes)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            fixed_param_names=self._fixed_param_names,
            grad_req=grad_req)
        self.binded = True

    # -- optimizer ------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer (``rescale_grad = 1 / batch``) and, with a
        kvstore instance, hand it the compression config, initialize
        every key from the bound parameters and let it apply the
        optimizer (reference module.py:465)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer() requires bind() and "
                             "init_params()")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kv, update_on_kvstore = _create_kvstore(kvstore, len(self._context))
        rescale_grad = 1.0 / self._data_shapes[0].shape[0]
        if isinstance(optimizer, str):
            config = dict(optimizer_params)
            config.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)), **config)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but rescale_grad "
                "is not normalized to 1.0/batch_size (%s vs. %s). Is this "
                "intended?", optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        group = self._exec_group
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            exe = group._exec
            _initialize_kvstore(
                kv, group.param_arrays,
                {n: exe.arg_dict[n] for n in group.param_names},
                group.param_names, update_on_kvstore)
        if update_on_kvstore:
            kv.set_optimizer(optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # -- execution ------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward() requires bind() and init_params()")
        arriving = tuple(tuple(a.shape) for a in data_batch.data)
        bound = tuple(d.shape for d in self._data_shapes)
        if arriving != bound:
            raise MXNetError("batch shapes %s differ from the bound %s; "
                             "re-binding comes with a later slice"
                             % (arriving, bound))
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("backward() requires bind() and init_params()")
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply one optimizer step to every parameter with a gradient:
        through the kvstore (push, then pull) when it updates, else by
        the local updater, after a reduce through the store if there is
        one (reference module.py:643)."""
        if not self.optimizer_initialized:
            raise MXNetError("update() requires init_optimizer()")
        group = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(group.param_arrays, group.grad_arrays,
                                      self._kvstore, group.param_names,
                                      push_order=group.push_order)
        else:
            _update_params(group.param_arrays, group.grad_arrays,
                           updater=self._updater, num_device=1,
                           kvstore=self._kvstore,
                           param_names=group.param_names,
                           push_order=group.push_order)

    def get_outputs(self, merge_multi_context=True):
        outs = self._exec_group.get_outputs()
        return outs if merge_multi_context else [[o] for o in outs]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels)
