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
nothing is compressed (the JAX package's rule).

``fit_step`` runs eligible configurations as the single-launch fused
step (``module/fused_fit.py``: one CUDA graph replay per step on the
card) and returns True; ``MXNET_FIT_FUSED=0`` keeps the eager pair
(forward and backward, then ``update``).

A batch whose shapes differ from the bound ones re-binds (``forward``
and ``fit_step`` call :meth:`reshape`, reference module.py:291, :423):
the executor group of those shapes, made once and kept, shares the
first group's parameters, gradients and auxiliary states, so the
optimizer state, the fused step (one graph a batch shape, none captured
again when a shape returns) and its loss scaler and metric accumulator
carry over.  ``bind(inputs_need_grad=True)`` gives the data inputs
gradients (``get_input_grads``; such a module trains on the eager
pair).  ``bind(shared_module=m)`` binds over ``m``'s arrays: each
argument and auxiliary state whose name and shape match ``m``'s takes
``m``'s NDArray (its gradient too), any other its own zeros, as the
JAX executor does (``mxnet_tpu/executor.py:887-891``); the module then
counts as initialized, borrows ``m``'s optimizer when ``m`` has one
(``borrow_optimizer``) and runs its fused steps in ``m``'s
``FusedFitStep`` (one graph pool, one scalar buffer, one step seed, one
set of residuals; the graph of each module its own), which is how
``BucketingModule``'s buckets train.  ``Module.load``,
``save_checkpoint`` and ``save/load_optimizer_states`` write and read
the reference's files as the JAX package does: the optimizer states
are a pickle keyed by parameter name whatever key the live updater
uses (``pickle_compat.py``), so either package's file loads into
either path.  Several contexts come with a later slice.
"""
from __future__ import annotations

import logging
import os

import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
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
            raise MXNetError("a Module over %d contexts (and its fused fit "
                             "step over a mesh) comes with the multi-GPU "
                             "slice of the PyTorch port (ROADMAP A.8)"
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
        # executor groups by input shapes (Module.reshape), all sharing
        # the first one's parameters
        self._exec_groups = {}
        self.inputs_need_grad = False
        self._data_shapes = None
        self._label_shapes = None
        # MXNET_FIT_FUSED=0 keeps every step on the eager pair
        self._fused_fit_enabled = os.environ.get("MXNET_FIT_FUSED",
                                                 "1") != "0"
        self._fused_fit = None
        self._fused_fit_tried = False
        self._monitor_installed = False
        # the fused step's DynamicLossScaler for bf16 parameters
        # (module/fused_fit.py), kept across re-binds
        self._loss_scaler = None
        # Module.load / checkpoint.restore on a module not yet bound:
        # the parameters set at bind, the states file read at
        # init_optimizer
        self._preloaded_params = None
        self._preload_opt_states = None
        # bound with shared_module: the module whose arrays and fused
        # step this one uses
        self._fit_owner = None

    # -- checkpoint files -----------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix-symbol.json`` with the parameters of
        ``prefix-%04d.params`` (set when it binds) and, with
        ``load_optimizer_states``, the states of ``prefix-%04d.states``
        (loaded at ``init_optimizer``)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._preloaded_params = (args, auxs)
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write ``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        self._symbol.save("%s-symbol.json" % prefix)
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, None, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

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

    @property
    def output_shapes(self):
        """``[(output name, shape)]`` of the bound shapes."""
        shapes = {d.name: d.shape for d in list(self._data_shapes)
                  + list(self._label_shapes or [])}
        return list(zip(self._output_names,
                        self._symbol.infer_shape(**shapes)[1]))

    # -- parameters -----------------------------------------------------
    def get_params(self):
        """``(arg_params, aux_params)`` as host (CPU) NDArrays, copied
        from the device."""
        if not self.params_initialized:
            raise MXNetError("get_params() before init_params()")
        if self._preloaded_params is not None:
            return self._preloaded_params
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
        if shared_module is not None and not (
                isinstance(shared_module, Module) and shared_module.binded
                and shared_module.params_initialized):
            raise MXNetError("bind(shared_module=...) takes a bound Module "
                             "whose parameters are initialized")
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad requires for_training")
        if force_rebind:
            self._drop_fused_fit()
            self.binded = False
            self.params_initialized = False
            self._exec_group = None
            self._exec_groups = {}
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = bool(inputs_need_grad)
        self._data_shapes = as_descs(data_shapes)
        self._label_shapes = as_descs(label_shapes)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, inputs_need_grad=self.inputs_need_grad,
            shared_group=shared_module._exec_group
            if shared_module is not None else None)
        self._exec_groups = {self._shape_key(self._data_shapes,
                                             self._label_shapes):
                             self._exec_group}
        self.binded = True
        if shared_module is not None:
            self.params_initialized = True
            self._fit_owner = shared_module._fit_family()
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
            return
        if self._preloaded_params is not None:
            args, auxs = self._preloaded_params
            self._preloaded_params = None
            self.init_params(initializer=None, arg_params=args,
                             aux_params=auxs, force_init=True,
                             allow_extra=True)

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
        self._drop_fused_fit()
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
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer, kvstore and updater (the
        bucketing path, reference module.py borrow_optimizer)."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("borrow_optimizer() needs a module whose "
                             "optimizer is initialized")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    def _fit_family(self):
        """The module whose ``FusedFitStep`` this one's steps run in:
        the module it was bound over (``shared_module``), else itself."""
        return self._fit_owner if self._fit_owner is not None else self

    @staticmethod
    def _shape_key(data_shapes, label_shapes):
        return tuple((d.name, tuple(d.shape))
                     for d in list(data_shapes) + list(label_shapes or []))

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind to new input shapes, keeping the parameters, their
        gradients, the auxiliary states, the optimizer and the fused
        step: the group of these shapes (made at its first use, then
        kept) shares the first group's arrays (reference module.py:291)."""
        if not self.binded:
            raise MXNetError("reshape() requires bind()")
        self._data_shapes = as_descs(data_shapes)
        self._label_shapes = as_descs(label_shapes)
        key = self._shape_key(self._data_shapes, self._label_shapes)
        group = self._exec_groups.get(key)
        if group is None:
            group = self._exec_groups[key] = self._exec_group.reshape(
                self._data_shapes, self._label_shapes)
        self._exec_group = group

    def _reshape_for(self, data_batch):
        """Re-bind when ``data_batch``'s shapes differ from the bound
        ones (reference module.py:423-431): the batch's
        ``provide_data``/``provide_label`` when it has them, else the
        bound names with the arriving shapes."""
        arriving = tuple(tuple(a.shape) for a in data_batch.data)
        if arriving == tuple(d.shape for d in self._data_shapes):
            return
        d_descs = getattr(data_batch, "provide_data", None) or \
            [(d.name, shape) for d, shape in zip(self._data_shapes,
                                                 arriving)]
        labels = getattr(data_batch, "label", None)
        l_descs = getattr(data_batch, "provide_label", None)
        if not l_descs and labels:
            l_descs = [(name, tuple(a.shape))
                       for name, a in zip(self._label_names, labels)]
        self.reshape(d_descs, l_descs or None)

    # -- execution ------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward() requires bind() and init_params()")
        self._reshape_for(data_batch)
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
        fused = self._fit_family()._fused_fit
        if fused is not None:
            # an eager update between fused steps sees the exact
            # accumulated error-feedback residuals
            fused._release()
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

    def fit_step(self, data_batch, eval_metric=None):
        """One training step: eligible configurations run forward,
        backward, 2-bit compression, the update and the metric's device
        accumulation as the single-launch fused step and return True;
        everything else takes the eager pair and returns False."""
        self._reshape_for(data_batch)
        fused = self._get_fused_fit()
        if fused is not None and fused.step(data_batch, eval_metric, self):
            return True
        return super().fit_step(data_batch, eval_metric)

    def _get_fused_fit(self):
        if self._fit_owner is not None:
            return self._fit_owner._get_fused_fit() \
                if self.optimizer_initialized else None
        if not self._fused_fit_tried:
            self._fused_fit_tried = True
            if self.binded and self.params_initialized \
                    and self.optimizer_initialized:
                from .fused_fit import FusedFitStep
                self._fused_fit = FusedFitStep.build(self)
        return self._fused_fit

    def _drop_fused_fit(self):
        """Forget the fused step (its eligibility is checked again at
        the next ``fit_step``), its residuals spilled to the store."""
        if self._fused_fit is not None:
            self._fused_fit._release()
        self._fused_fit = None
        self._fused_fit_tried = False

    def _fit_sync(self):
        """Wait until the steps enqueued so far have run
        (``MXNET_FIT_SYNC_EVERY``), then publish the loss scaler's
        ``loss_scale`` and overflow skips (already a sync point)."""
        if self.binded:
            exe = self._exec_group._exec
            dev = exe.arg_dict[self._param_names[0]]._data.device \
                if self._param_names else None
            if dev is not None and dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        scaler = self._fit_family()._loss_scaler
        if scaler is not None:
            scaler.publish()

    def _live_updater(self):
        """The updater applying the updates: the store's with
        ``update_on_kvstore``, else the module's own."""
        return self._kvstore._updater if self._update_on_kvstore \
            else self._updater

    def _opt_state_key_maps(self):
        """``(name -> live updater key, either scheme's key -> live
        key)``: the store's updater keys states by parameter name, the
        module's own by index (``fused_fit`` uses the same keys), and a
        states file keyed either way loads into the live scheme."""
        from ..kvstore import _updater_key
        names = self._exec_group.param_names
        if self._update_on_kvstore:
            name_to_live = {n: _updater_key(n) for n in names}
        else:
            name_to_live = {n: i for i, n in enumerate(names)}
        alias = {}
        for i, n in enumerate(names):
            alias[_updater_key(n)] = name_to_live[n]
            alias[i] = name_to_live[n]
        return name_to_live, alias

    def save_optimizer_states(self, fname):
        """Write the updater's states to ``fname`` as the name-keyed
        pickle both packages read."""
        from .. import pickle_compat
        if not self.optimizer_initialized:
            raise MXNetError("save_optimizer_states() requires "
                             "init_optimizer()")
        if self._kvstore is not None:
            self._kvstore._flush_pending()   # pending buckets touch state
        updater = self._live_updater()
        name_to_live, _ = self._opt_state_key_maps()
        live_to_name = {lk: n for n, lk in name_to_live.items()}
        states = {live_to_name.get(k, k): v
                  for k, v in updater.states.items()}
        with open(fname, "wb") as f:
            pickle_compat.dump(states, f)

    def load_optimizer_states(self, fname):
        """Load a states file of either package (keyed by name or by
        either updater's keys; with the optimizer in the
        ``dump_optimizer`` form, which then becomes the module's) into
        the updater, in place where a state exists."""
        from .. import pickle_compat
        if not self.optimizer_initialized:
            raise MXNetError("load_optimizer_states() requires "
                             "init_optimizer()")
        if self._kvstore is not None:
            self._kvstore._flush_pending()
        updater = self._live_updater()
        with open(fname, "rb") as f:
            data = pickle_compat.load(f)
        _, alias = self._opt_state_key_maps()
        if isinstance(data, tuple) and len(data) == 2:
            states, optimizer = data
            updater.set_states(({alias.get(k, k): v
                                 for k, v in states.items()}, optimizer))
            self._optimizer = updater.optimizer
        else:
            updater.set_states({alias.get(k, k): v for k, v in data.items()})

    def get_outputs(self, merge_multi_context=True):
        outs = self._exec_group.get_outputs()
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        """The data inputs' gradients of the last backward (a module
        bound with ``inputs_need_grad=True``)."""
        if not (self.binded and self.params_initialized
                and self.inputs_need_grad):
            raise MXNetError("get_input_grads() requires bind("
                             "inputs_need_grad=True) and init_params()")
        grads = self._exec_group.get_input_grads()
        return grads if merge_multi_context else [[g] for g in grads]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels)
