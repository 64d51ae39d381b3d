"""Gluon Trainer: applies an Optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference
python/mxnet/gluon/trainer.py): ``step = _allreduce_grads + _update``
over the port's kvstore (``kvstore.create('device')`` by default, whose
dense f32 pushes take the bucketed path, ``kvstore_fused.py``),
``update_on_kvstore``, ``compression_params`` (2-bit compression in the
store: one ``two_bit_quantize_fused`` launch per dispatched bucket),
``learning_rate``/``set_learning_rate`` and ``ignore_stale_grad``.  The
kvstore keys are the parameters' positions, in name order for a
ParameterDict.  With ``update_on_kvstore`` the store keeps its own copy
of each weight, applies the optimizer there and the pull copies it back
into the parameter; without it, the updater runs on the parameter in
place.  bf16 or f16 weights (``net.cast('bfloat16')`` or
``'float16'``) under ``multi_precision`` train through the ``Updater``'s f32 masters on
either side, as ``Module`` does.  ``save_states``/``load_states``
write and read the updater's states with the optimizer (the
``dump_optimizer`` form), the JAX package's file.
"""
from __future__ import annotations

from .. import kvstore as kvs
from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """One ``step()`` = reduce grads across replicas + apply the optimizer.
    Keys on the kvstore are the parameters' positional indices."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        self._params = self._normalize_params(params)
        self._param2idx = {p.name: i for i, p in enumerate(self._params)}
        self._compression_params = compression_params
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None

    @staticmethod
    def _normalize_params(params):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                f"First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(
                    f"First argument must be a list or dict of Parameters, "
                    f"got list of {type(p)}.")
        return list(params)

    def _trainable(self):
        """(index, param) pairs that receive gradients."""
        return ((i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null")

    def _require_worker_side_update(self, what):
        if self._kvstore and self._update_on_kvstore:
            raise MXNetError(
                f"{what} when parameters are updated on kvstore is not "
                f"supported. Try setting `update_on_kvstore` to False "
                f"when creating trainer.")

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params and set(optimizer_params) != {"rescale_grad"}:
                raise MXNetError(
                    "optimizer_params must be None if optimizer is an "
                    "instance of Optimizer instead of str")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _init_kvstore(self):
        config = self._kvstore_params
        kvstore = config["kvstore"]
        update_on_kvstore = config["update_on_kvstore"]
        if kvstore is None:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            kv = kvs.create(kvstore) if isinstance(kvstore, str) else kvstore
            if update_on_kvstore is None:
                update_on_kvstore = True
            if self._compression_params is not None:
                kv.set_gradient_compression(self._compression_params)
            self._kvstore = kv
            self._update_on_kvstore = update_on_kvstore
            for i, param in self._trainable():
                kv.init(i, param.data())
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        if not isinstance(self._optimizer, opt.Optimizer):
            raise MXNetError("Optimizer has to be defined before its "
                             "learning rate can be accessed.")
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        if not isinstance(self._optimizer, opt.Optimizer):
            raise MXNetError("Optimizer has to be defined before its "
                             "learning rate is mutated.")
        self._optimizer.set_learning_rate(lr)

    # ------------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Make one parameter update: allreduce grads then apply the
        optimizer (reference trainer.py:241)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce gradients over devices/workers WITHOUT updating — only
        valid with update_on_kvstore=False (reference trainer.py:276)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._require_worker_side_update("allreduce_grads()")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        # one batched push (then pull) over every trainable param, so the
        # bucketed kvstore packs the whole key set; priority -i keeps the
        # reference's dispatch order
        keys, grads, prios = [], [], []
        for i, param in self._trainable():
            keys.append(i)
            grads.append(param.list_grad())
            prios.append(-i)
        if not keys:
            return
        self._kvstore.push(keys, grads, priority=prios)
        if not self._update_on_kvstore:
            self._kvstore.pull(keys, out=grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply optimizer only — only valid with update_on_kvstore=False
        (reference trainer.py:300)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._require_worker_side_update("update()")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        store_side = self._kvstore and self._update_on_kvstore
        pull_keys, pull_outs = [], []
        for i, param in self._trainable():
            if param._data is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Gradient of Parameter `{param.name}` has not been "
                    f"initialized")
            if store_side:
                pull_keys.append(i)
                pull_outs.append(param.list_data())
                continue
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)
        if pull_keys:
            # one batched pull over every trainable param
            self._kvstore.pull(pull_keys, out=pull_outs)

    # ------------------------------------------------------------------
    def save_states(self, fname):
        """Write the updater's states and the optimizer to ``fname``
        (reference trainer.py:312)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load a :meth:`save_states` file (either package's); its
        optimizer becomes the Trainer's (reference trainer.py:330)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for upd in self._updaters:
                upd.set_states(states)
            self._optimizer = self._updaters[0].optimizer
            for upd in self._updaters:
                upd.optimizer = self._optimizer
        self._optimizer.param_dict = {
            i: param for i, param in enumerate(self._params)}
