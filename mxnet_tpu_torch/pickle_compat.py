"""Pickles that both packages read: optimizer states, checkpoint extras.

The reference's ``.states`` files (``Updater.get_states``), Gluon's
``Trainer.save_states`` and the checkpoint's ``.extra`` file are
pickles.  The JAX package's name its own classes
(``mxnet_tpu.ndarray.ndarray.NDArray``, whose state is ``{"data":
numpy, "ctx": str}``, ``mxnet_tpu.optimizer.SGD``,
``mxnet_tpu.lr_scheduler.FactorScheduler``, and in a Trainer's file
``mxnet_tpu.gluon.parameter.Parameter``).  This module reads and writes
that one format without importing the JAX package:

* :func:`loads` / :func:`load` unpickle through an allow-list that maps
  each JAX class name (and the port's own) onto the port's class, keeps
  numpy's reconstructors and refuses every other global; a JAX Gluon
  ``Parameter`` (the optimizer's ``param_dict``, which the loader sets
  anew) becomes an inert placeholder.
* :func:`dumps` / :func:`dump` write the port's NDArrays, optimizers and
  schedules under the JAX package's class names (the C pickler insists
  that a global it writes can be imported, so this is the pure-Python
  ``pickle._Pickler`` with ``save_global`` overridden).
"""
from __future__ import annotations

import importlib
import io
import pickle

__all__ = ["dumps", "dump", "loads", "load"]

_JAX = "mxnet_tpu"
_PORT = "mxnet_tpu_torch"

# numpy's array, dtype and scalar reconstructors (numpy 2 moved them to
# numpy._core)
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _Dropped:
    """Stands in for a pickled object the port does not carry over (a
    JAX Gluon Parameter in an optimizer's ``param_dict``)."""

    def __setstate__(self, state):
        pass


def _port_classes():
    """``{(module, name): port class}`` for every class a states or
    extra pickle may name, under both packages' module paths."""
    from . import lr_scheduler, optimizer
    from .ndarray.ndarray import NDArray
    table = {}
    for sub, names in (("ndarray.ndarray", {"NDArray": NDArray}),
                       ("optimizer", {c.__name__: c for c in
                                      optimizer._OPT_REGISTRY.values()}),
                       ("lr_scheduler", {n: getattr(lr_scheduler, n)
                                         for n in lr_scheduler.__all__})):
        for name, cls in names.items():
            table[("%s.%s" % (_JAX, sub), name)] = cls
            table[("%s.%s" % (_PORT, sub), name)] = cls
    table[(_JAX + ".gluon.parameter", "Parameter")] = _Dropped
    return table


class _Unpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._classes = _port_classes()

    def find_class(self, module, name):
        cls = self._classes.get((module, name))
        if cls is not None:
            return cls
        if (module, name) in _NUMPY_GLOBALS:
            try:
                mod = importlib.import_module(module)
            except ImportError:
                # a pickle from numpy 2 (numpy._core) read by numpy 1
                mod = importlib.import_module(
                    module.replace("numpy._core", "numpy.core"))
            return getattr(mod, name)
        if (module, name) == ("ml_dtypes", "bfloat16"):
            try:
                import ml_dtypes
            except ImportError:
                raise pickle.UnpicklingError(
                    "the pickle holds a bfloat16 numpy array, which needs "
                    "the ml_dtypes package") from None
            return ml_dtypes.bfloat16
        raise pickle.UnpicklingError(
            "refusing to unpickle %s.%s: not a class that optimizer-state "
            "or checkpoint files hold" % (module, name))


def load(f):
    """Unpickle from the binary file ``f`` through the allow-list."""
    return _Unpickler(f).load()


def loads(blob):
    return load(io.BytesIO(blob))


def _jax_names():
    """``{port class: (JAX module, name)}`` for the classes written."""
    out = {}
    for (module, name), cls in _port_classes().items():
        if module.startswith(_JAX + ".") and cls is not _Dropped:
            out[cls] = (module, name)
    return out


class _Pickler(pickle._Pickler):
    def __init__(self, f, protocol=None):
        super().__init__(f, protocol or pickle.DEFAULT_PROTOCOL)
        self._names = _jax_names()

    def save_global(self, obj, name=None):
        target = self._names.get(obj) if isinstance(obj, type) else None
        if target is None:
            return super().save_global(obj, name)
        module, qualname = target
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + bytes(module, "utf-8") + b"\n"
                       + bytes(qualname, "utf-8") + b"\n")
        self.memoize(obj)

    # the pure-Python pickler dispatches on exact types: classes go
    # through save_global, like the C pickler's
    dispatch = dict(pickle._Pickler.dispatch)
    dispatch[type] = save_global


def dump(obj, f):
    """Pickle ``obj`` into the binary file ``f`` under the JAX package's
    class names."""
    _Pickler(f).dump(obj)


def dumps(obj):
    buf = io.BytesIO()
    dump(obj, buf)
    return buf.getvalue()
