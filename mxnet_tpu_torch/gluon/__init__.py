"""Gluon: the imperative and hybridizable neural-network API.

Counterpart of ``mxnet_tpu/gluon`` (reference python/mxnet/gluon):
Block, HybridBlock, Parameter, ParameterDict, Constant, Trainer, and the
``nn``, ``rnn``, ``loss``, ``data``, ``model_zoo`` and ``utils``
modules.  ``SymbolBlock``, the parameter files and ``export`` read and
write the JAX package's files.  ``contrib`` is still to port (ROADMAP
A.6).
"""
from . import data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "Trainer",
           "data", "loss", "model_zoo", "nn", "rnn", "utils"]
