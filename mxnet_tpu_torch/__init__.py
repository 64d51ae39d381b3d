"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

A second package beside ``mxnet_tpu`` (the JAX reference), with the same
MXNet-shaped API.  It serves the decoder-only transformer LM through the
paged decode engine, and trains it, LeNet and ResNet through
``Module.fit``, optionally through the device kvstore with 2-bit
gradient compression (``mx.kv.create('device')``), and trains the
channel-last ResNet through ``parallel.TrainStep``, optionally after
the BN -> ReLU -> Conv1x1 fusion pass (``symbol.fuse``).  The paged
decode attention, the chunked-prefill attention, LayerNorm (forward and
backward), causal flash attention (forward and backward), the 2-bit
quantizer and the fused BN-apply/ReLU/1x1 convolution (over a 2-D view,
and over a strided 4-D channel-last tensor) run in hand-written CUDA
kernels (``csrc/``), built for ``sm_90a`` on first use.  ``Module.fit``
runs each step of an eligible configuration as one CUDA graph replay
(``module/fused_fit.py``).  The imperative front end (``mx.nd`` ops, ``autograd``) and Gluon
(blocks, layers, losses, ``Trainer``, the model-zoo ResNets) train
eagerly or hybridized; ``mx.rtc.CudaModule`` compiles users' CUDA
kernels with NVRTC and launches them on NDArrays.  ``mx.nd.save``/
``load``, symbol JSON, ``Module.load``/``save_checkpoint`` and the
Gluon parameter files write and read the JAX package's files, and
``mx.checkpoint`` saves the full training state asynchronously (the
fused step's weights, f32 masters, states, residuals and loss scaler)
and restores it bit for bit.  ``mx.rnn`` (the symbolic cells, the fused
``RNN`` op, ``BucketSentenceIter``), ``mx.mod.BucketingModule`` (one
captured fit graph a bucket over one set of weights) and
``gluon.rnn`` train the RNN language models.

Entry points run on the card (``gpu(0)``, i.e. ``cuda:0``) unless the
caller passes ``ctx=mx.cpu()``; with no GPU and no CPU request they
raise.  On CPU tensors every kernel takes its plain PyTorch version.
"""
from . import autograd, base, context, kernels, ndarray, ops, symbol  # noqa
from . import decode, models, weights  # noqa: F401
from . import (callback, initializer, io, kvstore, lr_scheduler,  # noqa: F401
               metric, model, module, optimizer, parallel, random)
from . import checkpoint, config, gluon, name, rnn, rtc  # noqa: F401
from .base import MXNetError
from .context import Context, cpu, current_context, gpu
from .module import Module

nd = ndarray
sym = symbol
init = initializer
mod = module
kv = kvstore

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context", "nd",
           "sym", "ndarray", "symbol", "decode", "models", "weights",
           "kernels", "callback", "init", "initializer", "io", "kv",
           "kvstore", "lr_scheduler", "metric", "model", "module", "mod",
           "Module", "optimizer", "parallel", "random", "autograd", "gluon", "rtc",
           "checkpoint", "config", "name", "rnn"]
