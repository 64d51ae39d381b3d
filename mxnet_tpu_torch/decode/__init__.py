"""Generative serving: paged KV cache + continuous batching
(counterpart of ``mxnet_tpu/decode``).

Quickstart::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.weights import convert_params

    cfg = dict(num_classes=16384, num_layers=12, d_model=2048,
               num_heads=16, seq_len=1024)
    params = convert_params(np_params, mx.gpu(0), cfg)
    eng = DecodeEngine(params, cfg, capacity=8, block_size=16,
                       num_blocks=512)
    for tok in eng.submit(prompt_ids, max_new_tokens=32):   # streamed
        ...
    eng.stop()
"""
from .cache import CacheOOMError, PagedKVCache
from .engine import DecodeEngine
from .scheduler import (DeadlineExceededError, QueueFullError, Scheduler,
                        Sequence, StreamHandle)

__all__ = ["DecodeEngine", "PagedKVCache", "CacheOOMError", "Scheduler",
           "Sequence", "StreamHandle", "DeadlineExceededError",
           "QueueFullError"]
