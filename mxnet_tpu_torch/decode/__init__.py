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

Speculative decoding verifies up to ``spec_k`` draft tokens per slot in
each forward: ``DecodeEngine(params, cfg, spec_k=4, spec_impl="ngram")``
(prompt lookup), or ``spec_impl="draft"`` with ``draft_params`` and
``draft_config`` (a draft transformer); greedy streams stay those of
the one-token engine.
"""
from .cache import CacheOOMError, PagedKVCache
from .engine import DecodeEngine
from .scheduler import (DeadlineExceededError, QueueFullError, Scheduler,
                        Sequence, StreamHandle)
from .spec import (DraftModelDrafter, Drafter, DraftWeightsError,
                   NGramDrafter, choose_spec_impl, make_drafter)

__all__ = ["DecodeEngine", "PagedKVCache", "CacheOOMError", "Scheduler",
           "Sequence", "StreamHandle", "DeadlineExceededError",
           "QueueFullError", "Drafter", "NGramDrafter", "DraftModelDrafter",
           "DraftWeightsError", "choose_spec_impl", "make_drafter"]
