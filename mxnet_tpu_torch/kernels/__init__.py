"""Hand-written Hopper kernels and their plain PyTorch versions
(counterpart of ``mxnet_tpu/pallas``).  The device of the inputs picks
the path: CPU tensors take the plain version, CUDA tensors the kernel
(``dispatch.py``)."""
from .dispatch import LAUNCHES, PLAIN_CALLS, reset_counts
from .layernorm import layernorm_fused, layernorm_plain
from .paged_attention import (paged_chunk_prefill_attend,
                              paged_chunk_prefill_attend_plain,
                              paged_decode_attend, paged_decode_attend_plain)

__all__ = ["LAUNCHES", "PLAIN_CALLS", "reset_counts", "layernorm_fused",
           "layernorm_plain", "paged_decode_attend",
           "paged_decode_attend_plain", "paged_chunk_prefill_attend",
           "paged_chunk_prefill_attend_plain"]
