"""Hand-written Hopper kernels and their plain PyTorch versions
(counterpart of ``mxnet_tpu/pallas``).  The device of the inputs picks
the path: CPU tensors take the plain version, CUDA tensors the kernel
(``dispatch.py``)."""
from .dispatch import LAUNCHES, LAUNCHES_BY_DTYPE, PLAIN_CALLS, reset_counts
from .flash_attention import (FlashAttentionFn, flash_attention,
                              flash_attention_bwd_dkv,
                              flash_attention_bwd_dkv_plain,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_dq_plain,
                              flash_attention_fwd, flash_attention_fwd_plain,
                              flash_attention_plain)
from .fused_band4d import fused_band4d, fused_band4d_plain
from .fused_matmul import (fused_scale_relu_matmul_fwd,
                           fused_scale_relu_matmul_plain)
from .layernorm import (LayerNormFn, layernorm, layernorm_bwd_plain,
                        layernorm_fused, layernorm_fused_bwd, layernorm_plain)
from .paged_attention import (paged_chunk_prefill_attend,
                              paged_chunk_prefill_attend_plain,
                              paged_decode_attend, paged_decode_attend_plain,
                              paged_prefill_attend, paged_prefill_attend_plain)
from .quant import two_bit_quantize_fused, two_bit_quantize_plain

__all__ = ["LAUNCHES", "LAUNCHES_BY_DTYPE", "PLAIN_CALLS", "reset_counts",
           "layernorm_fused",
           "layernorm_plain", "layernorm_fused_bwd", "layernorm_bwd_plain",
           "LayerNormFn", "layernorm", "flash_attention",
           "flash_attention_plain", "FlashAttentionFn", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_plain", "paged_decode_attend",
           "paged_decode_attend_plain", "paged_chunk_prefill_attend",
           "paged_chunk_prefill_attend_plain", "paged_prefill_attend",
           "paged_prefill_attend_plain", "two_bit_quantize_fused",
           "two_bit_quantize_plain", "fused_scale_relu_matmul_fwd",
           "fused_scale_relu_matmul_plain", "fused_band4d",
           "fused_band4d_plain"]
