"""Kernel-path selection and launch counts.

Counterpart of ``mxnet_tpu/pallas/dispatch.py``, with a different
contract: the device of the inputs decides.

* Tensors on the CPU take the kernel's plain PyTorch version.
* Tensors on a CUDA device take the hand-written kernel, or the wrapper
  raises.  No environment knob sends a CUDA tensor to the plain
  version, and no ``try`` falls back to it.

``LAUNCHES[name]`` counts the wrapper's kernel launches and
``PLAIN_CALLS[name]`` the calls of the plain version, as plain ints, so
a run can show which path its work went through.  A wrapper whose
kernel has several element types also counts each launch under
``LAUNCHES_BY_DTYPE["name:dtype"]`` (``"flash_attention_fwd:bfloat16"``).
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError

__all__ = ["KERNELS", "LAUNCHES", "LAUNCHES_BY_DTYPE", "PLAIN_CALLS",
           "on_cpu", "count_launch", "count_plain", "reset_counts"]

KERNELS = ("paged_decode_attend", "paged_chunk_prefill_attend",
           "paged_prefill_attend", "layernorm_fused", "layernorm_fused_bwd",
           "flash_attention_fwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "two_bit_quantize_fused",
           "fused_scale_relu_matmul", "fused_band4d")
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {k: 0 for k in KERNELS}
LAUNCHES_BY_DTYPE = {}
_lock = threading.Lock()


def on_cpu(kernel, *tensors):
    """True when every given tensor lies on the CPU (take the plain
    version), False when every one lies on one CUDA device (take the
    kernel).  Raises for mixed or other devices.  ``None`` entries
    (absent optional inputs) are skipped."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise MXNetError("%s: inputs must share one device, got %s"
                         % (kernel, sorted(str(d) for d in devices)))
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise MXNetError("%s: no kernel or plain version for device %s"
                     % (kernel, dev))


def count_launch(kernel, dtype=None):
    with _lock:
        LAUNCHES[kernel] += 1
        if dtype is not None:
            key = "%s:%s" % (kernel, str(dtype).replace("torch.", ""))
            LAUNCHES_BY_DTYPE[key] = LAUNCHES_BY_DTYPE.get(key, 0) + 1


def count_plain(kernel):
    with _lock:
        PLAIN_CALLS[kernel] += 1


def reset_counts():
    with _lock:
        for k in KERNELS:
            LAUNCHES[k] = 0
            PLAIN_CALLS[k] = 0
        LAUNCHES_BY_DTYPE.clear()


def check_tensor(kernel, name, t, *, dtypes, ndim=None, shape=None):
    """Wrapper-side validation before a pointer reaches a kernel."""
    if t.dtype not in dtypes:
        raise MXNetError("%s: %s has dtype %s; the kernel takes %s"
                         % (kernel, name, t.dtype,
                            ", ".join(str(d) for d in dtypes)))
    if ndim is not None and t.dim() != ndim:
        raise MXNetError("%s: %s must be %d-D, got shape %s"
                         % (kernel, name, ndim, tuple(t.shape)))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise MXNetError("%s: %s has shape %s, expected %s"
                         % (kernel, name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise MXNetError("%s: %s must be contiguous" % (kernel, name))


FLOAT_TYPES = (torch.float32, torch.bfloat16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
