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
``LAUNCHES_BY_DTYPE["name:dtype"]`` (``"flash_attention_fwd:bfloat16"``,
``"paged_decode_attend:float16"``).

float16 has kernels wherever the reference gives one (``F16_KERNELS``:
rows 1, 2, 3, 4, 5, 7 and 10 and row 8's three); :func:`check_tensor`
refuses a float16 tensor bound for row 6, the 2-bit quantizer, which is
f32 by design, before a pointer reaches it.
Inside :func:`record_launches` the launches made on a stream being
captured are also counted into dicts of their own: what a CUDA graph
records, from any thread (autograd runs a captured backward on a thread
of its own), whatever other threads launch eagerly meanwhile.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..base import MXNetError

__all__ = ["KERNELS", "F16_KERNELS", "LAUNCHES", "LAUNCHES_BY_DTYPE",
           "PLAIN_CALLS", "on_cpu", "count_launch", "count_plain",
           "record_launches", "reset_counts", "refuse_f16",
           "check_same_16bit"]

KERNELS = ("paged_decode_attend", "paged_chunk_prefill_attend",
           "paged_prefill_attend", "layernorm_fused", "layernorm_fused_bwd",
           "flash_attention_fwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "two_bit_quantize_fused",
           "fused_scale_relu_matmul", "fused_band4d")
# the kernels with a float16 form: the serving path's (rows 1, 2, 3, 5
# and row 8's forward, the draft model's), the transformer's training
# path's (row 4 and row 8's backward) and ResNet's (rows 7 and 10)
F16_KERNELS = frozenset(("paged_decode_attend", "paged_chunk_prefill_attend",
                         "paged_prefill_attend", "layernorm_fused",
                         "layernorm_fused_bwd", "flash_attention_fwd",
                         "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                         "fused_scale_relu_matmul", "fused_band4d"))
# why a kernel outside F16_KERNELS refuses float16
F16_REFUSALS = {
    "two_bit_quantize_fused": "the kernel is f32 by design: 2-bit compression quantizes "
    "the f32 master-gradient view, which the kvstore makes of 16-bit "
    "gradients (ROADMAP A.1)"}
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {k: 0 for k in KERNELS}
LAUNCHES_BY_DTYPE = {}
_lock = threading.Lock()
# the capture in progress: (by kernel, by "name:dtype"), or None;
# cuda_graph.py captures one graph at a time
_recording = {"dicts": None}


def _capturing():
    return torch.cuda.is_current_stream_capturing()


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
    key = None if dtype is None else \
        "%s:%s" % (kernel, str(dtype).replace("torch.", ""))
    with _lock:
        LAUNCHES[kernel] += 1
        if key is not None:
            LAUNCHES_BY_DTYPE[key] = LAUNCHES_BY_DTYPE.get(key, 0) + 1
        rec = _recording["dicts"]
        if rec is not None and _capturing():
            rec[0][kernel] = rec[0].get(kernel, 0) + 1
            if key is not None:
                rec[1][key] = rec[1].get(key, 0) + 1


@contextlib.contextmanager
def record_launches():
    """Count the launches made on a stream being captured while the
    block runs: yields ``(by kernel, by "name:dtype")``, two dicts that
    hold only kernels launched.  One recording at a time."""
    with _lock:
        if _recording["dicts"] is not None:
            raise MXNetError("record_launches: a recording is running")
        _recording["dicts"] = rec = ({}, {})
    try:
        yield rec
    finally:
        with _lock:
            _recording["dicts"] = None


def count_plain(kernel):
    with _lock:
        PLAIN_CALLS[kernel] += 1


def reset_counts():
    with _lock:
        for k in KERNELS:
            LAUNCHES[k] = 0
            PLAIN_CALLS[k] = 0
        LAUNCHES_BY_DTYPE.clear()


def refuse_f16(kernel, name, t):
    """Raises for a float16 tensor ``t`` bound for a kernel outside
    ``F16_KERNELS``, naming the reason (``F16_REFUSALS``)."""
    if t.dtype == torch.float16 and kernel not in F16_KERNELS:
        raise MXNetError("%s: %s is float16; %s"
                         % (kernel, name, F16_REFUSALS[kernel]))


def check_tensor(kernel, name, t, *, dtypes, ndim=None, shape=None):
    """Wrapper-side validation before a pointer reaches a kernel: a
    float16 tensor for a kernel outside ``F16_KERNELS`` raises
    (:func:`refuse_f16`)."""
    refuse_f16(kernel, name, t)
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


def check_same_16bit(kernel, a_name, a, b_name, b):
    """The float16 forms take float16 with float16 only (f32 and bf16
    pair in any way): raises for a float16 tensor beside one of another
    type, which no kernel takes."""
    if (a.dtype == torch.float16) != (b.dtype == torch.float16):
        raise MXNetError("%s: %s is %s and %s %s; the float16 form takes "
                         "float16 with float16" % (kernel, a_name, a.dtype,
                                                   b_name, b.dtype))


FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)
# the C entry points' dtype codes; each has its own case there, and an
# unknown code returns an error
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
