"""Device contexts: ``mx.gpu(i)`` maps to ``cuda:i``, ``mx.cpu()`` to
the host.

Counterpart of ``mxnet_tpu/context.py``.  The default context is the
card, ``gpu(0)``: an entry point that is not handed a context runs on
``cuda:0``, and where no GPU exists it raises instead of carrying on
on the host.  The CPU is used only when the caller asks for it
(``ctx=mx.cpu()`` or ``with mx.cpu():``), which is what the CPU tests
do.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context"]


class Context:
    """A device: ``Context('gpu', i)`` is ``torch.device('cuda', i)``,
    ``Context('cpu')`` the host."""

    _default = threading.local()

    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "gpu"):
            raise MXNetError("unknown device type %r; use 'cpu' or 'gpu'"
                             % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The torch device; raises for a GPU context when no GPU is
        present (never a silent move to the host)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s requested but no CUDA device is available; pass "
                "ctx=mx.cpu() to run on the host" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%s requested but only %d CUDA device(s) exist"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        stack = getattr(Context._default, "stack", None)
        if stack is None:
            stack = Context._default.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope, else ``gpu(0)``.  Raises when
    the result is a GPU context and no GPU exists."""
    stack = getattr(Context._default, "stack", None)
    ctx = stack[-1] if stack else gpu(0)
    ctx.torch_device            # raises when the card is missing
    return ctx


def context_of(device: torch.device) -> Context:
    """The Context of a torch device."""
    if device.type == "cuda":
        return gpu(device.index or 0)
    if device.type == "cpu":
        return cpu()
    raise MXNetError("tensor on unsupported device %s" % device)
