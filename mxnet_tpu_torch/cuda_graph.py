"""One body of device work captured once as a CUDA graph and replayed.

Shared by the fused fit step (``module/fused_fit.py``: one program per
batch shape, warmed up over real training steps) and the executor's
donated inference forward (``Executor.donate_args``: warmed up and
captured inside its first forward).  Both follow PyTorch's rule for a
capture: the body first runs eagerly on a side stream (``WARMUP``
times), so lazy initialisation (a kernel library's first load, cuBLAS
workspaces) happens outside the graph; then it is captured once on a
stream of its own, and every later call is one replay on the current
stream.  The graph reads and writes the tensors the body closed over,
where they live; its outputs are static tensors that the next replay
overwrites.

A capture holds ``_CAPTURE_LOCK``, so one capture runs at a time in
the process (as PyTorch documents), and captures in
``"thread_local"`` mode: another thread may launch kernels, replay
graphs, allocate, copy and synchronize a stream or an event while it
runs (an engine stepping on its own thread).  One call CUDA refuses
from any thread while a capture runs, and the refusal breaks the
capture too: a device-wide ``torch.cuda.synchronize()``
(``tools/torch_capture_threads.py``).  A body that syncs the host, or
a launch that fails, fails the capture: :meth:`Program.capture` raises
an ``MXNetError`` naming the program; nothing falls back to the eager
body.  Random
streams are not registered with the graph, so a body that draws random
numbers raises at warm-up instead of replaying one draw forever.

Inputs reach the graph through :class:`Staging`: two pinned host slots
per input, so the host waits only for the copy two calls back, never
for the step in flight.
"""
from __future__ import annotations

import threading

import torch

from . import random as _random
from .base import MXNetError
from .kernels.dispatch import record_launches

__all__ = ["WARMUP", "GraphPool", "Program", "Staging"]

# eager runs of a body, on a side stream, before its capture
WARMUP = 2

# one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()


class Staging:
    """Copies into one device tensor from two pinned host slots in
    turn: the host fills a slot only after the copy made from it two
    steps back has run (its event), so it never waits for the step in
    flight.  On the CPU, or from a device tensor, a plain copy."""

    def __init__(self, target):
        self.target = target
        self._slots = []
        if target.device.type == "cuda":
            self._slots = [(torch.empty(target.shape, dtype=target.dtype,
                                        pin_memory=True), torch.cuda.Event())
                           for _ in range(2)]
        self._turn = 0

    def put(self, value):
        if not self._slots or value.device.type != "cpu":
            self.target.copy_(value)
            return
        slot, done = self._slots[self._turn]
        self._turn ^= 1
        done.synchronize()
        slot.copy_(value)
        self.target.copy_(slot, non_blocking=True)
        done.record()


class GraphPool:
    """A graph memory pool, made at the first capture into it.  Graphs
    captured into one pool reuse each other's freed temporaries, so
    they must replay one at a time, in one stream order, and a graph's
    outputs last only until another graph of the pool replays.  A
    capture into the pool needs a live graph of it, or none yet
    (PyTorch asserts on a pool whose graphs are all gone), and a failed
    capture spoils the pool for later captures: :meth:`discard` gives
    the next capture a new one."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def discard(self):
        self._handle = None


class Program:
    """``body()`` (device work returning tensors) warmed up, captured
    once and replayed on ``device``.  ``what`` names it in errors,
    ``eager_hint`` says how to keep it eager; ``pool`` is a
    :class:`GraphPool` to capture into (None: a pool of its own).
    After :meth:`capture`, ``captured`` and ``captured_by_dtype`` hold
    the kernel launches recorded in the graph (by kernel, and by
    ``"name:dtype"``)."""

    def __init__(self, body, device, what, eager_hint, pool=None):
        self.body = body
        self.device = device
        self.what = what
        self.eager_hint = eager_hint
        self.pool = pool
        self.graph = None
        self.outs = None
        self.captured = {}
        self.captured_by_dtype = {}

    def warm_up(self):
        """One eager run of the body on a side stream; returns its
        outputs.  Raises when the body draws random numbers."""
        gen = _random.generator(self.device)
        drawn = gen.get_state()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs = self.body()
        cur.wait_stream(side)
        if not torch.equal(gen.get_state(), drawn):
            raise MXNetError(
                "%s: draws random numbers, whose stream a captured graph "
                "would replay unchanged; %s" % (self.what, self.eager_hint))
        return outs

    def capture(self):
        """Capture the body once and replay it; returns the graph's
        static outputs.  A failed capture raises ``MXNetError``."""
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(cur)
        # a pool of its own, unless shared: its id ends a failed capture
        pool = self.pool.handle() if self.pool is not None \
            else torch.cuda.graph_pool_handle()
        try:
            with _CAPTURE_LOCK, record_launches() as rec, \
                    torch.cuda.stream(stream):
                # the side streams' cached blocks back to the card first,
                # as torch.cuda.graph does
                torch.cuda.empty_cache()
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outs = self.body()
                except BaseException:
                    _end_failed(graph, self.device, pool)
                    raise
                graph.capture_end()
        except RuntimeError as exc:     # MXNetError is one
            if self.pool is not None:
                self.pool.discard()
            raise MXNetError("%s: CUDA graph capture failed: %s; %s"
                             % (self.what, exc, self.eager_hint)) from exc
        cur.wait_stream(stream)
        self.graph, self.outs = graph, outs
        self.captured, self.captured_by_dtype = rec
        graph.replay()
        return outs

    def replay(self):
        self.graph.replay()
        return self.outs


def _end_failed(graph, device, pool):
    """End a capture whose body raised, so the stream leaves capture
    mode.  The capture is invalid, and ending it raises before PyTorch
    stops routing the stream's allocations to ``pool``: stop that here.
    The pool stays unfit for another capture (``GraphPool.discard``)."""
    try:
        graph.capture_end()
    except RuntimeError:
        torch._C._cuda_endAllocateToPool(device.index or 0, pool)
