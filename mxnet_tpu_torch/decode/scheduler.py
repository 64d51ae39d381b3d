"""Continuous-batching scheduler state (host-side policy, no device code).

Counterpart of ``mxnet_tpu/decode/scheduler.py``.

Iteration-level scheduling in the Orca (OSDI '22) sense: the unit of
work is one *decode iteration* over a fixed array of batch slots, and
sequences join/leave between iterations — a new request never waits for
the batch to drain, a finished request never pads it.  The policies are
deliberately simple and documented (docs/DECODE.md):

* **Admission** — FIFO, no head-of-line bypass: the oldest waiting
  sequence is admitted as soon as a slot AND its FIRST prefill chunk's
  cache blocks are free (chunked prefill grows the rest incrementally,
  one chunk per decode iteration — Sarathi-style stall-free prefill).
* **Preemption** — on cache pressure the YOUNGEST running sequence is
  preempted *by recompute*: its blocks are freed, its tokens so far
  fold into a new prompt, and it rejoins the FRONT of the wait queue,
  re-prefilling when memory frees up.  Streamed tokens are never
  re-emitted.
* **Expiry** — deadlines are checked while waiting and between
  iterations; an expired sequence settles with
  ``DeadlineExceededError`` exactly like a serving request.

Everything here is plain-Python and single-owner: only the engine
thread mutates slots/blocks, only ``submit`` (any thread, under the
engine lock) appends to the wait queue — which is what makes the
policy unit-testable without a device.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque

from ..serving.batcher import DeadlineExceededError, QueueFullError

__all__ = ["Sequence", "StreamHandle", "Scheduler",
           "DeadlineExceededError", "QueueFullError"]


class StreamHandle:
    """Client-side view of one generation: an iterator of streamed
    tokens plus a synchronous :meth:`result`.

    The engine appends every generated token to :attr:`tokens` *before*
    publishing it to the event queue, so ``tokens`` is always a prefix-
    consistent transcript; iteration consumes the queue.  ``ttft_ms``
    is set at the first token (time-to-first-token, queue wait
    included)."""

    def __init__(self, rid):
        self.rid = rid
        self.tokens = []
        self.logits = None          # populated when collect_logits=True
        self.finish_reason = None
        self.error = None
        self.ttft_ms = None
        self.preemptions = 0
        self._events = _queue.Queue()
        self._done = threading.Event()
        self._cancelled = threading.Event()

    def cancel(self):
        """Ask the engine to stop this generation (client went away).
        Takes effect at the next scheduler iteration: the sequence's
        slot and cache blocks are released and the stream settles with
        ``finish_reason='cancelled'``.  Idempotent; a no-op once done."""
        self._cancelled.set()

    def cancelled(self):
        return self._cancelled.is_set()

    # engine side ------------------------------------------------------
    def _emit(self, token):
        self.tokens.append(token)
        self._events.put(("token", token))

    def _finish(self, reason=None, error=None):
        self.finish_reason = reason if error is None else "error"
        self.error = error
        self._events.put(("done", reason) if error is None
                         else ("error", error))
        self._done.set()

    # client side ------------------------------------------------------
    def __iter__(self):
        while True:
            kind, payload = self._events.get()
            if kind == "token":
                yield payload
            elif kind == "done":
                return
            else:
                raise payload

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Wait for completion; returns the generated tokens (prompt
        excluded).  Raises the stream's error (deadline, cache OOM,
        server closed) if it failed."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation %d still running" % self.rid)
        if self.error is not None:
            raise self.error
        return list(self.tokens)


class Sequence:
    """One request's full scheduler state."""

    def __init__(self, rid, prompt, max_new_tokens, eos_id=None,
                 deadline=None, temperature=0.0, seed=None,
                 collect_logits=False, speculative=True):
        self.rid = rid
        self.tokens = list(int(t) for t in prompt)   # prompt + generated
        self.n_prompt = len(self.tokens)             # original prompt size
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline = deadline
        self.temperature = float(temperature)
        self.seed = seed
        # False pins this stream to one verified token per iteration on
        # a spec-enabled engine; sampling and collect_logits streams
        # never draft either way (greedy acceptance is exact only for
        # greedy streams)
        self.speculative = bool(speculative)
        self.handle = StreamHandle(rid)
        if collect_logits:
            self.handle.logits = []
        self._rng = None
        # engine-owned placement state
        self.slot = None
        self.blocks = []
        self.pos = 0              # next cache position to be written
        self.last_token = None    # token the next decode step consumes
        # chunked-prefill cursor: prompt rows [0, n_prefilled) are in
        # the KV cache; the sequence decodes once n_prefilled reaches
        # prefill_target (set at admission to the full prompt length)
        self.prefill_target = 0
        self.n_prefilled = 0
        self.t_submit = time.monotonic()
        self.t_first = None
        self.submit_step = None   # engine step count at submit (TTFT-steps)
        self.preemptions = 0

    @property
    def n_generated(self):
        return len(self.tokens) - self.n_prompt

    @property
    def recompute_prompt(self):
        """Prompt for (re-)prefill: everything produced so far."""
        return self.tokens

    def rng(self):
        if self._rng is None:
            import numpy as np
            self._rng = np.random.RandomState(
                self.seed if self.seed is not None else (self.rid * 9973 + 7))
        return self._rng

    def expired(self, now=None):
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)


class Scheduler:
    """Slot/queue bookkeeping for the engine (module docstring)."""

    def __init__(self, capacity, cache, max_waiting=256):
        self.capacity = int(capacity)
        self.cache = cache
        self.max_waiting = int(max_waiting)
        self.waiting = deque()
        self.slots = [None] * self.capacity

    # -- queue side (called under the engine lock) ---------------------
    def enqueue(self, seq, front=False):
        if len(self.waiting) >= self.max_waiting:
            raise QueueFullError(
                "decode wait queue full (%d sequences)" % self.max_waiting)
        (self.waiting.appendleft if front else self.waiting.append)(seq)

    def take_expired_waiting(self, now=None):
        now = time.monotonic() if now is None else now
        expired = [s for s in self.waiting if s.expired(now)]
        if expired:
            self.waiting = deque(s for s in self.waiting
                                 if not s.expired(now))
        return expired

    # -- slot side (engine thread only) --------------------------------
    def has_active(self):
        return any(s is not None for s in self.slots)

    def active(self):
        """[(slot_index, Sequence)] for occupied slots, slot order."""
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def free_slot(self):
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def may_admit(self):
        """Admission gate: continuous admission into in-flight
        iterations whenever a slot is free and a sequence waits."""
        return self.free_slot() is not None and bool(self.waiting)

    def place(self, seq, slot):
        assert self.slots[slot] is None
        self.slots[slot] = seq
        seq.slot = slot

    def release(self, seq):
        """Recycle the sequence's slot and cache blocks."""
        if seq.slot is not None:
            self.slots[seq.slot] = None
            seq.slot = None
        if seq.blocks:
            self.cache.free(seq.blocks)
            seq.blocks = []

    def pick_prefilling(self):
        """Chunk policy: the OLDEST placed sequence still mid-prefill
        (smallest rid) feeds this iteration's chunk rows — FIFO TTFT
        order, one chunk per iteration."""
        cands = [s for _, s in self.active()
                 if s.n_prefilled < s.prefill_target]
        return min(cands, key=lambda s: s.rid) if cands else None

    def pick_victim(self, exclude=()):
        """Preemption policy: youngest running sequence (largest rid)
        not in ``exclude`` — it has the least recompute to lose and the
        oldest requests keep their latency."""
        cands = [s for _, s in self.active()
                 if s is not None and s not in exclude]
        return max(cands, key=lambda s: s.rid) if cands else None

    def preempt(self, seq):
        """Preempt-by-recompute: free everything, rejoin the queue
        front.  The caller streams nothing; already-emitted tokens stay
        emitted and the re-prefill continues from ``seq.tokens``."""
        self.release(seq)
        seq.pos = 0
        seq.last_token = None
        # a partially-prefilled prompt folds whole: the next admission
        # re-targets the full (prompt + generated) token list
        seq.prefill_target = 0
        seq.n_prefilled = 0
        seq.preemptions += 1
        seq.handle.preemptions = seq.preemptions
        self.waiting.appendleft(seq)
