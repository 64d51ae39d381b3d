"""DecodeEngine: continuous-batching generation with chunked prefill.

Counterpart of ``mxnet_tpu/decode/engine.py`` on the mixed step.  One
engine owns (a) a paged KV cache (``cache.PagedKVCache`` + the
per-layer cache tensors on the device) and (b) ONE bound mixed step,
``models.transformer.get_mixed_step_symbol``, that every iteration
runs up to K prefill-chunk tokens of one admitted prompt AND one decode
token for every active slot (Sarathi-Serve-style stall-free
scheduling).

Execution discipline:

* every iteration is one forward of the mixed step; padded slots ride
  along masked (position -1), an empty chunk rides along with
  ``chunk_len == 0``;
* sequence raggedness (positions, chunk offsets/lengths, block tables)
  enters as runtime inputs, so the bound shapes never change;
* the caches are updated in place on the device by the step's ops;
* the only per-iteration host sync is reading the greedy tokens (or
  the logits, for sampling streams) back: that readback is the
  streamed response.

Scheduling policy lives in ``scheduler.py``.  Speculative decoding,
tracing spans, the hang watchdog and hot weight reload of the JAX
engine come with later slices.
"""
from __future__ import annotations

import collections as _collections
import threading
import time

import numpy as _np

from ..base import MXNetError
from ..serving.batcher import (DeadlineExceededError, ServerClosedError,
                               percentile as _percentile)
from ..telemetry import REGISTRY
from .cache import CacheOOMError, PagedKVCache
from .scheduler import Scheduler, Sequence

__all__ = ["DecodeEngine"]

QUEUE_DEPTH = REGISTRY.gauge(
    "decode_queue_depth", "sequences waiting for a decode slot",
    unit="sequences")
ACTIVE_SEQS = REGISTRY.gauge(
    "decode_active_sequences", "sequences occupying decode slots",
    unit="sequences")
ADMITTED = REGISTRY.counter(
    "decode_admitted", "sequences accepted into the wait queue")
COMPLETED = REGISTRY.counter(
    "decode_completed", "sequences finished (eos or length)")
FAILED = REGISTRY.counter(
    "decode_failed", "sequences failed (cache OOM, engine stop, error)")
EXPIRED = REGISTRY.counter(
    "decode_expired", "sequences expired before finishing (deadline)")
CANCELLED = REGISTRY.counter(
    "decode_cancelled", "sequences cancelled by the client")
PREFILLS = REGISTRY.counter(
    "decode_prefills", "prompts admitted into chunked prefill "
    "(admissions + preemption recomputes)")
PREFILL_CHUNKS = REGISTRY.counter(
    "decode_prefill_chunks", "prompt chunks processed by mixed steps")
PREEMPTIONS = REGISTRY.counter(
    "decode_preemptions", "sequences preempted-by-recompute on cache "
    "pressure")
STEPS = REGISTRY.counter(
    "decode_steps", "decode iterations run (one mixed-step forward each)")
TOKENS = REGISTRY.counter(
    "decode_tokens", "tokens generated (prefill first-tokens included)")
STEP_MS = REGISTRY.histogram(
    "decode_step_ms", "wall time of one decode iteration (forward + "
    "token readback + bookkeeping)", unit="ms")
TTFT_MS = REGISTRY.histogram(
    "decode_ttft_ms", "time to first token (submit -> first streamed "
    "token, queue wait included)", unit="ms")


def _shape(v):
    return tuple(v.shape) if hasattr(v, "shape") else _np.shape(v)


def _chunk_budget(chunk_tokens, max_context):
    """The per-iteration prefill-chunk token budget K: ``chunk_tokens``
    (default 64) padded up to a power of two and capped at the context
    length, as in the JAX engine."""
    ck = int(chunk_tokens) if chunk_tokens else 64
    p = 1
    while p < ck:
        p *= 2
    return min(p, int(max_context))


class DecodeEngine:
    """Generative serving engine for the decoder-only transformer.

    Parameters
    ----------
    arg_params : parameters (name -> NDArray, tensor or numpy), e.g. from
        ``weights.convert_params``
    model_config : the ``transformer`` kwargs (num_classes, num_layers,
        d_model, num_heads, ffn_dim, seq_len, ...); ``seq_len`` is also
        the longest context a sequence may reach.
    capacity : decode batch slots (the step's batch dimension)
    block_size, num_blocks : KV-cache geometry (per layer, K and V are
        each ``(num_blocks, block_size, H, D)``)
    chunk_tokens : per-iteration prefill-chunk budget K (pow2-padded)
    ctx : the device; default ``current_context()``, the card
    eos_id : default end-of-sequence token id (None = length-stop only)
    spec_k : speculative decoding; must be 0 in this slice
    prefix_cache : copy-on-write prefix sharing (off by default)
    """

    def __init__(self, arg_params, model_config, capacity=8, block_size=16,
                 num_blocks=64, chunk_tokens=None, ctx=None, eos_id=None,
                 max_waiting=256, default_max_new_tokens=64, warmup=False,
                 start=True, spec_k=0, prefix_cache=False):
        from ..context import current_context
        from ..models import transformer

        if spec_k and int(spec_k) > 0:
            raise MXNetError(
                "speculative decoding (spec_k=%s) is not in the PyTorch port "
                "yet: ROADMAP.md lists it under the decode slice's later "
                "work (the spec step and its drafters)" % spec_k)
        self._cfg = dict(model_config)
        self._cfg.pop("dropout", None)          # inference graphs
        self._ctx = ctx if ctx is not None else current_context()
        self.capacity = int(capacity)
        self._eos = eos_id
        self._default_max_new = int(default_max_new_tokens)
        self._max_context = int(self._cfg.get("seq_len", 1024))
        self._num_layers = int(self._cfg.get("num_layers", 12))
        bs = int(block_size)
        self._table_width = -(-self._max_context // bs)
        self._chunk_tokens = _chunk_budget(chunk_tokens, self._max_context)
        self._prefix_cache = bool(prefix_cache)

        self.cache = PagedKVCache(num_blocks, bs,
                                  prefix_sharing=self._prefix_cache)
        self._sched = Scheduler(self.capacity, self.cache,
                                max_waiting=max_waiting)

        msym = transformer.get_mixed_step_symbol(
            block_size=bs, num_blocks=int(num_blocks), **self._cfg)
        self._exe = msym.simple_bind(
            ctx=self._ctx, grad_req="null", data=(self.capacity, 1),
            positions=(self.capacity, 1),
            block_table=(self.capacity, self._table_width),
            chunk_data=(1, self._chunk_tokens),
            chunk_positions=(1, self._chunk_tokens),
            chunk_start=(1,), chunk_len=(1,),
            chunk_table=(1, self._table_width))
        self._cache_names = []
        for i in range(self._num_layers):
            self._cache_names += ["layer%d_k_cache" % i,
                                  "layer%d_v_cache" % i]
        self.cache.attach_arrays([self._exe.arg_dict[n]
                                  for n in self._cache_names])
        self._weight_names = [n for n in self._exe.arg_dict
                              if n not in transformer.MIXED_STEP_INPUTS
                              and n not in self._cache_names]
        self._check_params(arg_params)
        self._exe.copy_params_from(
            {k: v for k, v in arg_params.items() if k in self._weight_names})

        # accounting (instance state; registry series are process-wide)
        self._n_steps = 0
        self._n_prefills = 0
        self._n_prefill_chunks = 0
        self._occ_sum = 0
        self._cache_occ_sum = 0.0
        self._n_tokens = 0
        self._n_completed = 0
        self._n_failed = 0
        self._n_expired = 0
        self._n_preemptions = 0
        self._n_admitted = 0
        self._n_cancelled = 0
        # last-4096 windows only: a long-lived server must not keep one
        # float per request or step
        self._ttfts = _collections.deque(maxlen=4096)
        self._ttft_steps = _collections.deque(maxlen=4096)
        self._step_ms = _collections.deque(maxlen=4096)
        self._rid = 0

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._step_lock = threading.Lock()
        self._closing = False
        self._abort = False
        self._thread = None
        if warmup:
            self.warmup()
        if start:
            self.start()

    # ------------------------------------------------------------------
    def _check_params(self, arg_params):
        missing = [n for n in self._weight_names if n not in arg_params]
        if missing:
            raise MXNetError("decode: params missing for %s"
                             % sorted(missing))
        bad = [n for n in self._weight_names
               if _shape(arg_params[n]) != self._exe.arg_dict[n].shape]
        if bad:
            raise MXNetError("decode: param shapes do not match the bound "
                             "model for %s" % sorted(bad))

    def _idle_feeds(self):
        """All-slots-inactive, empty-chunk inputs: positions -1 mask every
        decode row and ``chunk_len == 0`` makes the chunk a no-op."""
        K, M = self._chunk_tokens, self._table_width
        return dict(
            data=_np.zeros((self.capacity, 1), _np.float32),
            positions=_np.full((self.capacity, 1), -1.0, _np.float32),
            block_table=_np.zeros((self.capacity, M), _np.float32),
            chunk_data=_np.zeros((1, K), _np.float32),
            chunk_positions=_np.zeros((1, K), _np.float32),
            chunk_start=_np.zeros((1,), _np.float32),
            chunk_len=_np.zeros((1,), _np.float32),
            chunk_table=_np.zeros((1, M), _np.float32))

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="mx-decode-engine", daemon=True)
            self._thread.start()

    def warmup(self):
        """One idle step: builds the kernels (first use) and touches
        every op once before serving.  Leaves the caches unchanged."""
        with self._step_lock:
            outs = self._exe.forward(is_train=False, **self._idle_feeds())
            outs[1].asnumpy()

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, tokens, max_new_tokens=None, eos_id="default",
               timeout_ms=None, temperature=0.0, seed=None,
               collect_logits=False):
        """Queue one generation; returns a :class:`StreamHandle` (iterate
        it for streamed tokens, or ``.result()`` for the list).  Raises
        ``QueueFullError`` on backpressure and ``MXNetError`` for an
        inadmissible prompt."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise MXNetError("decode: empty prompt")
        if max_new_tokens is not None and int(max_new_tokens) < 1:
            raise MXNetError("decode: max_new_tokens must be >= 1 "
                             "(got %s)" % (max_new_tokens,))
        if len(tokens) >= self._max_context:
            raise MXNetError("decode: prompt of %d tokens leaves no "
                             "room to generate within seq_len=%d"
                             % (len(tokens), self._max_context))
        if self.cache.blocks_for(len(tokens)) > self.cache.num_blocks:
            raise MXNetError("decode: prompt needs %d cache blocks, the "
                             "cache only has %d"
                             % (self.cache.blocks_for(len(tokens)),
                                self.cache.num_blocks))
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        with self._cv:
            if self._closing:
                raise ServerClosedError("decode engine is stopped")
            self._rid += 1
            seq = Sequence(
                self._rid, tokens,
                max_new_tokens if max_new_tokens is not None
                else self._default_max_new,
                eos_id=self._eos if eos_id == "default" else eos_id,
                deadline=deadline, temperature=temperature, seed=seed,
                collect_logits=collect_logits)
            seq.submit_step = self._n_steps
            self._sched.enqueue(seq)          # may raise QueueFullError
            self._n_admitted += 1
            ADMITTED.inc()
            QUEUE_DEPTH.set(len(self._sched.waiting))
            self._cv.notify_all()
        return seq.handle

    def generate(self, tokens, timeout=None, **kwargs):
        """Synchronous convenience: submit + wait; returns the generated
        token list."""
        return self.submit(tokens, **kwargs).result(timeout)

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------
    def _loop(self):
        while True:
            with self._cv:
                while (not self._closing
                       and not self._sched.waiting
                       and not self._sched.has_active()):
                    self._cv.wait(0.1)
                abort = self._abort
                drained = (self._closing and not self._sched.waiting
                           and not self._sched.has_active())
            # _fail_everything re-acquires _cv (a plain Lock), so it
            # must run OUTSIDE the monitor or abort deadlocks
            if abort:
                self._fail_everything(
                    ServerClosedError("decode engine stopped"))
                return
            if drained:
                return
            try:
                worked = self._tick()
            except Exception as exc:   # noqa: BLE001 — engine must survive
                self._fail_everything(exc)
                continue
            if not worked:
                time.sleep(0.002)      # blocked on cache; don't spin hot

    def _fail_everything(self, exc):
        with self._cv:
            seqs = list(self._sched.waiting)
            self._sched.waiting.clear()
        seqs += [s for _, s in self._sched.active()]
        for seq in seqs:
            self._finish(seq, error=exc)

    def _tick(self):
        """One scheduler iteration; returns False when nothing ran."""
        now = time.monotonic()
        with self._cv:
            expired = self._sched.take_expired_waiting(now)
            cancelled = [s for s in self._sched.waiting
                         if s.handle.cancelled()]
            for s in cancelled:
                self._sched.waiting.remove(s)
            QUEUE_DEPTH.set(len(self._sched.waiting))
        for seq in expired:
            self._finish(seq, error=DeadlineExceededError(
                "request %d expired before a decode slot freed" % seq.rid))
        for seq in cancelled:
            self._finish(seq, reason="cancelled")
        for _, seq in self._sched.active():
            if seq.handle.cancelled():
                self._finish(seq, reason="cancelled")
            elif seq.expired(now):
                self._finish(seq, error=DeadlineExceededError(
                    "request %d deadline expired mid-generation" % seq.rid))
        progressed = False
        while True:
            with self._cv:
                if not self._sched.may_admit():
                    break
                seq = self._sched.waiting[0]
                # admission gates on the FIRST chunk's footprint only —
                # chunked prefill grows the table incrementally, and
                # later chunks may preempt (youngest first) for blocks
                need = self.cache.blocks_for(
                    min(len(seq.tokens), self._chunk_tokens))
                if need > self.cache.free_count:
                    break             # FIFO: wait for blocks, no bypass
                self._sched.waiting.popleft()
                QUEUE_DEPTH.set(len(self._sched.waiting))
            slot = self._sched.free_slot()
            try:
                self._admit(seq, slot)
                progressed = True
            except Exception as exc:   # noqa: BLE001 — the sequence is
                # off the wait queue and may not be placed yet, so any
                # failure here must settle its handle
                self._finish(seq, error=exc)
        # grow every DECODING sequence's block table BEFORE the step —
        # the step writes cache position seq.pos, and a missing table
        # entry would default to block 0 and corrupt whoever owns it.
        # Growth may preempt (youngest first), so re-snapshot after.
        for _, seq in self._sched.active():
            if seq.slot is None:      # preempted by an earlier growth
                continue
            if seq.n_prefilled < seq.prefill_target:
                continue              # prefilling: grown with its chunk
            try:
                self._ensure_blocks(seq, seq.pos // self.cache.block_size)
            except CacheOOMError as exc:
                self._finish(seq, error=exc)
        # this iteration's prefill chunk (oldest prefilling sequence)
        chunk_seq = self._sched.pick_prefilling()
        chunk_len = 0
        if chunk_seq is not None:
            chunk_len = min(self._chunk_tokens,
                            chunk_seq.prefill_target
                            - chunk_seq.n_prefilled)
            last_row = chunk_seq.n_prefilled + chunk_len - 1
            try:
                self._ensure_blocks(chunk_seq,
                                    last_row // self.cache.block_size)
            except CacheOOMError as exc:
                self._finish(chunk_seq, error=exc)
                chunk_seq, chunk_len = None, 0
        active = self._sched.active()
        ACTIVE_SEQS.set(len(active))
        if active:
            self._step(active, chunk_seq, chunk_len)
            progressed = True
        return progressed

    # ------------------------------------------------------------------
    def _ensure_blocks(self, seq, block_idx):
        """Make sure table entry ``block_idx`` exists, preempting the
        youngest other sequence on cache pressure."""
        while block_idx >= len(seq.blocks):
            try:
                seq.blocks += self.cache.alloc(1)
            except CacheOOMError:
                victim = self._sched.pick_victim(exclude=(seq,))
                if victim is None:
                    raise
                self._preempt(victim)

    def _preempt(self, victim):
        with self._cv:
            self._sched.preempt(victim)
            QUEUE_DEPTH.set(len(self._sched.waiting))
        self._n_preemptions += 1
        PREEMPTIONS.inc()

    def _admit(self, seq, slot):
        """Place a waiting sequence into a slot for chunked prefill (no
        device work: the mixed steps carry the prompt in chunk by
        chunk)."""
        P = len(seq.tokens)
        seq.prefill_target = P
        seq.n_prefilled = 0
        seq.pos = 0
        # prefix-cache hit: adopt the trie's already-prefilled blocks
        # and start chunked prefill at the first unshared row
        if self._prefix_cache and not seq.blocks:
            shared, rows = self.cache.acquire_prefix(seq.tokens[:P])
            if shared:
                seq.blocks = list(shared)
                seq.n_prefilled = rows
        self._n_prefills += 1
        PREFILLS.inc()
        with self._cv:
            self._sched.place(seq, slot)

    def _step(self, active, chunk_seq=None, chunk_len=0):
        t0 = time.perf_counter()
        if chunk_seq is not None and chunk_seq.slot is None:
            chunk_seq, chunk_len = None, 0   # preempted after selection
        # decode rows feed only FULLY-prefilled sequences; a sequence
        # mid-prefill rides the step at pos=-1 (inactive row) until its
        # last chunk lands, when the chunk head emits its first token
        decoding = [(slot, seq) for slot, seq in active
                    if seq.n_prefilled >= seq.prefill_target]
        feeds = self._idle_feeds()
        for slot, seq in decoding:
            feeds["data"][slot, 0] = seq.last_token
            feeds["positions"][slot, 0] = seq.pos
            feeds["block_table"][slot, :len(seq.blocks)] = seq.blocks
        if chunk_seq is not None:
            s0 = chunk_seq.n_prefilled
            feeds["chunk_data"][0, :chunk_len] = \
                chunk_seq.tokens[s0:s0 + chunk_len]
            feeds["chunk_positions"][0, :chunk_len] = \
                _np.arange(s0, s0 + chunk_len)
            feeds["chunk_start"][0] = s0
            feeds["chunk_len"][0] = chunk_len
            feeds["chunk_table"][0, :len(chunk_seq.blocks)] = \
                chunk_seq.blocks
        with self._step_lock:
            outs = self._exe.forward(is_train=False, **feeds)
        self._n_steps += 1
        self._occ_sum += len(active)
        self._cache_occ_sum += self.cache.occupancy
        STEPS.inc()
        if chunk_seq is not None:
            self._advance_chunk(chunk_seq, chunk_len, outs)
        # ONE host copy of the (capacity, vocab) logits per step, shared
        # by every sampling/collect_logits sequence, and ONE of the
        # greedy tokens
        logits_host = None
        if any(self._needs_logits(s) for _, s in decoding):
            logits_host = outs[0].asnumpy()
        next_host = outs[1].asnumpy() if decoding else None
        for slot, seq in decoding:
            seq.pos += 1
            tok = self._pick_token(seq, outs, slot, logits_host, next_host)
            self._emit(seq, tok)
            self._maybe_finish(seq, tok)
        ms = (time.perf_counter() - t0) * 1e3
        STEP_MS.observe(ms)
        with self._cv:
            self._step_ms.append(ms)

    def _advance_chunk(self, chunk_seq, chunk_len, outs):
        """Account this iteration's prefill chunk; on the LAST chunk,
        publish sharable blocks and emit the sequence's first token from
        the chunk head (outputs 2 and 3)."""
        chunk_seq.n_prefilled += chunk_len
        self._n_prefill_chunks += 1
        PREFILL_CHUNKS.inc()
        if chunk_seq.n_prefilled < chunk_seq.prefill_target:
            return
        chunk_seq.pos = chunk_seq.prefill_target
        if self._prefix_cache:
            self.cache.register_prefix(
                chunk_seq.tokens[:chunk_seq.prefill_target],
                chunk_seq.prefill_target, chunk_seq.blocks)
        tok = self._pick_token(chunk_seq, outs, 0, base=2)
        self._emit(chunk_seq, tok)
        self._maybe_finish(chunk_seq, tok)

    # ------------------------------------------------------------------
    @staticmethod
    def _needs_logits(seq):
        return seq.temperature > 0 or seq.handle.logits is not None

    def _pick_token(self, seq, outs, row, logits_host=None, next_host=None,
                    base=0):
        """Greedy reads the on-device argmax output; temperature
        sampling reads the logits row on the host, with the sequence's
        own seeded numpy RNG (the JAX engine's draws, for the same
        seed).  ``base`` selects the output pair: 0 for the decode head,
        2 for the chunk head."""
        if self._needs_logits(seq):
            if logits_host is None:
                logits_host = outs[base].asnumpy()
            logits = logits_host[row]
            if seq.handle.logits is not None:
                seq.handle.logits.append(_np.array(logits, copy=True))
            if seq.temperature > 0:
                z = logits / max(seq.temperature, 1e-6)
                z = z - z.max()
                p = _np.exp(z)
                p /= p.sum()
                return int(seq.rng().choice(len(p), p=p))
            return int(logits.argmax())
        if next_host is None:
            next_host = outs[base + 1].asnumpy()
        return int(next_host[row])

    def _emit(self, seq, tok):
        now = time.monotonic()
        seq.tokens.append(tok)
        seq.last_token = tok
        if seq.t_first is None:
            seq.t_first = now
            ttft = (now - seq.t_submit) * 1e3
            seq.handle.ttft_ms = ttft
            TTFT_MS.observe(ttft)
            with self._cv:     # stats() reads these from other threads
                self._ttfts.append(ttft)
                self._ttft_steps.append(self._n_steps - seq.submit_step)
        seq.handle._emit(tok)
        self._n_tokens += 1
        TOKENS.inc()

    def _maybe_finish(self, seq, tok):
        if seq.eos_id is not None and tok == seq.eos_id:
            self._finish(seq, reason="eos")
        elif seq.n_generated >= seq.max_new_tokens:
            self._finish(seq, reason="length")
        elif seq.pos >= self._max_context:
            self._finish(seq, reason="context")

    def _finish(self, seq, reason=None, error=None):
        with self._cv:
            self._sched.release(seq)
        if error is None and reason == "cancelled":
            self._n_cancelled += 1
            CANCELLED.inc()
        elif error is None:
            self._n_completed += 1
            COMPLETED.inc()
        elif isinstance(error, DeadlineExceededError):
            self._n_expired += 1
            EXPIRED.inc()
        else:
            self._n_failed += 1
            FAILED.inc()
        seq.handle._finish(reason=reason, error=error)

    # ------------------------------------------------------------------
    def stop(self, drain=True, timeout=None):
        """Stop the engine; ``drain=True`` finishes queued work first,
        ``drain=False`` fails it with ``ServerClosedError``."""
        with self._cv:
            self._closing = True
            if not drain:
                self._abort = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            # a timed-out join leaves the loop running: keep _thread so
            # start() can't spawn a SECOND loop over the same slots
            if not self._thread.is_alive():
                self._thread = None

    # ------------------------------------------------------------------
    def stats(self):
        """Operational snapshot (the JAX engine's keys that apply)."""
        with self._cv:
            depth = len(self._sched.waiting)
            active = sum(1 for s in self._sched.slots if s is not None)
            ttfts = sorted(self._ttfts)
            ttft_steps = sorted(self._ttft_steps)
            step_ms = sorted(self._step_ms)
        n = self._n_steps
        return {
            "capacity": self.capacity,
            "queue_depth": depth,
            "active_sequences": active,
            "admitted": self._n_admitted,
            "completed": self._n_completed,
            "failed": self._n_failed,
            "expired": self._n_expired,
            "cancelled": self._n_cancelled,
            "tokens_generated": self._n_tokens,
            "steps": n,
            "prefills": self._n_prefills,
            "preemptions": self._n_preemptions,
            "mean_slot_occupancy": self._occ_sum / n if n else None,
            "mean_cache_occupancy": self._cache_occ_sum / n if n else None,
            "prefill_chunks": self._n_prefill_chunks,
            "prefill_chunks_per_iter": self._n_prefill_chunks / n if n
            else None,
            "chunk_tokens": self._chunk_tokens,
            "step_ms_p50": _percentile(step_ms, 0.5),
            "ttft_p99_ms": _percentile(ttfts, 0.99),
            "ttft_steps_p99": _percentile(ttft_steps, 0.99),
            "device": str(self._ctx),
            "cache": {
                "num_blocks": self.cache.num_blocks,
                "block_size": self.cache.block_size,
                "blocks_used": self.cache.used_count,
                "blocks_free": self.cache.free_count,
                "occupancy": round(self.cache.occupancy, 4),
                "prefix_sharing": self._prefix_cache,
                "prefix_hit_blocks":
                    self.cache.prefix_stats["hit_blocks"],
                "prefix_trie_blocks":
                    self.cache.prefix_stats["trie_blocks"],
            },
        }
