"""Draft proposers for draft-verify (speculative) decoding.

Counterpart of ``mxnet_tpu/decode/spec.py``.  Each serving iteration
splits into a cheap PROPOSE and an exact VERIFY: a drafter guesses the
next K tokens of a stream, the target model scores all K+1 positions in
one forward of the spec step (``models.transformer.get_spec_step_symbol``,
run by ``engine.DecodeEngine._step_spec``), and the longest prefix of
the draft that matches the target's own greedy choices is committed.
Under greedy acceptance every emitted token is one the target would
have produced one at a time: speculation changes tokens per launch,
never the stream.

Two drafters:

* :class:`NGramDrafter` (the default): self-speculative prompt lookup,
  matching the stream's trailing n-gram against its own earlier tokens
  and proposing what followed.  Host-side integer matching, no device
  work and no extra weights.
* :class:`DraftModelDrafter`: a draft transformer with the target's
  weight names, proposing a K-token span in one forward of the unrolled
  draft program (``get_draft_span_symbol``) and one K-int readback.

``choose_spec_impl`` resolves the ``auto|ngram|draft|off`` knob:
``auto`` takes the draft model when a checkpoint was given and the
n-gram drafter otherwise; forcing ``draft`` without one raises.  Under
``auto`` a draft checkpoint that fails the weight check (a missing or
misshapen parameter, :class:`DraftWeightsError`) falls back to the
n-gram drafter and bumps ``decode_spec_fallbacks``; no other error is
caught.
"""
from __future__ import annotations

import numpy as _np

from ..telemetry import REGISTRY

__all__ = ["Drafter", "NGramDrafter", "DraftModelDrafter",
           "DraftWeightsError", "choose_spec_impl", "make_drafter"]

SPEC_PROPOSED = REGISTRY.counter(
    "decode_spec_proposed", "draft tokens proposed for verification")
SPEC_ACCEPTED = REGISTRY.counter(
    "decode_spec_accepted", "draft tokens accepted by target-model "
    "verification (committed to streams)")
SPEC_FALLBACKS = REGISTRY.counter(
    "decode_spec_fallbacks", "auto-mode draft-model selections that fell "
    "back to the n-gram drafter (the draft checkpoint failed the weight "
    "check)")
ACCEPT_RATE = REGISTRY.gauge(
    "decode_accept_rate", "accepted/proposed draft-token ratio over the "
    "engine's lifetime", unit="ratio")
TOKENS_PER_LAUNCH = REGISTRY.gauge(
    "decode_tokens_per_launch", "tokens committed per decode launch (1.0 "
    "= non-speculative)", unit="tokens")


class DraftWeightsError(ValueError):
    """A draft checkpoint lacks a parameter the draft model binds, or
    holds one of another shape."""


def choose_spec_impl(impl, has_draft_model, *,
                     env_var="MXNET_DECODE_SPEC_IMPL"):
    """Resolve the drafter knob ``impl`` (``auto|ngram|draft|off``) to
    ``"ngram"``, ``"draft"`` or ``None`` (speculation off).  Forcing
    ``draft`` without a draft checkpoint raises ``ValueError``, as does
    an unknown value."""
    if impl == "off":
        return None
    if impl not in ("auto", "ngram", "draft"):
        raise ValueError("%s=%s; use auto|ngram|draft|off" % (env_var, impl))
    if impl == "draft":
        if not has_draft_model:
            raise ValueError(
                "%s=draft but no draft checkpoint was provided "
                "(DecodeEngine(draft_params=..., draft_config=...))"
                % env_var)
        return "draft"
    if impl == "ngram":
        return "ngram"
    return "draft" if has_draft_model else "ngram"


class Drafter:
    """Proposer interface: ``propose(tokens, k)`` returns up to ``k``
    guessed continuation ids for a stream whose whole history (prompt
    and generated tokens) is ``tokens``.  Proposals are hints: the
    verify step keeps only the prefix the target model agrees with."""

    name = "null"

    def propose(self, tokens, k):
        return []


class NGramDrafter(Drafter):
    """Prompt lookup: find the most recent earlier occurrence of the
    stream's trailing n-gram (the longest ``n`` in ``[min_n, max_n]``
    wins) and propose the tokens that followed it, within the last
    ``window`` tokens."""

    name = "ngram"

    def __init__(self, max_n=3, min_n=1, window=1024):
        if not (1 <= int(min_n) <= int(max_n)):
            raise ValueError("NGramDrafter: need 1 <= min_n <= max_n")
        self.max_n = int(max_n)
        self.min_n = int(min_n)
        self.window = int(window)

    def propose(self, tokens, k):
        k = int(k)
        hist = [int(t) for t in tokens[-self.window:]]
        n_hist = len(hist)
        for n in range(min(self.max_n, n_hist - 1), self.min_n - 1, -1):
            tail = hist[n_hist - n:]
            for i in range(n_hist - n - 1, -1, -1):
                if hist[i:i + n] == tail:
                    cont = hist[i + n:i + n + k]
                    if cont:
                        return cont
        return []


class DraftModelDrafter(Drafter):
    """Draft-transformer proposer over ``get_draft_span_symbol``: the
    K-step greedy draft loop unrolled into one graph, bound lazily per
    span length K at the fixed ``(1, seq_len)`` geometry (the engine
    proposes at its ``spec_k``, fewer only near a stream's end).  The
    history is left-aligned and zero-padded, trimmed to ``seq_len - K``
    tokens so every write-back stays in range.  The weights are checked
    at construction (:class:`DraftWeightsError`) and copied onto the
    device once: every later K binds with ``shared_exec`` over the
    first executor's weights.  With ``donate`` (the engine's
    ``MXNET_DECODE_DONATE``) each executor donates the history it
    consumes (``Executor.donate_args``), so on the card a ``propose``
    is one replay of its K's captured graph; the executors share one
    graph pool (``shared_exec``), each proposal read back at once."""

    name = "draft"

    def __init__(self, arg_params, model_config, ctx=None, donate=True):
        from ..context import current_context
        from ..models import transformer
        from ..weights import symbol_shapes

        self._cfg = dict(model_config)
        self._cfg.pop("dropout", None)
        self._seq_len = int(self._cfg.get("seq_len", 1024))
        self._ctx = ctx if ctx is not None else current_context()
        self._tf = transformer
        # the weight names and shapes do not depend on K
        want, _ = symbol_shapes(transformer.get_draft_span_symbol(
            1, **self._cfg), data=(1, self._seq_len), length=(1,))
        arg_params = arg_params or {}
        missing = [n for n in sorted(want) if n not in arg_params]
        if missing:
            raise DraftWeightsError("draft checkpoint missing params: %s"
                                    % ", ".join(missing[:4]))
        bad = [n for n in sorted(want)
               if tuple(_np.shape(arg_params[n])) != want[n]]
        if bad:
            raise DraftWeightsError("draft checkpoint params of another "
                                    "shape: %s" % ", ".join(bad[:4]))
        self._params = {n: arg_params[n] for n in want}
        self._exes = {}                    # span K -> bound executor
        self._donate = bool(donate)
        self._iota = _np.arange(self._seq_len,
                                dtype=_np.float32).reshape(1, -1)

    def _span_exe(self, k):
        exe = self._exes.get(k)
        if exe is None:
            dsym = self._tf.get_draft_span_symbol(k, **self._cfg)
            shapes = {"data": (1, self._seq_len), "length": (1,)}
            if "iota" in dsym.list_arguments():   # absent when K == 1
                shapes["iota"] = (1, self._seq_len)
            first = next(iter(self._exes.values()), None)
            exe = dsym.simple_bind(ctx=self._ctx, grad_req="null",
                                   shared_exec=first, **shapes)
            if first is None:
                exe.copy_params_from(self._params)
            if self._donate:
                exe.donate_args(("data",))
            self._exes[k] = exe
        return exe

    def warmup(self, k_max):
        """Propose once at every span length ``k_max..1`` (binding, and
        on the card capturing, each K's program) on a one-token
        history."""
        for k in range(min(int(k_max), self._seq_len - 1), 0, -1):
            self.propose([0], k)

    def propose(self, tokens, k):
        k = int(k)
        if k < 1 or k >= self._seq_len:
            return []
        ctx_toks = [int(t) for t in tokens][-(self._seq_len - k):]
        n = len(ctx_toks)
        if n == 0:
            return []
        data = _np.zeros((1, self._seq_len), _np.float32)
        data[0, :n] = ctx_toks
        exe = self._span_exe(k)
        feeds = {"data": data, "length": _np.array([n], _np.float32)}
        if "iota" in exe.arg_dict:
            feeds["iota"] = self._iota
        out = exe.forward(is_train=False, **feeds)[0]
        return [int(t) for t in out.asnumpy().reshape(-1)[:k]]


def make_drafter(impl, draft_params=None, draft_config=None, ctx=None,
                 forced=False, donate=True):
    """The resolved drafter.  Under ``auto`` (``forced=False``) a draft
    checkpoint that fails the weight check degrades to the n-gram
    drafter and bumps ``decode_spec_fallbacks``; a forced draft model
    raises.  ``donate``: the draft model's forwards are captured."""
    if impl is None:
        return None
    if impl == "ngram":
        return NGramDrafter()
    try:
        return DraftModelDrafter(draft_params, draft_config, ctx=ctx,
                                 donate=donate)
    except DraftWeightsError:
        if forced:
            raise
        SPEC_FALLBACKS.inc()
        return NGramDrafter()
