"""Decoder-only transformer LM (GPT-style, pre-LN): the training
symbol and the serving symbols.

Counterpart of ``mxnet_tpu/models/transformer.py`` ``get_symbol``,
``get_decode_step_symbol``, ``get_prefill_symbol``,
``get_mixed_step_symbol``, ``get_spec_step_symbol`` and
``get_draft_span_symbol``, with the same inputs, outputs and variable
names, so the JAX package's parameters bind unchanged in both
directions (``weights.convert_params`` / ``weights.export_params``) and
a model trained by the port serves in the port's ``DecodeEngine``.
The training symbol takes ``dtype='bfloat16'`` or ``'float16'`` as the
JAX package's does (the embeddings cast to the 16-bit type, the logits
back to f32; the weights the trunk meets infer it), and so do the five
serving symbols: their weights, LayerNorms and paged caches bind 16-bit,
their block tables, positions, offsets and lengths float32
(``shape_rules.INDEX_INPUTS``).  ``dropout > 0`` adds the reference's
three Dropout sites to the training graph (``embed_drop`` after the
embeddings' cast, ``layer%d_drop1`` on the attention's projection and
``layer%d_drop2`` on the FFN's, before each residual add).  MoE layers
and tensor parallelism come with later slices.
"""
from __future__ import annotations

from .. import initializer as _init
from .. import symbol as sym
from ..base import MXNetError, check_float_dtype

# the mixed step's per-iteration inputs; every other argument is a
# parameter or a cache
MIXED_STEP_INPUTS = ("data", "positions", "block_table", "chunk_data",
                     "chunk_positions", "chunk_start", "chunk_len",
                     "chunk_table")
SPEC_STEP_INPUTS = MIXED_STEP_INPUTS + ("span_start", "span_len")


def get_symbol(num_classes=16384, num_layers=12, d_model=2048, num_heads=16,
               ffn_dim=None, seq_len=1024, dtype="float32", dropout=0.0,
               moe_experts=0, moe_every=2, moe_aux_coeff=0.01,
               tensor_parallel=None, **kwargs):
    """The training graph: ``data`` (B, seq_len) token ids through the
    token and position embeddings, ``num_layers`` pre-LN blocks (LN ->
    FusedCausalSelfAttention -> residual, LN -> FFN with tanh-GELU ->
    residual), the final LN and the LM head, ending in SoftmaxOutput
    (``normalization='batch'``) over the (B * seq_len, vocab) logits
    with ``softmax_label`` (B * seq_len,) next-token targets.
    ``num_classes`` is the vocabulary size.  With ``dtype='bfloat16'``
    or ``'float16'`` the embedding sum is cast to that type before the
    first layer and the logits back to f32 before the softmax."""
    later = []
    if moe_experts:
        later.append("MoE layers (moe_experts=%s, ROADMAP A.8)" % moe_experts)
    if tensor_parallel:
        later.append("tensor_parallel=%r (multi-GPU, ROADMAP A.8)"
                     % (tensor_parallel,))
    if dtype not in ("float32", "bfloat16", "float16"):
        later.append("dtype=%r (ROADMAP A.1)" % (dtype,))
    if later:
        raise MXNetError("transformer.get_symbol: %s; not in the PyTorch "
                         "port yet" % "; ".join(later))
    vocab = int(num_classes)
    d = int(d_model)
    ffn = int(ffn_dim) if ffn_dim else 4 * d
    lp = float(dropout)

    data = sym.Variable("data")                      # (B, S) token ids
    tok = sym.Embedding(data, input_dim=vocab, output_dim=d,
                        name="tok_embed")
    pos = sym.Variable("pos_embed_weight", shape=(1, int(seq_len), d))
    x = _cast_in(sym.broadcast_add(tok, pos, name="embed_add"), dtype)
    if lp > 0:
        x = sym.Dropout(data=x, p=lp, name="embed_drop")

    for i in range(int(num_layers)):
        pre = "layer%d_" % i
        ln1 = sym.LayerNorm(data=x, name=pre + "ln1")
        proj = sym.contrib.FusedCausalSelfAttention(
            ln1,
            sym.Variable(pre + "qkv_weight"),
            sym.Variable(pre + "qkv_bias", init=_init.Zero()),
            sym.Variable(pre + "proj_weight"),
            sym.Variable(pre + "proj_bias", init=_init.Zero()),
            num_heads=int(num_heads), name=pre + "attn")
        if lp > 0:
            proj = sym.Dropout(data=proj, p=lp, name=pre + "drop1")
        x = x + proj
        ln2 = sym.LayerNorm(data=x, name=pre + "ln2")
        h = sym.FullyConnected(
            data=ln2, weight=sym.Variable(pre + "ffn_up_weight"),
            bias=sym.Variable(pre + "ffn_up_bias", init=_init.Zero()),
            num_hidden=ffn, flatten=False, name=pre + "ffn_up")
        h = sym.LeakyReLU(data=h, act_type="gelu_tanh", name=pre + "gelu")
        h = sym.FullyConnected(
            data=h, weight=sym.Variable(pre + "ffn_down_weight"),
            bias=sym.Variable(pre + "ffn_down_bias", init=_init.Zero()),
            num_hidden=d, flatten=False, name=pre + "ffn_down")
        if lp > 0:
            h = sym.Dropout(data=h, p=lp, name=pre + "drop2")
        x = x + h

    x = sym.LayerNorm(data=x, name="ln_f")
    logits = sym.FullyConnected(data=x, num_hidden=vocab, flatten=False,
                                name="lm_head")
    flat = sym.Reshape(data=_cast_out(logits, dtype), shape=(-1, vocab),
                       name="logits_2d")
    return sym.SoftmaxOutput(data=flat, name="softmax",
                             normalization="batch")


def _decode_trunk_vars(pre):
    """The attention sublayer's weight variables, training-graph names."""
    return (sym.Variable(pre + "qkv_weight"), sym.Variable(pre + "qkv_bias"),
            sym.Variable(pre + "proj_weight"),
            sym.Variable(pre + "proj_bias"))


def _ffn_vars(pre):
    """The post-attention sublayer's weight variables, training-graph
    names; created once per layer, so several streams over them bind
    ONE copy of every parameter."""
    return {name: sym.Variable(pre + name)
            for name in ("ln2_gamma", "ln2_beta", "ffn_up_weight",
                         "ffn_up_bias", "ffn_down_weight", "ffn_down_bias")}


def _decode_ffn(x, pre, d, ffn, w, tag=""):
    """Pre-LN FFN sublayer (inference form) over the weight variables
    ``w`` (:func:`_ffn_vars`); ``tag`` keeps the op names of
    several streams over one copy distinct."""
    ln2 = sym.LayerNorm(data=x, gamma=w["ln2_gamma"], beta=w["ln2_beta"],
                        name=pre + tag + "ln2")
    h = sym.FullyConnected(data=ln2, weight=w["ffn_up_weight"],
                           bias=w["ffn_up_bias"], num_hidden=ffn,
                           flatten=False, name=pre + tag + "ffn_up")
    h = sym.LeakyReLU(data=h, act_type="gelu_tanh", name=pre + tag + "gelu")
    return sym.FullyConnected(data=h, weight=w["ffn_down_weight"],
                              bias=w["ffn_down_bias"], num_hidden=d,
                              flatten=False, name=pre + tag + "ffn_down")


def _single_stream_trunk(x, attention, inputs, num_layers, d, ffn, H, D,
                         num_blocks, block_size):
    """The decode step's and the prefill's layer stack over the paged
    caches: per layer LN -> ``attention`` (a paged attention op fed
    ``inputs`` after the caches) -> residual -> FFN -> residual, then
    ``ln_f``.  Returns ``(x, new caches)``."""
    new_kv = []
    for i in range(int(num_layers)):
        pre = "layer%d_" % i
        ln1 = sym.LayerNorm(data=x, name=pre + "ln1")
        kc = sym.Variable(pre + "k_cache",
                          shape=(int(num_blocks), int(block_size), H, D))
        vc = sym.Variable(pre + "v_cache",
                          shape=(int(num_blocks), int(block_size), H, D))
        att = attention(ln1, *_decode_trunk_vars(pre), kc, vc, *inputs,
                        num_heads=H, name=pre + "attn")
        x = x + att[0]
        new_kv += [att[1], att[2]]
        x = x + _decode_ffn(x, pre, d, ffn, _ffn_vars(pre))
    return sym.LayerNorm(data=x, name="ln_f"), new_kv


def _cast_in(x, dtype, tag=""):
    """The embeddings cast to a 16-bit ``dtype`` (a no-op for f32)."""
    if dtype in ("float16", "bfloat16"):
        return sym.Cast(data=x, dtype=dtype, name=tag + "cast_embed")
    return x


def _cast_out(logits, dtype, tag=""):
    """The logits back in f32 after a 16-bit trunk."""
    if dtype in ("float16", "bfloat16"):
        return sym.Cast(data=logits, dtype="float32", name=tag + "cast_out")
    return logits


def _serving_only(fn_name, moe_experts, tensor_parallel=None,
                  dtype="float32"):
    """The serving symbols' options that come with later slices (they
    serve in float32, bfloat16 or float16)."""
    check_float_dtype(dtype, fn_name)
    if moe_experts:
        raise MXNetError("%s: MoE layers (moe_experts=%s) are not in the "
                         "PyTorch port yet (ROADMAP A.8)"
                         % (fn_name, moe_experts))
    if tensor_parallel:
        raise MXNetError("%s: tensor-parallel decode is not in the PyTorch "
                         "port yet (ROADMAP A.8)" % fn_name)


def get_decode_step_symbol(num_classes=16384, num_layers=12, d_model=2048,
                           num_heads=16, ffn_dim=None, seq_len=1024,
                           dtype="float32", block_size=16, num_blocks=64,
                           moe_experts=0, **kwargs):
    """One cached decode step over C batch slots.  Inputs: ``data``
    (C, 1) current token ids, ``positions`` (C, 1) their 0-based
    positions (< 0 = inactive slot), ``block_table`` (C, M), and the
    per-layer ``layer%d_k_cache`` / ``layer%d_v_cache`` paged caches
    (num_blocks, block_size, H, D), written in place.  Outputs:
    ``[logits (C, vocab), greedy next token (C,), caches...]``."""
    _serving_only("get_decode_step_symbol", moe_experts, dtype=dtype)
    vocab = int(num_classes)
    d = int(d_model)
    ffn = int(ffn_dim) if ffn_dim else 4 * d
    H = int(num_heads)
    D = d // H

    data = sym.Variable("data")                      # (C, 1) token ids
    positions = sym.Variable("positions")            # (C, 1)
    table = sym.Variable("block_table")              # (C, M)
    tok = sym.Embedding(data, input_dim=vocab, output_dim=d,
                        name="tok_embed")
    pos_w = sym.Variable("pos_embed_weight", shape=(1, int(seq_len), d))
    pe = sym.take(sym.Reshape(pos_w, shape=(int(seq_len), d)), positions,
                  name="pos_take")                   # (C, 1, d), clipped
    x, new_kv = _single_stream_trunk(
        _cast_in(tok + pe, dtype), sym.contrib.PagedDecodeAttention,
        (table, positions), num_layers, d, ffn, H, D, num_blocks,
        block_size)
    logits = sym.FullyConnected(data=x, num_hidden=vocab, flatten=False,
                                name="lm_head")      # (C, 1, vocab)
    flat = sym.Reshape(data=_cast_out(logits, dtype), shape=(-1, vocab),
                       name="logits_2d")
    nxt = sym.argmax(flat, axis=1, name="greedy_token")
    return sym.Group([flat, nxt] + new_kv)


def get_prefill_symbol(num_classes=16384, num_layers=12, d_model=2048,
                       num_heads=16, ffn_dim=None, seq_len=1024,
                       prefill_len=None, dtype="float32", block_size=16,
                       num_blocks=64, moe_experts=0, **kwargs):
    """The prompt-phase forward that fills the paged KV cache in one
    launch per layer.  ``prefill_len`` is the padded prompt length S
    (default ``seq_len``).  Inputs: ``data`` (B, S) padded prompt ids,
    ``prompt_len`` (B,) real lengths, ``block_table`` (B, M), and the
    decode step's cache variables.  Outputs: ``[last-token logits
    (B, vocab), greedy next token (B,), caches...]``.  Bound beside the
    decode step with ``simple_bind(shared_exec=...)``, the two share
    the weights and the caches."""
    _serving_only("get_prefill_symbol", moe_experts, dtype=dtype)
    vocab = int(num_classes)
    d = int(d_model)
    ffn = int(ffn_dim) if ffn_dim else 4 * d
    H = int(num_heads)
    D = d // H
    S = int(prefill_len) if prefill_len else int(seq_len)
    if S > int(seq_len):
        raise MXNetError("prefill_len %d exceeds the position-embedding "
                         "range seq_len=%d" % (S, int(seq_len)))

    data = sym.Variable("data")                      # (B, S) token ids
    lengths = sym.Variable("prompt_len")             # (B,)
    table = sym.Variable("block_table")              # (B, M)
    tok = sym.Embedding(data, input_dim=vocab, output_dim=d,
                        name="tok_embed")
    pos_w = sym.Variable("pos_embed_weight", shape=(1, int(seq_len), d))
    pe = pos_w.slice_axis(axis=1, begin=0, end=S)
    x, new_kv = _single_stream_trunk(
        _cast_in(sym.broadcast_add(tok, pe, name="embed_add"), dtype),
        sym.contrib.PagedPrefillAttention, (table, lengths), num_layers, d,
        ffn, H, D, num_blocks, block_size)
    last = sym.contrib.GatherTimestep(x, lengths - 1, name="last_token")
    logits = sym.FullyConnected(data=last, num_hidden=vocab, flatten=False,
                                name="lm_head")      # (B, vocab)
    logits = _cast_out(logits, dtype)
    nxt = sym.argmax(logits, axis=1, name="greedy_token")
    return sym.Group([logits, nxt] + new_kv)


def get_mixed_step_symbol(num_classes=16384, num_layers=12, d_model=2048,
                          num_heads=16, ffn_dim=None, seq_len=1024,
                          dtype="float32", block_size=16, num_blocks=64,
                          moe_experts=0, tensor_parallel=None, **kwargs):
    """ONE decode iteration with chunked prefill fused in: up to K
    prefill-chunk tokens of one admitted prompt AND one decode token for
    every active slot, in one forward.

    Decode stream: ``data`` (C, 1), ``positions`` (C, 1) (< 0 =
    inactive), ``block_table`` (C, M).  Chunk stream: ``chunk_data``
    (1, K), ``chunk_positions`` (1, K), ``chunk_start`` (1,),
    ``chunk_len`` (1,) (0 disables the stream for the iteration) and
    ``chunk_table`` (1, M).  Per layer ``layer%d_k_cache`` /
    ``layer%d_v_cache`` (num_blocks, block_size, H, D) caches; the decode
    scatter writes them before the chunk reads and writes them.
    Outputs: ``[decode logits (C, vocab), decode greedy token (C,),
    chunk last-token logits (1, vocab), chunk greedy token (1,), new
    caches...]``."""
    _serving_only("get_mixed_step_symbol", moe_experts, tensor_parallel,
                  dtype)
    return _two_stream_step(False, num_classes, num_layers, d_model,
                            num_heads, ffn_dim, seq_len, dtype, block_size,
                            num_blocks)


def get_spec_step_symbol(num_classes=16384, num_layers=12, d_model=2048,
                         num_heads=16, ffn_dim=None, seq_len=1024,
                         dtype="float32", block_size=16, num_blocks=64,
                         moe_experts=0, tensor_parallel=None, **kwargs):
    """The mixed step with draft-verify spans in place of single decode
    tokens (speculative decoding): every slot scores an S-token span,
    its last committed token followed by up to S-1 draft tokens, in the
    same forward as the prefill chunk.

    Span stream: ``data`` (C, S) span token ids, ``positions`` (C, S)
    their absolute positions, ``span_start`` (C,) each row's cache
    offset, ``span_len`` (C,) its real tokens (0 = inactive slot) and
    ``block_table`` (C, M), through ``PagedChunkPrefillAttention`` with
    per-row starts and lengths: the span's K/V rows are written at
    ``span_start + j`` and row j attends the slot's whole cache prefix
    plus span tokens <= j, which is verification.  Rows a later step
    rejects stay above the accepted prefix and are overwritten by the
    next span before any query can see them.  The chunk stream is the
    mixed step's, reading the caches after the span's writes.

    Outputs: ``[span logits (C*S, vocab), span greedy tokens (C*S,),
    chunk last-token logits (1, vocab), chunk greedy token (1,), new
    caches...]``; row ``r*S + j`` is slot r, span offset j."""
    _serving_only("get_spec_step_symbol", moe_experts, tensor_parallel,
                  dtype)
    return _two_stream_step(True, num_classes, num_layers, d_model,
                            num_heads, ffn_dim, seq_len, dtype, block_size,
                            num_blocks)


def _two_stream_step(spans, num_classes, num_layers, d_model, num_heads,
                     ffn_dim, seq_len, dtype, block_size, num_blocks):
    """The mixed step (``spans`` False: one decode token per slot) or
    the spec step (``spans`` True: a span per slot through the chunk
    attention); both share every weight between their two streams."""
    vocab = int(num_classes)
    d = int(d_model)
    ffn = int(ffn_dim) if ffn_dim else 4 * d
    H = int(num_heads)
    D = d // H

    data = sym.Variable("data")                      # (C, 1) or (C, S) ids
    positions = sym.Variable("positions")            # (C, 1) or (C, S)
    if spans:
        sstart = sym.Variable("span_start")          # (C,)
        slen = sym.Variable("span_len")              # (C,) 0 = inactive
    table = sym.Variable("block_table")              # (C, M)
    cdata = sym.Variable("chunk_data")               # (1, K) chunk ids
    cpos = sym.Variable("chunk_positions")           # (1, K) absolute
    cstart = sym.Variable("chunk_start")             # (1,)
    clen = sym.Variable("chunk_len")                 # (1,)
    ctable = sym.Variable("chunk_table")             # (1, M)

    tokw = sym.Variable("tok_embed_weight")
    pos_w = sym.Variable("pos_embed_weight", shape=(1, int(seq_len), d))
    pos_flat = sym.Reshape(pos_w, shape=(int(seq_len), d))

    tok = sym.Embedding(data, tokw, input_dim=vocab, output_dim=d,
                        name="tok_embed")
    x = tok + sym.take(pos_flat, positions, name="pos_take")
    ctok = sym.Embedding(cdata, tokw, input_dim=vocab, output_dim=d,
                         name="c_tok_embed")
    xc = ctok + sym.take(pos_flat, cpos, name="c_pos_take")
    x, xc = _cast_in(x, dtype), _cast_in(xc, dtype, "c_")

    new_kv = []
    for i in range(int(num_layers)):
        pre = "layer%d_" % i
        attn_vars = _decode_trunk_vars(pre)
        ln1_g = sym.Variable(pre + "ln1_gamma")
        ln1_b = sym.Variable(pre + "ln1_beta")
        kc = sym.Variable(pre + "k_cache",
                          shape=(int(num_blocks), int(block_size), H, D))
        vc = sym.Variable(pre + "v_cache",
                          shape=(int(num_blocks), int(block_size), H, D))

        ln1 = sym.LayerNorm(data=x, gamma=ln1_g, beta=ln1_b,
                            name=pre + "ln1")
        if spans:
            att = sym.contrib.PagedChunkPrefillAttention(
                ln1, *attn_vars, kc, vc, table, sstart, slen,
                num_heads=H, name=pre + "attn")
        else:
            att = sym.contrib.PagedDecodeAttention(
                ln1, *attn_vars, kc, vc, table, positions,
                num_heads=H, name=pre + "attn")
        x = x + att[0]

        # the chunk reads/writes the cache AFTER the decode (or span)
        # scatter; the block tables are disjoint (a sequence is either
        # prefilling or decoding in one step), so the streams never
        # alias a block
        cln1 = sym.LayerNorm(data=xc, gamma=ln1_g, beta=ln1_b,
                             name=pre + "c_ln1")
        catt = sym.contrib.PagedChunkPrefillAttention(
            cln1, *attn_vars, att[1], att[2], ctable, cstart, clen,
            num_heads=H, name=pre + "c_attn")
        xc = xc + catt[0]
        new_kv += [catt[1], catt[2]]

        shared = _ffn_vars(pre)
        x = x + _decode_ffn(x, pre, d, ffn, shared)
        xc = xc + _decode_ffn(xc, pre, d, ffn, shared, tag="c_")

    lnf_g = sym.Variable("ln_f_gamma")
    lnf_b = sym.Variable("ln_f_beta")
    lmw = sym.Variable("lm_head_weight")
    lmb = sym.Variable("lm_head_bias")

    x = sym.LayerNorm(data=x, gamma=lnf_g, beta=lnf_b, name="ln_f")
    logits = sym.FullyConnected(data=x, weight=lmw, bias=lmb,
                                num_hidden=vocab, flatten=False,
                                name="lm_head")      # (C, 1 or S, vocab)
    flat = sym.Reshape(data=_cast_out(logits, dtype), shape=(-1, vocab),
                       name="logits_2d")
    nxt = sym.argmax(flat, axis=1, name="greedy_token")

    xc = sym.LayerNorm(data=xc, gamma=lnf_g, beta=lnf_b, name="c_ln_f")
    clast = sym.contrib.GatherTimestep(xc, clen - 1, name="c_last_token")
    clogits = sym.FullyConnected(data=clast, weight=lmw, bias=lmb,
                                 num_hidden=vocab, flatten=False,
                                 name="c_lm_head")   # (1, vocab)
    clogits = _cast_out(clogits, dtype, "c_")
    cnxt = sym.argmax(clogits, axis=1, name="c_greedy_token")
    return sym.Group([flat, nxt, clogits, cnxt] + new_kv)


def get_draft_span_symbol(draft_k, num_classes=16384, num_layers=12,
                          d_model=2048, num_heads=16, ffn_dim=None,
                          seq_len=1024, dtype="float32", moe_experts=0,
                          **kwargs):
    """One forward that proposes ``draft_k`` greedy draft tokens: the
    draft model's K autoregressive full forwards unrolled into one
    graph, every iteration binding ONE copy of every weight.  Inputs:
    ``data`` (1, seq_len) the left-aligned, zero-padded history,
    ``length`` (1,) its real token count n, ``iota`` (1, seq_len) the
    row ``arange(seq_len)`` (absent when K == 1).  Iteration j reads
    the hidden row at ``n + j - 1``, takes its greedy token and writes
    it into ``data`` at ``n + j`` by an iota-mask blend, so token j+1
    conditions on token j without leaving the device.  Output: the (K,)
    proposed token ids.  The causal mask keeps the padded tail out of
    every row that is read."""
    _serving_only("get_draft_span_symbol", moe_experts, dtype=dtype)
    vocab = int(num_classes)
    d = int(d_model)
    ffn = int(ffn_dim) if ffn_dim else 4 * d
    H = int(num_heads)
    S = int(seq_len)
    K = int(draft_k)
    if K < 1:
        raise MXNetError("get_draft_span_symbol: draft_k must be >= 1")

    data = sym.Variable("data")                      # (1, S) history ids
    length = sym.Variable("length")                  # (1,) real count
    iota = sym.Variable("iota")                      # (1, S) arange(S)

    tokw = sym.Variable("tok_embed_weight")
    pos_w = sym.Variable("pos_embed_weight", shape=(1, S, d))
    lnf_g = sym.Variable("ln_f_gamma")
    lnf_b = sym.Variable("ln_f_beta")
    lmw = sym.Variable("lm_head_weight")
    lmb = sym.Variable("lm_head_bias")
    layers = []
    for i in range(int(num_layers)):
        pre = "layer%d_" % i
        layers.append({"pre": pre,
                       "ln1_g": sym.Variable(pre + "ln1_gamma"),
                       "ln1_b": sym.Variable(pre + "ln1_beta"),
                       "attn": _decode_trunk_vars(pre),
                       "ffn": _ffn_vars(pre)})

    toks = []
    for j in range(K):
        tag = "d%d_" % j
        tok = sym.Embedding(data, tokw, input_dim=vocab, output_dim=d,
                            name=tag + "tok_embed")
        x = _cast_in(sym.broadcast_add(tok, pos_w, name=tag + "embed_add"),
                     dtype, tag)
        for ly in layers:
            pre = ly["pre"]
            ln1 = sym.LayerNorm(data=x, gamma=ly["ln1_g"], beta=ly["ln1_b"],
                                name=pre + tag + "ln1")
            x = x + sym.contrib.FusedCausalSelfAttention(
                ln1, *ly["attn"], num_heads=H, name=pre + tag + "attn")
            x = x + _decode_ffn(x, pre, d, ffn, ly["ffn"], tag=tag)
        x = sym.LayerNorm(data=x, gamma=lnf_g, beta=lnf_b,
                          name=tag + "ln_f")
        # the greedy token after n + j tokens is read from row n + j - 1
        last = sym.contrib.GatherTimestep(x, length + (float(j) - 1.0),
                                          name=tag + "last_token")
        logits = sym.FullyConnected(data=last, weight=lmw, bias=lmb,
                                    num_hidden=vocab,
                                    name=tag + "lm_head")  # (1, vocab)
        logits = _cast_out(logits, dtype, tag)
        nxt = sym.argmax(logits, axis=1, name=tag + "greedy")   # (1,)
        toks.append(nxt)
        if j + 1 < K:
            # write the token at position n + j: data += mask * (t - data)
            posj = sym.Reshape(length + float(j), shape=(1, 1),
                               name=tag + "pos2d")
            onehot = sym.broadcast_equal(iota, posj, name=tag + "onehot")
            tok2d = sym.Reshape(nxt, shape=(1, 1), name=tag + "tok2d")
            data = data + onehot * (tok2d - data)

    return sym.Concat(*toks, dim=0, name="draft_tokens")    # (K,)
