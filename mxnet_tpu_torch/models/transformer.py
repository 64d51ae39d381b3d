"""Decoder-only transformer LM (GPT-style, pre-LN): the training
symbol and the mixed decode step.

Counterpart of ``mxnet_tpu/models/transformer.py`` ``get_symbol`` and
``get_mixed_step_symbol``, with the same variable names and ``init=``
attributes, so the JAX package's parameters bind unchanged in both
directions (``weights.convert_params`` / ``weights.export_params``) and
a model trained by the port serves in the port's ``DecodeEngine``.
MoE layers, tensor parallelism, bf16 and dropout come with later
slices.
"""
from __future__ import annotations

from .. import initializer as _init
from .. import symbol as sym
from ..base import MXNetError

# the mixed step's per-iteration inputs; every other argument is a
# parameter or a cache
MIXED_STEP_INPUTS = ("data", "positions", "block_table", "chunk_data",
                     "chunk_positions", "chunk_start", "chunk_len",
                     "chunk_table")


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
    ``num_classes`` is the vocabulary size."""
    later = []
    if moe_experts:
        later.append("MoE layers (moe_experts=%s): the MoE slice" % moe_experts)
    if tensor_parallel:
        later.append("tensor_parallel=%r: the multi-GPU slice"
                     % (tensor_parallel,))
    if dtype != "float32":
        later.append("dtype=%r: the bf16 training slice" % (dtype,))
    if float(dropout) > 0:
        later.append("dropout=%s: the Dropout op comes with the vision "
                     "training slice" % dropout)
    if later:
        raise MXNetError("transformer.get_symbol: %s; not in the PyTorch "
                         "port yet (ROADMAP)" % "; ".join(later))
    vocab = int(num_classes)
    d = int(d_model)
    ffn = int(ffn_dim) if ffn_dim else 4 * d

    data = sym.Variable("data")                      # (B, S) token ids
    tok = sym.Embedding(data, input_dim=vocab, output_dim=d,
                        name="tok_embed")
    pos = sym.Variable("pos_embed_weight", shape=(1, int(seq_len), d))
    x = sym.broadcast_add(tok, pos, name="embed_add")

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
        x = x + h

    x = sym.LayerNorm(data=x, name="ln_f")
    logits = sym.FullyConnected(data=x, num_hidden=vocab, flatten=False,
                                name="lm_head")
    flat = sym.Reshape(data=logits, shape=(-1, vocab), name="logits_2d")
    return sym.SoftmaxOutput(data=flat, name="softmax",
                             normalization="batch")


def _decode_trunk_vars(pre):
    """The attention sublayer's weight variables, training-graph names."""
    return (sym.Variable(pre + "qkv_weight"), sym.Variable(pre + "qkv_bias"),
            sym.Variable(pre + "proj_weight"),
            sym.Variable(pre + "proj_bias"))


def _ffn_shared_vars(pre):
    """The post-attention sublayer's weights, created once so the mixed
    step's two streams bind ONE copy of every parameter."""
    return {name: sym.Variable(pre + name)
            for name in ("ln2_gamma", "ln2_beta", "ffn_up_weight",
                         "ffn_up_bias", "ffn_down_weight", "ffn_down_bias")}


def _decode_ffn(x, pre, d, ffn, shared, tag=""):
    """Pre-LN FFN sublayer (inference form); ``tag`` keeps the second
    stream's op names distinct."""
    ln2 = sym.LayerNorm(data=x, gamma=shared["ln2_gamma"],
                        beta=shared["ln2_beta"], name=pre + tag + "ln2")
    h = sym.FullyConnected(data=ln2, weight=shared["ffn_up_weight"],
                           bias=shared["ffn_up_bias"], num_hidden=ffn,
                           flatten=False, name=pre + tag + "ffn_up")
    h = sym.LeakyReLU(data=h, act_type="gelu_tanh", name=pre + tag + "gelu")
    return sym.FullyConnected(data=h, weight=shared["ffn_down_weight"],
                              bias=shared["ffn_down_bias"], num_hidden=d,
                              flatten=False, name=pre + tag + "ffn_down")


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
    if moe_experts:
        raise MXNetError("MoE layers (moe_experts=%s) are not in the PyTorch "
                         "port yet" % moe_experts)
    if tensor_parallel:
        raise MXNetError("tensor-parallel decode is not in the PyTorch port "
                         "yet")
    vocab = int(num_classes)
    d = int(d_model)
    ffn = int(ffn_dim) if ffn_dim else 4 * d
    H = int(num_heads)
    D = d // H

    data = sym.Variable("data")                      # (C, 1) token ids
    positions = sym.Variable("positions")            # (C, 1)
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
    if dtype in ("float16", "bfloat16"):
        x = sym.Cast(data=x, dtype=dtype, name="cast_embed")
        xc = sym.Cast(data=xc, dtype=dtype, name="c_cast_embed")

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
        att = sym.contrib.PagedDecodeAttention(
            ln1, *attn_vars, kc, vc, table, positions,
            num_heads=H, name=pre + "attn")
        x = x + att[0]

        # the chunk reads/writes the cache AFTER the decode scatter; the
        # block tables are disjoint (a sequence is either prefilling or
        # decoding in one step), so the streams never alias a block
        cln1 = sym.LayerNorm(data=xc, gamma=ln1_g, beta=ln1_b,
                             name=pre + "c_ln1")
        catt = sym.contrib.PagedChunkPrefillAttention(
            cln1, *attn_vars, att[1], att[2], ctable, cstart, clen,
            num_heads=H, name=pre + "c_attn")
        xc = xc + catt[0]
        new_kv += [catt[1], catt[2]]

        shared = _ffn_shared_vars(pre)
        x = x + _decode_ffn(x, pre, d, ffn, shared)
        xc = xc + _decode_ffn(xc, pre, d, ffn, shared, tag="c_")

    lnf_g = sym.Variable("ln_f_gamma")
    lnf_b = sym.Variable("ln_f_beta")
    lmw = sym.Variable("lm_head_weight")
    lmb = sym.Variable("lm_head_bias")

    x = sym.LayerNorm(data=x, gamma=lnf_g, beta=lnf_b, name="ln_f")
    logits = sym.FullyConnected(data=x, weight=lmw, bias=lmb,
                                num_hidden=vocab, flatten=False,
                                name="lm_head")      # (C, 1, vocab)
    if dtype in ("float16", "bfloat16"):
        logits = sym.Cast(data=logits, dtype="float32", name="cast_out")
    flat = sym.Reshape(data=logits, shape=(-1, vocab), name="logits_2d")
    nxt = sym.argmax(flat, axis=1, name="greedy_token")

    xc = sym.LayerNorm(data=xc, gamma=lnf_g, beta=lnf_b, name="c_ln_f")
    clast = sym.contrib.GatherTimestep(xc, clen - 1, name="c_last_token")
    clogits = sym.FullyConnected(data=clast, weight=lmw, bias=lmb,
                                 num_hidden=vocab, flatten=False,
                                 name="c_lm_head")   # (1, vocab)
    if dtype in ("float16", "bfloat16"):
        clogits = sym.Cast(data=clogits, dtype="float32",
                           name="c_cast_out")
    cnxt = sym.argmax(clogits, axis=1, name="c_greedy_token")
    return sym.Group([flat, nxt, clogits, cnxt] + new_kv)
