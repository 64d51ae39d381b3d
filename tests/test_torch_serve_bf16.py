"""PyTorch port: bf16 serving (ROADMAP A.1) held against the JAX package.

The five serving symbols with ``dtype='bfloat16'`` (bf16 weights,
LayerNorms and paged caches; f32 embeddings and logits), the decode
engine on the mixed step, speculative decoding (n-gram and draft model),
preemption, the prefill/decode-step pair and the weight swap, at
tests/test_decode.py's tiny config.  Both packages get the same numpy
weights; the JAX side runs its Pallas kernels in interpret mode, the
port's wrappers take their plain versions on CPU tensors.

Bounds: greedy streams equal; logits (compared where both streams hold
the same tokens, i.e. under teacher forcing) within relative L2 2e-2,
the bound chip_smoke.py's bf16 agreement phases use; caches within one
bf16 ulp at the cache's scale (``_ulps``); attention outputs of the plain versions against the Pallas
kernels at rtol 2^-7 (one bf16 ulp of the value) / atol 1e-5, each
rounding an f32 result to bf16 once.

Index inputs (block tables, positions, chunk and span offsets and
lengths) stay f32 in the port, where the JAX package's same-type rule
makes them bf16; bf16 rounds integers above 256.  Every tiny config
here keeps block ids and offsets below 256, so the two packages still
agree; the port's own behaviour above 256 has a test of its own.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.decode import DecodeEngine as JaxEngine
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.pallas import paged_chunk_prefill_attend as jax_chunk
from mxnet_tpu.pallas import paged_prefill_attend as jax_prefill

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.decode import DecodeEngine
from mxnet_tpu_torch.kernels import (paged_chunk_prefill_attend,
                                     paged_prefill_attend)
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.weights import convert_params, param_shapes

CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2, seq_len=48,
           dtype="bfloat16")
ENGINE = dict(capacity=3, block_size=4, num_blocks=36, chunk_tokens=8)
LOGITS_L2 = 2e-2
OUT_RTOL, OUT_ATOL = 2.0 ** -7, 1e-5
# the serving symbols' index inputs: f32 in the port
INDEX = {"block_table", "positions", "prompt_len", "chunk_positions",
         "chunk_start", "chunk_len", "chunk_table", "span_start", "span_len",
         "length"}
M = 12
_SYMBOLS = {
    "decode_step": (lambda m, **kw: m.get_decode_step_symbol(**kw),
                    dict(data=(3, 1), positions=(3, 1), block_table=(3, M))),
    "prefill": (lambda m, **kw: m.get_prefill_symbol(prefill_len=16, **kw),
                dict(data=(3, 16), prompt_len=(3,), block_table=(3, M))),
    "mixed_step": (lambda m, **kw: m.get_mixed_step_symbol(**kw),
                   dict(data=(3, 1), positions=(3, 1), block_table=(3, M),
                        chunk_data=(1, 8), chunk_positions=(1, 8),
                        chunk_start=(1,), chunk_len=(1,),
                        chunk_table=(1, M))),
    "spec_step": (lambda m, **kw: m.get_spec_step_symbol(**kw),
                  dict(data=(3, 4), positions=(3, 4), block_table=(3, M),
                       chunk_data=(1, 8), chunk_positions=(1, 8),
                       chunk_start=(1,), chunk_len=(1,), chunk_table=(1, M),
                       span_start=(3,), span_len=(3,))),
    "draft_span": (lambda m, **kw: m.get_draft_span_symbol(
        3, **{k: v for k, v in kw.items() if "block" not in k}),
        dict(data=(1, 48), length=(1,), iota=(1, 48))),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tensors here are tiny and gain nothing from many intra-op
    threads; two keep this file off the cores that timing-sensitive
    tests running beside it in other workers measure."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas(monkeypatch):
    """The JAX engine traces its step at the first dispatch, on its own
    thread, so the Pallas knobs stay set for the whole test."""
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


@pytest.fixture(scope="module")
def np_params():
    rng = np.random.RandomState(7)
    return {n: rng.normal(0, 0.1, s).astype(np.float32)
            for n, s in param_shapes(CFG).items()}


@pytest.fixture(scope="module")
def params(np_params):
    return convert_params(np_params, mx.cpu(), CFG)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16(a):
    """A numpy array (f32, or the JAX package's bf16) as a bf16 tensor;
    bf16 values are exact in f32."""
    return torch.from_numpy(np.asarray(a).astype(np.float32)) \
        .to(torch.bfloat16)


def _ulps(a, b):
    """The largest difference between two bf16 caches in bf16 ulps at
    the scale of ``b`` (the ulp of its largest magnitude).  The first
    layer's caches come out bit for bit equal; later layers see inputs
    that already differ by a rounding, so elementwise ulps of values
    near zero would count noise far below the cache's resolution."""
    a, b = a.float(), b.float()
    top = float(b.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top else 2.0 ** -133
    return float((a - b).abs().max()) / ulp


def _engine_caches(eng):
    return [_bf16(nd.asnumpy()) for nd in eng._cache_arrs]


def _run(engine_cls, params, prompts, caches=False, **kw):
    """Streams (and per-step logits) of ``prompts`` submitted at once,
    and with ``caches`` the engine's caches after the run."""
    eng = engine_cls(params, CFG, **{**ENGINE, **kw})
    try:
        hs = [eng.submit(p, **sub) for p, sub in prompts]
        outs = [h.result(timeout=300) for h in hs]
        st = eng.stats()
        return outs, [h.logits for h in hs], st, \
            (_engine_caches(eng) if caches else None)
    finally:
        eng.stop()


def _both(np_params, prompts, caches=False, **kw):
    jax_out = _run(JaxEngine, np_params, prompts, caches, **kw)
    port_out = _run(DecodeEngine, convert_params(np_params, mx.cpu(), CFG),
                    prompts, caches, ctx=mx.cpu(), **kw)
    return jax_out, port_out


# ----------------------------------------------------------------------
# the symbols
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", sorted(_SYMBOLS))
def test_bound_types_match_jax(which):
    """Every argument binds the JAX package's type, name for name, but
    the index inputs, which stay f32; the weights the trunk meets, its
    LayerNorms and the caches are bf16, the embeddings f32."""
    build, shapes = _SYMBOLS[which]
    kw = dict(block_size=4, num_blocks=16, **CFG)
    jsym, psym = build(jtransformer, **kw), build(transformer, **kw)
    names = psym.list_arguments()
    assert names == jsym.list_arguments()
    jtypes = dict(zip(names, jsym.infer_shape_type(shapes, {})[1]))
    ptypes = dict(zip(names, psym.infer_shape_type(shapes, {})[1]))
    ptypes = {n: str(t).replace("torch.", "") for n, t in ptypes.items()}
    for n in names:
        if n in INDEX:
            assert ptypes[n] == "float32", n
        else:
            assert ptypes[n] == str(jtypes[n]), n
    assert ptypes["layer1_ffn_up_weight"] == "bfloat16"
    assert ptypes["tok_embed_weight"] == "float32"
    if which != "draft_span":
        assert ptypes["layer0_k_cache"] == "bfloat16"
        assert ptypes["lm_head_weight"] == "bfloat16"
    exe = psym.simple_bind(ctx=mx.cpu(), grad_req="null", **shapes)
    exe.copy_params_from({n: v for n, v in convert_params(
        {n: np.zeros(s, np.float32) for n, s in param_shapes(CFG).items()},
        mx.cpu(), CFG).items() if n in exe.arg_dict})


@pytest.mark.parametrize("which", sorted(_SYMBOLS))
def test_float16_serving_raises(which):
    """float16 serving is ported (tests/test_torch_serve_f16.py); any
    type but f32, bf16 and f16 still raises, naming ROADMAP A.1."""
    build, _ = _SYMBOLS[which]
    kw = dict(block_size=4, num_blocks=16, **CFG)
    with pytest.raises(mx.MXNetError, match="ROADMAP A.1"):
        build(transformer, **dict(kw, dtype="float64"))


def test_block_table_stays_exact_above_256():
    """A block id of 301 reads back 301 from the port's bound bf16
    decode step; the JAX package's same-type rule binds the table bf16,
    where it reads back 300 (ROADMAP C)."""
    build, shapes = _SYMBOLS["decode_step"]
    table = np.full((3, M), 301.0, np.float32)
    kw = dict(block_size=4, num_blocks=16, **CFG)
    pexe = build(transformer, **kw).simple_bind(ctx=mx.cpu(), **shapes)
    pexe.arg_dict["block_table"][:] = table
    assert pexe.arg_dict["block_table"].asnumpy().max() == 301.0
    jexe = build(jtransformer, **kw).simple_bind(ctx=jmx.cpu(),
                                                 grad_req="null", **shapes)
    jexe.arg_dict["block_table"][:] = table
    assert float(np.asarray(jexe.arg_dict["block_table"].asnumpy(),
                            np.float32).max()) == 300.0


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def test_engine_streams_logits_and_caches_match_jax(pallas, np_params):
    """Ragged prompts, one longer than three chunks, more requests than
    slots: equal greedy streams, the collected logits of each step
    within relative L2 2e-2 (the streams being equal, both steps saw the
    same tokens), the caches within one bf16 ulp."""
    rng = np.random.RandomState(31)
    prompts = [(list(rng.randint(0, 50, n)), dict(max_new_tokens=6,
                                                  collect_logits=True))
               for n in (3, 27, 11, 5)]
    (jout, jlog, jst, jc), (out, plog, st, pc) = _both(np_params, prompts,
                                                       caches=True)
    assert jst["attn_impl"] == "pallas"
    assert out == jout
    l2 = [_rel_l2(p, j) for ps, js in zip(plog, jlog)
          for p, j in zip(ps, js)]
    assert len(l2) == 24 and max(l2) <= LOGITS_L2
    assert all(t.dtype == torch.bfloat16 for t in pc)
    assert max(_ulps(p, j) for p, j in zip(pc, jc)) <= 1


def test_engine_preemption_matches_jax(pallas, np_params):
    """Cache pressure (7 blocks for 4 sequences) preempts and recomputes
    in bf16 as in f32: the streams equal the JAX engine's."""
    prompts = [([i + 1, i + 2, i + 3], dict(max_new_tokens=10))
               for i in range(4)]
    (jout, _, jst, _), (out, _, st, _) = _both(np_params, prompts,
                                               capacity=4, num_blocks=7)
    assert st["preemptions"] > 0 and jst["preemptions"] > 0
    assert out == jout


SPEC_PROMPTS = [[3, 7, 11, 3, 7, 11, 3, 7], [1, 2, 3, 4, 5],
                [42, 17, 42, 17, 42]]


@pytest.mark.parametrize("impl", ["ngram", "draft"])
def test_spec_engine_matches_jax(pallas, np_params, impl):
    """The bf16 spec step (spec_k 3) with the n-gram drafter or a bf16
    draft model (the target's own weights): the streams equal the JAX
    spec engine's, drafts are proposed, the caches within one bf16
    ulp."""
    kw = dict(spec_k=3, spec_impl=impl)
    if impl == "draft":
        kw.update(draft_config=CFG)
    prompts = [(p, dict(max_new_tokens=8)) for p in SPEC_PROMPTS]
    jrun = _run(JaxEngine, np_params, prompts, True,
                **dict(kw, draft_params=np_params) if impl == "draft"
                else kw)
    prun = _run(DecodeEngine, convert_params(np_params, mx.cpu(), CFG),
                prompts, True, ctx=mx.cpu(),
                **dict(kw, draft_params=np_params) if impl == "draft"
                else kw)
    (jout, _, jst, jc), (out, _, st, pc) = jrun, prun
    assert out == jout
    assert st["spec_impl"] == impl and st["spec_proposed"] > 0
    assert (st["spec_proposed"], st["spec_accepted"]) == \
        (jst["spec_proposed"], jst["spec_accepted"])
    assert max(_ulps(p, j) for p, j in zip(pc, jc)) <= 1


def test_prefill_pair_matches_jax(pallas, np_params):
    """The bf16 decode-step and prefill symbols bound as a pair with
    ``shared_exec`` (the same bf16 weight and cache objects) in both
    packages: two ragged prompts prefilled, then decode steps fed the
    same tokens; logits within relative L2 2e-2, greedy tokens equal,
    caches within one bf16 ulp."""
    bs, nb, P, bucket = 4, 16, (11, 6), 16
    Mt = -(-CFG["seq_len"] // bs)
    rng = np.random.RandomState(9)
    toks = rng.randint(0, 50, (2, CFG["seq_len"])).astype(np.float32)
    table = np.zeros((2, Mt), np.float32)
    table[0, :6] = np.arange(6)[::-1] + 1
    table[1, :6] = np.arange(6) + 8
    geo = dict(block_size=bs, num_blocks=nb, **CFG)
    runs = []
    for pkg, ctx, params in ((jtransformer, jmx.cpu(), np_params),
                             (transformer, mx.cpu(),
                              convert_params(np_params, mx.cpu(), CFG))):
        dexe = pkg.get_decode_step_symbol(**geo).simple_bind(
            ctx=ctx, grad_req="null", data=(2, 1), positions=(2, 1),
            block_table=(2, Mt))
        if pkg is jtransformer:
            from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray
            dexe.copy_params_from({k: JNDArray(v) for k, v in params.items()},
                                  {}, allow_extra_params=True)
        else:
            dexe.copy_params_from(params)
        pexe = pkg.get_prefill_symbol(prefill_len=bucket, **geo).simple_bind(
            ctx=ctx, grad_req="null", shared_exec=dexe, data=(2, bucket),
            prompt_len=(2,), block_table=(2, Mt))
        assert pexe.arg_dict["layer1_v_cache"] is \
            dexe.arg_dict["layer1_v_cache"]
        caches = [n for n in dexe.arg_dict if n.endswith("_cache")]
        pad = np.zeros((2, bucket), np.float32)
        for b, n in enumerate(P):
            pad[b, :n] = toks[b, :n]
        outs = pexe.forward(is_train=False, data=pad,
                            prompt_len=np.asarray(P, np.float32),
                            block_table=table)
        for j, nm in enumerate(caches):   # the JAX caches are returned
            dexe.arg_dict[nm]._set_data(outs[2 + j]._data)
        got = [(outs[0].asnumpy(), outs[1].asnumpy())]
        for t in range(5):
            pos = np.asarray([[P[0] + t], [P[1] + t]], np.float32)
            data = np.stack([toks[0, P[0] + t], toks[1, P[1] + t]])[:, None]
            outs = dexe.forward(is_train=False, data=data, positions=pos,
                                block_table=table)
            for j, nm in enumerate(caches):
                dexe.arg_dict[nm]._set_data(outs[2 + j]._data)
            got.append((outs[0].asnumpy(), outs[1].asnumpy()))
        runs.append((got, [_bf16(dexe.arg_dict[n].asnumpy())
                           for n in caches]))
    (jgot, jcache), (pgot, pcache) = runs
    for (jl, jt), (pl, pt) in zip(jgot, pgot):
        assert _rel_l2(pl, jl) <= LOGITS_L2
        np.testing.assert_array_equal(pt, jt)
    assert max(_ulps(p, j) for p, j in zip(pcache, jcache)) <= 1


def test_swap_params_casts_f32_into_bf16_engine(np_params, params):
    """f32 parameters swapped into a bf16 engine land in its bf16 bound
    arrays, rounded once (as the JAX engine's swap casts them), and the
    engine then streams what a fresh bf16 engine built on them streams."""
    rng = np.random.RandomState(11)
    other = {n: rng.normal(0, 0.1, a.shape).astype(np.float32)
             for n, a in np_params.items()}
    prompt = [5, 9, 2, 7]
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), **ENGINE)
    fresh = DecodeEngine(convert_params(other, mx.cpu(), CFG), CFG,
                         ctx=mx.cpu(), **ENGINE)
    try:
        before = eng.generate(prompt, max_new_tokens=6, timeout=120)
        eng.swap_params(other, version="v2")
        for n in ("layer0_qkv_weight", "ln_f_gamma", "lm_head_weight"):
            bound = eng._exe.arg_dict[n]._data
            assert bound.dtype == torch.bfloat16
            assert torch.equal(bound, torch.from_numpy(other[n])
                               .to(torch.bfloat16))
        assert eng._exe.arg_dict["tok_embed_weight"]._data.dtype == \
            torch.float32
        after = eng.generate(prompt, max_new_tokens=6, timeout=120)
        assert after == fresh.generate(prompt, max_new_tokens=6,
                                       timeout=120)
        assert after != before
        assert eng.stats()["model_version"] == "v2"
    finally:
        eng.stop()
        fresh.stop()


def test_fork_block_copies_bf16_rows(params):
    """Copy-on-write in a bf16 engine copies a shared block's bf16 rows
    bit for bit."""
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), start=False,
                       prefix_cache=True, capacity=2, block_size=4,
                       num_blocks=12, chunk_tokens=8)
    try:
        b = eng.cache.alloc(1)[0]
        eng.cache.incref(b)
        for i, nd in enumerate(eng._cache_arrs):
            assert nd._data.dtype == torch.bfloat16
            nd._data[b] = torch.randn(nd._data[b].shape).to(torch.bfloat16)
        seq = type("Seq", (), {"blocks": [b]})()
        eng._fork_block(seq, 0)
        assert seq.blocks[0] != b
        for nd in eng._cache_arrs:
            assert torch.equal(nd._data[seq.blocks[0]], nd._data[b])
    finally:
        eng.stop()


def test_block_ids_and_chunk_starts_above_256_are_exact(np_params):
    """Port only: an engine of 600 blocks whose free list hands out ids
    of 300 and up, and a 300-token prompt at seq_len 320, so chunk
    starts, positions and block ids all pass 256.  Its logits (the chunk
    head's first token, then decode steps) equal, within relative L2
    2e-2, those of the port's bf16 one-shot prefill and decode-step pair
    on the same prompt and tokens, whose prefill takes lengths, not
    starts; every index input binds f32."""
    cfg = dict(CFG, seq_len=320)
    big = dict(np_params, pos_embed_weight=np.random.RandomState(3).normal(
        0, 0.1, (1, 320, 16)).astype(np.float32))
    params = convert_params(big, mx.cpu(), cfg)
    prompt = list(np.random.RandomState(4).randint(0, 50, 300))
    new, bs = 4, 4
    eng = DecodeEngine(params, cfg, ctx=mx.cpu(), capacity=2, block_size=bs,
                       num_blocks=600, chunk_tokens=8)
    try:
        held = eng.cache.alloc(300)             # ids 0-299 off the list
        h = eng.submit(prompt, max_new_tokens=new, collect_logits=True)
        toks = h.result(timeout=300)
        eng_logits = h.logits
        for n in ("block_table", "chunk_table", "chunk_start", "positions"):
            assert eng._exe.arg_dict[n]._data.dtype == torch.float32, n
        eng.cache.free(held)
    finally:
        eng.stop()
    Mt = -(-320 // bs)
    geo = dict(block_size=bs, num_blocks=600, **cfg)
    dexe = transformer.get_decode_step_symbol(**geo).simple_bind(
        ctx=mx.cpu(), grad_req="null", data=(1, 1), positions=(1, 1),
        block_table=(1, Mt))
    dexe.copy_params_from(params)
    pexe = transformer.get_prefill_symbol(prefill_len=320, **geo).simple_bind(
        ctx=mx.cpu(), grad_req="null", shared_exec=dexe, data=(1, 320),
        prompt_len=(1,), block_table=(1, Mt))
    table = np.zeros((1, Mt), np.float32)
    table[0] = np.arange(599, 599 - Mt, -1)       # ids 520-599
    data = np.zeros((1, 320), np.float32)
    data[0, :300] = prompt
    outs = pexe.forward(is_train=False, data=data,
                        prompt_len=np.array([300.0], np.float32),
                        block_table=table)
    pair = [outs[0].asnumpy()[0]]
    for t in range(new - 1):
        outs = dexe.forward(is_train=False,
                            data=np.array([[toks[t]]], np.float32),
                            positions=np.array([[300.0 + t]], np.float32),
                            block_table=table)
        pair.append(outs[0].asnumpy()[0])
    l2 = [_rel_l2(a, b) for a, b in zip(eng_logits, pair)]
    assert len(l2) == new and max(l2) <= LOGITS_L2, l2


# ----------------------------------------------------------------------
# the plain versions of rows 5 and 2 on bf16 against the Pallas kernels
# ----------------------------------------------------------------------
def _rand_bf16(rng, *shape):
    return np.asarray(jnp.asarray((rng.randn(*shape) * 0.5)
                                  .astype(np.float32)).astype(jnp.bfloat16))


def _check_out(out, ref):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=OUT_RTOL,
                               atol=OUT_ATOL)


def _check_caches(tk, tv, jk, jv):
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))


@pytest.mark.parametrize("bs,S,Mt,lengths", [
    (4, 16, 4, (16, 9, 0)),
    (8, 19, 3, (19, 0, 18)),
])
def test_prefill_plain_bf16_matches_pallas(bs, S, Mt, lengths):
    """Row 5 on bf16 q/k/v over bf16 caches: the plain version (f32 math
    on the widened inputs, one rounding at the end) against the Pallas
    kernel; the caches byte for byte."""
    rng = np.random.RandomState(5)
    B, H, D, nb = len(lengths), 2, 8, 16
    q, k, v = (_rand_bf16(rng, B, S, H, D) for _ in range(3))
    kc, vc = _rand_bf16(rng, nb, bs, H, D), _rand_bf16(rng, nb, bs, H, D)
    perm = rng.permutation(nb)
    table = np.zeros((B, Mt), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        table[b, :-(-n // bs)] = perm[used:used - (-n // bs)]
        used += -(-n // bs)
    L = np.array(lengths, np.int32)
    sc = 1.0 / np.sqrt(D)
    ref, jk, jv = jax_prefill(*(jnp.asarray(a) for a in (q, k, v, kc, vc,
                                                         table, L)),
                              scale=sc, interpret=True)
    tk, tv = _bf16(kc), _bf16(vc)
    out, _, _ = paged_prefill_attend(_bf16(q), _bf16(k), _bf16(v), tk, tv,
                                     torch.from_numpy(table),
                                     torch.from_numpy(L), scale=sc)
    assert out.dtype == torch.bfloat16
    _check_out(out, ref)
    _check_caches(tk, tv, jk, jv)


@pytest.mark.parametrize("starts,lens,K", [
    ((5, 0, 13), (8, 3, 0), 8),       # a full chunk, a ragged one, a no-op
    ((0, 7, 22, 30), (5, 5, 2, 5), 5),  # spec-style spans of 5 rows
])
def test_chunk_plain_bf16_matches_pallas(starts, lens, K):
    """Row 2 on bf16 q/k/v over bf16 caches: the plain version against
    the Pallas kernel on the real rows; the caches byte for byte."""
    rng = np.random.RandomState(6)
    B, H, D, nb, bs, Mt = len(starts), 2, 8, 40, 4, 9
    q, k, v = (_rand_bf16(rng, B, K, H, D) for _ in range(3))
    kc, vc = _rand_bf16(rng, nb, bs, H, D), _rand_bf16(rng, nb, bs, H, D)
    table = rng.permutation(nb)[:B * Mt].reshape(B, Mt).astype(np.int32)
    st, ln = np.array(starts, np.int32), np.array(lens, np.int32)
    sc = 1.0 / np.sqrt(D)
    ref, jk, jv = jax_chunk(*(jnp.asarray(a) for a in (q, k, v, kc, vc,
                                                       table, st, ln)),
                            scale=sc, interpret=True)
    tk, tv = _bf16(kc), _bf16(vc)
    out, _, _ = paged_chunk_prefill_attend(
        _bf16(q), _bf16(k), _bf16(v), tk, tv, torch.from_numpy(table),
        torch.from_numpy(st), torch.from_numpy(ln), scale=sc)
    real = np.arange(K)[None, :] < np.array(lens)[:, None]
    _check_out(out[torch.from_numpy(real)], np.asarray(ref, np.float32)[real])
    _check_caches(tk, tv, jk, jv)


# ----------------------------------------------------------------------
# the bf16 tile's arithmetic (csrc/attention_bf16.cuh), emulated
# ----------------------------------------------------------------------
def _split_pv(p, v):
    """P V as the kernel takes it: P in bf16 hi and lo halves, two
    products of bf16 operands summed in f32."""
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    return hi.float() @ v.float() + lo.float() @ v.float()


def _tile_forward(q, k, v, mask, scale, kt):
    """One query tile's online softmax over key tiles of ``kt`` in log2
    units (scores of exact bf16 products, exp2, the unrounded P summed
    into l); returns the unnormalised accumulator, the running max (log2
    units) and the sum.  q (R, D), k/v (N, D) bf16, mask (R, N) True
    where a key is visible."""
    sl2 = scale * 1.4426950408889634
    R = q.shape[0]
    m = torch.full((R, 1), -float("inf"))
    l = torch.zeros(R, 1)
    acc = torch.zeros(R, v.shape[1])
    for c0 in range(0, k.shape[0], kt):
        s = (q.float() @ k[c0:c0 + kt].float().T) * sl2
        s = torch.where(mask[:, c0:c0 + kt], s, torch.tensor(-1e30))
        mx_ = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        alpha = torch.exp2(m - mx_)
        p = torch.exp2(s - mx_)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        acc = acc * alpha + _split_pv(p, v[c0:c0 + kt])
        m = mx_
    return acc, m, l


@pytest.mark.parametrize("S,D", [(130, 16), (64, 40)])
def test_bf16_tile_emulation_matches_plain_prefill(S, D):
    """The one-shot prefill's bf16 tile (64-key tiles, P in two bf16
    halves) against the plain version at the card's bf16 bound."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(S, D, generator=g).to(torch.bfloat16)
               for _ in range(3))
    sc = D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    acc, _, l = _tile_forward(q, k, v, mask, sc, 64)
    out = (acc / l).to(torch.bfloat16)
    ref = torch.softmax((q.float() @ k.float().T * sc)
                        .masked_fill(~mask, -float("inf")), dim=1) \
        @ v.float()
    torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float(),
                               rtol=OUT_RTOL, atol=OUT_ATOL)


def test_bf16_tile_emulation_matches_plain_chunk():
    """The chunked prefill's bf16 form: a chunk's rows over key ranges of
    KR keys (32-key tiles), each range's max stored in natural-log units
    (m ln 2) and the ranges combined in order, as the combine kernel
    does; against the plain version at the card's bf16 bound."""
    g = torch.Generator().manual_seed(2)
    st, L, D, KR = 300, 20, 32, 64
    ctx = st + L
    q = torch.randn(L, D, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(ctx, D, generator=g).to(torch.bfloat16)
            for _ in range(2))
    sc = D ** -0.5
    pos = st + torch.arange(L)
    mask = torch.arange(ctx)[None, :] <= pos[:, None]
    parts = []
    for k0 in range(0, ctx, KR):
        acc, m, l = _tile_forward(q, k[k0:k0 + KR], v[k0:k0 + KR],
                                  mask[:, k0:k0 + KR], sc, 32)
        parts.append((acc, m * 0.6931471805599453, l))
    mx_ = torch.stack([m for _, m, _ in parts]).max(dim=0).values
    w = [torch.exp(m - mx_) for _, m, _ in parts]
    num = sum(a * wj for (a, _, _), wj in zip(parts, w))
    den = sum(l * wj for (_, _, l), wj in zip(parts, w))
    out = (num / den).to(torch.bfloat16)
    ref = torch.softmax((q.float() @ k.float().T * sc)
                        .masked_fill(~mask, -1e30), dim=1) @ v.float()
    torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float(),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
