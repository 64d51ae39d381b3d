"""PyTorch port: float16 serving (ROADMAP A.1) held against the JAX package.

The five serving symbols with ``dtype='float16'`` (f16 weights,
LayerNorms and paged caches; f32 embeddings, logits and index inputs),
the decode engine on the mixed step, speculative decoding (n-gram and
draft model), preemption, the prefill/decode-step pair, the weight swap
and copy-on-write, at tests/test_decode.py's tiny config.  Both packages
get the same numpy weights; the JAX side runs its Pallas kernels in
interpret mode, the port's wrappers take their plain versions on CPU
tensors.  The float16 ResNet training calls that raised until ROADMAP
A.1's float16 for rows 7 and 10 now run (held against the JAX package
in tests/test_torch_resnet_f16.py), and row 6, f32 by design, refuses
float16; the transformer's float16 training is
tests/test_torch_fit_f16.py's.

Bounds:
- greedy streams equal;
- logits (compared where both streams hold the same tokens) within
  relative L2 ``LOGITS_L2`` = 2.5e-3: the bf16 files' 2e-2 scaled by
  2^-3, f16 carrying 3 more significand bits than bf16 through the same
  roundings (weights, activations, caches rounded once each);
- caches within one f16 ulp at the cache's scale (``_ulps``);
- attention and LayerNorm outputs of the plain versions against the
  Pallas kernels at rtol 2^-10 (one f16 ulp of the value) / atol 1e-5,
  each side rounding an f32 result to f16 once;
- row 8's plain f16 forward against the JAX package's f16
  ``CausalSelfAttention`` on its XLA path at relative L2 ``FLASH_L2`` =
  2^-8: that path rounds the scores q.k to f16 and again after the scale
  (``mxnet_tpu/ops/nn.py:796-798``) where the port keeps them f32, a
  relative error of up to 2^-10 in each score and so in each
  probability's exponent; both round P to f16 before P V.

Index inputs (block tables, positions, chunk and span offsets and
lengths) stay f32 in the port, where the JAX package's same-type rule
makes them f16, which holds integers exactly only up to 2048.  Every
tiny config here keeps them below 2048, so the two packages agree; the
port's own behaviour above 2048 has tests of its own.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.decode import DecodeEngine as JaxEngine
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ops.nn import causal_self_attention as jax_attention
from mxnet_tpu.pallas import layernorm_fused as jax_layernorm
from mxnet_tpu.pallas import paged_chunk_prefill_attend as jax_chunk
from mxnet_tpu.pallas import paged_decode_attend as jax_decode
from mxnet_tpu.pallas import paged_prefill_attend as jax_prefill

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.decode import DecodeEngine
from mxnet_tpu_torch.kernels import (flash_attention_fwd_plain,
                                     layernorm_fused,
                                     paged_chunk_prefill_attend,
                                     paged_decode_attend,
                                     paged_prefill_attend)
from mxnet_tpu_torch.models import resnet, transformer
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.weights import convert_params, param_shapes

CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2, seq_len=48,
           dtype="float16")
ENGINE = dict(capacity=3, block_size=4, num_blocks=36, chunk_tokens=8)
LOGITS_L2 = 2.5e-3
OUT_RTOL, OUT_ATOL = 2.0 ** -10, 1e-5
FLASH_L2 = 2.0 ** -8
F16 = torch.float16
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


def _f16(a):
    """A numpy array (f32, or the JAX package's f16) as an f16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float16)))


def _ulps(a, b):
    """The largest difference between two f16 caches in f16 ulps at the
    scale of ``b`` (the ulp of its largest magnitude: 10 fraction
    bits).  Later layers see inputs that already differ by a rounding,
    so elementwise ulps of values near zero would count noise far below
    the cache's resolution."""
    a, b = a.float(), b.float()
    top = float(b.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 10) if top else 2.0 ** -24
    return float((a - b).abs().max()) / ulp


def _engine_caches(eng):
    return [_f16(nd.asnumpy()) for nd in eng._cache_arrs]


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
    the index inputs, which are f32 in the port, where the JAX package's
    same-type rule makes the block tables, the chunk and span offsets
    and lengths and the prompt lengths f16 (its positions, fed first to
    a float op, f32); the weights the trunk meets, its LayerNorms and
    the caches are f16, the embeddings f32; every argument binds for
    inference."""
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
            assert str(jtypes[n]) == ("float32" if "positions" in n
                                      or n == "length" else "float16"), n
        else:
            assert ptypes[n] == str(jtypes[n]), n
    assert ptypes["layer1_ffn_up_weight"] == "float16"
    assert ptypes["tok_embed_weight"] == "float32"
    if which != "draft_span":
        assert ptypes["layer0_k_cache"] == "float16"
        assert ptypes["lm_head_weight"] == "float16"
    exe = psym.simple_bind(ctx=mx.cpu(), grad_req="null", **shapes)
    exe.copy_params_from({n: v for n, v in convert_params(
        {n: np.zeros(s, np.float32) for n, s in param_shapes(CFG).items()},
        mx.cpu(), CFG).items() if n in exe.arg_dict})
    assert exe.arg_dict["layer0_qkv_weight"]._data.dtype == F16


def test_block_table_stays_exact_above_2048():
    """A block id of 2049 reads back 2049 from the port's bound f16
    decode step; the JAX package's same-type rule binds the table f16,
    where it reads back 2048 (ROADMAP C)."""
    build, shapes = _SYMBOLS["decode_step"]
    table = np.full((3, M), 2049.0, np.float32)
    kw = dict(block_size=4, num_blocks=16, **CFG)
    pexe = build(transformer, **kw).simple_bind(ctx=mx.cpu(), **shapes)
    pexe.arg_dict["block_table"][:] = table
    assert pexe.arg_dict["block_table"].asnumpy().max() == 2049.0
    jexe = build(jtransformer, **kw).simple_bind(ctx=jmx.cpu(),
                                                 grad_req="null", **shapes)
    jexe.arg_dict["block_table"][:] = table
    assert float(np.asarray(jexe.arg_dict["block_table"].asnumpy(),
                            np.float32).max()) == 2048.0


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def test_engine_streams_logits_and_caches_match_jax(pallas, np_params):
    """Ragged prompts, one longer than three chunks, more requests than
    slots: equal greedy streams, the collected logits of each step
    within LOGITS_L2 (the streams being equal, both steps saw the same
    tokens), the caches within one f16 ulp."""
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
    assert len(l2) == 24 and max(l2) <= LOGITS_L2, max(l2)
    assert all(t.dtype == F16 for t in pc)
    assert max(_ulps(p, j) for p, j in zip(pc, jc)) <= 1


def test_engine_preemption_matches_jax(pallas, np_params):
    """Cache pressure (7 blocks for 4 sequences) preempts and recomputes
    in f16 as in f32: the streams equal the JAX engine's."""
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
    """The f16 spec step (spec_k 3) with the n-gram drafter or an f16
    draft model (the target's own weights, its spans through row 8's
    f16 forward): the streams and (proposed, accepted) equal the JAX
    spec engine's, drafts are proposed, the caches within one f16
    ulp."""
    kw = dict(spec_k=3, spec_impl=impl)
    if impl == "draft":
        kw.update(draft_config=CFG, draft_params=np_params)
    prompts = [(p, dict(max_new_tokens=8)) for p in SPEC_PROMPTS]
    jout, _, jst, jc = _run(JaxEngine, np_params, prompts, True, **kw)
    out, _, st, pc = _run(DecodeEngine, convert_params(np_params, mx.cpu(),
                                                       CFG),
                          prompts, True, ctx=mx.cpu(), **kw)
    assert out == jout
    assert st["spec_impl"] == impl and st["spec_proposed"] > 0
    assert (st["spec_proposed"], st["spec_accepted"]) == \
        (jst["spec_proposed"], jst["spec_accepted"])
    assert max(_ulps(p, j) for p, j in zip(pc, jc)) <= 1


def test_prefill_pair_matches_jax(pallas, np_params):
    """The f16 decode-step and prefill symbols bound as a pair with
    ``shared_exec`` (the same f16 weight and cache objects) in both
    packages: two ragged prompts prefilled, then decode steps fed the
    same tokens; logits within LOGITS_L2, greedy tokens equal, caches
    within one f16 ulp."""
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
        runs.append((got, [_f16(dexe.arg_dict[n].asnumpy())
                           for n in caches]))
    (jgot, jcache), (pgot, pcache) = runs
    for (jl, jt), (pl, pt) in zip(jgot, pgot):
        assert _rel_l2(pl, jl) <= LOGITS_L2
        np.testing.assert_array_equal(pt, jt)
    assert all(t.dtype == F16 for t in pcache)
    assert max(_ulps(p, j) for p, j in zip(pcache, jcache)) <= 1


def test_swap_params_casts_f32_into_f16_engine(np_params, params):
    """f32 parameters swapped into an f16 engine land in its f16 bound
    arrays, rounded once (as the JAX engine's swap casts them), and the
    engine then streams what a fresh f16 engine built on them streams."""
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
            assert bound.dtype == F16
            assert torch.equal(bound, torch.from_numpy(other[n]).to(F16))
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


def test_convert_params_keeps_float16_arrays(np_params):
    """float16 numpy parameters (the JAX package's f16 arrays) are
    carried bit for bit as f16 tensors, f32 ones as f32; an f16 engine
    built on them serves what an engine given the f32 values serves
    (its binding rounds both to the same f16)."""
    half = {n: a.astype(np.float16) for n, a in np_params.items()}
    conv = convert_params(half, mx.cpu(), CFG)
    for n, a in half.items():
        assert conv[n]._data.dtype == F16
        np.testing.assert_array_equal(conv[n].asnumpy(), a)
    prompt = [4, 8, 15, 16]
    a = DecodeEngine(conv, CFG, ctx=mx.cpu(), **ENGINE)
    b = DecodeEngine(convert_params({n: v.astype(np.float32) for n, v in
                                     half.items()}, mx.cpu(), CFG), CFG,
                     ctx=mx.cpu(), **ENGINE)
    try:
        assert a.generate(prompt, max_new_tokens=5, timeout=120) == \
            b.generate(prompt, max_new_tokens=5, timeout=120)
    finally:
        a.stop()
        b.stop()


def test_fork_block_copies_f16_rows(params):
    """Copy-on-write in an f16 engine copies a shared block's f16 rows
    bit for bit."""
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), start=False,
                       prefix_cache=True, capacity=2, block_size=4,
                       num_blocks=12, chunk_tokens=8)
    try:
        b = eng.cache.alloc(1)[0]
        eng.cache.incref(b)
        for nd in eng._cache_arrs:
            assert nd._data.dtype == F16
            nd._data[b] = torch.randn(nd._data[b].shape).to(F16)
        seq = type("Seq", (), {"blocks": [b]})()
        eng._fork_block(seq, 0)
        assert seq.blocks[0] != b
        for nd in eng._cache_arrs:
            assert torch.equal(nd._data[seq.blocks[0]], nd._data[b])
    finally:
        eng.stop()


def test_block_ids_and_chunk_starts_above_2048_are_exact(np_params):
    """Port only: an engine of 2400 blocks whose free list hands out ids
    of 2100 and up, and a 2100-token prompt at seq_len 2120, so chunk
    starts, positions and block ids all pass 2048, where f16 would round
    them.  Its logits (the chunk head's first token, then decode steps)
    equal, within LOGITS_L2, those of the port's f16 one-shot prefill and
    decode-step pair on the same prompt and tokens, whose prefill takes
    lengths, not starts; every index input binds f32."""
    S, n, new, bs = 2120, 2100, 3, 8
    cfg = dict(CFG, seq_len=S)
    big = dict(np_params, pos_embed_weight=np.random.RandomState(3).normal(
        0, 0.1, (1, S, 16)).astype(np.float32))
    params = convert_params(big, mx.cpu(), cfg)
    prompt = list(np.random.RandomState(4).randint(0, 50, n))
    eng = DecodeEngine(params, cfg, ctx=mx.cpu(), capacity=1, block_size=bs,
                       num_blocks=2400, chunk_tokens=64)
    try:
        held = eng.cache.alloc(2100)            # ids 0-2099 off the list
        h = eng.submit(prompt, max_new_tokens=new, collect_logits=True)
        toks = h.result(timeout=300)
        eng_logits = h.logits
        for name in ("block_table", "chunk_table", "chunk_start",
                     "positions"):
            assert eng._exe.arg_dict[name]._data.dtype == torch.float32, name
        eng.cache.free(held)
    finally:
        eng.stop()
    Mt = -(-S // bs)
    geo = dict(block_size=bs, num_blocks=2400, **cfg)
    dexe = transformer.get_decode_step_symbol(**geo).simple_bind(
        ctx=mx.cpu(), grad_req="null", data=(1, 1), positions=(1, 1),
        block_table=(1, Mt))
    dexe.copy_params_from(params)
    pexe = transformer.get_prefill_symbol(prefill_len=S, **geo).simple_bind(
        ctx=mx.cpu(), grad_req="null", shared_exec=dexe, data=(1, S),
        prompt_len=(1,), block_table=(1, Mt))
    table = np.zeros((1, Mt), np.float32)
    table[0] = np.arange(2399, 2399 - Mt, -1)     # ids 2135-2399
    assert pexe.arg_dict["block_table"]._data.dtype == torch.float32
    data = np.zeros((1, S), np.float32)
    data[0, :n] = prompt
    outs = pexe.forward(is_train=False, data=data,
                        prompt_len=np.array([float(n)], np.float32),
                        block_table=table)
    pair = [outs[0].asnumpy()[0]]
    for t in range(new - 1):
        outs = dexe.forward(is_train=False,
                            data=np.array([[toks[t]]], np.float32),
                            positions=np.array([[n + t]], np.float32),
                            block_table=table)
        pair.append(outs[0].asnumpy()[0])
    l2 = [_rel_l2(a, b) for a, b in zip(eng_logits, pair)]
    assert len(l2) == new and max(l2) <= LOGITS_L2, l2


# ----------------------------------------------------------------------
# float16 ResNet training runs; row 6 stays f32
# ----------------------------------------------------------------------
_RESNET18 = dict(num_classes=10, num_layers=18, image_shape=(3, 32, 32))


def _resnet_get_symbol():
    sym = resnet.get_symbol(dtype="float16", **_RESNET18)
    _, at, _, xt = sym.infer_shape_type({"data": (1, 3, 32, 32),
                                        "softmax_label": (1,)})
    assert "cast_data" in sym.tojson() and F16 in at and F16 in xt


def _trainstep():
    ts = TrainStep(resnet.get_symbol(**_RESNET18),
                   mx.optimizer.SGD(multi_precision=True), dtype="float16",
                   ctx=mx.cpu(), data_shapes={"data": (2, 3, 32, 32)},
                   label_shapes={"softmax_label": (2,)})
    ts.init_params(mx.init.Xavier())
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    out = ts.step({"data": x, "softmax_label": np.array([1.0, 3.0],
                                                        np.float32)})[0]
    assert ts.params["conv0_weight"].dtype == F16
    assert np.isfinite(out.float().numpy()).all()


def _f32_resnet_bound_f16():
    sym = resnet.get_symbol(**_RESNET18)
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="write",
                          type_dict={"data": "float16"},
                          data=(2, 3, 32, 32), softmax_label=(2,))
    assert exe.arg_dict["conv0_weight"]._data.dtype == F16
    assert exe.grad_dict["conv0_weight"]._data.dtype == F16
    exe.arg_dict["conv0_weight"][:] = mx.nd.array(
        np.full((64, 3, 3, 3), 0.1, np.float32), ctx=mx.cpu())
    exe.arg_dict["data"][:] = mx.nd.array(
        np.random.RandomState(0).rand(2, 3, 32, 32), ctx=mx.cpu())
    exe.forward(is_train=True)
    exe.backward()
    assert torch.isfinite(exe.grad_dict["conv0_weight"]._data).all()


_TRAINING = {
    "resnet_get_symbol": _resnet_get_symbol,
    "trainstep": _trainstep,
    "simple_bind_training_graph": _f32_resnet_bound_f16,
}


@pytest.mark.parametrize("what", sorted(_TRAINING))
def test_float16_training_raises(what):
    """The three float16 ResNet training calls that raised until ROADMAP
    A.1's float16 for rows 7 and 10 now run on the CPU: the training
    symbol builds and infers f16 weights and statistics, TrainStep on it
    steps with f16 weights, and a bind of the f32 graph with f16 data
    allocates f16 arguments and gradients and runs forward and backward
    (its BatchNorm, Convolution and Pooling are in
    ``executor.FLOAT16_OPS``).  Float16 ResNet training is held against
    the JAX package in tests/test_torch_resnet_f16.py."""
    _TRAINING[what]()


def _on_card(monkeypatch, module):
    """Send ``module``'s wrappers down their card path (past the device
    decision), where they check their tensors before any pointer
    reaches a kernel."""
    monkeypatch.setattr(module, "on_cpu", lambda *a: False)


def _t16(*shape):
    return torch.zeros(*shape, dtype=F16)


# rows 7 and 10 take f16 with f16 only; row 6 is f32 by design
_NO_F16_FORM = {
    "fused_scale_relu_matmul": ("fused_matmul",
                                lambda m: m.fused_scale_relu_matmul_fwd(
                                    _t16(4, 8), torch.ones(8),
                                    torch.zeros(8), _t16(3, 8).bfloat16())),
    "fused_band4d": ("fused_band4d", lambda m: m.fused_band4d(
        _t16(1, 2, 2, 8), torch.ones(8), torch.zeros(8),
        _t16(8, 3).bfloat16())),
    "two_bit_quantize_fused": ("quant", lambda m: m.two_bit_quantize_fused(
        _t16(16), _t16(16), threshold=0.5)),
}


@pytest.mark.parametrize("kernel", sorted(_NO_F16_FORM))
def test_kernels_without_f16_form_refuse_it(monkeypatch, kernel):
    """Row 6 (the 2-bit quantizer, which reads the f32 master-gradient
    view) is f32 by design and refuses a float16 tensor in the wrapper,
    before any pointer reaches the kernel, naming ROADMAP A.1.  Rows 7
    and 10 have f16 forms since ROADMAP A.1's float16 for rows 7 and 10:
    on the CPU they take f16 (their plain versions), and on the card
    path they refuse f16 beside bf16, a mixed pair no kernel takes."""
    import importlib
    name, call = _NO_F16_FORM[kernel]
    mod = importlib.import_module("mxnet_tpu_torch.kernels." + name)
    if kernel == "two_bit_quantize_fused":
        _on_card(monkeypatch, mod)
        with pytest.raises(mx.MXNetError, match=kernel + ".*float16.*f32 "
                           "by design.*ROADMAP A.1"):
            call(mod)
        return
    x, w = (_t16(4, 8), _t16(3, 8)) if kernel == "fused_scale_relu_matmul" \
        else (_t16(1, 2, 2, 8), _t16(8, 3))
    fn = mod.fused_scale_relu_matmul_fwd if kernel == \
        "fused_scale_relu_matmul" else mod.fused_band4d
    out = fn(x, torch.ones(8), torch.zeros(8), w)
    assert out.dtype == F16 and not out.any()
    _on_card(monkeypatch, mod)
    with pytest.raises(mx.MXNetError, match=kernel + ": w has dtype "
                       "torch.bfloat16; the kernel takes torch.float16"):
        call(mod)


_MIXED = {
    "decode_q_f16_cache_bf16": lambda m: m.paged_decode_attend(
        _t16(2, 2, 8), torch.zeros(4, 4, 2, 8, dtype=torch.bfloat16),
        torch.zeros(4, 4, 2, 8, dtype=torch.bfloat16),
        torch.zeros(2, 1, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), scale=1.0),
    "prefill_q_f32_cache_f16": lambda m: m.paged_prefill_attend(
        *[torch.zeros(1, 4, 2, 8)] * 3, _t16(4, 4, 2, 8), _t16(4, 4, 2, 8),
        torch.zeros(1, 1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), scale=1.0),
    "chunk_q_f16_cache_f32": lambda m: m.paged_chunk_prefill_attend(
        *[_t16(1, 4, 2, 8)] * 3, torch.zeros(4, 4, 2, 8),
        torch.zeros(4, 4, 2, 8), torch.zeros(1, 1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        scale=1.0),
}


@pytest.mark.parametrize("case", sorted(_MIXED))
def test_f16_pairs_only_with_f16(monkeypatch, case):
    """The f16 forms take f16 q with f16 caches only: a mixed pair is
    refused in the wrapper (the C entry points return an error for it
    too, held on the card by chip_smoke.py)."""
    from mxnet_tpu_torch.kernels import paged_attention as m
    _on_card(monkeypatch, m)
    with pytest.raises(mx.MXNetError, match="float16 form takes float16 "
                       "with float16"):
        _MIXED[case](m)


def test_layernorm_f16_pairs_only_with_f16(monkeypatch):
    import importlib
    m = importlib.import_module("mxnet_tpu_torch.kernels.layernorm")
    _on_card(monkeypatch, m)
    with pytest.raises(mx.MXNetError, match="float16 form takes float16 "
                       "with float16"):
        m.layernorm_fused(_t16(4, 8), torch.ones(8), torch.zeros(8))


# ----------------------------------------------------------------------
# the plain f16 versions of rows 1, 2, 3, 5 and 8 against the reference
# ----------------------------------------------------------------------
def _rand_f16(rng, *shape, scale=0.5):
    return (rng.randn(*shape) * scale).astype(np.float16)


def _check_out(out, ref):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=OUT_RTOL,
                               atol=OUT_ATOL)


def _check_caches(tk, tv, jk, jv):
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_decode_plain_f16_matches_pallas():
    """Row 1 on f16 q over f16 caches: the plain version (f32 math on
    the widened inputs, one rounding at the end) against the Pallas
    kernel; inactive slots zeros."""
    rng = np.random.RandomState(3)
    nb, bs, H, D, C, Mt = 10, 4, 2, 8, 4, 5
    q = _rand_f16(rng, C, H, D)
    kc, vc = _rand_f16(rng, nb, bs, H, D), _rand_f16(rng, nb, bs, H, D)
    table = rng.randint(0, nb, (C, Mt)).astype(np.int32)
    pos = np.array([bs - 2, 3 * bs + 1, -1, Mt * bs - 1], np.int32)
    sc = 1.0 / np.sqrt(D)
    ref = np.asarray(jax_decode(*(jnp.asarray(a) for a in (q, kc, vc, table,
                                                           pos)),
                                scale=sc, interpret=True))
    out = paged_decode_attend(_f16(q), _f16(kc), _f16(vc),
                              torch.from_numpy(table), torch.from_numpy(pos),
                              scale=sc)
    assert out.dtype == F16
    act = pos >= 0
    _check_out(out[torch.from_numpy(act)], ref[act])
    assert bool((out[torch.from_numpy(~act)] == 0).all())


@pytest.mark.parametrize("bs,S,Mt,lengths", [
    (4, 16, 4, (16, 9, 0)),
    (8, 19, 3, (19, 0, 18)),
])
def test_prefill_plain_f16_matches_pallas(bs, S, Mt, lengths):
    """Row 5 on f16 q/k/v over f16 caches: the plain version against
    the Pallas kernel; the caches byte for byte."""
    rng = np.random.RandomState(5)
    B, H, D, nb = len(lengths), 2, 8, 16
    q, k, v = (_rand_f16(rng, B, S, H, D) for _ in range(3))
    kc, vc = _rand_f16(rng, nb, bs, H, D), _rand_f16(rng, nb, bs, H, D)
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
    tk, tv = _f16(kc), _f16(vc)
    out, _, _ = paged_prefill_attend(_f16(q), _f16(k), _f16(v), tk, tv,
                                     torch.from_numpy(table),
                                     torch.from_numpy(L), scale=sc)
    assert out.dtype == F16
    _check_out(out, ref)
    _check_caches(tk, tv, jk, jv)


@pytest.mark.parametrize("starts,lens,K", [
    ((5, 0, 13), (8, 3, 0), 8),       # a full chunk, a ragged one, a no-op
    ((0, 7, 22, 30), (5, 5, 2, 5), 5),  # spec-style spans of 5 rows
])
def test_chunk_plain_f16_matches_pallas(starts, lens, K):
    """Row 2 on f16 q/k/v over f16 caches: the plain version against
    the Pallas kernel on the real rows; the caches byte for byte."""
    rng = np.random.RandomState(6)
    B, H, D, nb, bs, Mt = len(starts), 2, 8, 40, 4, 9
    q, k, v = (_rand_f16(rng, B, K, H, D) for _ in range(3))
    kc, vc = _rand_f16(rng, nb, bs, H, D), _rand_f16(rng, nb, bs, H, D)
    table = rng.permutation(nb)[:B * Mt].reshape(B, Mt).astype(np.int32)
    st, ln = np.array(starts, np.int32), np.array(lens, np.int32)
    sc = 1.0 / np.sqrt(D)
    ref, jk, jv = jax_chunk(*(jnp.asarray(a) for a in (q, k, v, kc, vc,
                                                       table, st, ln)),
                            scale=sc, interpret=True)
    tk, tv = _f16(kc), _f16(vc)
    out, _, _ = paged_chunk_prefill_attend(
        _f16(q), _f16(k), _f16(v), tk, tv, torch.from_numpy(table),
        torch.from_numpy(st), torch.from_numpy(ln), scale=sc)
    real = np.arange(K)[None, :] < np.array(lens)[:, None]
    _check_out(out[torch.from_numpy(real)], np.asarray(ref, np.float32)[real])
    _check_caches(tk, tv, jk, jv)


@pytest.mark.parametrize("shape,with_res", [((6, 40), False),
                                            ((9, 2048), True)])
def test_layernorm_plain_f16_matches_pallas(shape, with_res):
    """Row 3 on f16 x and f16 gamma/beta (the f16 serving symbols'
    LayerNorms): the plain version against the Pallas kernel, output at
    one f16 ulp, the f32 statistics at the f32 bound."""
    rng = np.random.RandomState(11)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float16)
    res = rng.randn(*shape).astype(np.float16) if with_res else None
    g = rng.randn(shape[-1]).astype(np.float16)
    b = rng.randn(shape[-1]).astype(np.float16)
    ref = jax_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                        residual=None if res is None else jnp.asarray(res),
                        eps=1e-5, interpret=True)
    out, mean, rstd = layernorm_fused(
        _f16(x), _f16(g), _f16(b),
        residual=None if res is None else _f16(res), eps=1e-5)
    assert out.dtype == F16
    _check_out(out, ref[0])
    for a, r in ((mean, ref[1]), (rstd, ref[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("B,S,H,D", [(2, 40, 2, 8), (1, 128, 4, 16)])
def test_flash_forward_plain_f16_matches_jax_xla(B, S, H, D):
    """Row 8's plain f16 forward (the draft spans' attention) against
    the JAX package's f16 CausalSelfAttention on its XLA path (the
    reference's flash gate keeps f16 off its kernel) on the same packed
    qkv, within FLASH_L2 (module docstring: that path rounds the scores
    to f16, the port keeps them f32; both round P to f16)."""
    rng = np.random.RandomState(12)
    qkv = (rng.randn(B, S, 3 * H * D)).astype(np.float16)
    ref = np.asarray(jax_attention(jnp.asarray(qkv), num_heads=H),
                     np.float32)
    heads = torch.from_numpy(qkv).reshape(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    out, _ = flash_attention_fwd_plain(heads[0].contiguous(),
                                       heads[1].contiguous(),
                                       heads[2].contiguous(),
                                       scale=D ** -0.5)
    assert out.dtype == F16
    got = out.permute(0, 2, 1, 3).reshape(B, S, H * D).float().numpy()
    assert _rel_l2(got, ref) <= FLASH_L2


# ----------------------------------------------------------------------
# the f16 tile's arithmetic (csrc/attention_bf16.cuh), emulated
# ----------------------------------------------------------------------
P_SCALE = 2.0 ** 12


def _split_pv(p, v, scale=P_SCALE):
    """P V as the f16 tile takes it: P * scale in f16 hi and lo halves,
    two products of f16 operands summed in f32, the sum times 1/scale
    (exact: a power of two)."""
    ps = p * scale
    hi = ps.to(F16)
    lo = (ps - hi.float()).to(F16)
    return (hi.float() @ v.float() + lo.float() @ v.float()) / scale


def _tile_forward(q, k, v, mask, scale, kt):
    """One query tile's online softmax over key tiles of ``kt`` in log2
    units (scores of exact f16 products, exp2, the unrounded P summed
    into l); returns the unnormalised accumulator, the running max (log2
    units) and the sum.  q (R, D), k/v (N, D) f16, mask (R, N) True
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


@pytest.mark.parametrize("S,D", [(130, 16), (64, 40), (1024, 32)])
def test_f16_tile_emulation_matches_plain_prefill(S, D):
    """The one-shot prefill's f16 tile (64-key tiles, P * 2^12 in two
    f16 halves) against the plain version at the card's f16 bound, up to
    a 1024-token context."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(S, D, generator=g).to(F16) for _ in range(3))
    sc = D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    acc, _, l = _tile_forward(q, k, v, mask, sc, 64)
    out = (acc / l).to(F16)
    ref = torch.softmax((q.float() @ k.float().T * sc)
                        .masked_fill(~mask, -float("inf")), dim=1) \
        @ v.float()
    torch.testing.assert_close(out.float(), ref.to(F16).float(),
                               rtol=OUT_RTOL, atol=OUT_ATOL)


def test_f16_tile_emulation_matches_plain_chunk():
    """The chunked prefill's f16 form: a chunk's rows over key ranges of
    KR keys (32-key tiles), each range's max stored in natural-log units
    (m ln 2) and the ranges combined in order, as the combine kernel
    does; against the plain version at the card's f16 bound."""
    g = torch.Generator().manual_seed(2)
    st, L, D, KR = 300, 20, 32, 64
    ctx = st + L
    q = torch.randn(L, D, generator=g).to(F16)
    k, v = (torch.randn(ctx, D, generator=g).to(F16) for _ in range(2))
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
    out = (num / den).to(F16)
    ref = torch.softmax((q.float() @ k.float().T * sc)
                        .masked_fill(~mask, -1e30), dim=1) @ v.float()
    torch.testing.assert_close(out.float(), ref.to(F16).float(),
                               rtol=OUT_RTOL, atol=OUT_ATOL)


def test_p_scale_keeps_small_probabilities():
    """Why the f16 tile scales P by 2^12: probabilities between 2^-26
    and 2^-14 (f16's normal range ends at 2^-14, its subnormals at
    2^-24) keep their bits in the scaled hi/lo split and lose them
    unscaled.  On 4096 such P against f16 values, the scaled split's
    P V is within 2^-20 of the f32 product (relative L2); the unscaled
    split is off by more than 2^-12."""
    g = torch.Generator().manual_seed(3)
    p = torch.exp2(-14.0 - 12.0 * torch.rand(8, 4096, generator=g))
    v = torch.randn(4096, 16, generator=g).to(F16)
    exact = p.double() @ v.double()

    def rel(x):
        return float((x.double() - exact).norm() / exact.norm())

    assert rel(_split_pv(p, v)) <= 2.0 ** -20
    assert rel(_split_pv(p, v, scale=1.0)) > 2.0 ** -12
