"""PyTorch port: speculative decoding (the spec step, the drafters, the
engine's draft-verify iteration) and the engine's weight swap, held
against the JAX package.

tests/test_spec.py's tiny model (2 layers, d16, numpy-seeded weights)
goes to both packages.  The JAX engines run with the Pallas kernels in
interpret mode, the port's on CPU tensors (the plain versions).  Greedy
streams, proposals and the selection contract must be equal exactly.
"""
import types

import numpy as np
import pytest
import torch

from mxnet_tpu.decode import DecodeEngine as JaxEngine
from mxnet_tpu.decode.spec import DraftModelDrafter as JaxDraftModelDrafter
from mxnet_tpu.decode.spec import NGramDrafter as JaxNGramDrafter
from mxnet_tpu.decode.spec import choose_spec_impl as jax_choose_spec_impl
from mxnet_tpu.models import transformer as jtransformer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.decode import (DecodeEngine, DraftModelDrafter,
                                    DraftWeightsError, NGramDrafter,
                                    choose_spec_impl)
from mxnet_tpu_torch.decode.spec import SPEC_FALLBACKS
from mxnet_tpu_torch.weights import convert_params

SEQ = 48
CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2,
           seq_len=SEQ)
ENGINE = dict(capacity=3, block_size=4, num_blocks=36, chunk_tokens=8)
# repeated n-grams (drafter hits) and none (misses)
PROMPTS = [[3, 7, 11, 3, 7, 11, 3, 7],
           [1, 2, 3, 4, 5],
           [9, 9, 9, 9],
           [42, 17, 42, 17, 42]]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The tensors here are tiny and gain nothing from many intra-op
    threads; two keep this file off the cores that timing-sensitive
    tests running beside it in other workers measure."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    """tests/test_spec.py's model: the JAX training symbol's parameters,
    N(0, 0.1) from RandomState(7)."""
    tsym = jtransformer.get_symbol(**CFG)
    arg_shapes, _, _ = tsym.infer_shape(data=(1, SEQ), softmax_label=(SEQ,))
    rng = np.random.RandomState(7)
    return {n: rng.normal(0, 0.1, s).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


@pytest.fixture(scope="module")
def params(np_params):
    return convert_params(np_params, mx.cpu(), CFG)


@pytest.fixture(scope="module")
def baseline(params):
    """The port's non-speculative engine and its greedy streams."""
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), **ENGINE)
    streams = [eng.generate(p, max_new_tokens=10, timeout=120)
               for p in PROMPTS]
    yield {"eng": eng, "streams": streams}
    eng.stop()


@pytest.fixture(scope="module")
def spec_engine(params):
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), spec_k=3,
                       spec_impl="ngram", prefix_cache=True, **ENGINE)
    yield eng
    eng.stop()


@pytest.fixture
def pallas(monkeypatch):
    """The JAX engine traces its step at the first dispatch, on its own
    thread, so the Pallas knobs stay set for the whole test."""
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


# ----------------------------------------------------------------------
# draft-verify decoding
# ----------------------------------------------------------------------
def test_spec_streams_match_nonspec_and_jax(pallas, np_params, spec_engine,
                                            baseline):
    """The port's spec engine gives the streams of its non-speculative
    engine and of the JAX spec engine, with more than one token per
    verified launch, and frees every block but the trie's."""
    outs = [spec_engine.generate(p, max_new_tokens=10, timeout=120)
            for p in PROMPTS]
    assert outs == baseline["streams"]
    jeng = JaxEngine(np_params, CFG, warmup=True, spec_k=3,
                     spec_impl="ngram", prefix_cache=True, **ENGINE)
    try:
        jouts = [jeng.generate(p, max_new_tokens=10, timeout=120)
                 for p in PROMPTS]
        jst = jeng.stats()
    finally:
        jeng.stop()
    assert jst["attn_impl"] == "pallas"
    assert outs == jouts
    st = spec_engine.stats()
    assert st["spec_k"] == 3 and st["spec_impl"] == "ngram"
    assert st["spec_proposed"] > 0
    assert st["tokens_per_launch"] > 1.0
    assert (st["spec_proposed"], st["spec_accepted"]) == \
        (jst["spec_proposed"], jst["spec_accepted"])
    assert st["cache"]["blocks_free"] + st["cache"]["prefix_trie_blocks"] \
        == st["cache"]["num_blocks"]


def test_spec_concurrent_load_matches_sequential(spec_engine, baseline):
    handles = [spec_engine.submit(p, max_new_tokens=10) for p in PROMPTS]
    assert [h.result(timeout=120) for h in handles] == baseline["streams"]


def test_spec_eos_mid_span(spec_engine, baseline):
    """The 3rd greedy token declared EOS: the spec engine stops exactly
    where the one-token engine does, even inside an accepted span."""
    eos = baseline["streams"][0][2]
    want = baseline["eng"].generate(PROMPTS[0], max_new_tokens=10,
                                    eos_id=eos, timeout=120)
    got = spec_engine.generate(PROMPTS[0], max_new_tokens=10, eos_id=eos,
                               timeout=120)
    assert got == want and got[-1] == eos and len(got) <= 3


def test_spec_sampling_rides_span_one(pallas, np_params, spec_engine):
    """Sampling slots never draft: a seeded sampled stream repeats,
    equals the JAX spec engine's for the same seed, and adds no
    proposal."""
    before = spec_engine.stats()["spec_proposed"]
    kw = dict(max_new_tokens=5, temperature=0.8, seed=3, timeout=120)
    t1 = spec_engine.generate([1, 2], **kw)
    t2 = spec_engine.generate([1, 2], **kw)
    assert t1 == t2 and len(t1) == 5
    assert spec_engine.stats()["spec_proposed"] == before
    jeng = JaxEngine(np_params, CFG, spec_k=3, spec_impl="ngram", **ENGINE)
    try:
        assert jeng.generate([1, 2], **kw) == t1
    finally:
        jeng.stop()


def test_spec_per_request_opt_out(spec_engine, baseline):
    before = spec_engine.stats()["spec_proposed"]
    out = spec_engine.generate(PROMPTS[0], max_new_tokens=10,
                               speculative=False, timeout=120)
    assert out == baseline["streams"][0]
    assert spec_engine.stats()["spec_proposed"] == before


def test_spec_draft_model_engine(np_params, params, baseline):
    """Self-draft (the target's own weights as the draft model): the
    stream is the one-token engine's and the drafts are accepted."""
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), spec_k=2,
                       spec_impl="draft", draft_params=np_params,
                       draft_config=CFG, capacity=2, block_size=4,
                       num_blocks=36, chunk_tokens=8)
    try:
        out = eng.generate(PROMPTS[1], max_new_tokens=8, timeout=120)
        st = eng.stats()
    finally:
        eng.stop()
    assert out == baseline["eng"].generate(PROMPTS[1], max_new_tokens=8,
                                           timeout=120)
    assert st["spec_impl"] == "draft"
    assert st["spec_proposed"] > 0 and st["spec_accepted"] > 0


@pytest.mark.parametrize("k", [1, 3])
def test_draft_model_proposals_match_jax(np_params, params, k):
    """The unrolled draft span's K greedy tokens equal the JAX
    ``DraftModelDrafter.propose`` on every prompt; an empty history
    proposes nothing."""
    jdr = JaxDraftModelDrafter(np_params, CFG)
    pdr = DraftModelDrafter(params, CFG, ctx=mx.cpu())
    for p in PROMPTS + [list(range(40))]:
        got = pdr.propose(p, k)
        assert got == jdr.propose(p, k), (k, p)
        assert len(got) == k
    assert pdr.propose([], k) == []


def test_draft_span_lengths_share_one_weight_copy(np_params, params):
    """Every span length the drafter binds holds the first executor's
    weight NDArrays (one copy on the device), and the proposals at each
    K still equal JAX's."""
    jdr = JaxDraftModelDrafter(np_params, CFG)
    pdr = DraftModelDrafter(params, CFG, ctx=mx.cpu())
    for k in (3, 1, 2):
        assert pdr.propose(PROMPTS[0], k) == jdr.propose(PROMPTS[0], k), k
    first, *rest = pdr._exes.values()
    assert len(rest) == 2
    assert all(e.arg_dict[n] is first.arg_dict[n]
               for e in rest for n in pdr._params)


# ----------------------------------------------------------------------
# drafters and their selection
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hist,k", [
    ([3, 7, 11, 3, 7], 2), ([1, 2, 9, 1, 2, 5, 1, 2], 1),
    ([1, 2, 3, 4], 3), ([5], 3), ([2, 2, 2, 2], 0),
    ([4, 8, 4, 8, 4, 8, 4], 5), (list(range(30)) + [7, 8], 4)])
def test_ngram_drafter_matches_jax(hist, k):
    assert NGramDrafter().propose(hist, k) == \
        JaxNGramDrafter().propose(hist, k)
    assert NGramDrafter(max_n=2, min_n=2, window=6).propose(hist, k) == \
        JaxNGramDrafter(max_n=2, min_n=2, window=6).propose(hist, k)


@pytest.mark.parametrize("impl,has", [
    ("off", False), ("auto", False), ("auto", True), ("ngram", True),
    ("draft", True), ("draft", False), ("medusa", True)])
def test_choose_spec_impl_matches_jax(impl, has):
    def resolve(fn):
        try:
            return fn(impl, has)
        except ValueError as exc:
            return type(exc)
    assert resolve(choose_spec_impl) == resolve(jax_choose_spec_impl)


def test_draft_checkpoint_fallback_contract(np_params, params):
    """A forced draft engine without draft weights raises at
    construction; under ``auto`` a draft checkpoint that fails the
    weight check falls back to the n-gram drafter and is counted, and a
    forced one raises the weight check's error."""
    kw = dict(ctx=mx.cpu(), start=False, capacity=1, block_size=4,
              num_blocks=8, chunk_tokens=8)
    with pytest.raises(ValueError):
        DecodeEngine(params, CFG, spec_k=2, spec_impl="draft", **kw)
    bad = dict(np_params)
    bad.pop("layer1_qkv_bias")
    before = SPEC_FALLBACKS.value
    eng = DecodeEngine(params, CFG, spec_k=2, spec_impl="auto",
                       draft_params=bad, draft_config=CFG, **kw)
    assert eng.stats()["spec_impl"] == "ngram"
    assert SPEC_FALLBACKS.value == before + 1
    misshapen = dict(np_params, lm_head_weight=np.zeros((50, 8), np.float32))
    with pytest.raises(DraftWeightsError, match="lm_head_weight"):
        DecodeEngine(params, CFG, spec_k=2, spec_impl="draft",
                     draft_params=misshapen, draft_config=CFG, **kw)


def test_spec_env_knobs(params, monkeypatch):
    kw = dict(ctx=mx.cpu(), start=False, capacity=1, block_size=4,
              num_blocks=8, chunk_tokens=8)
    monkeypatch.setenv("MXNET_DECODE_SPEC_K", "2")
    monkeypatch.setenv("MXNET_DECODE_SPEC_IMPL", "ngram")
    eng = DecodeEngine(params, CFG, **kw)
    assert eng.stats()["spec_k"] == 2 and eng.stats()["spec_impl"] == "ngram"
    assert eng._exe.arg_dict["data"].shape == (1, 3)     # spans of 3
    monkeypatch.setenv("MXNET_DECODE_SPEC_IMPL", "off")
    eng = DecodeEngine(params, CFG, **kw)
    assert eng.stats()["spec_k"] == 0                    # off: no spans
    assert eng._exe.arg_dict["data"].shape == (1, 1)
    eng = DecodeEngine(params, CFG, spec_k=0, **kw)      # the argument wins
    assert eng.stats()["spec_k"] == 0


# ----------------------------------------------------------------------
# weight swap, copy-on-write fork, drain
# ----------------------------------------------------------------------
def test_swap_params_flushes_prefix_trie_and_keeps_streams(params):
    """Swapping in the same weights keeps the streams; the trie, built
    under the old weights, is flushed and then rebuilt; the version
    stamps the stats."""
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), prefix_cache=True,
                       capacity=2, block_size=4, num_blocks=36,
                       chunk_tokens=8)
    try:
        ref = eng.generate(PROMPTS[0], max_new_tokens=6, timeout=120)
        assert eng.stats()["cache"]["prefix_trie_blocks"] > 0
        eng.swap_params(params, version="v2")
        assert eng.drain(timeout=60)
        out = eng.generate(PROMPTS[0], max_new_tokens=6, timeout=120)
        st = eng.stats()
    finally:
        eng.stop()
    assert out == ref
    assert st["model_version"] == "v2"
    assert st["cache"]["prefix_trie_blocks"] > 0
    assert st["cache"]["prefix_hit_blocks"] == 0     # flushed before reuse


def test_swap_params_changes_streams_and_rejects_bad_weights(params,
                                                             np_params):
    """New weights take effect at the next step; a checkpoint with a
    missing or misshapen parameter is rejected by ``check_params`` and
    by ``swap_params`` without touching the bound weights."""
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), start=False, **ENGINE)
    other = {k: (v * -1.0).astype(np.float32) for k, v in np_params.items()}
    bad = dict(np_params, lm_head_bias=np.zeros((7,), np.float32))
    for cand in (bad, {k: v for k, v in np_params.items()
                       if k != "ln_f_beta"}):
        with pytest.raises(mx.MXNetError):
            eng.check_params(cand)
        with pytest.raises(mx.MXNetError):
            eng.swap_params(cand)
    np.testing.assert_array_equal(
        eng._exe.arg_dict["lm_head_bias"].asnumpy(),
        np_params["lm_head_bias"])
    eng.check_params(other)
    eng.swap_params(other, version=3)
    np.testing.assert_array_equal(
        eng._exe.arg_dict["lm_head_weight"].asnumpy(),
        other["lm_head_weight"])
    assert eng.stats()["model_version"] == 3
    eng.stop()


def test_fork_block_isolates_device_rows(params):
    """``_fork_block`` gives the writer a private copy of a shared
    block: the copy carries the original rows, the original keeps its
    data and drops to the remaining sharer."""
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), start=False,
                       prefix_cache=True, capacity=2, block_size=4,
                       num_blocks=12, chunk_tokens=8)
    b = eng.cache.alloc(1)[0]
    eng.cache.incref(b)                        # a second sharer
    for i, nd in enumerate(eng._cache_arrs):
        nd._data[b] = 7.5 + i
    seq = types.SimpleNamespace(blocks=[b])
    eng._fork_block(seq, 0)
    nb = seq.blocks[0]
    assert nb != b
    assert eng.cache.ref(b) == 1 and eng.cache.ref(nb) == 1
    for i, nd in enumerate(eng._cache_arrs):
        assert bool((nd._data[nb] == 7.5 + i).all())
        assert bool((nd._data[b] == 7.5 + i).all())
    eng._fork_block(seq, 0)                    # exclusive now: no fork
    assert seq.blocks[0] == nb
    eng.stop()


def test_drain_waits_for_queued_and_active_work(params):
    eng = DecodeEngine(params, CFG, ctx=mx.cpu(), **ENGINE)
    try:
        hs = [eng.submit(p, max_new_tokens=4) for p in PROMPTS * 2]
        assert eng.drain(timeout=120)
        assert all(h.done() for h in hs)
        st = eng.stats()
        assert st["completed"] == len(hs) and st["active_sequences"] == 0
        assert st["tokens_per_launch"] == 1.0           # no speculation
    finally:
        eng.stop()
