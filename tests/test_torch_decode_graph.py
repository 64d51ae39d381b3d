"""PyTorch port: the serving step as one dispatch (the donated forward)
and the JAX engine's one-dispatch-per-step witnesses.

tests/test_decode.py pins, on the JAX engine, that a warm engine never
retraces and runs each iteration as exactly one device launch
(``steady_state_retraces``, ``decode_step_dispatches``,
``dispatches_per_step``, ``cache_donation``).  Each workload here goes
through both packages (tests/test_torch_decode.py's tiny config; the
JAX engine with its Pallas kernels in interpret mode, the port's on CPU
tensors) and both must report the same four witnesses and equal
greedy streams.  On the CPU the port's donated forward is the eager
walk (the device decides); the captured graph runs on the card
(``chip_smoke.py``'s serve phases).  The executor's donated path is
rehearsed here with a stand-in for the graph that re-runs the walk into
the captured outputs, as a replay overwrites the graph's static
tensors.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.decode import DecodeEngine as JaxEngine
from mxnet_tpu.models import transformer as jtransformer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import executor as executor_mod
from mxnet_tpu_torch.decode import DecodeEngine
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.weights import convert_params, param_shapes

CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2, seq_len=48)
ENGINE = dict(capacity=3, block_size=4, num_blocks=36, chunk_tokens=8)
WITNESSES = ("steady_state_retraces", "decode_step_dispatches",
             "dispatches_per_step", "cache_donation")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny tensors: two intra-op threads keep this file off the cores
    that other workers' tests use."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    rng = np.random.RandomState(7)
    return {n: rng.normal(0, 0.1, s).astype(np.float32)
            for n, s in param_shapes(CFG).items()}


@pytest.fixture
def pallas(monkeypatch):
    """The JAX engine traces at its first dispatch, on its own thread:
    the Pallas knobs stay set for the whole test."""
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


def _run(engine_cls, params, prompts, max_new, **kw):
    """Streams of ``prompts`` (submitted at once) and ``stats()``."""
    eng = engine_cls(params, CFG, **{**ENGINE, **kw})
    try:
        hs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts,
                                                              max_new)]
        return [h.result(timeout=120) for h in hs], eng.stats()
    finally:
        eng.stop()


def _both(params, prompts, max_new, **kw):
    """The workload through the JAX engine and the port's; asserts equal
    streams and equal witnesses, returns the port's stats."""
    jout, jst = _run(JaxEngine, params, prompts, max_new, **kw)
    out, st = _run(DecodeEngine, convert_params(params, mx.cpu(), CFG),
                   prompts, max_new, ctx=mx.cpu(), **kw)
    assert jst["attn_impl"] == "pallas"
    assert out == jout
    assert {k: st[k] for k in WITNESSES} == {k: jst[k] for k in WITNESSES}
    assert st["steps"] == jst["steps"]
    return st


def _one_dispatch_per_step(st):
    assert st["steady_state_retraces"] == 0
    assert st["decode_step_dispatches"] == st["steps"] > 0
    assert st["dispatches_per_step"] == 1.0
    assert st["cache_donation"] is True


# ----------------------------------------------------------------------
# the witnesses (tests/test_decode.py:361-377, :394-412, :435-456,
# :459-480), through both packages
# ----------------------------------------------------------------------
def test_zero_retraces_and_one_dispatch_per_step_ragged(pallas, params):
    """Ragged prompt and output lengths on a warm engine: nothing
    captured again, every iteration one dispatch."""
    rng = np.random.RandomState(11)
    prompts, news = [], []
    for _ in range(9):
        prompts.append(list(rng.randint(0, 50, rng.randint(2, 9))))
        news.append(int(rng.randint(2, 10)))
    st = _both(params, prompts, news, warmup=True)
    _one_dispatch_per_step(st)
    assert st["completed"] == 9


def test_mixed_step_witnesses_with_chunks_in_flight(pallas, params):
    """Multi-chunk prefills interleaving live decodes: still one
    dispatch an iteration and no retrace."""
    rng = np.random.RandomState(13)
    prompts = [list(rng.randint(0, 50, n)) for n in (3, 21, 17, 30, 5, 26)]
    st = _both(params, prompts, [6] * 6, warmup=True)
    _one_dispatch_per_step(st)
    assert st["prefills"] == 6
    assert st["prefill_chunks"] >= 1 + 3 + 3 + 4 + 1 + 4
    assert st["cache"]["blocks_free"] == st["cache"]["num_blocks"]


@pytest.mark.parametrize("case", ["decode", "mid_prefill"])
def test_preemption_witnesses(pallas, params, case):
    """Cache pressure preempts and recomputes (after decoding started,
    and in the middle of a chunked prefill) on an engine that was not
    warmed: the first step captures, nothing captures again, and the
    streams equal the JAX engine's."""
    if case == "decode":
        prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
        st = _both(params, prompts, [10] * 4, capacity=4, num_blocks=7)
    else:
        rng = np.random.RandomState(17)
        prompts = [list(rng.randint(0, 50, n)) for n in (18, 22, 20)]
        st = _both(params, prompts, [6] * 3, num_blocks=7)
    assert st["preemptions"] > 0
    _one_dispatch_per_step(st)
    assert st["cache"]["blocks_free"] == st["cache"]["num_blocks"]


def _draft_kw(params, impl):
    kw = dict(spec_k=3, spec_impl=impl, warmup=True)
    if impl == "draft":
        kw.update(draft_params=params, draft_config=CFG)
    return kw


@pytest.mark.parametrize("impl", ["ngram", "draft"])
def test_spec_engine_witnesses(pallas, params, impl):
    """The spec step: one dispatch a verify iteration, with the n-gram
    drafter and with a draft model (the target's own weights), whose
    proposals are one forward of its span program each."""
    prompts = [[3, 7, 11, 3, 7, 11, 3, 7], [1, 2, 3, 4, 5], [9, 9, 9, 9],
               [42, 17, 42, 17, 42]]
    jout, jst = _run(JaxEngine, params, prompts, [10] * 4,
                     **_draft_kw(params, impl))
    eng = DecodeEngine(convert_params(params, mx.cpu(), CFG), CFG,
                       ctx=mx.cpu(), **ENGINE, **_draft_kw(params, impl))
    try:
        if impl == "draft":
            # warmup() bound every span length up to spec_k
            assert sorted(eng._drafter._exes) == [1, 2, 3]
            before = {k: e.dispatches for k, e in eng._drafter._exes.items()}
        hs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        out = [h.result(timeout=120) for h in hs]
        st = eng.stats()
        if impl == "draft":
            exes = eng._drafter._exes
            # one forward a proposal, K tokens each
            assert sum(k * (e.dispatches - before[k])
                       for k, e in exes.items()) == st["spec_proposed"]
            assert all(e._donated_names == ("data",) for e in exes.values())
    finally:
        eng.stop()
    assert out == jout
    assert {k: st[k] for k in WITNESSES} == {k: jst[k] for k in WITNESSES}
    assert st["spec_impl"] == jst["spec_impl"] == impl
    assert st["spec_proposed"] == jst["spec_proposed"] > 0
    _one_dispatch_per_step(st)


def test_donation_off_keeps_the_eager_walk(pallas, params, monkeypatch):
    """MXNET_DECODE_DONATE=0: no donation in either package, the same
    streams as with it."""
    rng = np.random.RandomState(31)
    prompts = [list(rng.randint(0, 50, n)) for n in (3, 27, 11, 5)]
    on = _run(DecodeEngine, convert_params(params, mx.cpu(), CFG), prompts,
              [6] * 4, ctx=mx.cpu())
    monkeypatch.setenv("MXNET_DECODE_DONATE", "0")
    st = _both(params, prompts, [6] * 4)
    assert st["cache_donation"] is False
    assert st["dispatches_per_step"] == 1.0
    out, _ = _run(DecodeEngine, convert_params(params, mx.cpu(), CFG),
                  prompts, [6] * 4, ctx=mx.cpu())
    assert out == on[0]
    assert on[1]["cache_donation"] is True
    # the knob keeps a draft model's span programs eager too
    eng = DecodeEngine(convert_params(params, mx.cpu(), CFG), CFG,
                       ctx=mx.cpu(), start=False, **ENGINE,
                       **_draft_kw(params, "draft"))
    assert eng._exe._donated_names == ()
    assert eng._drafter._exes and all(
        e._donated_names == () for e in eng._drafter._exes.values())


# ----------------------------------------------------------------------
# Executor.donate_args (mxnet_tpu/executor.py:593-639)
# ----------------------------------------------------------------------
def _decode_step(pkg, ctx, sym_mod, **geo):
    sym = sym_mod.get_decode_step_symbol(block_size=4, num_blocks=16, **CFG)
    return sym.simple_bind(ctx=ctx, grad_req="null", data=(2, 1),
                           positions=(2, 1), block_table=(2, 12))


def test_donate_args_contract_matches_jax():
    """An unknown name raises in both packages, a known one and an empty
    sequence (donation off) return True."""
    jexe = _decode_step(jmx, jmx.cpu(), jtransformer)
    exe = _decode_step(mx, mx.cpu(), transformer)
    caches = ["layer0_k_cache", "layer0_v_cache"]
    for e, err in ((jexe, jmx.base.MXNetError), (exe, mx.MXNetError)):
        with pytest.raises(err, match="unknown argument 'nope'"):
            e.donate_args(["nope"])
        assert e.donate_args(caches) is True
        assert e.donate_args(()) is True
    assert exe._donated_names == ()


class _StandInProgram:
    """The graph's contract without a card: warm-up and capture run the
    body; a replay runs it again INTO the captured outputs (a replay
    rewrites the graph's static tensors)."""

    made = []

    def __init__(self, body, device, what, eager_hint, pool=None):
        self.body, self.what, self.pool = body, what, pool
        self.outs = None
        self.captured, self.captured_by_dtype = {"paged_decode_attend": 2}, {}
        _StandInProgram.made.append(self)

    def warm_up(self):
        return self.body()

    def capture(self):
        self.outs = self.body()
        return self.outs

    def replay(self):
        for static, new in zip(self.outs, self.body()):
            static.copy_(new)
        return self.outs


def _feeds(rng, step):
    return dict(data=rng.randint(0, 50, (2, 1)).astype(np.float32),
                positions=np.array([[step], [step + 3]], np.float32),
                block_table=np.arange(24, dtype=np.float32).reshape(2, 12)
                % 16)


def test_donated_forward_equals_a_fresh_executor(params, monkeypatch):
    """The donated path (its staging, replay, outputs and the recapture
    when a bound tensor is replaced) against a fresh executor's eager
    walk, across changing feeds and an in-place copy_params_from
    between forwards, with a stand-in graph on CPU tensors."""
    from types import SimpleNamespace
    monkeypatch.setattr(executor_mod, "Program", _StandInProgram)
    _StandInProgram.made.clear()
    tparams = convert_params(params, mx.cpu(), CFG)
    exe = _decode_step(mx, mx.cpu(), transformer)
    exe.copy_params_from({n: v for n, v in tparams.items()
                          if n in exe.arg_dict})
    caches = [n for n in exe.arg_dict if n.endswith("_cache")]
    exe.donate_args(caches)
    # the donated path runs where the device is CUDA; only its type is
    # read, the tensors stay on the CPU
    exe._device = SimpleNamespace(type="cuda")
    ref = _decode_step(mx, mx.cpu(), transformer)
    ref.copy_params_from({n: v for n, v in tparams.items()
                          if n in ref.arg_dict})
    rng = np.random.RandomState(3)
    outs_seen = []
    for step in range(4):
        if step == 2:
            # new weights copied INTO the bound tensors: no recapture
            rs = np.random.RandomState(5)
            new = {n: (v + rs.normal(0, 0.01, v.shape)).astype(np.float32)
                   for n, v in params.items()}
            exe.copy_params_from({n: v for n, v in new.items()
                                  if n in exe.arg_dict})
            ref.copy_params_from({n: v for n, v in new.items()
                                  if n in ref.arg_dict})
        f = _feeds(rng, step)
        got = exe.forward(is_train=False, **f)
        want = ref.forward(is_train=False, **f)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        outs_seen.append(got[0]._data)
    # one capture, replayed into the same static tensors
    assert len(_StandInProgram.made) == 1 and exe.captures == 1
    assert all(t is outs_seen[0] for t in outs_seen)
    assert exe.dispatches == 4 and exe.retraces == 0
    assert exe.captured_launches() == {"paged_decode_attend": 2}
    assert _StandInProgram.made[0].pool is exe._graph_pool
    assert "logits" in _StandInProgram.made[0].what
    # a bound tensor replaced: the next forward captures again, a retrace
    exe.arg_dict["lm_head_bias"]._set_data(
        exe.arg_dict["lm_head_bias"]._data.clone())
    f = _feeds(rng, 4)
    for a, b in zip(exe.forward(is_train=False, **f),
                    ref.forward(is_train=False, **f)):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert exe.captures == 2 and exe.retraces == 1
    # donation off: the eager walk again, nothing more captured; on
    # again: the graph captured before replays
    exe.donate_args(())
    f = _feeds(rng, 5)
    for a, b in zip(exe.forward(is_train=False, **f),
                    ref.forward(is_train=False, **f)):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert exe.captures == 2 and exe.dispatches == 6
    exe.donate_args(caches)
    f = _feeds(rng, 6)
    got = exe.forward(is_train=False, **f)
    for a, b in zip(got, ref.forward(is_train=False, **f)):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert exe.captures == 2 and len(_StandInProgram.made) == 2
    assert got[0]._data is _StandInProgram.made[1].outs[0]


def test_shared_exec_shares_the_graph_pool(params):
    """The prefill executor bound over the decode step's (shared_exec)
    captures into the decode step's graph pool."""
    dexe = _decode_step(mx, mx.cpu(), transformer)
    pexe = transformer.get_prefill_symbol(
        prefill_len=8, block_size=4, num_blocks=16, **CFG).simple_bind(
        ctx=mx.cpu(), grad_req="null", shared_exec=dexe, data=(2, 8),
        prompt_len=(2,), block_table=(2, 12))
    assert pexe._graph_pool is dexe._graph_pool
    assert _decode_step(mx, mx.cpu(), transformer)._graph_pool \
        is not dexe._graph_pool


def test_record_launches_counts_launches_on_a_capturing_stream(
        monkeypatch):
    """A capture's recorded launches: those made on a stream being
    captured, from any thread (autograd runs a captured backward on a
    thread of its own), not another thread's eager ones; the global
    counts move as before; one recording at a time."""
    import threading
    from mxnet_tpu_torch.kernels import dispatch
    capturing = set()
    monkeypatch.setattr(dispatch, "_capturing", lambda: threading.get_ident()
                        in capturing)
    saved = dict(dispatch.LAUNCHES), dict(dispatch.LAUNCHES_BY_DTYPE)

    def launch(name, n, captured):
        if captured:
            capturing.add(threading.get_ident())
        try:
            for _ in range(n):
                dispatch.count_launch(name, torch.bfloat16)
        finally:
            capturing.discard(threading.get_ident())

    try:
        n0 = dispatch.LAUNCHES["layernorm_fused"]
        with dispatch.record_launches() as (by_kernel, by_dtype):
            launch("paged_decode_attend", 1, True)
            for name, n, captured in (("layernorm_fused_bwd", 2, True),
                                      ("layernorm_fused", 5, False)):
                t = threading.Thread(target=launch,
                                     args=(name, n, captured))
                t.start()
                t.join()
            with pytest.raises(mx.MXNetError, match="recording is running"):
                with dispatch.record_launches():
                    pass
        dispatch.count_launch("paged_decode_attend")
        assert by_kernel == {"paged_decode_attend": 1,
                             "layernorm_fused_bwd": 2}
        assert by_dtype == {"paged_decode_attend:bfloat16": 1,
                            "layernorm_fused_bwd:bfloat16": 2}
        assert dispatch.LAUNCHES["layernorm_fused"] == n0 + 5
    finally:
        dispatch.LAUNCHES.update(saved[0])
        dispatch.LAUNCHES_BY_DTYPE.clear()
        dispatch.LAUNCHES_BY_DTYPE.update(saved[1])
