"""PyTorch port: the one-shot paged prefill, its op, the serving
symbols' new op core and the prefill/decode-step pair, held against
the JAX package.

Inputs come from seeded numpy RandomStates and go to both packages.
The JAX kernel runs in Pallas interpret mode (as tests/test_pallas.py
runs it on the CPU), the port's wrapper on CPU tensors, which takes the
plain PyTorch version.  Outputs are compared at the JAX suite's f32
bound (rtol 2e-5, atol 1e-6); where both packages write the caches from
the SAME K/V inputs (the kernel tests) the caches must be equal byte for
byte, and where each computes K/V by its own projection (the op, the
symbols) at the f32 bound.  The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.pallas import paged_prefill_attend as jax_prefill

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import (PLAIN_CALLS, paged_chunk_prefill_attend,
                                     paged_prefill_attend, reset_counts)
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.ops import nn
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.weights import convert_params

RTOL, ATOL = 2e-5, 1e-6
CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2, seq_len=48)


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
    """The JAX ops take their Pallas kernels (interpret mode) for the
    whole test."""
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _table(rng, B, M, nb, bs, lengths):
    """Each row's real blocks from one permutation of the cache, the
    padding entries out-of-range ids (never to be dereferenced); block
    nb - 1 is left to no row."""
    perm = rng.permutation(nb - 1)
    table = rng.randint(10 * nb, 20 * nb, (B, M)).astype(np.int32)
    used = 0
    for b, n in enumerate(lengths):
        nblk = -(-n // bs)
        table[b, :nblk] = perm[used:used + nblk]
        used += nblk
    return table


# ----------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bs,S,M,lengths", [
    (8, 16, 2, (16, 9, 0)),          # S a block multiple, one empty row
    (8, 11, 2, (11, 4, 1)),          # S not a multiple of bs
    (16, 13, 3, (0, 13, 7)),         # table wider than S needs
    (4, 19, 7, (19, 0, 18)),         # five blocks a row, padding past 5
])
def test_prefill_matches_pallas(bs, S, M, lengths):
    """Every one of the S output rows (rows past a length included), and
    the caches byte for byte: rows below each length land in their
    table block, every other byte is the input's."""
    rng = np.random.RandomState(5)
    B, H, D, nb = len(lengths), 2, 8, 16
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    table = _table(rng, B, M, nb, bs, lengths)
    L = np.array(lengths, np.int32)
    sc = 1.0 / np.sqrt(D)
    ref, jk, jv = jax_prefill(*(jnp.asarray(a) for a in (q, k, v, kc, vc,
                                                         table, L)),
                              scale=sc, interpret=True)
    tk, tv = _t(kc), _t(vc)
    out, ko, vo = paged_prefill_attend(_t(q), _t(k), _t(v), tk, tv,
                                       _t(table), _t(L), scale=sc)
    assert ko is tk and vo is tv                     # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the rows the scatter may write, and nothing else, changed
    rows = {int(table[b, j // bs]) * bs + j % bs
            for b, n in enumerate(lengths) for j in range(n)}
    changed = np.nonzero((tk.numpy() != kc).reshape(nb * bs, -1)
                         .any(axis=1))[0]
    assert set(changed.tolist()) <= rows


def test_prefill_bf16_caches_match_pallas():
    """bf16 caches, f32 inputs: both round the written rows to bf16 the
    same way (cache bytes equal) and attend in f32 from the inputs."""
    rng = np.random.RandomState(6)
    B, S, H, D, nb, bs, M = 2, 10, 2, 8, 8, 4, 3
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    kc = jnp.asarray(_rand(rng, nb, bs, H, D)).astype(jnp.bfloat16)
    vc = jnp.asarray(_rand(rng, nb, bs, H, D)).astype(jnp.bfloat16)
    lengths = (10, 6)
    table = _table(rng, B, M, nb, bs, lengths)
    L = np.array(lengths, np.int32)
    sc = 1.0 / np.sqrt(D)
    ref, jk, jv = jax_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kc, vc, jnp.asarray(table), jnp.asarray(L),
                              scale=sc, interpret=True)
    tk = _t(np.asarray(kc.astype(jnp.float32))).to(torch.bfloat16)
    tv = _t(np.asarray(vc.astype(jnp.float32))).to(torch.bfloat16)
    out, _, _ = paged_prefill_attend(_t(q), _t(k), _t(v), tk, tv, _t(table),
                                     _t(L), scale=sc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))


def test_prefill_rejects_a_narrow_table():
    """The JAX function's contract: the table addresses every block of
    an S-token prompt."""
    q = torch.zeros(1, 9, 2, 4)
    kc = torch.zeros(4, 4, 2, 4)
    with pytest.raises(MXNetError, match="block_table width 2 < 3"):
        paged_prefill_attend(q, q, q, kc, kc.clone(),
                             torch.zeros(1, 2, dtype=torch.int32),
                             torch.tensor([9], dtype=torch.int32), scale=0.5)


@pytest.mark.parametrize("bs,S,K", [(8, 19, 8), (4, 13, 8), (8, 30, 16),
                                    (8, 21, 6)])
def test_chunked_prefill_reproduces_one_shot_cache(bs, S, K):
    """The port's chunk prefill fed K rows at a time over a live cache
    writes the same cache bytes as the port's one-shot prefill, and its
    outputs agree at the f32 bound (the oracle of tests/test_pallas.py,
    within the port)."""
    rng = np.random.RandomState(21)
    B, H, D, nb = 1, 2, 8, 12
    M = -(-S // bs) + 1
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    table = ((np.arange(M) + 3) % nb).astype(np.int32).reshape(B, M)
    sc = 1.0 / np.sqrt(D)
    ok, ov = _t(kc), _t(vc)
    ref, _, _ = paged_prefill_attend(_t(q), _t(k), _t(v), ok, ov, _t(table),
                                     _t(np.array([S], np.int32)), scale=sc)
    ck, cv = _t(kc), _t(vc)
    outs, st = [], 0
    while st < S:
        L = min(K, S - st)
        pad = [np.zeros((B, K, H, D), np.float32) for _ in range(3)]
        for p, a in zip(pad, (q, k, v)):
            p[:, :L] = a[:, st:st + L]
        o, _, _ = paged_chunk_prefill_attend(
            *(_t(p) for p in pad), ck, cv, _t(table),
            _t(np.array([st], np.int32)), _t(np.array([L], np.int32)),
            scale=sc)
        outs.append(o.numpy()[:, :L])
        st += L
    np.testing.assert_array_equal(ck.numpy(), ok.numpy())
    np.testing.assert_array_equal(cv.numpy(), ov.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), ref.numpy(),
                               rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# the op and the new op core
# ----------------------------------------------------------------------
def test_paged_prefill_op_matches_jax(pallas):
    """``_contrib_PagedPrefillAttention`` in both packages: the hidden
    output of every row and the new caches (each package projects K/V
    itself, so at the f32 bound), the caches updated in place."""
    rng = np.random.RandomState(23)
    B, S, d, H, nb, bs, M = 3, 11, 16, 2, 16, 4, 4
    D = d // H
    data = _rand(rng, B, S, d)
    w = [_rand(rng, 3 * d, d), _rand(rng, 3 * d), _rand(rng, d, d),
         _rand(rng, d)]
    kc, vc = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    lengths = (11, 0, 6)
    table = _table(rng, B, M, nb, bs, lengths).astype(np.float32)
    L = np.array(lengths, np.float32)
    from mxnet_tpu.pallas.dispatch import PALLAS_LAUNCHES
    jl = PALLAS_LAUNCHES.labels(kernel="paged_prefill_attend")
    before = jl.value
    ref = jnn.paged_prefill_attention(
        *(jnp.asarray(a) for a in [data] + w + [kc, vc, table, L]),
        num_heads=H)
    assert jl.value == before + 1                    # the Pallas kernel ran
    tk, tv = _t(kc), _t(vc)
    reset_counts()
    out = get_op("PagedPrefillAttention").fn(
        *(_t(a) for a in [data] + w), tk, tv, _t(table), _t(L), num_heads=H)
    assert PLAIN_CALLS["paged_prefill_attend"] == 1
    assert out[1] is tk and out[2] is tv
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               rtol=RTOL, atol=ATOL)
    for got, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


_CORE_CASES = {
    "slice_axis": (lambda r: [_rand(r, 1, 7, 3)],
                   dict(axis=1, begin=0, end=5)),
    "slice_axis_end_none": (lambda r: [_rand(r, 4, 6)],
                            dict(axis=-1, begin=2, end=None)),
    "broadcast_mul": (lambda r: [_rand(r, 1, 5), _rand(r, 3, 1)], {}),
    "broadcast_equal": (lambda r: [np.arange(6, dtype=np.float32)[None],
                                   np.full((1, 1), 3.0, np.float32)], {}),
    "_mul_scalar": (lambda r: [_rand(r, 4)], dict(scalar=2.5)),
    "Concat": (lambda r: [_rand(r, 1), _rand(r, 1), _rand(r, 1)],
               dict(num_args=3, dim=0)),
    "Concat_dim1": (lambda r: [_rand(r, 2, 3), _rand(r, 2, 1)],
                    dict(num_args=2, dim=1)),
}


@pytest.mark.parametrize("case", sorted(_CORE_CASES))
def test_new_op_core_matches_jax(case):
    """The ops the prefill and draft symbols add, op by op."""
    make, attrs = _CORE_CASES[case]
    name = case.replace("_end_none", "").replace("_dim1", "")
    ins = make(np.random.RandomState(5))
    ref = np.asarray(jget_op(name).fn(*(jnp.asarray(a) for a in ins),
                                      **attrs))
    got = get_op(name).fn(*(_t(a) for a in ins), **attrs).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_symbol_mul_slice_and_concat_infer_like_jax():
    """``Symbol.__mul__``, ``slice_axis`` and a variadic ``Concat``
    compose and infer shapes as in the JAX package."""
    from mxnet_tpu import symbol as jsym
    from mxnet_tpu_torch import symbol as sym
    outs = []
    for s in (jsym, sym):
        a, b = s.Variable("a"), s.Variable("b")
        y = s.Concat(a * b, (a * 2.0).slice_axis(axis=1, begin=1, end=3),
                     dim=1, name="cat")
        outs.append((y.list_arguments(), y.list_outputs(),
                     [tuple(x) for x in y.infer_shape(a=(2, 4),
                                                      b=(1, 4))[1]]))
    assert outs[0] == outs[1] == (["a", "b"], ["cat_output"], [(2, 6)])


# ----------------------------------------------------------------------
# the serving symbols and the prefill/decode-step pair
# ----------------------------------------------------------------------
def _jax_params():
    """Random parameters under the JAX training symbol's names and
    shapes: a JAX checkpoint."""
    tsym = jtransformer.get_symbol(**CFG)
    arg_shapes, _, _ = tsym.infer_shape(data=(1, CFG["seq_len"]),
                                        softmax_label=(CFG["seq_len"],))
    rng = np.random.RandomState(7)
    return {n: rng.normal(0, 0.1, s).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


_SYMBOLS = {
    "decode_step": (lambda m, **kw: m.get_decode_step_symbol(**kw),
                    dict(data=(2, 1), positions=(2, 1), block_table=(2, 12))),
    "prefill": (lambda m, **kw: m.get_prefill_symbol(prefill_len=16, **kw),
                dict(data=(2, 16), prompt_len=(2,), block_table=(2, 12))),
    "spec_step": (lambda m, **kw: m.get_spec_step_symbol(**kw),
                  dict(data=(3, 4), positions=(3, 4), span_start=(3,),
                       span_len=(3,), block_table=(3, 12),
                       chunk_data=(1, 8), chunk_positions=(1, 8),
                       chunk_start=(1,), chunk_len=(1,),
                       chunk_table=(1, 12))),
    "draft_span": (lambda m, **kw: m.get_draft_span_symbol(
        3, **{k: v for k, v in kw.items() if "block" not in k}),
        dict(data=(1, 48), length=(1,), iota=(1, 48))),
}


@pytest.mark.parametrize("which", sorted(_SYMBOLS))
def test_jax_checkpoint_binds_serving_symbol(which):
    """Each new serving symbol has the JAX symbol's arguments, outputs
    and shapes, and a JAX checkpoint converted by ``convert_params``
    binds every one of its parameters."""
    build, shapes = _SYMBOLS[which]
    kw = dict(block_size=4, num_blocks=16, **CFG)
    jsym, psym = build(jtransformer, **kw), build(transformer, **kw)
    assert psym.list_arguments() == jsym.list_arguments()
    assert psym.list_outputs() == jsym.list_outputs()
    jshape, pshape = jsym.infer_shape(**shapes), psym.infer_shape(**shapes)
    for j, p in zip(jshape[:2], pshape[:2]):
        assert [tuple(x) for x in j] == [tuple(x) for x in p]
    params = convert_params(_jax_params(), mx.cpu(), CFG)
    exe = psym.simple_bind(ctx=mx.cpu(), grad_req="null", **shapes)
    weights = [n for n in exe.arg_dict
               if n not in shapes and not n.endswith("_cache")]
    assert sorted(weights) == sorted(params)
    exe.copy_params_from(params)


def test_prefill_then_decode_matches_jax(pallas):
    """The pair bound with ``shared_exec`` (the same weight and cache
    objects) in both packages: prefill two ragged prompts padded to 16,
    then decode-step forwards over the shared caches; the logits agree
    at every step at the f32 bound and the greedy tokens are equal.
    tests/test_decode.py's prefill-then-decode test, port against JAX."""
    params = _jax_params()
    bs, nb, P, bucket = 4, 16, (11, 6), 16
    M = -(-CFG["seq_len"] // bs)
    rng = np.random.RandomState(9)
    toks = rng.randint(0, 50, (2, CFG["seq_len"])).astype(np.float32)
    table = np.zeros((2, M), np.float32)
    table[0, :6] = np.arange(6)[::-1] + 1
    table[1, :6] = np.arange(6) + 8
    geo = dict(block_size=bs, num_blocks=nb, **CFG)
    runs = []
    for pkg, ctx, wrap in ((jtransformer, jmx.cpu(), JNDArray),
                           (transformer, mx.cpu(), np.asarray)):
        dexe = pkg.get_decode_step_symbol(**geo).simple_bind(
            ctx=ctx, grad_req="null", data=(2, 1), positions=(2, 1),
            block_table=(2, M))
        dexe.copy_params_from({k: wrap(v) for k, v in params.items()}, {},
                              allow_extra_params=True)
        pexe = pkg.get_prefill_symbol(prefill_len=bucket, **geo).simple_bind(
            ctx=ctx, grad_req="null", shared_exec=dexe, data=(2, bucket),
            prompt_len=(2,), block_table=(2, M))
        assert pexe.arg_dict["lm_head_weight"] is \
            dexe.arg_dict["lm_head_weight"]
        assert pexe.arg_dict["layer1_v_cache"] is \
            dexe.arg_dict["layer1_v_cache"]
        caches = [n for n in dexe.arg_dict if n.endswith("_cache")]
        pad = np.zeros((2, bucket), np.float32)
        for b, n in enumerate(P):
            pad[b, :n] = toks[b, :n]
        outs = pexe.forward(is_train=False, data=pad,
                            prompt_len=np.asarray(P, np.float32),
                            block_table=table)
        for j, nm in enumerate(caches):          # the JAX caches are
            dexe.arg_dict[nm]._set_data(outs[2 + j]._data)   # returned
        got = [(outs[0].asnumpy(), outs[1].asnumpy())]
        for t in range(6):
            pos = np.asarray([[P[0] + t], [P[1] + t]], np.float32)
            data = np.stack([toks[0, P[0] + t], toks[1, P[1] + t]])[:, None]
            outs = dexe.forward(is_train=False, data=data, positions=pos,
                                block_table=table)
            for j, nm in enumerate(caches):
                dexe.arg_dict[nm]._set_data(outs[2 + j]._data)
            got.append((outs[0].asnumpy(), outs[1].asnumpy()))
        runs.append((got, [dexe.arg_dict[n].asnumpy() for n in caches]))
    (jgot, jcache), (pgot, pcache) = runs
    for (jl, jt), (pl, pt) in zip(jgot, pgot):
        np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(pt, jt)
    for p, j in zip(pcache, jcache):
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)


def test_shared_exec_shares_by_name_and_shape():
    """Only arguments whose name AND shape match are shared; the rest
    are the new executor's own."""
    a = mx.sym.Variable("w") * mx.sym.Variable("x")
    e1 = a.simple_bind(ctx=mx.cpu(), w=(2, 3), x=(2, 3))
    e2 = a.simple_bind(ctx=mx.cpu(), shared_exec=e1, w=(2, 3), x=(1, 3))
    assert e2.arg_dict["w"] is e1.arg_dict["w"]
    assert e2.arg_dict["x"] is not e1.arg_dict["x"]
    e1.arg_dict["w"][:] = np.full((2, 3), 2.0, np.float32)
    out = e2.forward(x=np.full((1, 3), 3.0, np.float32))[0].asnumpy()
    np.testing.assert_array_equal(out, np.full((2, 3), 6.0, np.float32))
