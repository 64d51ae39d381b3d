"""PyTorch port: the bf16 prefill/decode-step pair against the bf16
mixed-step engine, held against the same gap in the JAX package.

On the card, at 12 layers, the pair's first-token logits sit about 1%
(relative L2) from the mixed engine's.  This test measures that gap at
2 layers and a narrow width on the CPU in both packages (the JAX side
with its Pallas kernels in interpret mode) from the same numpy weights
and prompts: the port's gap is no larger than the JAX package's (both
are at or near 0 here), so the card's gap comes from the card's kernels
and products, not from an op of the port's serving symbols.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.decode import DecodeEngine as JaxEngine
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.decode import DecodeEngine
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.weights import convert_params, param_shapes

CFG = dict(num_classes=256, num_layers=2, d_model=128, num_heads=4,
           seq_len=64, dtype="bfloat16")
ENGINE = dict(capacity=3, block_size=4, num_blocks=80, chunk_tokens=8)
LENGTHS = (60, 33, 9, 47)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _engine_first(engine_cls, params, prompts, **kw):
    eng = engine_cls(params, CFG, **ENGINE, **kw)
    try:
        hs = [eng.submit(p, max_new_tokens=1, collect_logits=True)
              for p in prompts]
        for h in hs:
            h.result(timeout=300)
        return [np.asarray(h.logits[0], np.float32) for h in hs]
    finally:
        eng.stop()


def _pair_first(pkg, ctx, params, prompts):
    """The first token's logits of one prefill forward of the pair."""
    bs, B, S = ENGINE["block_size"], len(prompts), CFG["seq_len"]
    Mt = -(-S // bs)
    geo = dict(block_size=bs, num_blocks=ENGINE["num_blocks"], **CFG)
    dexe = pkg.get_decode_step_symbol(**geo).simple_bind(
        ctx=ctx, grad_req="null", data=(B, 1), positions=(B, 1),
        block_table=(B, Mt))
    if pkg is jtransformer:
        dexe.copy_params_from({k: JNDArray(v) for k, v in params.items()},
                              {}, allow_extra_params=True)
    else:
        dexe.copy_params_from(params)
    pexe = pkg.get_prefill_symbol(prefill_len=S, **geo).simple_bind(
        ctx=ctx, grad_req="null", shared_exec=dexe, data=(B, S),
        prompt_len=(B,), block_table=(B, Mt))
    data = np.zeros((B, S), np.float32)
    table = np.zeros((B, Mt), np.float32)
    used = 0
    for b, p in enumerate(prompts):
        data[b, :len(p)] = p
        n = -(-(len(p) + 1) // bs)
        table[b, :n] = np.arange(used, used + n)
        used += n
    outs = pexe.forward(is_train=False, data=data, block_table=table,
                        prompt_len=np.asarray([len(p) for p in prompts],
                                              np.float32))
    return [np.asarray(row, np.float32) for row in outs[0].asnumpy()]


def test_pair_first_token_gap_no_larger_than_jax(pallas):
    rng = np.random.RandomState(7)
    np_params = {n: rng.normal(0, 0.1, s).astype(np.float32)
                 for n, s in param_shapes(CFG).items()}
    r = np.random.RandomState(5)
    prompts = [list(r.randint(0, CFG["num_classes"], n)) for n in LENGTHS]
    jax_gap = [_rel_l2(p, e) for p, e in zip(
        _pair_first(jtransformer, jmx.cpu(), np_params, prompts),
        _engine_first(JaxEngine, np_params, prompts))]
    params = convert_params(np_params, mx.cpu(), CFG)
    pair = _pair_first(transformer, mx.cpu(), params, prompts)
    engine = _engine_first(DecodeEngine, params, prompts, ctx=mx.cpu())
    port_gap = [_rel_l2(p, e) for p, e in zip(pair, engine)]
    assert all(p <= j for p, j in zip(port_gap, jax_gap)), \
        (port_gap, jax_gap)
    assert max(jax_gap) <= 1e-5
