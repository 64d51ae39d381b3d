"""PyTorch port: the decode engine against the JAX package's, plus the
port's package rules (import hygiene, the card as default context).

Both engines get the same numpy parameters (tests/test_decode.py's tiny
config) and the same prompts; the JAX engine runs with the Pallas
kernels forced on in interpret mode, the port's on CPU tensors (the
plain versions).  Greedy streams must be equal token for token.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu.decode import DecodeEngine as JaxEngine

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.decode import DecodeEngine
from mxnet_tpu_torch.weights import convert_params, param_shapes

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2, seq_len=48)
ENGINE = dict(capacity=3, block_size=4, num_blocks=36, chunk_tokens=8)


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
def params():
    rng = np.random.RandomState(7)
    return {n: rng.normal(0, 0.1, s).astype(np.float32)
            for n, s in param_shapes(CFG).items()}


@pytest.fixture
def pallas(monkeypatch):
    """The JAX engine traces its step at the first dispatch, on its own
    thread, so the Pallas knobs stay set for the whole test."""
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    monkeypatch.setenv("MXNET_LN_IMPL", "pallas")


def _run(engine_cls, params, prompts, **kw):
    """Streams of ``prompts`` submitted at once; returns (tokens,
    stats, handles)."""
    eng = engine_cls(params, CFG, **{**ENGINE, **kw})
    try:
        hs = [eng.submit(p, **sub) for p, sub in prompts]
        outs = [h.result(timeout=120) for h in hs]
        return outs, eng.stats(), hs
    finally:
        eng.stop()


def _both(params, prompts, **kw):
    jax_out = _run(JaxEngine, params, prompts, **kw)
    port_out = _run(DecodeEngine, convert_params(params, mx.cpu(), CFG),
                    prompts, ctx=mx.cpu(), **kw)
    return jax_out, port_out


def test_engine_greedy_streams_match_jax(pallas, params):
    """Ragged prompts, one longer than three chunks, more requests than
    slots (admission mid-flight): equal greedy streams."""
    rng = np.random.RandomState(31)
    prompts = [(list(rng.randint(0, 50, n)), dict(max_new_tokens=6))
               for n in (3, 27, 11, 5)]
    (jout, jst, _), (out, st, _) = _both(params, prompts)
    assert jst["attn_impl"] == "pallas"
    assert out == jout
    assert st["completed"] == 4 and st["prefill_chunks"] >= 6
    assert st["cache"]["blocks_free"] == st["cache"]["num_blocks"]


def test_engine_preemption_by_recompute_matches_jax(pallas, params):
    """Cache pressure (7 blocks for 4 sequences) preempts the youngest
    and recomputes it; the streams still equal the JAX engine's."""
    prompts = [([i + 1, i + 2, i + 3], dict(max_new_tokens=10))
               for i in range(4)]
    (jout, jst, _), (out, st, _) = _both(params, prompts, capacity=4,
                                         num_blocks=7)
    assert st["preemptions"] > 0 and jst["preemptions"] > 0
    assert out == jout
    assert st["cache"]["blocks_free"] == st["cache"]["num_blocks"]


def test_engine_sampling_and_logits_match_jax(pallas, params):
    """Temperature sampling draws on the host from the sequence's seeded
    numpy RNG over the logits row, so one seed gives one stream in both
    packages; collected logits agree at the f32 bound."""
    prompts = [([4, 8, 15, 16, 23], dict(max_new_tokens=8, temperature=0.8,
                                         seed=42)),
               ([42, 1], dict(max_new_tokens=5, collect_logits=True))]
    (jout, _, jhs), (out, _, hs) = _both(params, prompts)
    assert out == jout
    np.testing.assert_allclose(np.stack(hs[1].logits),
                               np.stack(jhs[1].logits), rtol=2e-5,
                               atol=1e-6)


def test_engine_rejects_speculative_decoding(params):
    """Speculative decoding is ported (tests/test_torch_spec.py); what
    the engine still rejects, as the JAX engine does, is a forced draft
    model without a draft checkpoint and an unknown drafter."""
    for impl in ("draft", "medusa"):
        with pytest.raises(ValueError, match="MXNET_DECODE_SPEC_IMPL"):
            DecodeEngine(params, CFG, ctx=mx.cpu(), spec_k=2, start=False,
                         spec_impl=impl, **ENGINE)


def test_convert_params_checks_names_and_shapes(params):
    bad = dict(params)
    bad.pop("layer1_qkv_bias")
    with pytest.raises(mx.MXNetError, match="layer1_qkv_bias"):
        convert_params(bad, mx.cpu(), CFG)
    bad = dict(params, lm_head_weight=np.zeros((50, 8), np.float32))
    with pytest.raises(mx.MXNetError, match="lm_head_weight"):
        convert_params(bad, mx.cpu(), CFG)


# ----------------------------------------------------------------------
# package rules
# ----------------------------------------------------------------------
def test_current_context_raises_without_gpu(monkeypatch, params):
    """The card is the default; with no GPU an entry point that was not
    asked for the CPU raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.current_context()
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        DecodeEngine(params, CFG, start=False, **ENGINE)
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
    assert str(mx.gpu(1)) == "gpu(1)"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    assert len(files) > 20 and not bad
    code = ("import sys, mxnet_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
