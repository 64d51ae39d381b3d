"""PyTorch port: the LayerNorm forward (TPU kernel row 3,
``_ln_forward``) as the card runs it, emulated on the CPU.

On the card ``layernorm_fused`` (``mxnet_tpu_torch/csrc/layernorm.cu``)
gives each row to a group of warps (the fewest of 1, 2, 4 or 8 whose
registers hold it), each thread holding 8 values of it in either type.
The row mean and then the mean of the centred squares (the two-pass
variance) are each summed per thread in its own order, across the warp
by a butterfly of shuffles and across the group's warps in warp order;
padded columns add nothing.  Each output is ((x + res - mean) * rstd) *
gamma + beta with every operation rounded once, as the plain version
rounds it, and rounded to x's type once; rstd is the card's rsqrt,
within 2 ulp of the 1 / sqrt emulated here.  Wider rows (past 2048
columns) take a looped form (256 threads a row, the warps' sums in
order).  This file emulates that arithmetic in f32 torch and holds it
against ``layernorm_plain`` at ``chip_smoke.py``'s tolerance (rtol 1e-4
/ atol 1e-5), with and without a residual, at the served widths, at
ragged widths and at the widest width the wrapper took before the
forward kept its rows in registers.  The kernel itself runs only on the
card (``chip_smoke.py``'s layernorm and layernorm_bf16 phases); the
parity tests against the JAX package run the plain version, unchanged.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_layernorm_bwd import _row_sums

ln = importlib.import_module("mxnet_tpu_torch.kernels.layernorm")

RTOL, ATOL = 1e-4, 1e-5
EPS = 1e-5
VALS = 8          # values of a row a thread holds, in either type


def ln_fwd_emulated(x, gamma, beta, residual=None, eps=EPS):
    """(out, mean, rstd) as the forward computes them."""
    rows, cols = x.shape
    N, vals = 16 // x.element_size(), VALS
    v = x.float()
    if residual is not None:
        v = v + residual.float()
    inv = torch.tensor(1.0, dtype=torch.float32) / cols
    mean = _row_sums(v, cols, N, vals) * inv
    d = v - mean[:, None]
    var = _row_sums(d * d, cols, N, vals) * inv
    rstd = 1.0 / torch.sqrt(var + eps)
    out = d * rstd[:, None] * gamma.float() + beta.float()
    return out.to(x.dtype), mean, rstd


def _case(rows, cols, residual, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x, res = (torch.from_numpy(rng.randn(rows, cols).astype(np.float32))
              .to(dtype) for _ in range(2))
    gamma = torch.from_numpy((1 + 0.02 * rng.randn(cols)).astype(np.float32))
    beta = torch.from_numpy((0.02 * rng.randn(cols)).astype(np.float32))
    return x, gamma.to(dtype), beta.to(dtype), res if residual else None


# (rows, cols): the serve steps' rows (8 decode, 40 spec spans, 64
# chunk) and more at the model's width (eight warps a row), one warp a
# row, two, four with a ragged row end, a width off the 16-byte vector,
# tiny rows, the looped form (4096), and the widest row the wrapper took
# with a shared-memory row buffer (58112)
WIDTHS = [(8, 2048), (40, 2048), (64, 2048), (600, 2048), (300, 256),
          (200, 512), (96, 1000), (64, 2046), (5, 100), (3, 1), (40, 4096),
          (24, 6000), (8, 14528), (4, 58112)]


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("rows,cols", WIDTHS,
                         ids=["%dx%d" % w for w in WIDTHS])
def test_row_groups_hold_the_card_tolerance(rows, cols, residual):
    x, gamma, beta, res = _case(rows, cols, residual, seed=rows + cols)
    got = ln_fwd_emulated(x, gamma, beta, residual=res)
    ref = ln.layernorm_plain(x, gamma, beta, residual=res)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.allclose(a, b, rtol=RTOL, atol=ATOL), \
            float((a - b).abs().max())


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("rows,cols", [(512, 2048), (48, 2046), (16, 6000)])
def test_bf16_rounds_once(rows, cols, residual):
    """bf16 x, residual, gamma and beta (eight warps a row at 2048 and at
    a width off the vector, the looped form at 6000): f32 arithmetic and
    one rounding of each output, within one bf16 ulp of the plain
    version's rounding; the f32 statistics at the f32 bound."""
    x, gamma, beta, res = _case(rows, cols, residual, seed=7,
                                dtype=torch.bfloat16)
    out, mean, rstd = ln_fwd_emulated(x, gamma, beta, residual=res)
    ref_out, ref_mean, ref_rstd = ln.layernorm_plain(x, gamma, beta,
                                                     residual=res)
    assert out.dtype == ref_out.dtype == torch.bfloat16
    a, b = out.float(), ref_out.float()
    assert bool(((a - b).abs() <= 2.0 ** -7 * b.abs()).all())
    for a, b in ((mean, ref_mean), (rstd, ref_rstd)):
        assert torch.allclose(a, b, rtol=RTOL, atol=ATOL)


def test_two_pass_variance_keeps_a_large_mean():
    """Rows far from zero (mean 1000, spread 1): the centred squares keep
    the variance that E[x^2] - E[x]^2 in f32 loses."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((1000 + rng.randn(16, 2048)).astype(np.float32))
    gamma, beta = torch.ones(2048), torch.zeros(2048)
    _, mean, rstd = ln_fwd_emulated(x, gamma, beta)
    _, ref_mean, ref_rstd = ln.layernorm_plain(x, gamma, beta)
    assert torch.allclose(rstd, ref_rstd, rtol=RTOL, atol=ATOL)
    naive = (x * x).mean(dim=1) - x.mean(dim=1) ** 2
    assert not torch.allclose(torch.rsqrt(naive + EPS), ref_rstd, rtol=RTOL,
                              atol=ATOL)
