"""PyTorch port: the LayerNorm backward (TPU kernel row 4,
``_ln_backward``) as the card runs it, emulated on the CPU.

On the card ``layernorm_fused_bwd`` (``mxnet_tpu_torch/csrc/layernorm.cu``)
gives each row to a group of warps (up to 8), each thread holding 16
values of a bf16 row or 8 of an f32 row (or of a row not read by 16-byte
vectors): the two row means are summed per thread in its own order,
across the warp by a butterfly of shuffles and across the group's warps
in warp order; each thread keeps its
columns' dgamma and dbeta partials over the rows its group takes in
turn, the block sums its groups' partials in group order, and a second
kernel sums the blocks' partials column by column in 32 fixed slices
and then the slices in order.  Wider rows (past 2048 columns in f32,
4096 in bf16) take a looped form (one row a block, the partials over
the block's rows in order).  This file emulates that arithmetic in f32 torch and holds it
against ``layernorm_bwd_plain`` at ``chip_smoke.py``'s tolerance (rtol
1e-4; atol 1e-5 for dx, 2e-4 for dgamma and dbeta), with and without a
residual, at ragged widths and at the widest width the wrapper takes.
The kernel itself runs only on the card (``chip_smoke.py``'s
layernorm_bwd and layernorm_bf16 phases); the parity tests against the
JAX package run the plain version, unchanged.
"""
import importlib

import numpy as np
import pytest
import torch

ln = importlib.import_module("mxnet_tpu_torch.kernels.layernorm")

RTOL, ATOL, ATOL_SUMS = 1e-4, 1e-5, 2e-4
THREADS = 256               # threads a block
SLICES = 32                 # stage 2's slices a column


def _vals(x, cols):
    """Values of a row a thread holds: 16 of bf16 read by 16-byte
    vectors, else 8."""
    return 16 if x.element_size() == 2 and cols % 8 == 0 else 8


def _seq(v):
    """Sum over the last axis one element at a time, in f32."""
    acc = torch.zeros(v.shape[:-1])
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def _butterfly(v):
    """A warp's xor-shuffle sum over the last axis (32 lanes)."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    return v[..., 0]


def _row_sums(a, cols, N, vals):
    """Per row: each thread's values in its own order, the butterfly in
    each warp, the warps in order.  ``a`` is (rows, cols)."""
    rows = a.shape[0]
    gw = -(-cols // (32 * vals))
    if gw <= 8:                       # the register form
        gw = 1 << (gw - 1).bit_length()
        gt = 32 * gw
        cw = gt * vals
        p = torch.nn.functional.pad(a, (0, cw - cols))
        # column (t + j gt) N + e belongs to thread t, value (j, e)
        p = p.reshape(rows, vals // N, gt, N).permute(0, 2, 1, 3)
        per_thread = _seq(p.reshape(rows, gw, 32, vals))
    else:                             # the looped form: 256 threads a row
        step = THREADS * N
        p = torch.nn.functional.pad(a, (0, -(-cols // step) * step - cols))
        p = p.reshape(rows, -1, THREADS, N).permute(0, 2, 1, 3)
        per_thread = _seq(p.reshape(rows, THREADS // 32, 32, -1))
    return _seq(_butterfly(per_thread))


def ln_bwd_emulated(x, gamma, mean, rstd, dy, residual=None):
    """dx, dgamma, dbeta as the two stages compute them."""
    rows, cols = x.shape
    N, vals = 16 // x.element_size(), _vals(x, cols)
    xf = x.float() + (residual.float() if residual is not None else 0)
    dyf = dy.float()
    xh = (xf - mean[:, None]) * rstd[:, None]
    g = dyf * gamma.float()
    inv = torch.tensor(1.0, dtype=torch.float32) / cols
    m1 = _row_sums(g, cols, N, vals) * inv
    m2 = _row_sums(g * xh, cols, N, vals) * inv
    dx = rstd[:, None] * (g - m1[:, None] - xh * m2[:, None])
    # stage 1: each block's rows, its groups taking them in turn
    per_block = -(-rows // ln._BWD_BLOCKS)
    nblk = -(-rows // per_block)
    gw = -(-cols // (32 * vals))
    groups = THREADS // (32 * (1 << (gw - 1).bit_length())) if gw <= 8 else 1
    parts = torch.zeros(2, nblk, cols)
    for b in range(nblk):
        r0, r1 = b * per_block, min((b + 1) * per_block, rows)
        block = torch.zeros(2, cols)
        for k in range(groups):
            acc = torch.zeros(2, cols)
            for r in range(r0 + k, r1, groups):
                acc = acc + torch.stack([dyf[r] * xh[r], dyf[r]])
            block = block + acc
        parts[:, b] = block
    # stage 2: slice s sums blocks s, s + 32, ... in order, then the slices
    total = torch.zeros(2, cols)
    for s in range(SLICES):
        acc = torch.zeros(2, cols)
        for i in range(s, nblk, SLICES):
            acc = acc + parts[:, i]
        total = total + acc
    return dx.to(x.dtype), total[0].to(gamma.dtype), total[1].to(gamma.dtype)


def _case(rows, cols, residual, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x, res, dy = (torch.from_numpy(rng.randn(rows, cols).astype(np.float32))
                  .to(dtype) for _ in range(3))
    gamma = torch.from_numpy((1 + 0.02 * rng.randn(cols)).astype(np.float32))
    beta = torch.from_numpy((0.02 * rng.randn(cols)).astype(np.float32))
    gamma, beta = gamma.to(dtype), beta.to(dtype)
    r = res if residual else None
    _, mean, rstd = ln.layernorm_plain(x, gamma, beta, residual=r)
    return x, gamma, mean, rstd, dy, r


# (rows, cols): the training width (eight warps a row in f32), one warp
# a row, two, four with a ragged row end, a width off the 16-byte vector,
# the looped form (4096 in f32), and the widest row the wrapper takes
WIDTHS = [(600, 2048), (300, 256), (200, 512), (96, 1000), (64, 2046),
          (40, 4096), (24, 6000), (16, 14528)]


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("rows,cols", WIDTHS,
                         ids=["%dx%d" % w for w in WIDTHS])
def test_row_groups_hold_the_card_tolerance(rows, cols, residual):
    args = _case(rows, cols, residual, seed=rows + cols)
    got = ln_bwd_emulated(*args[:5], residual=args[5])
    ref = ln.layernorm_bwd_plain(*args[:5], residual=args[5])
    for a, b, atol in zip(got, ref, (ATOL, ATOL_SUMS, ATOL_SUMS)):
        assert torch.allclose(a, b, rtol=RTOL, atol=atol), \
            float((a - b).abs().max())


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("cols", [2048, 2046, 6000])
def test_bf16_rounds_once(cols, residual):
    """bf16 x, dy, gamma (four warps a row at 2048, eight of 8 values at a
    width off the vector, the looped form at 6000): f32 arithmetic, each
    output rounded once, within one bf16 ulp of the plain version's
    rounding (the sums of dgamma and dbeta also within 2^-9 of their
    largest magnitude)."""
    args = _case(512 if cols == 2048 else 48, cols, residual, seed=5,
                 dtype=torch.bfloat16)
    got = ln_bwd_emulated(*args[:5], residual=args[5])
    ref = ln.layernorm_bwd_plain(*args[:5], residual=args[5])
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        lim = 2.0 ** -7 * b.abs() + 2.0 ** -9 * float(b.abs().max())
        assert bool(((a - b).abs() <= lim).all())


def test_widest_row_the_wrapper_takes():
    """The wrapper's width limit is unchanged: 16 bytes a column of the
    old shared-memory row buffers, 14528 columns."""
    assert ln._MAX_SMEM // 16 == WIDTHS[-1][1]
