"""PyTorch port: the split-context chunked prefill (TPU kernel row 2,
``paged_chunk_prefill_attend``) in split TF32, emulated on the CPU.

On the card the chunk kernel (``mxnet_tpu_torch/csrc/paged_attention.cu``)
splits each row's keys [0, M * block_size) into fixed ranges of
``key_range`` keys (``chunk_plan``, a function of the static shapes),
runs the f32 flash forward of ``csrc/attention_f32.cuh`` over each
range in tiles of 32 keys (scores and P V in split TF32, the online
softmax in f32, keys past a row's position masked to the finite -1e30),
writes each range's unnormalised sums and its running max and sum, and
a second kernel combines a row's ranges in order.  This file emulates
that arithmetic in torch with the helpers of ``test_torch_flash_f32.py``
and holds it against ``paged_chunk_prefill_attend_plain`` at the card's
tolerance (rtol 1e-4 / atol 1e-5, ``chip_smoke.py``'s) at the mixed
step's chunk and the spec step's spans (small head_dim), with a ragged
length, a zero length and a scrambled table; it also checks that the
launch plan depends on shapes alone and fills the card at both served
shapes.  The kernel itself runs only on the card (``chip_smoke.py``'s
chunk and head_dim phases); the parity tests against the JAX package
run the plain version, unchanged.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

from test_torch_flash_f32 import ATOL, RTOL, mm_one, mm_split

pa = importlib.import_module("mxnet_tpu_torch.kernels.paged_attention")

STEP = 32          # keys a stage of the kernel


def chunk_emulated(q, k, v, kc, vc, table, starts, lens, scale, key_range,
                   mm):
    """The kernel's arithmetic on (B, K, H, D) chunk rows: the scatter of
    each row's real K/V rows (rounded to the cache type), then per key
    range an online softmax over 32-key tiles with every product through
    ``mm``, then the ordered combine of a row's ranges.  Padded rows are
    zeros.  Writes the caches in place."""
    B, K, H, D = q.shape
    nb, bs = kc.shape[:2]
    M = table.shape[1]
    kf, vf = kc.view(nb * bs, H, D), vc.view(nb * bs, H, D)
    out = torch.zeros(B, K, H, D)
    for b in range(B):
        st = int(starts[b])
        L = max(0, min(int(lens[b]), K, M * bs - st))
        if L == 0:
            continue
        pos = st + torch.arange(L)
        rows = table[b, pos // bs].long() * bs + pos % bs
        kf[rows] = k[b, :L].to(kc.dtype)
        vf[rows] = v[b, :L].to(vc.dtype)
        ctx = torch.arange(st + L)
        cr = table[b, ctx // bs].long() * bs + ctx % bs
        keys = kf[cr].float().transpose(0, 1)                  # (H, ctx, D)
        vals = vf[cr].float().transpose(0, 1)
        qh = q[b, :L].float().transpose(0, 1)                  # (H, L, D)
        parts = []
        for k0 in range(0, st + L, key_range):
            k1 = min(k0 + key_range, st + L)
            m = torch.full((H, L), float("-inf"))
            lsum = torch.zeros(H, L)
            acc = torch.zeros(H, L, D)
            for t0 in range(k0, k1, STEP):
                t1 = min(t0 + STEP, k1)
                s = mm(qh, keys[:, t0:t1].transpose(1, 2)) * scale
                c = torch.arange(t0, t1)
                masked = c[None, :] > (st + torch.arange(L))[:, None]
                s = s.masked_fill(masked, -1e30)
                mx = torch.maximum(m, s.max(-1).values)
                alpha = torch.exp(m - mx)
                p = torch.exp(s - mx[..., None])
                lsum = lsum * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + mm(p, vals[:, t0:t1])
                m = mx
            parts.append((m, lsum, acc))
        for i in range(L):
            n = (st + i) // key_range + 1
            ms = torch.stack([parts[r][0][:, i] for r in range(n)])  # (n, H)
            w = torch.exp(ms - ms.max(0).values)
            lw = sum(parts[r][1][:, i] * w[r] for r in range(n))
            aw = sum(parts[r][2][:, i] * w[r][:, None] for r in range(n))
            out[b, i] = aw / lw[:, None]
    return out.to(q.dtype)


def _case(B, K, H, D, nb, bs, M, starts, lens, seed, cdt=torch.float32):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, K, H, D).astype(np.float32))
               for _ in range(3))
    kc = torch.from_numpy(rng.randn(nb, bs, H, D).astype(np.float32)).to(cdt)
    vc = torch.from_numpy(rng.randn(nb, bs, H, D).astype(np.float32)).to(cdt)
    table = torch.from_numpy(rng.permutation(nb)[:B * M].astype(np.int32)
                             .reshape(B, M))
    return q, k, v, kc, vc, table, torch.tensor(starts, dtype=torch.int32), \
        torch.tensor(lens, dtype=torch.int32)


def _compare(args, mm, key_range=None):
    """(emulated out, plain out, real-row mask, caches equal)"""
    q, k, v, kc, vc, table, st, ln = args
    B, K, H, D = q.shape
    kr = key_range or pa.chunk_plan(B, K, H, D,
                                    table.shape[1] * kc.shape[1])["key_range"]
    kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    sc = 1.0 / D ** 0.5
    got = chunk_emulated(q, k, v, kc1, vc1, table, st, ln, sc, kr, mm)
    ref, _, _ = pa.paged_chunk_prefill_attend_plain(q, k, v, kc2, vc2, table,
                                                    st, ln, scale=sc)
    real = torch.arange(K)[None, :] < ln.long()[:, None]
    return got, ref, real, torch.equal(kc1, kc2) and torch.equal(vc1, vc2)


# (name, B, K, H, D, nb, bs, M, starts, lens, key_range): the mixed
# step's 64-row chunk after 576 cached rows and a ragged one straddling
# table blocks (the plan's 64-key ranges at 16 heads), a zero length,
# the spec step's 8 x 5-row spans (128-key ranges) and a short range
CASES = [
    ("mixed", 1, 64, 16, 32, 512, 16, 64, [576], [64], None),
    ("mixed_ragged", 1, 64, 16, 32, 512, 16, 64, [600], [37], None),
    ("len_0", 1, 64, 16, 32, 512, 16, 64, [320], [0], None),
    ("spec_spans", 8, 5, 16, 32, 1024, 16, 64,
     [37, 700, 0, 1018, 255, 512, 96, 3], [5, 3, 0, 5, 1, 2, 4, 5], None),
    ("ranges_of_32", 2, 20, 2, 40, 64, 4, 32, [7, 60], [20, 11], 32),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_context_split_tf32_holds_the_card_tolerance(case):
    name, B, K, H, D, nb, bs, M, starts, lens, kr = case
    got, ref, real, caches_equal = _compare(
        _case(B, K, H, D, nb, bs, M, starts, lens, seed=len(name)),
        mm_split, kr)
    assert caches_equal
    assert torch.allclose(got[real], ref[real], rtol=RTOL, atol=ATOL), \
        float((got[real] - ref[real]).abs().max())
    assert bool((got[~real] == 0).all())


def test_bf16_caches_are_widened_and_split():
    """bf16 caches: in-chunk keys rounded to bf16 as they enter, every
    cached value's split has lo = 0."""
    args = _case(1, 64, 4, 32, 128, 16, 64, [600], [37], seed=7,
                 cdt=torch.bfloat16)
    got, ref, real, caches_equal = _compare(args, mm_split)
    assert caches_equal
    assert torch.allclose(got[real], ref[real], rtol=RTOL, atol=ATOL)


def test_one_tf32_product_does_not():
    """The mixed step's chunk with a single TF32 product in each of the
    two products leaves the tolerance."""
    got, ref, real, _ = _compare(
        _case(1, 64, 16, 128, 512, 16, 64, [576], [64], seed=11), mm_one)
    assert not torch.allclose(got[real], ref[real], rtol=RTOL, atol=ATOL)


def test_launch_plan_is_a_function_of_shapes_and_fills_the_card():
    """The plan reads static shapes only (never start or lengths, which
    live on the device) and gives at least one block per SM (132 on an
    H100) at both served shapes: the mixed step's (1, 64, 16, 128) chunk
    and the spec step's 8 x 5-row spans, each over 64 table blocks of 16
    rows."""
    assert list(inspect.signature(pa.chunk_plan).parameters) == \
        ["B", "K", "H", "D", "ctx"]
    mixed = pa.chunk_plan(1, 64, 16, 128, 64 * 16)
    spec = pa.chunk_plan(8, 5, 16, 128, 64 * 16)
    assert mixed == pa.chunk_plan(1, 64, 16, 128, 64 * 16)
    assert (mixed["warps"], spec["warps"]) == (4, 1)
    for plan in (mixed, spec):
        assert plan["blocks"] >= 132
        assert plan["key_range"] % STEP == 0
        assert plan["ranges"] * plan["key_range"] >= 64 * 16
