"""PyTorch port: the split-context paged decode (TPU kernel row 1,
``paged_decode_attend``), emulated on the CPU.

On the card the decode kernel (``mxnet_tpu_torch/csrc/paged_attention.cu``)
splits each slot's keys [0, position] evenly over ``ranges`` blocks
(``decode_plan``, a function of the static shapes; the split itself, in
whole 4-key warp steps, is worked out on the device from the position);
a block of 4 warps takes each range, each warp 4 keys at a time in turn
with the others (an online softmax in f32 from the finite -1e30), the
warps' results are combined in warp order, and the ranges holding a key
in range order by rank 0 of the slot's thread block cluster.  This file
emulates that arithmetic in torch and holds it against
``paged_decode_attend_plain`` at the card's tolerance (rtol 1e-4 / atol
1e-5, ``chip_smoke.py``'s) with ragged positions, an inactive slot, a
position past the table, a scrambled table, bf16 caches and ranges and
warps left empty; it also checks that the launch plan depends on shapes
alone and fills the card at the served shape.  The kernel itself runs
only on the card (``chip_smoke.py``'s decode and head_dim phases); the
parity tests against the JAX package run the plain version, unchanged.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

pa = importlib.import_module("mxnet_tpu_torch.kernels.paged_attention")

RTOL, ATOL = 1e-4, 1e-5
WARPS, KEYS = 4, 4          # warps a block, keys a warp takes a step
FILL = -1e30                # the finite fill of an empty softmax state


def _online(s, v, m, lsum, acc):
    """One warp step: scores ``s (H, n)`` and values ``v (H, n, D)``
    folded into the running max, sum and accumulators."""
    mx = torch.maximum(m, s.max(-1).values)
    alpha = torch.exp(m - mx)
    p = torch.exp(s - mx[:, None])
    return mx, lsum * alpha + p.sum(-1), \
        acc * alpha[:, None] + torch.einsum("hk,hkd->hd", p, v)


def _combine(parts):
    """(max, sum, acc) partials combined in order from the finite fill:
    an empty partial (FILL, 0, 0) weighs exp(FILL - max) = 0."""
    gm = torch.full_like(parts[0][0], FILL)
    for m, _, _ in parts:
        gm = torch.maximum(gm, m)
    w = [torch.exp(m - gm) for m, _, _ in parts]
    lsum = sum(l * wj for (_, l, _), wj in zip(parts, w))
    acc = sum(a * wj[:, None] for (_, _, a), wj in zip(parts, w))
    return gm, lsum, acc


def decode_emulated(q, kc, vc, table, pos, scale, ranges,
                    every_range=False):
    """The kernel's arithmetic: per slot, its keys split evenly over
    ``ranges`` ranges in whole 4-key steps, each range over 4 warps
    taking 4 keys in turn, warps combined in order, then the ranges
    holding a key (or, with ``every_range``, every range, the empty ones
    as the finite fill) in order.  Inactive slots are zeros."""
    C, H, D = q.shape
    nb, bs = kc.shape[:2]
    M = table.shape[1]
    kf, vf = kc.view(nb * bs, H, D), vc.view(nb * bs, H, D)
    out = torch.zeros(C, H, D)
    for c in range(C):
        p = int(pos[c])
        if p < 0:
            continue
        kend = min(p + 1, M * bs)
        keys = torch.arange(kend)
        rows = table[c, keys // bs].long() * bs + keys % bs
        kk = kf[rows].float().transpose(0, 1)                # (H, kend, D)
        vv = vf[rows].float().transpose(0, 1)
        s_all = torch.einsum("hd,hkd->hk", q[c].float() * scale, kk)
        parts = []
        per = -(-(-(-kend // ranges)) // KEYS) * KEYS
        last = ranges * per if every_range else kend
        for k0 in range(0, last, per):
            k1 = min(k0 + per, kend)
            warps = []
            for w in range(WARPS):
                st = (torch.full((H,), FILL), torch.zeros(H),
                      torch.zeros(H, D))
                for t0 in range(k0 + w * KEYS, k1, WARPS * KEYS):
                    t1 = min(t0 + KEYS, k1)
                    st = _online(s_all[:, t0:t1], vv[:, t0:t1], *st)
                warps.append(st)
            parts.append(_combine(warps))
        _, lsum, acc = _combine(parts)
        out[c] = acc / lsum[:, None]
    return out.to(q.dtype)


def _case(C, H, D, nb, bs, M, positions, seed, cdt=torch.float32):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(C, H, D).astype(np.float32))
    kc = torch.from_numpy(rng.randn(nb, bs, H, D).astype(np.float32)).to(cdt)
    vc = torch.from_numpy(rng.randn(nb, bs, H, D).astype(np.float32)).to(cdt)
    table = torch.from_numpy(rng.permutation(nb)[:C * M].astype(np.int32)
                             .reshape(C, M))
    return q, kc, vc, table, torch.tensor(positions, dtype=torch.int32)


def _compare(args, ranges=None, every_range=False):
    q, kc, vc, table, pos = args
    C, H, D = q.shape
    bs, M = kc.shape[1], table.shape[1]
    nr = ranges or pa.decode_plan(C, H, D, bs, M)["ranges"]
    sc = 1.0 / D ** 0.5
    got = decode_emulated(q, kc, vc, table, pos, sc, nr, every_range)
    ref = pa.paged_decode_attend_plain(q, kc, vc, table, pos, scale=sc)
    return got, ref, pos >= 0


# the served shape's plan (8 slots, 16 heads of 128, 64 table blocks of
# 16 rows): 4 ranges a slot
SERVED_RANGES = pa.decode_plan(8, 16, 128, 16, 64)["ranges"]
# (name, C, H, D, nb, bs, M, positions, ranges): the served ranges over
# long and short contexts (fewer, narrower heads), an inactive slot and
# a position past the table; one slot over the plan's 8 ranges; a last
# range holding fewer keys than one warp step (the other warps empty),
# ranges past the position (empty) and one range
CASES = [
    ("served_long", 8, 4, 32, 512, 16, 64,
     [20, 731, 500, 129, 127, 640, 333, 1], SERVED_RANGES),
    ("served_short", 8, 4, 32, 512, 16, 64,
     [20, 145, 64, 99, 31, 32, 100, 77], SERVED_RANGES),
    ("inactive_past_table", 8, 4, 32, 512, 16, 64,
     [300, -1, 5000, 0, 1023, 1024, 600, -1], SERVED_RANGES),
    ("one_slot", 1, 4, 32, 128, 16, 64, [700], None),
    ("partial_warps", 3, 2, 40, 64, 4, 16, [36, 60, 3], 8),
    ("small_blocks", 4, 2, 24, 256, 3, 20, [59, 17, 41, 8], 2),
    ("one_range", 2, 2, 16, 64, 16, 8, [100, 7], 1),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_context_holds_the_card_tolerance(case):
    name, C, H, D, nb, bs, M, positions, kr = case
    got, ref, act = _compare(_case(C, H, D, nb, bs, M, positions,
                                   seed=len(name)), kr)
    assert torch.isfinite(got).all()
    assert torch.allclose(got[act], ref[act], rtol=RTOL, atol=ATOL), \
        float((got[act] - ref[act]).abs().max())
    assert bool((got[~act] == 0).all())


def test_empty_ranges_add_nothing_and_no_nan():
    """Ranges past a slot's position, combined as the finite fill, leave
    the result finite and within the tolerance: what a cluster's empty
    ranks hold."""
    args = _case(4, 2, 32, 256, 16, 32, [10, 200, 31, 0], seed=3)
    got, ref, act = _compare(args, ranges=8, every_range=True)
    assert torch.isfinite(got).all()
    assert torch.allclose(got[act], ref[act], rtol=RTOL, atol=ATOL)


def test_bf16_caches_are_widened():
    args = _case(8, 4, 32, 512, 16, 64, [20, 731, 500, 129, -1, 640, 5000,
                                         1], seed=7, cdt=torch.bfloat16)
    got, ref, act = _compare(args, SERVED_RANGES)
    assert torch.allclose(got[act], ref[act], rtol=RTOL, atol=ATOL)
    assert bool((got[~act] == 0).all())


def test_bf16_query_rounds_once():
    """A bf16 q: the f32 result rounded once to bf16, within one bf16 ulp
    of the plain version's rounding of its own f32 result."""
    q, kc, vc, table, pos = _case(8, 4, 32, 512, 16, 64,
                                  [20, 731, 500, 129, 127, 640, 333, 1],
                                  seed=9)
    got, ref, _ = _compare((q.to(torch.bfloat16), kc, vc, table, pos),
                           SERVED_RANGES)
    assert got.dtype == ref.dtype == torch.bfloat16
    assert torch.allclose(got.float(), ref.float(), rtol=2.0 ** -7, atol=0)


def test_launch_plan_is_a_function_of_shapes_and_fills_the_card():
    """The plan reads static shapes only (never the positions, which live
    on the device); at the served shape (8 slots, 16 heads of 128, 64
    table blocks of 16 rows) it gives at least one block per SM (132 on
    an H100), far more than the one block a (slot, head) of the old
    kernel; every cluster holds at most 8 ranges (the portable size)."""
    assert list(inspect.signature(pa.decode_plan).parameters) == \
        ["C", "H", "D", "bs", "M"]
    served = pa.decode_plan(8, 16, 128, 16, 64)
    assert served == pa.decode_plan(8, 16, 128, 16, 64)
    assert served["blocks"] >= 132 and served["ranges"] > 1
    assert pa.decode_plan(1, 16, 128, 16, 64)["ranges"] == 8
    for C, H, D, bs, M in ((8, 16, 128, 16, 64), (1, 16, 128, 16, 64),
                           (8, 8, 128, 16, 1024), (2, 2, 40, 4, 16)):
        plan = pa.decode_plan(C, H, D, bs, M)
        assert plan["ranges"] in (1, 2, 4, 8)
        assert plan["blocks"] == C * H * plan["ranges"]
