"""PyTorch port: the split-TF32 arithmetic of the f32 fused GEMM (TPU
kernel row 7, ``fused_scale_relu_matmul``), emulated on the CPU.

On the card the f32 form runs on the tensor cores
(``mxnet_tpu_torch/csrc/fused_gemm_f32.cuh``): the prologue computes
relu(x * scale + shift) in f32 as the plain version does, each operand
of the product is split into hi = tf32(x) and lo = x - hi, every product
step is lo*hi' + hi*lo' + hi*hi', each group of 32 columns of K sums
into a fresh fragment that an f32 add puts into the accumulator, and
the residual is added in f32.  This file emulates that arithmetic in
torch with the helpers of ``test_torch_flash_f32.py`` and shows that it
holds the card's tolerance against ``fused_scale_relu_matmul_plain``
(rtol 1e-4 / atol 1e-5, ``chip_smoke.py``'s), at K = 2048 (ResNet-50's
widest site) with and without a residual and at the odd shape, and that
ONE TF32 product does not.  The kernel itself runs only on the card
(``chip_smoke.py``'s fused_matmul phase); the parity tests against the
JAX package run the plain version, unchanged.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_flash_f32 import ATOL, RTOL, mm_one, mm_split

fm = importlib.import_module("mxnet_tpu_torch.kernels.fused_matmul")

GROUP = 32       # K columns an mma chain sums (kGroup k8 steps)
# (M, K, N, residual): ResNet-50's widest site, cut in M, with and
# without a residual, and chip_smoke.py's FUSED_ODD
SHAPES = [(96, 2048, 128, False), (96, 2048, 128, True), (1000, 37, 93, True)]


def fused_emulated(x, scale, shift, w, res, mm):
    """The kernel's arithmetic: the prologue as the plain version
    computes it, then each 32-column group of K through ``mm`` into a
    fresh sum that an f32 add puts into the accumulator, then the
    residual added in f32."""
    a = torch.relu(x * scale + shift)
    y = torch.zeros(x.shape[0], w.shape[0], dtype=torch.float32)
    for k0 in range(0, x.shape[1], GROUP):
        y = y + mm(a[:, k0:k0 + GROUP], w[:, k0:k0 + GROUP].t())
    return y + res if res is not None else y


def _inputs(M, K, N, with_res, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    scale = torch.from_numpy((1 + 0.2 * rng.randn(K)).astype(np.float32))
    shift = torch.from_numpy((0.2 * rng.randn(K)).astype(np.float32))
    w = torch.from_numpy((rng.randn(N, K) / K ** 0.5).astype(np.float32))
    res = torch.from_numpy(rng.randn(M, N).astype(np.float32)) \
        if with_res else None
    return x, scale, shift, w, res


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_tf32_gemm_holds_the_card_tolerance(shape):
    args = _inputs(*shape, seed=0)
    ref = fm.fused_scale_relu_matmul_plain(*args)
    got = fused_emulated(*args, mm_split)
    assert torch.allclose(got, ref, rtol=RTOL, atol=ATOL), \
        float((got - ref).abs().max())


@pytest.mark.parametrize("with_res", [False, True])
def test_one_tf32_product_does_not(with_res):
    """The same sums with a single TF32 product leave the tolerance at
    K = 2048."""
    args = _inputs(96, 2048, 128, with_res, seed=1)
    ref = fm.fused_scale_relu_matmul_plain(*args)
    got = fused_emulated(*args, mm_one)
    assert not torch.allclose(got, ref, rtol=RTOL, atol=ATOL)

