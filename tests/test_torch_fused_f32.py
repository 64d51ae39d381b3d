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

Row 10's f32 band (``fused_band4d``, ``tools/fused_sandwich_bench.py``
``pal4d_band``) runs the same GEMM with W given (K, N) and X's rows
gathered through its four strides: each row m = (b, h, w) at element
offset b sb + h sh + w sw, its channels sk apart.  Its emulation gathers
the rows that way from a contiguous tensor, the NHWC view of an NCHW
tensor and a channel slice, sums each 32-column group of K in split TF32
against W's (K, N) rows, and is held against ``fused_band4d_plain`` at
the same tolerance; the plain version in f32 is held against the JAX
package's ``pal4d_band`` run on the CPU in interpret mode (the fixture of
``test_torch_fused_band4d.py``).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_flash_f32 import ATOL, RTOL, mm_one, mm_split
from test_torch_fused_band4d import _band_inputs, fsb  # noqa: F401 (fixture)

fm = importlib.import_module("mxnet_tpu_torch.kernels.fused_matmul")
fb = importlib.import_module("mxnet_tpu_torch.kernels.fused_band4d")

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



# ----------------------------------------------------------------------
# row 10: the band, W (K, N), X through its strides
# ----------------------------------------------------------------------
def gather_rows(x):
    """The (M, K) rows of a 4-D ``x`` as the kernel reads them: row m =
    (b, h, w) from m with H W pixels an image and W an image row, at
    element offset b sb + h sh + w sw, channel k at k sk more, read from
    ``x``'s storage."""
    B, H, W, K = x.shape
    sb, sh, sw, sk = x.stride()
    m = torch.arange(B * H * W)
    b, q = m // (H * W), m % (H * W)
    h, w = q // W, q % W
    off = (b * sb + h * sh + w * sw)[:, None] + torch.arange(K)[None] * sk
    flat = x.as_strided((int(off.max()) + 1,), (1,))
    return flat[off]


def band_emulated(x, scale, shift, w, mm):
    """The f32 band's arithmetic: the prologue on the gathered rows as the
    plain version computes it, then each 32-column group of K against
    W's (K, N) rows through ``mm`` into a fresh sum added in f32."""
    a = torch.relu(gather_rows(x) * scale + shift)
    y = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], GROUP):
        y = y + mm(a[:, k0:k0 + GROUP], w[k0:k0 + GROUP])
    return y.view(*x.shape[:3], w.shape[1])


def _layouts(x):
    """``x`` contiguous, as the NHWC view of an NCHW tensor (channel
    stride H W) and as a channel slice of a wider tensor."""
    t = torch.from_numpy(x)
    nchw = t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    wide = torch.zeros(*t.shape[:3], t.shape[3] + 5)
    wide[..., :t.shape[3]] = t
    return {"contiguous": t, "nchw_view": nchw,
            "channel_slice": wide[..., :t.shape[3]]}


# (B, H, W, K, N): the sandwich's up and down bands cut in batch and
# image, and chip_smoke.py's odd band shape
BANDS = [(2, 7, 8, 128, 512), (2, 7, 8, 512, 128), (3, 7, 9, 37, 93)]


@pytest.mark.parametrize("layout", ["contiguous", "nchw_view",
                                    "channel_slice"])
@pytest.mark.parametrize("shape", BANDS, ids=lambda s: "x".join(map(str, s)))
def test_band_split_tf32_holds_the_card_tolerance(shape, layout):
    B, H, W, K, N = shape
    x, s, t, w = _band_inputs((B, H, W), K, N, seed=K + N)
    xv = _layouts(x)[layout]
    assert torch.equal(gather_rows(xv), torch.from_numpy(x).reshape(-1, K))
    s, t, w = torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(w)
    ref = fb.fused_band4d_plain(xv, s, t, w)
    got = band_emulated(xv, s, t, w, mm_split)
    assert torch.allclose(got, ref, rtol=RTOL, atol=ATOL), \
        float((got - ref).abs().max())
    # the same bits as row 7's arithmetic on the 2-D view, W (N, K)
    row7 = fused_emulated(torch.from_numpy(x).reshape(-1, K), s, t,
                          w.t().contiguous(), None, mm_split)
    assert torch.equal(got.reshape(row7.shape), row7)


@pytest.mark.parametrize("shape,K,N", [((1, 8, 16), 128, 512),
                                       ((1, 8, 16), 512, 128),
                                       ((2, 4, 8), 37, 93)])
def test_band_plain_f32_matches_pal4d_band(fsb, shape, K, N):  # noqa: F811
    """The f32 yardstick against the TPU kernel, interpreted on the CPU,
    at the bands' widths: the card's tolerance (rtol 1e-4 / atol 1e-5),
    since the sums over K = 512 run in another order (the band tests of
    test_torch_fused_band4d.py, at K <= 72, hold rtol 2e-5 / atol 1e-6)."""
    x, s, t, w = _band_inputs(shape, K, N, seed=K * N + 1)
    ref = np.asarray(fsb.pal4d_band(jnp.asarray(x), jnp.asarray(s),
                                    jnp.asarray(t), jnp.asarray(w)))
    got = fb.fused_band4d_plain(torch.from_numpy(x), torch.from_numpy(s),
                                torch.from_numpy(t), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
