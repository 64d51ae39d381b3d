"""PyTorch port: ``mx.rtc`` (user CUDA kernels through NVRTC) on the
CPU, where no kernel can compile or run: the signature parser, the
argument checks a launch makes, the refusals (``PallasModule``, a CPU
context, no GPU), the per-source build flags of ``csrc/rtc.cu``, and the
plain PyTorch versions of the user kernels that ``chip_smoke.py`` holds
the launched kernels against, here held against the same functions
written as JAX ``PallasModule`` bodies (Pallas interpret mode), at
rtol 2e-5 / atol 1e-6.
"""
import ctypes
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.kernels import _build

RTOL, ATOL = 2e-5, 1e-6


def axpy_plain(x, y, alpha):
    """The plain version of the axpy kernels: y + alpha * x."""
    return y + alpha * x


def row_sum_plain(x):
    """The plain version of row_sum: the sum of each row."""
    return x.sum(dim=1)


def test_plain_versions_match_jax_pallas_bodies():
    rng = np.random.RandomState(0)
    x, y = rng.randn(1024).astype(np.float32), \
        rng.randn(1024).astype(np.float32)
    m = rng.randn(16, 256).astype(np.float32)
    alpha = 2.5

    def axpy(a_ref, x_ref, y_ref, o_ref):
        o_ref[...] = y_ref[...] + a_ref[...] * x_ref[...]

    def rsum(x_ref, o_ref):
        o_ref[...] = jnp.sum(x_ref[...], axis=1)

    mod = jmx.rtc.PallasModule(axpy=axpy, row_sum=rsum)
    ja = mod.get_kernel("axpy", out_shape=(1024,)).launch(
        [jmx.nd.array(np.full(1024, alpha, np.float32)), jmx.nd.array(x),
         jmx.nd.array(y)], jmx.cpu())
    jr = mod.get_kernel("row_sum", out_shape=(16,)).launch(
        [jmx.nd.array(m)], jmx.cpu())
    np.testing.assert_allclose(
        axpy_plain(torch.from_numpy(x), torch.from_numpy(y), alpha).numpy(),
        ja.asnumpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(row_sum_plain(torch.from_numpy(m)).numpy(),
                               jr.asnumpy(), rtol=RTOL, atol=ATOL)
    d = rng.randn(64)
    np.testing.assert_array_equal(
        axpy_plain(torch.from_numpy(d), torch.from_numpy(d[::-1].copy()),
                   alpha).numpy(), d[::-1] + alpha * d)


@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, float alpha, int n",
     [(True, True, "float", "x"), (True, False, "float", "y"),
      (False, False, "float", "alpha"), (False, False, "int", "n")]),
    ("const double* __restrict__ a, int64_t  n, __half h, uint8_t *u",
     [(True, True, "double", "a"), (False, False, "int64_t", "n"),
      (False, False, "__half", "h"), (True, False, "uint8_t", "u")]),
    ("int8_t*p,int32_t k", [(True, False, "int8_t", "p"),
                            (False, False, "int32_t", "k")]),
])
def test_signature_parsing(sig, want):
    assert rtc.parse_signature(sig) == want


@pytest.mark.parametrize("sig", ["float4 *x", "unsigned long n", "float **p",
                                 "const float *x, , int n"])
def test_signature_parsing_rejects(sig):
    with pytest.raises(mx.MXNetError, match="signature"):
        rtc.parse_signature(sig)


def _kernel(sig):
    return rtc.CudaKernel("k", None, rtc.parse_signature(sig),
                          torch.device("cpu"))


def _nd(a):
    return mx.nd.array(a, ctx=mx.cpu())


def test_launch_arguments_are_checked():
    """Each argument against the signature: pointer <-> NDArray of the
    declared type on the launch's device, contiguous; scalar <-> a
    number of the declared kind within its range."""
    k = _kernel("const float *x, float *y, float alpha, int n, int64_t m")
    x = _nd(np.ones(8, np.float32))
    dev = torch.device("cpu")
    cells = k._cells([x, x, 2.5, 8, 2 ** 40], dev)
    assert [type(c) for c in cells] == [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_float, ctypes.c_int32,
                                        ctypes.c_int64]
    assert cells[0].value == x._data.data_ptr()
    assert cells[4].value == 2 ** 40                   # not cut to 32 bits
    assert abs(cells[2].value - 2.5) < 1e-7
    bad = [
        ([x, x, 2.5, 8], "arguments"),
        ([x, mx.nd.array(np.ones(8), ctx=mx.cpu(), dtype="float64"), 2.5, 8,
          1], "float64"),
        ([2.0, x, 2.5, 8, 1], "NDArray"),
        ([x, x, x, 8, 1], "scalar"),
        ([x, x, 2.5, 8.5, 1], "takes an int"),
        ([x, x, 2.5, 2 ** 31, 1], "range"),
        ([x, x, 2.5, True, 1], "scalar"),
        ([x, mx.nd.NDArray(torch.ones(4, 4).t()), 2.5, 8, 1], "contiguous"),
    ]
    for args, needle in bad:
        with pytest.raises(mx.MXNetError, match=needle):
            k._cells(args, dev)
    with pytest.raises(mx.MXNetError, match="lives on"):
        k._cells([x, x, 2.5, 8, 1], torch.device("meta"))
    half = _kernel("__half h, uint8_t u")._cells([1.5, 255], dev)
    assert half[0].value == struct.unpack("<H", struct.pack("<e", 1.5))[0]
    assert half[1].value == 255
    np_scalars = k._cells([x, x, np.float32(0.5), np.int64(3), 1], dev)
    assert np_scalars[3].value == 3


def test_rtc_refuses_without_a_gpu_context():
    with pytest.raises(mx.MXNetError, match="CudaModule"):
        mx.rtc.PallasModule(axpy=lambda *refs: None)
    with pytest.raises(mx.MXNetError, match="GPU context"):
        mx.rtc.CudaModule('extern "C" __global__ void f() {}', ctx=mx.cpu())
    k = rtc.CudaKernel("k", None, rtc.parse_signature("int n"),
                       torch.device("cuda", 0))
    with pytest.raises(mx.MXNetError, match="GPU context"):
        k.launch([1], mx.cpu(), (1,), (1,))
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            mx.rtc.CudaModule('extern "C" __global__ void f() {}')


def test_rtc_source_links_nvrtc_and_libcuda(monkeypatch, tmp_path):
    """rtc.cu alone links -lnvrtc -lcuda with the toolkit's library
    directory as its run path, and its flags are part of the library's
    hash."""
    (tmp_path / "bin").mkdir()
    (tmp_path / "lib64").mkdir()
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "bin" /
                                                    "nvcc"))
    flags = _build._flags("rtc")
    assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert "-lnvrtc" in flags and "-lcuda" in flags
    assert "-Xlinker" in flags and \
        "-rpath=%s" % (tmp_path / "lib64") in flags
    assert _build._flags("quant") == _build.NVCC_FLAGS
    assert "rtc" in _build.SOURCES
    src, flags, lib = _build._target("rtc")
    monkeypatch.setitem(_build.LINK_LIBS, "rtc", ("nvrtc",))
    assert _build._target("rtc")[2] != lib
