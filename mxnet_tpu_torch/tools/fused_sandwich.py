"""The fused-sandwich microbenchmark on the GPU.

Counterpart of ``tools/fused_sandwich_bench.py``: conv3x3 -> band
(c -> C) -> band (C -> c) -> conv3x3, forward, bf16, channel-last, at
that tool's stage-3-like shapes (batch 256, 28 x 28, c 128, C 512) and
seed-0 numpy weights, where a band is ``relu(x * scale + shift) @ w``
(BatchNorm-apply, ReLU and a 1x1 convolution).  Three arms:

* ``plain``: elementwise ops and ``torch.matmul`` (the reference's
  ``xla_band``, the library arm);
* ``pal2d``: row 7's kernel, ``fused_scale_relu_matmul_fwd``, over the
  2-D view ``x.reshape(-1, K)``, with the weight passed (N, K) as that
  kernel takes it (transposed once, outside the timed loop);
* ``pal4d``: ``kernels.fused_band4d``, which reads the 4-D ``x``
  through its own strides.

The convolutions are the port's channel-last ``Convolution`` (cuDNN),
as the reference computes them with ``lax.conv`` outside any kernel.

Timing is the reference's differential method: the loop carry patches
``x[0, 0, 0, 0]`` from the output every iteration, ``N0`` and
``N0 + ITERS`` iterations are each captured as one CUDA graph (the
counterpart of one jitted ``fori_loop``: no host work between
launches), each graph is replayed ``REPS`` times, and the best of each
gives ``(long - short) / ITERS`` ms per iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..kernels import fused_band4d, fused_scale_relu_matmul_fwd
from ..ops.nn import convolution

__all__ = ["SHAPE", "ITERS", "N0", "REPS", "ARMS", "inputs", "conv3",
           "matmul_band", "pal2d_band", "make_net", "arm_args", "step",
           "bench", "band_shapes"]

SHAPE = dict(B=256, H=28, W=28, c=128, C=512)
ITERS = 60
N0 = 2
REPS = 3


def inputs(device, dtype=torch.bfloat16, B=SHAPE["B"], H=SHAPE["H"],
           W=SHAPE["W"], c=SHAPE["c"], C=SHAPE["C"], seed=0):
    """``(x, wc1, s1, t1, wu, s2, t2, wd, wc2)`` drawn as the reference's
    ``main`` draws them: x (B, H, W, c), OHWI 3x3 weights, f32 scales
    and shifts, (K, N) band weights; x and the weights in ``dtype``."""
    rng = np.random.RandomState(seed)
    f32 = np.float32

    def t(a, scale=None):
        a = torch.from_numpy(a.astype(f32))
        if scale is not None:
            a = a * scale
        return a

    x = t(rng.randn(B, H, W, c))
    wc1 = t(rng.randn(c, 3, 3, c), 0.05)
    wc2 = t(rng.randn(c, 3, 3, c), 0.05)
    s1 = t(rng.rand(c).astype(f32) + 0.5)
    t1 = t(rng.randn(c))
    wu = t(rng.randn(c, C), 0.05)
    s2 = t(rng.rand(C).astype(f32) + 0.5)
    t2 = t(rng.randn(C))
    wd = t(rng.randn(C, c), 0.05)
    lo = [a.to(device=device, dtype=dtype) for a in (x, wc1, wu, wd, wc2)]
    hi = [a.to(device) for a in (s1, t1, s2, t2)]
    x, wc1, wu, wd, wc2 = lo
    s1, t1, s2, t2 = hi
    return x, wc1, s1, t1, wu, s2, t2, wd, wc2


def conv3(x, w):
    """3x3 stride-1 "same" convolution, NHWC data and OHWI weight, in
    x's dtype (the reference's ``lax.conv_general_dilated``)."""
    return convolution(x, w, kernel=(3, 3), num_filter=w.shape[0],
                       pad=(1, 1), no_bias=True, layout="NHWC").to(x.dtype)


def matmul_band(x, s, t, w2d):
    """The ``plain`` arm (the reference's ``xla_band``): the affine in
    f32, the ReLU'd activation in x's dtype, then ``torch.matmul``."""
    z = x.float() * s + t
    a = torch.relu(z).to(x.dtype)
    return torch.matmul(a, w2d).to(x.dtype)


def pal2d_band(x, s, t, w_nk):
    """The ``pal2d`` arm: row 7's kernel over the 2-D row view of x;
    ``w_nk`` is the band weight (N, K)."""
    b, h, w, k = x.shape
    y = fused_scale_relu_matmul_fwd(x.reshape(-1, k), s, t, w_nk)
    return y.view(b, h, w, w_nk.shape[0])


ARMS = {"plain": matmul_band, "pal2d": pal2d_band, "pal4d": fused_band4d}


def make_net(band):
    def net(x, wc1, s1, t1, wu, s2, t2, wd, wc2):
        h = conv3(x, wc1)
        h = band(h, s1, t1, wu)          # c -> C
        h = band(h, s2, t2, wd)          # C -> c
        return conv3(h, wc2)
    return net


def arm_args(name, args):
    """``args`` as arm ``name`` takes them: pal2d's band weights (N, K)."""
    if name != "pal2d":
        return args
    x, wc1, s1, t1, wu, s2, t2, wd, wc2 = args
    return (x, wc1, s1, t1, wu.t().contiguous(), s2, t2, wd.t().contiguous(),
            wc2)


def step(net, x, rest):
    """One iteration of the timed loop: the sandwich, then the carry's
    patch ``x[0, 0, 0, 0] = 1e-30 * sum(y[0, 0, 0, :8])`` in place, so
    every iteration depends on the one before it."""
    y = net(x, *rest)
    x[0, 0, 0, 0] = (y[0, 0, 0, :8].float().sum() * 1e-30).to(x.dtype)


def bench(net, args, iters=ITERS, n0=N0, reps=REPS):
    """ms per iteration of ``net`` by the differential method: ``n0`` and
    ``n0 + iters`` iterations each captured as one CUDA graph, replayed
    ``reps`` times, best of each.  Needs tensors on the card."""
    x0, rest = args[0], args[1:]
    if x0.device.type != "cuda":
        raise MXNetError("fused_sandwich.bench: the captured loops run on "
                         "the card; got tensors on %s" % x0.device)

    def capture(n):
        x = x0.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(net, x, rest)                      # warm-up, uncaptured
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                step(net, x, rest)
        return graph, x

    def best(graph):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    short, _ = capture(n0)
    long_, _ = capture(n0 + iters)
    t_short, t_long = best(short), best(long_)
    return {"ms_per_iter": (t_long - t_short) / iters, "short_ms": t_short,
            "long_ms": t_long, "iters": iters, "n0": n0, "reps": reps}


def band_shapes(args):
    """``[(name, x, s, t, w)]`` of the two bands at ``args``' shapes,
    each band's input as the sandwich gives it (the first convolution's
    output, then the up band's)."""
    x, wc1, s1, t1, wu, s2, t2, wd, wc2 = args
    with torch.no_grad():
        h = conv3(x, wc1)
        up = fused_band4d(h, s1, t1, wu)
    return [("up", h, s1, t1, wu), ("down", up, s2, t2, wd)]
