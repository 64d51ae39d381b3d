#!/usr/bin/env python3
"""The fused-sandwich microbenchmark on one NVIDIA GPU.

    python3 tools/torch_fused_sandwich_bench.py

The PyTorch port's counterpart of ``tools/fused_sandwich_bench.py``
(the logic is ``mxnet_tpu_torch/tools/fused_sandwich.py``): conv3x3 ->
band (c -> C) -> band (C -> c) -> conv3x3, channel-last, at batch 256,
28 x 28, c 128, C 512, seed-0 numpy weights, in bf16 and then in f16
(the f16 forms of rows 7 and 10).  Prints the card's name and power
limit, then for each type one JSON line per arm (``plain``: elementwise
ops and ``torch.matmul``; ``pal2d``: the fused_scale_relu_matmul kernel
over the 2-D row view; ``pal4d``: the fused_band4d kernel over the 4-D
tensor) with its ms per iteration from captured loops (CUDA graphs of
2 and 62 iterations, best of 3 replays each, difference over 60), then
one JSON line per band with the fused_band4d kernel's time (CUDA
events, median of 20 launches after warm-up, L2 flushed before each)
beside its bound (bytes over 3.35 TB/s or operations over the dense
16-bit tensor-core peak, 989 TFLOP/s, the larger) and beside
``torch.matmul`` on the already activated input.

Needs one CUDA device; exits non-zero without one.
"""
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 and f16 tensor cores, same sheet


def event_ms(torch, fn, flush, reps=20, warmup=3):
    """Median device ms of one ``fn()``, each launch bracketed by CUDA
    events after an L2 flush."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_sandwich_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mxnet_tpu_torch.kernels import fused_band4d
    from mxnet_tpu_torch.tools import fused_sandwich as fs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        line = torch.cuda.get_device_name(0)
    print(line, flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    for dtype in (torch.bfloat16, torch.float16):
        bench_type(torch, fs, fused_band4d, dev, dtype, flush)
    return 0


def bench_type(torch, fs, fused_band4d, dev, dtype, flush):
    """The three arms' ms per iteration and each band's kernel time in
    ``dtype``, one JSON line each."""
    dt = str(dtype).replace("torch.", "")
    args = fs.inputs(dev, dtype)
    with torch.no_grad():
        for name, band in fs.ARMS.items():
            r = fs.bench(fs.make_net(band), fs.arm_args(name, args))
            print(json.dumps({"arm": name, "dtype": dt, **r}), flush=True)
            torch.cuda.empty_cache()
        for name, x, s, t, w in fs.band_shapes(args):
            (B, H, W, K), N = x.shape, w.shape[1]
            M = B * H * W
            nbytes = (M * K + K * N + M * N) * x.element_size() + 2 * K * 4
            flops = 2 * M * K * N
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            a = torch.relu(x.float() * s + t).to(x.dtype)
            print(json.dumps({
                "band": name, "dtype": dt, "shape": [B, H, W, K, N],
                "ms": event_ms(torch, lambda: fused_band4d(x, s, t, w),
                               flush),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "matmul_ms": event_ms(torch, lambda: torch.matmul(a, w),
                                      flush)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
