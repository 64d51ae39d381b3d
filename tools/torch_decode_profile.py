#!/usr/bin/env python3
"""Where the time of one mixed decode step, or of one training step,
goes on the GPU.

    python3 tools/torch_decode_profile.py            # decode steps
    python3 tools/torch_decode_profile.py --train    # one Module.fit step
    python3 tools/torch_decode_profile.py --resnet   # one 2-bit ResNet step
    python3 tools/torch_decode_profile.py --resnet --layout NHWC --fuse
                                          # one TrainStep step

Builds the PyTorch port's DecodeEngine at chip_smoke.py's full-width
configuration (same seeded weights and geometry), then drives its bound
mixed step directly from this thread in two forms: a decode-only step
(8 active slots, no chunk) and a mixed step (8 active slots plus a full
64-row chunk at start 320).  For each it prints one JSON line with:

* the wall time of one step (forward plus the greedy-token readback,
  which synchronizes), median of 20;
* the device time per step by kernel group, from ``torch.profiler``
  over 5 steps, and the device's idle share of the wall time;
* the host time to enqueue one step (forward without synchronizing),
  and the calls in one forward that synchronize the host with the
  device (``torch.cuda.set_sync_debug_mode``).

With ``--train`` it instead binds chip_smoke.py's full-width training
Module (same seeded weights, batch 4 x 1024 tokens, SGD with momentum),
runs two warm-up steps (forward, backward, update) and prints one JSON
line with the wall time of a step (median of 5, ending in a
synchronize), the device time per step by kernel group over 3
profiled steps and the device's idle share.

With ``--resnet`` it binds chip_smoke.py's ResNet-50 (same seeded
weights and BatchNorm statistics, batch 128) with 2-bit compression
through ``mx.kv.create('device')``, runs two warm-up steps and prints
one JSON line with the wall time of a step (median of 5), the device
time per step by group over 3 profiled steps (convolution, BatchNorm,
the quantize kernel, the bucket's ``torch.cat`` and the pull's copies,
the optimizer, the rest), the device launches and host syncs per step,
and the device's idle share.  The groups come from ``record_function``
ranges this tool wraps around the ops, the bucket dispatch, the
optimizer and the pull in its own process.

With ``--resnet --layout NCHW|NHWC`` (and ``--fuse`` for the
BN -> ReLU -> Conv1x1 fusion pass) it binds chip_smoke.py's
ResNet-50 through ``parallel.TrainStep`` (same seeded weights, OHWI
for NHWC, batch 128, SGD with momentum and wd), runs two warm-up steps
and prints one JSON line with the wall time of a step (median of 5),
the device time per step by group over 3 profiled steps (cuDNN
convolutions forward and backward, without cuDNN's layout transposes;
the fused kernel; the fused op's backward matmuls and elementwise
passes; the rest of the fused op's forward: batch statistics, scale
and shift; BatchNorm forward and backward; relayout copies, the kernels
that change a tensor's memory layout, cuDNN's own transposes
included; device-to-device memcpy; the rest), the relayout kernels by
name, the device launches and host syncs per step and the device's
idle share.

Needs one CUDA device; exits non-zero without one.
"""
import json
import os
import statistics
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def group(name):
    n = name.lower()
    for key, label in (("paged_decode", "paged_decode_attend"),
                       ("paged_chunk", "paged_chunk_prefill_attend"),
                       ("layernorm_fwd", "layernorm_fused"),
                       ("layernorm_bwd", "layernorm_fused_bwd"),
                       ("flash_fwd", "flash_attention_fwd"),
                       ("flash_bwd_dkv", "flash_attention_bwd_dkv"),
                       ("flash_bwd_dq", "flash_attention_bwd_dq"),
                       ("gemm", "matmul"), ("gemv", "matmul"),
                       ("sm90", "matmul"), ("cutlass", "matmul"),
                       ("memcpy", "copies"), ("memset", "copies"),
                       ("index", "indexing"), ("gather", "indexing"),
                       ("scatter", "indexing")):
        if key in n:
            return label
    return "elementwise/other"


_RANGES = ("op:", "kv:")


def _is_range(ev):
    """A ``record_function`` range (its device-side copy spans kernels
    already counted one by one)."""
    return getattr(ev, "is_user_annotation", False) \
        or ev.key.startswith(_RANGES)


def device_ms_by_group(torch, prof, n):
    """``({group: device ms per step}, kernel launches)`` of a profile
    over ``n`` steps."""
    by_group, kernels = {}, 0
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if dt and ev.device_type == torch.autograd.DeviceType.CUDA \
                and not _is_range(ev):
            g = group(ev.key)
            by_group[g] = by_group.get(g, 0.0) + dt / 1e3 / n
            kernels += ev.count
    return by_group, kernels


def profile_train(torch, cs, mx):
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    from torch.profiler import ProfilerActivity, profile
    cfg, B = cs.FULL, cs.TRAIN["batch"]
    S = cfg["seq_len"]
    mod = mx.Module(transformer.get_symbol(**cfg), context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (B, S))],
             label_shapes=[("softmax_label", (B * S,))])
    mod.set_params(convert_params(cs.seeded_params(cfg), mx.gpu(0), cfg), {})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": cs.TRAIN["lr"], "momentum": cs.TRAIN["momentum"]})
    x, y = cs._token_batches(cfg, B, cs.SEED + 6)
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y.reshape(-1), ctx=mx.cpu())])

    def step():
        mod.fit_step(batch)
        torch.cuda.synchronize()

    for _ in range(2):
        step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
    by_group, kernels = device_ms_by_group(torch, prof, n)
    device_ms = sum(by_group.values())
    wall = statistics.median(walls)
    print(json.dumps({
        "phase": "profile", "step": "train", "config": cfg, "batch": B,
        "wall_ms_p50": wall, "wall_ms": walls, "device_ms": device_ms,
        "device_idle_share": 1 - device_ms / wall,
        "device_ms_by_group": {k: round(v, 4) for k, v in
                               sorted(by_group.items(),
                                      key=lambda kv: -kv[1])},
        "device_launches_per_step": kernels / n}), flush=True)


def _labelled(fn, label):
    """``fn`` inside a profiler range named ``label``."""
    from torch.autograd.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def _measure(torch, step, once, n=3):
    """``step()`` (which synchronizes) twice to warm up and five times
    timed; the synchronizing calls of one ``once()``, each as the Python
    line that made it; a profile of ``n`` steps.  Returns ``(wall ms
    list, sync sites, profile)``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            once()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = ["%s:%d" % (os.path.relpath(w.filename, ROOT), w.lineno)
             for w in caught if "called a synchronizing" in str(w.message)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
    return walls, syncs, prof


def _range_ms(torch, prof, n):
    """Device ms per step of each ``op:``/``kv:`` range and of
    ``aten::convolution_backward``: host-side ranges and ops carry the
    device time of the kernels launched inside them, except a kernel
    launched through ctypes, which is in no range."""
    ranges = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU and (
                ev.key.startswith(_RANGES)
                or ev.key == "aten::convolution_backward"):
            ranges[ev.key] = ranges.get(ev.key, 0.0) + getattr(
                ev, "device_time_total", getattr(ev, "cuda_time_total", 0)) \
                / 1e3 / n
    return ranges


def _kernel_ms(torch, prof, n, match):
    """``{kernel name: device ms per step}`` of the kernels whose
    lower-cased name contains one of ``match``."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not _is_range(ev) \
                and any(m in ev.key.lower() for m in match):
            out[ev.key[:120]] = out.get(ev.key[:120], 0.0) + getattr(
                ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0)) / 1e3 / n
    return out


def profile_resnet(torch, cs, mx):
    from mxnet_tpu_torch import kvstore, kvstore_fused, optimizer
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.weights import convert_symbol_params
    for name in ("BatchNorm", "Convolution"):
        op = get_op(name)
        op.fn = _labelled(op.fn, "op:" + name)
    bn_fn = ops_nn._BatchNormTrainFn
    bn_fn.backward = staticmethod(_labelled(bn_fn.backward,
                                            "op:BatchNorm_backward"))
    eng = kvstore_fused.FusedBucketEngine
    eng._dispatch = _labelled(eng._dispatch, "kv:bucket")
    optimizer.Updater.__call__ = _labelled(optimizer.Updater.__call__,
                                           "kv:optimizer")
    kvstore.KVStore.pull = _labelled(kvstore.KVStore.pull, "kv:pull")

    cfg, train = cs.RESNET, cs.RESNET_TRAIN
    B = train["batch"]
    shapes = dict(data=(B,) + tuple(cfg["image_shape"]), softmax_label=(B,))
    sym = resnet.get_symbol(**cfg)
    np_args, np_aux = cs.seeded_resnet_params(sym, B, cfg["image_shape"])
    mod = mx.Module(sym, context=mx.gpu(0), compression_params={
        "type": "2bit", "threshold": train["threshold"]})
    mod.bind(data_shapes=[("data", shapes["data"])],
             label_shapes=[("softmax_label", (B,))])
    mod.set_params(*convert_symbol_params(np_args, np_aux, mx.gpu(0), sym,
                                          **shapes))
    kv = mx.kv.create("device")
    mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params={
        "learning_rate": train["lr"], "momentum": train["momentum"],
        "wd": train["wd"]})
    x, y = cs._image_batches(cfg["image_shape"], B, cs.SEED + 11,
                             cfg["num_classes"])
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y, ctx=mx.cpu())])

    def step():
        mod.fit_step(batch)
        torch.cuda.synchronize()

    buckets = []

    def once():
        b0 = kv._engine.stats["buckets"]
        mod.fit_step(batch)
        buckets.append(kv._engine.stats["buckets"] - b0)

    n = 3
    walls, syncs, prof = _measure(torch, step, once, n)
    total, kernels = device_ms_by_group(torch, prof, n)
    device_ms = sum(total.values())
    ranges = _range_ms(torch, prof, n)
    quant = sum(_kernel_ms(torch, prof, n, ("two_bit_quantize",)).values())
    # the quantize kernel is in no range: the bucket range holds the cat,
    # the sums and the optimizer
    bucket = ranges.get("kv:bucket", 0.0)
    opt_ms = ranges.get("kv:optimizer", 0.0)
    groups = {
        "convolution": ranges.get("op:Convolution", 0.0)
        + ranges.get("aten::convolution_backward", 0.0),
        "batchnorm": ranges.get("op:BatchNorm", 0.0)
        + ranges.get("op:BatchNorm_backward", 0.0),
        "quantize": quant,
        "bucket_cat_and_sums": bucket - opt_ms,
        "optimizer": opt_ms,
        "pull_copies": ranges.get("kv:pull", 0.0)}
    groups["elementwise/other"] = device_ms - sum(groups.values())
    wall = statistics.median(walls)
    print(json.dumps({
        "phase": "profile", "step": "resnet50_2bit", "config": cfg,
        "batch": B, "threshold": train["threshold"], "wall_ms_p50": wall,
        "wall_ms": walls, "device_ms": device_ms,
        "device_idle_share": 1 - device_ms / wall,
        "device_ms_by_group": {k: round(v, 4) for k, v in
                               sorted(groups.items(), key=lambda kv: -kv[1])},
        "device_launches_per_step": kernels / n,
        "buckets_per_step": buckets[0],
        "host_syncs_per_step": len(syncs),
        "sync_sites": sorted(set(syncs))}), flush=True)


_RELAYOUT = ("nchwtonhwc", "nhwctonchw", "transpose", "direct_copy",
             "copy_kernel")


def profile_trainstep(torch, cs, mx, layout, fuse):
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import fused as ops_fused
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
    for name in ("BatchNorm", "Convolution", "_FusedBNReluConv"):
        op = get_op(name)
        op.fn = _labelled(op.fn, "op:" + name)
    for fn, label in ((ops_nn._BatchNormTrainFn, "op:BatchNorm_backward"),
                      (ops_fused._FusedScaleReluMatmulFn,
                       "op:fused_backward")):
        fn.backward = staticmethod(_labelled(fn.backward, label))
    ops_fused.fused_scale_relu_matmul_fwd = _labelled(
        ops_fused.fused_scale_relu_matmul_fwd, "op:fused_kernel_call")

    cfg, train = cs.RESNET, cs.NHWC_TRAIN
    B = train["batch"]
    sym = resnet.get_symbol(layout=layout, **cfg)
    np_args, np_aux = cs.seeded_resnet_params(resnet.get_symbol(**cfg), B,
                                              cfg["image_shape"])
    conv = cs._nhwc if layout == "NHWC" else (lambda a: a)
    if fuse:
        sym = fuse_conv_bn(sym)
    x, y = cs._image_batches(cfg["image_shape"], B, cs.SEED + 14,
                             cfg["num_classes"])
    dev = torch.device("cuda", 0)
    batch = {"data": torch.from_numpy(conv(x)).to(dev),
             "softmax_label": torch.from_numpy(y).to(dev)}
    ts = TrainStep(sym, mx.optimizer.SGD(
        learning_rate=train["lr"], momentum=train["momentum"],
        wd=train["wd"], rescale_grad=1.0 / B),
        data_shapes={"data": tuple(batch["data"].shape)},
        label_shapes={"softmax_label": (B,)}, ctx=mx.gpu(0))
    ts.init_params(mx.init.Xavier(), arg_params={
        n: conv(a) for n, a in np_args.items()}, aux_params=np_aux)

    def step():
        ts.step(batch)
        torch.cuda.synchronize()

    n = 3
    walls, syncs, prof = _measure(torch, step, lambda: ts.step(batch), n)
    total, kernels = device_ms_by_group(torch, prof, n)
    device_ms = sum(total.values())
    ranges = _range_ms(torch, prof, n)
    relayout = _kernel_ms(torch, prof, n, _RELAYOUT)
    fused_kernel = sum(_kernel_ms(torch, prof, n,
                                  ("fused_scale_relu_matmul",)).values())
    memcpy = sum(_kernel_ms(torch, prof, n, ("memcpy dtod",)).values())
    # cuDNN's own layout transposes run inside the convolution ranges; the
    # fused op's range holds whatever of the kernel its own range
    # (op:fused_kernel_call) was credited with, and the rest of its
    # forward: statistics, scale and shift
    cudnn_relayout = sum(v for k, v in relayout.items()
                         if "nchwtonhwc" in k.lower()
                         or "nhwctonchw" in k.lower())
    groups = {
        "convolution": ranges.get("op:Convolution", 0.0)
        + ranges.get("aten::convolution_backward", 0.0) - cudnn_relayout,
        "fused_kernel": fused_kernel,
        "fused_backward": ranges.get("op:fused_backward", 0.0),
        "fused_op_rest": ranges.get("op:_FusedBNReluConv", 0.0)
        - ranges.get("op:fused_kernel_call", 0.0),
        "batchnorm": ranges.get("op:BatchNorm", 0.0)
        + ranges.get("op:BatchNorm_backward", 0.0),
        "relayout_copies": sum(relayout.values()),
        "memcpy_dtod": memcpy}
    groups["elementwise/other"] = device_ms - sum(groups.values())
    wall = statistics.median(walls)
    print(json.dumps({
        "phase": "profile", "step": "resnet50_trainstep", "config": cfg,
        "layout": layout, "fused_sites": count_fused(sym), "batch": B,
        "wall_ms_p50": wall, "wall_ms": walls, "device_ms": device_ms,
        "device_idle_share": 1 - device_ms / wall,
        "device_ms_by_group": {k: round(v, 4) for k, v in
                               sorted(groups.items(), key=lambda kv: -kv[1])},
        "relayout_kernels": {k: round(v, 4) for k, v in relayout.items()},
        "ranges_ms": {k: round(v, 4) for k, v in ranges.items()},
        "device_launches_per_step": kernels / n,
        "host_syncs_per_step": len(syncs),
        "sync_sites": sorted(set(syncs))}), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.weights import convert_params
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device(torch)
    args = sys.argv[1:]
    if "--resnet" in args and ("--layout" in args or "--fuse" in args):
        layout = args[args.index("--layout") + 1] if "--layout" in args \
            else "NHWC"
        profile_trainstep(torch, cs, mx, layout, "--fuse" in args)
        return 0
    if "--resnet" in args:
        profile_resnet(torch, cs, mx)
        return 0
    if "--train" in sys.argv[1:]:
        profile_train(torch, cs, mx)
        return 0
    eng = DecodeEngine(convert_params(cs.seeded_params(cs.FULL), mx.gpu(0),
                                      cs.FULL), cs.FULL, ctx=mx.gpu(0),
                       start=False, warmup=True, **cs.GEOMETRY)
    rng = np.random.RandomState(cs.SEED)
    C, K = eng.capacity, eng._chunk_tokens
    blocks = rng.permutation(eng.cache.num_blocks)
    feeds = eng._idle_feeds()
    for c in range(C):                   # 8 slots at position 400 each
        feeds["data"][c, 0] = rng.randint(cs.FULL["num_classes"])
        feeds["positions"][c, 0] = 400
        feeds["block_table"][c, :26] = blocks[c * 26:(c + 1) * 26]
    mixed = {k: v.copy() for k, v in feeds.items()}
    mixed["chunk_data"][0] = rng.randint(cs.FULL["num_classes"], size=K)
    mixed["chunk_positions"][0] = np.arange(320, 320 + K)
    mixed["chunk_start"][0] = 320
    mixed["chunk_len"][0] = K
    mixed["chunk_table"][0, :24] = blocks[C * 26:C * 26 + 24]

    for kind, f in (("decode_only", feeds), ("mixed", mixed)):
        def step():
            outs = eng._exe.forward(is_train=False, **f)
            outs[1].asnumpy()
            return outs
        for _ in range(3):
            step()
        walls, enq = [], []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = eng._exe.forward(is_train=False, **f)
            enq.append((time.perf_counter() - t0) * 1e3)
            outs[1].asnumpy()
            walls.append((time.perf_counter() - t0) * 1e3)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng._exe.forward(is_train=False, **f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sorted({str(w.message).splitlines()[0][:80] for w in caught})
        n = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
        by_group, kernels = device_ms_by_group(torch, prof, n)
        device_ms = sum(by_group.values())
        wall = statistics.median(walls)
        print(json.dumps({
            "phase": "profile", "step": kind, "wall_ms_p50": wall,
            "enqueue_ms_p50": statistics.median(enq),
            "device_ms": device_ms, "device_idle_share": 1 - device_ms / wall,
            "device_ms_by_group": {k: round(v, 4) for k, v in
                                   sorted(by_group.items(),
                                          key=lambda kv: -kv[1])},
            "device_launches_per_step": kernels / n,
            "host_syncs_in_forward": len(caught), "sync_kinds": syncs}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
