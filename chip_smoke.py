#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``mxnet_tpu_torch/csrc`` for
   sm_90a (one nvcc per source, in parallel) into ``build/kernels/``;
3. one phase per kernel at the served shapes: the kernel against its
   plain PyTorch version on the same inputs (f32: rtol 1e-4, atol 1e-5,
   since the reductions run in another order; cache bytes and inactive
   slots exact), CUDA-event times of kernel, plain version and, where
   one exists, the single PyTorch call computing the same function
   (median of 60 launches after warm-up, L2 flushed before each), and
   the least time the card could take (bytes over 3.35 TB/s or f32
   operations over 67 TFLOP/s, whichever is larger);
4. serve: the transformer LM at full width (L12, d2048, h16, vocab
   16384, ffn 8192, seq 1024; random N(0, 0.02) weights from a numpy
   seed) through ``DecodeEngine``: 8 ragged requests fill the 8 slots
   and the first one, submitted again, waits for a slot and is admitted
   mid-flight; every request must finish with its token count, the
   resubmitted one must repeat its stream, every step must have launched
   each paged kernel 12 times and LayerNorm 50 times, and no plain
   version may run;
5. agreement: the same engine at 2 layers on the card and on the CPU
   (plain versions) over 3 requests: per-step logits within rtol 1e-4 /
   atol 1e-4 and equal greedy streams (a stream is compared only up to
   a step where the CPU's top-2 logit margin is inside that tolerance);
6. layernorm_bwd, flash_fwd, flash_bwd: the training kernels at the
   training shapes (LayerNorm backward on 4096 x 2048, with and without
   a residual, two runs bit-identical; causal flash attention on
   (4, 16, 1024, 128)), each against its plain version, timed as in 3,
   beside ``native_layer_norm_backward`` and
   ``scaled_dot_product_attention`` (forward, and its backward) as the
   library yardsticks;
7. train: the same full-width model trained through ``Module.fit``
   (SGD, momentum 0.9, learning rate 0.05, perplexity metric) over two
   fixed batches of 4 x 1024 random tokens for 5 epochs: the loss must
   be finite and fall on the repeated batch, every step must launch
   LayerNorm forward and backward 25 times and each flash kernel 12
   times, and no plain version may run; step time p50 over the last 8
   steps, tokens/s and peak device memory are printed;
8. train_agreement: the model at 2 layers, batch 2, seq 256, from the
   same numpy weights on the card and on the CPU: the loss, every
   parameter's gradient after one forward/backward and every
   parameter's change after 2 SGD steps agree within 1e-3 of the CPU's
   largest value of that quantity;
9. quant: the 2-bit quantizer against its plain version, bit for bit
   (int32 views, so NaN and -0.0 count) at the lengths of ``QUANT``, a
   4-byte-offset view and the edge values (NaN, +-inf, -0.0, sums at
   +-t and one ulp either side), thresholds 0.5 and 0.1; timed at a full
   4 MiB bucket and at ResNet-50's largest array (16 bytes per element
   over 3.35 TB/s bound it);
10. kvstore: the same numpy gradient streams (3 per key, 4 steps, the
   shapes of ``KV``, one key above the 4 MiB bucket cap) through a
   2-bit store on the card and one on the CPU: with no updater the
   pulled values and residuals are bit-identical, card against CPU and
   bucketed against eager; with SGD they agree within rtol/atol 5e-7;
11. train_resnet: ResNet-50 v2 (3x224x224, 1000 classes, seeded weights
   and BatchNorm statistics) through ``Module.fit`` with
   ``mx.kv.create('device')``, batch 128, two fixed synthetic batches
   for 5 epochs (SGD, learning rate 0.05, momentum 0.9, wd 1e-4,
   accuracy metric), a dense arm (the loss must be finite and fall on
   the repeated batch, the quantizer never runs) and a 2-bit arm
   (threshold 0.5: each step launches the quantizer once per bucket the
   engine dispatched, the same count every step after the first, the
   flat residuals stay finite, no plain version runs); step p50,
   images/s, peak memory and buckets per step are printed;
12. resnet_agreement: ResNet-18 (7x7 stem and max-pool) at 3x64x64, 10
   classes, batch 4, card against CPU from the same numpy weights: loss
   (rtol 1e-3), every gradient and moving statistic after the train
   forward (within 1e-3 and 1e-4 of the CPU's largest value of each),
   and one 2-bit update at the median |g|: q equal wherever the CPU's
   |g| lies farther than 1e-4 t from t, the elements inside that band
   counted and under 1e-4 of all;
13. fused_matmul: the fused BN-apply/ReLU/1x1-convolution kernel against
   its plain version (rtol 1e-4 / atol 1e-5) at the 8 (M, K, N) shapes of
   ResNet-50's 28 fused sites at batch 128 and one odd shape, two runs
   bit-identical; timed as in 3 beside ``torch.addmm``/``torch.matmul``
   on the already activated input (the product alone: a yardstick that
   skips the activation pass the kernel fuses);
14. train_resnet_nhwc: ResNet-50 v2 through ``parallel.TrainStep`` from
   the same numpy weights (OIHW transposed to OHWI for the channel-last
   arms) in three arms, NCHW, NHWC, and NHWC after ``fuse_conv_bn``:
   batch 128, SGD (learning rate 0.05, momentum 0.9, wd 1e-4, gradients
   rescaled by 1/batch as bench.py and Module.fit do), 10 steps over two
   fixed batches; the first-step losses agree within 1e-3, the
   loss falls on the repeated batch, the fused arm launches the kernel
   exactly 28 times per step and no plain version, the others never
   launch it; step p50, images/s and peak memory are printed per arm;
15. resnet_nhwc_agreement: one fused site's backward (16384 x 64 ->
   256 with a residual) card against CPU, each gradient within 1e-4 of
   its largest CPU value; then the fused NHWC ResNet-50 at 3x64x64, 10
   classes, batch 4, one TrainStep step on the card and on the CPU from
   the same numpy weights: loss (rtol 1e-3), probabilities (atol 1e-4),
   every moving statistic (1e-4 of its largest CPU value) and the whole
   gradient's relative L2 error (0.1: at random initialisation the
   gradient moves by percents under rounding-level changes, so a CPU run
   on the input scaled by 1 + 2^-22 is printed beside it).

Then the kernels' JSON line, and last ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no
result; it also exits non-zero when no CUDA device is present.
TF32 is off for every matrix product and convolution.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
SEED = 20261016
FULL = dict(num_classes=16384, num_layers=12, d_model=2048, num_heads=16,
            ffn_dim=8192, seq_len=1024)
GEOMETRY = dict(capacity=8, block_size=16, num_blocks=512, chunk_tokens=64)
RTOL, ATOL = 1e-4, 1e-5
TRAIN = dict(batch=4, lr=0.05, momentum=0.9, batches=2, epochs=5, warmup=2)
AGREE = dict(num_layers=2, seq_len=256, batch=2, rtol=1e-3)
# kernel launches of one training step of the full-width model
TRAIN_LAUNCHES = {"layernorm_fused": 25, "layernorm_fused_bwd": 25,
                  "flash_attention_fwd": 12, "flash_attention_bwd_dkv": 12,
                  "flash_attention_bwd_dq": 12}
# the 2-bit quantizer: lengths checked bit for bit (0 to a 4 MiB bucket,
# ResNet-50's largest array, an odd length) and the two timed
QUANT = dict(lengths=(0, 1, 7, 1048576, 2359296, 1000003),
             timed=(1048576, 2359296), thresholds=(0.5, 0.1))
# card store against CPU store: tests/test_kvstore_fused.py's shapes plus
# one key above the 4 MiB bucket cap
KV = dict(shapes=[(64, 32), (128,), (3, 3, 8, 8), (500, 10), (7,),
                  (1100, 1000)], streams=3, steps=4, threshold=0.1,
          sgd=dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
                   rescale_grad=0.5), rtol=5e-7, atol=5e-7)
# ResNet-50 v2 through Module.fit: common/fit.py's batch and the repo's
# compressed-training configuration (bench.py bench_checkpoint)
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))
RESNET_TRAIN = dict(batch=128, lr=0.05, momentum=0.9, wd=1e-4, batches=2,
                    epochs=5, warmup=2, threshold=0.5)
RESNET_AGREE = dict(num_classes=10, num_layers=18, image_shape=(3, 64, 64),
                    batch=4, loss_rtol=1e-3, grad_rtol=1e-3, aux_rtol=1e-4,
                    band=1e-4, band_share=1e-4)
# bench.py's channel-last ResNet-50 through TrainStep (f32, train_resnet's
# batch); the fused arm has 28 BN -> ReLU -> Conv1x1 sites
NHWC_TRAIN = dict(batch=128, lr=0.05, momentum=0.9, wd=1e-4, batches=2,
                  steps=10, warmup=2, sites=28, loss_rtol=1e-3)
NHWC_AGREE = dict(num_classes=10, num_layers=50, image_shape=(3, 64, 64),
                  batch=4, loss_rtol=1e-3, prob_atol=1e-4, aux_rtol=1e-4,
                  grad_l2=0.1, perturb=2.0 ** -22, site=(16384, 64, 256),
                  site_rtol=1e-4)
# (M, K, N, residual): site count, for ResNet-50's fused sites at batch 128
FUSED_SHAPES = {(401408, 256, 64, False): 2, (401408, 64, 256, True): 3,
                (100352, 512, 128, False): 3, (100352, 128, 512, True): 4,
                (25088, 1024, 256, False): 5, (25088, 256, 1024, True): 6,
                (6272, 2048, 512, False): 2, (6272, 512, 2048, True): 3}
FUSED_ODD = (1000, 37, 93, True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def time_ms(torch, fn, flush, reps=60, warmup=5):
    """Median device time of one ``fn()`` over ``reps`` launches, each
    bracketed by CUDA events after an L2 flush; a device-side sleep
    before the start event keeps the host's launch overhead out of the
    bracket."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def close(torch, a, b):
    return bool(torch.allclose(a.float(), b.float(), rtol=RTOL, atol=ATOL))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device(torch):
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        line = torch.cuda.get_device_name(0)
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


def phase_build():
    from mxnet_tpu_torch.kernels import _build
    secs = _build.build_all()
    logs = {n: sorted(_build.BUILD_DIR.glob("lib%s-*.log" % n))
            for n in _build.SOURCES}
    ptxas = {n: sorted({ln.split(":", 1)[-1].strip() for p in logs[n][-1:]
                        for ln in p.read_text().splitlines()
                        if "registers" in ln or "spill" in ln})
             for n in _build.SOURCES}
    emit({"phase": "build", "seconds": secs, "sources": list(_build.SOURCES),
          "ptxas": ptxas})


def phase_decode(torch, mxk, dev, flush):
    C, H, D, nb, bs, M = 8, 16, 128, 512, 16, 64
    g = torch.Generator(device="cpu").manual_seed(SEED)
    q = torch.randn(C, H, D, generator=g).to(dev)
    kc = torch.randn(nb, bs, H, D, generator=g).to(dev)
    vc = torch.randn(nb, bs, H, D, generator=g).to(dev)
    table = torch.randperm(nb, generator=g)[:C * M].reshape(C, M) \
        .to(torch.int32).to(dev)
    pos_live = torch.randint(20, 732, (C,), generator=g).to(torch.int32)
    pos_mixed = pos_live.clone()
    pos_mixed[7] = -1
    sc = 1.0 / D ** 0.5
    errs = []
    for pos in (pos_live.to(dev), pos_mixed.to(dev)):
        out = mxk.paged_decode_attend(q, kc, vc, table, pos, scale=sc)
        ref = mxk.paged_decode_attend_plain(q, kc, vc, table, pos, scale=sc)
        torch.cuda.synchronize()
        act = pos >= 0
        check(close(torch, out[act], ref[act]),
              "paged_decode_attend disagrees with its plain version "
              "(max abs err %g)" % max_err(out[act], ref[act]))
        check(bool((out[~act] == 0).all()),
              "paged_decode_attend: inactive slot is not exact zeros")
        errs.append(max_err(out[act], ref[act]))
    kb, vb = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    out = mxk.paged_decode_attend(q, kb, vb, table, pos_live.to(dev),
                                  scale=sc)
    ref = mxk.paged_decode_attend_plain(q, kb, vb, table, pos_live.to(dev),
                                        scale=sc)
    check(close(torch, out, ref), "paged_decode_attend (bf16 caches) "
          "disagrees with its plain version (max abs err %g)"
          % max_err(out, ref))
    pos = pos_live.to(dev)
    ms = time_ms(torch, lambda: mxk.paged_decode_attend(
        q, kc, vc, table, pos, scale=sc), flush)
    plain_ms = time_ms(torch, lambda: mxk.paged_decode_attend_plain(
        q, kc, vc, table, pos, scale=sc), flush)
    rows = int((pos_live.long() + 1).sum())
    nbytes = rows * H * D * 2 * 4 + 2 * C * H * D * 4 + C * (M + 1) * 4
    b_ms, b_by = bound(nbytes, rows * H * D * 4)
    res = {"name": "paged_decode_attend", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
           "replaces": "mxnet_tpu/pallas/attention.py:116",
           "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    emit({"phase": "kernel", **res, "shapes": {
        "q": [C, H, D], "cache": [nb, bs, H, D], "table": [C, M],
        "positions": pos_live.tolist()}, "context_rows": rows,
        "bf16_cache_max_abs_err": max_err(out, ref)})
    return res


def phase_chunk(torch, mxk, dev, flush):
    B, K, H, D, nb, bs, M = 1, 64, 16, 128, 512, 16, 64
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    q, k, v = (torch.randn(B, K, H, D, generator=g).to(dev)
               for _ in range(3))
    kc0 = torch.randn(nb, bs, H, D, generator=g).to(dev)
    vc0 = torch.randn(nb, bs, H, D, generator=g).to(dev)
    table = torch.randperm(nb, generator=g)[:M].reshape(B, M) \
        .to(torch.int32).to(dev)
    sc = 1.0 / D ** 0.5

    def i32(x):
        return torch.tensor([x], dtype=torch.int32, device=dev)

    errs = []
    # a block-aligned full chunk (the served case), a ragged chunk that
    # straddles block boundaries, and the no-op len == 0
    for st, L in ((576, 64), (600, 37), (320, 0)):
        kk, vk = kc0.clone(), vc0.clone()
        kp, vp = kc0.clone(), vc0.clone()
        out, _, _ = mxk.paged_chunk_prefill_attend(
            q, k, v, kk, vk, table, i32(st), i32(L), scale=sc)
        ref, _, _ = mxk.paged_chunk_prefill_attend_plain(
            q, k, v, kp, vp, table, i32(st), i32(L), scale=sc)
        torch.cuda.synchronize()
        check(close(torch, out[:, :L], ref[:, :L]),
              "paged_chunk_prefill_attend (start %d, len %d) disagrees "
              "with its plain version (max abs err %g)"
              % (st, L, max_err(out[:, :L], ref[:, :L])))
        check(torch.equal(kk, kp) and torch.equal(vk, vp),
              "paged_chunk_prefill_attend (start %d, len %d): caches "
              "differ from the plain version's" % (st, L))
        touched = torch.zeros(nb * bs, dtype=torch.bool, device=dev)
        for ap in range(st, st + L):
            touched[int(table[0, ap // bs]) * bs + ap % bs] = True
        kf, k0 = kk.view(nb * bs, -1), kc0.view(nb * bs, -1)
        check(torch.equal(kf[~touched], k0[~touched]),
              "paged_chunk_prefill_attend (start %d, len %d) wrote outside "
              "[start, start + len)" % (st, L))
        errs.append(max_err(out[:, :L], ref[:, :L]))
    kb, vb = kc0.to(torch.bfloat16), vc0.to(torch.bfloat16)
    kb2, vb2 = kb.clone(), vb.clone()
    out, _, _ = mxk.paged_chunk_prefill_attend(
        q, k, v, kb, vb, table, i32(600), i32(37), scale=sc)
    ref, _, _ = mxk.paged_chunk_prefill_attend_plain(
        q, k, v, kb2, vb2, table, i32(600), i32(37), scale=sc)
    check(close(torch, out[:, :37], ref[:, :37]) and torch.equal(kb, kb2),
          "paged_chunk_prefill_attend (bf16 caches) disagrees with its "
          "plain version")
    st, L = 576, 64
    kk, vk = kc0.clone(), vc0.clone()
    s_t, l_t = i32(st), i32(L)
    ms = time_ms(torch, lambda: mxk.paged_chunk_prefill_attend(
        q, k, v, kk, vk, table, s_t, l_t, scale=sc), flush)
    plain_ms = time_ms(torch, lambda: mxk.paged_chunk_prefill_attend_plain(
        q, k, v, kk, vk, table, s_t, l_t, scale=sc), flush)
    nbytes = (st * H * D * 2 * 4 + 3 * L * H * D * 4 + L * H * D * 2 * 4
              + K * H * D * 4 + M * 4 + 8)
    flops = sum(st + i + 1 for i in range(L)) * H * D * 4
    b_ms, b_by = bound(nbytes, flops)
    res = {"name": "paged_chunk_prefill_attend", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
           "replaces": "mxnet_tpu/pallas/attention.py:360",
           "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    emit({"phase": "kernel", **res, "shapes": {
        "q": [B, K, H, D], "cache": [nb, bs, H, D], "table": [B, M],
        "start": st, "len": L}, "checked": [[576, 64], [600, 37], [320, 0]],
        "bf16_cache_max_abs_err": max_err(out[:, :37], ref[:, :37])})
    return res


def phase_layernorm(torch, mxk, dev, flush):
    import torch.nn.functional as F
    cols = 2048
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev)
    per_shape = []
    for rows in (8, 64):
        x = torch.randn(rows, cols, generator=g).to(dev)
        res = torch.randn(rows, cols, generator=g).to(dev)
        err = 0.0
        for r in (None, res):
            got = mxk.layernorm_fused(x, gamma, beta, residual=r)
            ref = mxk.layernorm_plain(x, gamma, beta, residual=r)
            torch.cuda.synchronize()
            for a, b, what in zip(got, ref, ("out", "mean", "rstd")):
                check(close(torch, a, b), "layernorm_fused %s (rows %d, "
                      "residual %s) disagrees with its plain version (max "
                      "abs err %g)" % (what, rows, r is not None,
                                       max_err(a, b)))
                err = max(err, max_err(a, b))
        ms = time_ms(torch, lambda: mxk.layernorm_fused(x, gamma, beta),
                     flush)
        plain_ms = time_ms(torch, lambda: mxk.layernorm_plain(x, gamma, beta),
                           flush)
        lib_ms = time_ms(torch, lambda: F.layer_norm(x, (cols,), gamma, beta,
                                                     1e-5), flush)
        nbytes = 2 * rows * cols * 4 + 2 * cols * 4 + 2 * rows * 4
        b_ms, b_by = bound(nbytes, 8 * rows * cols)
        shape = {"rows": rows, "cols": cols, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "kernel", "name": "layernorm_fused", **shape})
        per_shape.append(shape)
    # the main path calls it 25 times per step at 8 rows and 25 at 64:
    # the kernels line carries the mean of the two shapes
    mean = {k: statistics.mean(s[k] for s in per_shape)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"name": "layernorm_fused", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/layernorm.cu",
            "replaces": "mxnet_tpu/pallas/layernorm.py:127",
            "max_abs_err": max(s["max_abs_err"] for s in per_shape),
            "bound_by": per_shape[-1]["bound_by"], **mean}


def seeded_params(cfg):
    """Random weights from a numpy seed, one stream per parameter name
    (so a 2-layer model shares its layers with the 12-layer one):
    N(0, 0.02), LayerNorm scales 1 + N(0, 0.02)."""
    from mxnet_tpu_torch.weights import param_shapes
    out = {}
    for name, shape in param_shapes(cfg).items():
        rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if name.endswith("_gamma"):
            a += np.float32(1.0)
        out[name] = a
    return out


def phase_serve(torch, mx, np_params):
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.weights import convert_params
    t0 = time.perf_counter()
    params = convert_params(np_params, mx.gpu(0), FULL)
    eng = DecodeEngine(params, FULL, ctx=mx.gpu(0), warmup=True,
                       **GEOMETRY)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    lengths = [700, 20, 350, 90, 520, 45, 260, 610]
    prompts = [rng.randint(0, FULL["num_classes"], n).tolist()
               for n in lengths]
    new = 32
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        # the 8 requests fill the 8 slots; the first one submitted again
        # waits in the queue and is admitted mid-flight when a slot frees
        handles = [eng.submit(p, max_new_tokens=new)
                   for p in prompts + prompts[:1]]
        outs = [h.result(timeout=900) for h in handles]
        wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        st = eng.stats()
    finally:
        eng.stop()
    check(all(len(o) == new for o in outs),
          "serve: a request finished with %s tokens, not %d"
          % ([len(o) for o in outs], new))
    check(outs[-1] == outs[0], "serve: the resubmitted request gave another "
          "stream")
    steps = st["steps"]
    check(launches["paged_decode_attend"] == 12 * steps
          and launches["paged_chunk_prefill_attend"] == 12 * steps
          and launches["layernorm_fused"] == 50 * steps,
          "serve: launch counts %s over %d steps (want 12, 12, 50 per "
          "step)" % (launches, steps))
    check(not any(plain.values()), "serve: plain versions ran on the main "
          "path: %s" % plain)
    ttft = sorted(h.ttft_ms for h in handles)
    emit({"phase": "serve", "config": FULL, "geometry": GEOMETRY,
          "requests": len(handles), "prompt_lengths": lengths + lengths[:1],
          "new_tokens_each": new, "setup_s": setup_s, "wall_s": wall,
          "steps": steps, "prefill_chunks": st["prefill_chunks"],
          "decode_tokens_per_s": len(handles) * new / wall,
          "step_ms_p50": st["step_ms_p50"], "ttft_ms_p50": ttft[len(ttft) // 2],
          "ttft_ms_max": ttft[-1], "launches": launches,
          "plain_calls": plain, "peak_mem_gb":
              torch.cuda.max_memory_allocated() / 1e9,
          "deterministic_resubmit": True})
    return launches, steps


def phase_agreement(torch, mx):
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.weights import convert_params
    cfg = dict(FULL, num_layers=2)
    np_params = seeded_params(cfg)
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, cfg["num_classes"], n).tolist()
               for n in (40, 100, 150)]
    runs = []                        # [card run, CPU run]
    for ctx in (mx.gpu(0), mx.cpu()):
        eng = DecodeEngine(convert_params(np_params, ctx, cfg), cfg, ctx=ctx,
                           **GEOMETRY)
        try:
            hs = [eng.submit(p, max_new_tokens=8, collect_logits=True)
                  for p in prompts]
            runs.append([(h.result(timeout=900), h.logits) for h in hs])
        finally:
            eng.stop()
    worst, compared, cut = 0.0, 0, []
    for r, ((gt, gl), (ct, cl)) in enumerate(zip(*runs)):
        for t, (a, b) in enumerate(zip(gl, cl)):
            check(np.allclose(a, b, rtol=1e-4, atol=1e-4),
                  "agreement: request %d step %d logits differ (max abs err "
                  "%g)" % (r, t, float(np.abs(a - b).max())))
            worst = max(worst, float(np.abs(a - b).max()))
            compared += 1
            if gt[t] != ct[t]:
                top2 = np.sort(b)[-2:]
                margin = float(top2[1] - top2[0])
                check(margin <= 1e-4 + 1e-4 * abs(float(top2[1])),
                      "agreement: request %d step %d greedy tokens differ "
                      "at a CPU top-2 margin of %g" % (r, t, margin))
                cut.append([r, t, margin])
                break
    emit({"phase": "agreement", "config": cfg, "requests": len(prompts),
          "steps_compared": compared, "max_abs_logit_err": worst,
          "streams_equal": all(g[0] == c[0] for g, c in zip(*runs)),
          "cut_at_small_margin": cut})


# ----------------------------------------------------------------------
# training kernels
# ----------------------------------------------------------------------
def phase_layernorm_bwd(torch, mxk, dev, flush):
    """LayerNorm backward at the training shape.  dx is held at rtol
    1e-4 / atol 1e-5.  dgamma and dbeta are sums over 4096 rows whose
    partial sums reach ~64 in magnitude, taken in another order than the
    plain version's: their rounding error is of order 1e-5 whatever the
    size of the result, so they are held at rtol 1e-4 / atol 2e-4, and
    whether the strict bound held too is printed."""
    rows, cols = 4096, 2048
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    x = torch.randn(rows, cols, generator=g).to(dev)
    res = torch.randn(rows, cols, generator=g).to(dev)
    dy = torch.randn(rows, cols, generator=g).to(dev)
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev)
    errs, strict = {}, True
    for r in (None, res):
        _, mean, rstd = mxk.layernorm_plain(x, gamma, beta, residual=r)
        got = mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy, residual=r)
        again = mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy, residual=r)
        ref = mxk.layernorm_bwd_plain(x, gamma, mean, rstd, dy, residual=r)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "layernorm_fused_bwd (residual %s): two runs differ"
              % (r is not None))
        for a, b, what in zip(got, ref, ("dx", "dgamma", "dbeta")):
            atol = ATOL if what == "dx" else 2e-4
            check(bool(torch.allclose(a, b, rtol=RTOL, atol=atol)),
                  "layernorm_fused_bwd %s (residual %s) disagrees with its "
                  "plain version (max abs err %g)"
                  % (what, r is not None, max_err(a, b)))
            strict = strict and close(torch, a, b)
            errs["%s%s" % (what, "_res" if r is not None else "")] = \
                max_err(a, b)
    _, mean, rstd = mxk.layernorm_plain(x, gamma, beta)
    ms = time_ms(torch, lambda: mxk.layernorm_fused_bwd(x, gamma, mean, rstd,
                                                        dy), flush)
    plain_ms = time_ms(torch, lambda: mxk.layernorm_bwd_plain(
        x, gamma, mean, rstd, dy), flush)
    m2, r2 = mean.reshape(rows, 1), rstd.reshape(rows, 1)
    lib_ms = time_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [cols], m2, r2, gamma, beta, [True, True, True]), flush)
    # x and dy read, dx written, gamma and the stats read, dgamma/dbeta
    # written; ~12 flops per element
    nbytes = 3 * rows * cols * 4 + 3 * cols * 4 + 2 * rows * 4
    b_ms, b_by = bound(nbytes, 12 * rows * cols)
    out = {"name": "layernorm_fused_bwd", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/layernorm.cu",
           "replaces": "mxnet_tpu/pallas/layernorm.py:158",
           "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    emit({"phase": "kernel", **out, "rows": rows, "cols": cols,
          "errors": errs, "strict_tolerance_held": strict,
          "deterministic": True,
          "library_call": "aten.native_layer_norm_backward"})
    return out


def phase_flash(torch, mxk, dev, flush):
    """Causal flash attention at the training shape: each kernel against
    its plain version on the same inputs (rtol 1e-4 / atol 1e-5), and
    FlashAttentionFn's output and gradients against autograd through
    the materialised reference.  Returns the three kernel rows."""
    import torch.nn.functional as F
    B, H, S, D = 4, 16, 1024, 128
    sc = 1.0 / D ** 0.5
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(dev)
                   for _ in range(4))
    o, lse = mxk.flash_attention_fwd(q, k, v, scale=sc)
    o_ref, lse_ref = mxk.flash_attention_fwd_plain(q, k, v, scale=sc)
    delta = (do * o_ref).sum(-1)
    dk, dv = mxk.flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta,
                                         scale=sc)
    dk_ref, dv_ref = mxk.flash_attention_bwd_dkv_plain(q, k, v, do, lse_ref,
                                                       delta, scale=sc)
    dq = mxk.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta, scale=sc)
    dq_ref = mxk.flash_attention_bwd_dq_plain(q, k, v, do, lse_ref, delta,
                                              scale=sc)
    torch.cuda.synchronize()
    errs = {}
    for what, a, b in (("out", o, o_ref), ("lse", lse, lse_ref),
                       ("dk", dk, dk_ref), ("dv", dv, dv_ref),
                       ("dq", dq, dq_ref)):
        check(close(torch, a, b), "flash attention %s disagrees with its "
              "plain version (max abs err %g)" % (what, max_err(a, b)))
        errs[what] = max_err(a, b)
    del o_ref, lse_ref, dk_ref, dv_ref, dq_ref
    # the autograd Function end to end against the reference's autograd
    ends = []
    for fn in (mxk.flash_attention, mxk.flash_attention_plain):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins, scale=sc)
        ends.append([out.detach()] + list(torch.autograd.grad(out, ins, do)))
        del out, ins
    for what, a, b in zip(("out", "dq", "dk", "dv"), *ends):
        check(close(torch, a, b), "FlashAttentionFn %s disagrees with "
              "autograd through the reference (max abs err %g)"
              % (what, max_err(a, b)))
        errs["fn_" + what] = max_err(a, b)
    del ends

    ms_f = time_ms(torch, lambda: mxk.flash_attention_fwd(q, k, v, scale=sc),
                   flush)
    ms_dkv = time_ms(torch, lambda: mxk.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, scale=sc), flush)
    ms_dq = time_ms(torch, lambda: mxk.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, scale=sc), flush)
    pl_f = time_ms(torch, lambda: mxk.flash_attention_fwd_plain(
        q, k, v, scale=sc), flush, reps=20)
    pl_dkv = time_ms(torch, lambda: mxk.flash_attention_bwd_dkv_plain(
        q, k, v, do, lse, delta, scale=sc), flush, reps=20)
    pl_dq = time_ms(torch, lambda: mxk.flash_attention_bwd_dq_plain(
        q, k, v, do, lse, delta, scale=sc), flush, reps=20)
    lib_f = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sc), flush)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=sc)
    lib_b = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qr, kr, vr), do, retain_graph=True), flush)
    del o_lib, qr, kr, vr
    # one causal product over the lower triangle, diagonal included
    tri = 2.0 * B * H * D * S * (S + 1) / 2
    io = B * H * S * D * 4
    rows = []
    for name, ms, plain_ms, n_prod, nbytes, lib in (
            ("flash_attention_fwd", ms_f, pl_f, 2, 4 * io + B * H * S * 4,
             lib_f),
            ("flash_attention_bwd_dkv", ms_dkv, pl_dkv, 4,
             6 * io + 2 * B * H * S * 4, lib_b),
            ("flash_attention_bwd_dq", ms_dq, pl_dq, 3,
             5 * io + 2 * B * H * S * 4, lib_b)):
        b_ms, b_by = bound(nbytes, n_prod * tri)
        rows.append({"name": name, "route": "cuda",
                     "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
                     "replaces": "mxnet_tpu/ops/nn.py:744",
                     "max_abs_err": max(errs.values()), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib})
    emit({"phase": "flash_fwd", **rows[0], "shape": [B, H, S, D],
          "scale": sc, "errors": errs,
          "library_call": "F.scaled_dot_product_attention(is_causal=True)"})
    emit({"phase": "flash_bwd", "kernels": rows[1:], "shape": [B, H, S, D],
          "library_call": "autograd backward of F.scaled_dot_product_attention"
                          " (dq, dk and dv together: the library_ms of both "
                          "rows)"})
    return rows


# ----------------------------------------------------------------------
# training through Module.fit
# ----------------------------------------------------------------------
class FlatLabels:
    """An NDArrayIter whose (B, S) label batches are flattened to the
    (B * S,) next-token targets that SoftmaxOutput over the (B * S,
    vocab) logits takes."""

    def __init__(self, mx, it):
        self.mx, self.it = mx, it

    @property
    def provide_data(self):
        return self.it.provide_data

    @property
    def provide_label(self):
        return [self.mx.io.DataDesc(d.name, (d.shape[0] * d.shape[1],))
                for d in self.it.provide_label]

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        return self.mx.io.DataBatch(
            data=b.data, pad=b.pad,
            label=[self.mx.nd.NDArray(x._data.reshape(-1)) for x in b.label])

    def reset(self):
        self.it.reset()


def _token_batches(cfg, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, cfg["num_classes"], (n, cfg["seq_len"]))
    return x.astype(np.float32), np.roll(x, -1, axis=1).astype(np.float32)


def phase_train(torch, mx, np_params, cfg=FULL, ctx=None):
    """Module.fit on the full-width model; returns the launch counts of
    the fit run."""
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    B, S = TRAIN["batch"], cfg["seq_len"]
    x, y = _token_batches(cfg, B * TRAIN["batches"], SEED + 6)
    t0 = time.perf_counter()
    mod = mx.Module(transformer.get_symbol(**cfg), context=ctx)
    mod.bind(data_shapes=[("data", (B, S))],
             label_shapes=[("softmax_label", (B * S,))])
    mod.set_params(convert_params(np_params, ctx, cfg), {})
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    ppl, stamps = [], []

    def per_step(param):
        sync()
        stamps.append(time.perf_counter())
        ppl.append(param.eval_metric.get()[1])
        param.eval_metric.reset()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stamps.append(time.perf_counter())
    mod.fit(FlatLabels(mx, mx.io.NDArrayIter(x, y, batch_size=B)),
            num_epoch=TRAIN["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN["lr"],
                              "momentum": TRAIN["momentum"]},
            eval_metric="perplexity", batch_end_callback=per_step)
    sync()
    launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
    steps = len(ppl)
    check(steps == TRAIN["batches"] * TRAIN["epochs"],
          "train: %d steps ran" % steps)
    check(all(np.isfinite(ppl)), "train: non-finite loss %s" % ppl)
    first, last = ppl[0], ppl[-TRAIN["batches"]]      # batch 0, epochs 0, -1
    check(last < first, "train: the loss on the repeated batch did not fall "
          "(perplexity %g -> %g)" % (first, last))
    for name, per in TRAIN_LAUNCHES.items():
        check(launches[name] == per * steps,
              "train: %s launched %d times over %d steps (want %d per step)"
              % (name, launches[name], steps, per))
    check(not any(plain.values()), "train: plain versions ran on the main "
          "path: %s" % plain)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    timed = sorted(step_ms[TRAIN["warmup"]:])
    p50 = statistics.median(timed)
    emit({"phase": "train", "config": cfg, "train": TRAIN,
          "setup_s": setup_s, "steps": steps,
          "step_ms": step_ms, "step_ms_p50": p50,
          "tokens_per_s": B * S / (p50 / 1e3),
          "perplexity": ppl, "loss_first": math.log(first),
          "loss_last_same_batch": math.log(last),
          "final_perplexity": ppl[-1],
          "launches": {k: launches[k] for k in TRAIN_LAUNCHES},
          "launches_per_step": {k: launches[k] / steps
                                for k in TRAIN_LAUNCHES},
          "plain_calls": plain,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
          if on_card else None})
    return launches, steps


def phase_train_agreement(torch, mx, cfg=None, ctxs=None):
    """Gradients after one forward/backward and parameter changes after
    two SGD steps, card against CPU, from the same numpy weights."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    cfg = cfg or dict(FULL, num_layers=AGREE["num_layers"],
                      seq_len=AGREE["seq_len"])
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    B, S, rtol = AGREE["batch"], cfg["seq_len"], AGREE["rtol"]
    np_params = seeded_params(cfg)
    x, y = _token_batches(cfg, B, SEED + 7)
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y.reshape(-1), ctx=mx.cpu())])
    runs = []
    for ctx in ctxs:
        mod = mx.Module(transformer.get_symbol(**cfg), context=ctx)
        mod.bind(data_shapes=[("data", (B, S))],
                 label_shapes=[("softmax_label", (B * S,))])
        mod.set_params(convert_params(np_params, ctx, cfg), {})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": TRAIN["lr"], "momentum": TRAIN["momentum"]})
        mod.forward_backward(batch)
        prob = mod.get_outputs()[0].asnumpy()
        loss = float(-np.log(prob[np.arange(B * S), y.reshape(-1)
                                  .astype(int)]).mean())
        group = mod._exec_group
        grads = {n: g[0].asnumpy() for n, g in zip(group.param_names,
                                                   group.grad_arrays)}
        mod.update()
        mod.forward_backward(batch)
        mod.update()
        moved = {n: v.asnumpy() - np_params[n]
                 for n, v in mod.get_params()[0].items()}
        runs.append((loss, grads, moved))
        del mod
    (gl, gg, gm), (cl, cg, cm) = runs
    check(abs(gl - cl) <= rtol * abs(cl), "train_agreement: loss %g on the "
          "card, %g on the CPU" % (gl, cl))
    worst = {"grad": {}, "step": {}}
    for kind, a, b in (("grad", gg, cg), ("step", gm, cm)):
        for name in b:
            scale = float(np.abs(b[name]).max())
            err = float(np.abs(a[name] - b[name]).max())
            check(err <= rtol * scale, "train_agreement: %s of %s differs "
                  "by %g (largest CPU value %g)" % (kind, name, err, scale))
            grp = name.split("_", 1)[1] if name.startswith("layer") else name
            worst[kind][grp] = max(worst[kind].get(grp, 0.0),
                                   err / scale if scale else 0.0)
    emit({"phase": "train_agreement", "config": cfg, "batch": B,
          "loss_card": gl, "loss_cpu": cl, "rtol": rtol,
          "worst_rel_err_by_group": worst})


# ----------------------------------------------------------------------
# the 2-bit quantizer and the kvstore
# ----------------------------------------------------------------------
def _bits(torch, t):
    return t.contiguous().view(torch.int32)


def phase_quant(torch, mxk, dev, flush):
    """two_bit_quantize_fused against its plain version on the card, bit
    for bit (int32 views, so NaN and -0.0 count): the lengths of QUANT,
    a view at a 4-byte offset, and the edge values (NaN, +-inf, -0.0,
    sums exactly at +-t and one ulp either side), at both thresholds;
    then the times of the two timed lengths."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 8)
    cases = 0
    for t in QUANT["thresholds"]:
        t32 = np.float32(t)
        up = float(np.nextafter(t32, np.float32(np.inf)))
        dn = float(np.nextafter(t32, np.float32(0)))
        edge = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                             0.0, float(t32), -float(t32), up, -up, dn, -dn],
                            device=dev)
        zero = torch.zeros_like(edge)
        ins = [(zero, edge), (edge, zero), (edge, edge)]
        for n in QUANT["lengths"]:
            ins.append(tuple((torch.randn(n, generator=g) * t).to(dev)
                             for _ in range(2)))
        base = (torch.randn(2, 1001, generator=g) * t).to(dev)
        ins.append((base[0, 1:], base[1, 1:]))          # 4-byte offset
        for r, gr in ins:
            got = mxk.two_bit_quantize_fused(r, gr, t)
            ref = mxk.two_bit_quantize_plain(r, gr, t)
            torch.cuda.synchronize()
            check(all(torch.equal(_bits(torch, a), _bits(torch, b))
                      for a, b in zip(got, ref)),
                  "two_bit_quantize_fused (n %d, threshold %g) differs from "
                  "its plain version" % (r.numel(), t))
            cases += 1
    per_len = []
    for n in QUANT["timed"]:
        r, gr = ((torch.randn(n, generator=g) * 0.5).to(dev) for _ in range(2))
        ms = time_ms(torch, lambda: mxk.two_bit_quantize_fused(r, gr, 0.5),
                     flush)
        plain_ms = time_ms(torch, lambda: mxk.two_bit_quantize_plain(
            r, gr, 0.5), flush)
        # r and g read, q and the new residual written; 4 ops per element
        b_ms, b_by = bound(16 * n, 4 * n)
        row = {"n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        emit({"phase": "kernel", "name": "two_bit_quantize_fused", **row})
        per_len.append(row)
    mean = {k: statistics.mean(s[k] for s in per_len)
            for k in ("ms", "plain_ms", "bound_ms")}
    emit({"phase": "quant", "cases_bit_identical": cases,
          "lengths": list(QUANT["lengths"]),
          "thresholds": list(QUANT["thresholds"])})
    return {"name": "two_bit_quantize_fused", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/quant.cu",
            "replaces": "mxnet_tpu/pallas/quant.py:44", "max_abs_err": 0.0,
            "bound_by": per_len[0]["bound_by"], "library_ms": None, **mean}


def _kv_run(mx, ctx, bucketed, updater):
    """KV's gradient streams through a 2-bit device store on ``ctx``:
    the pulled values and the per-(key, stream) residuals, as numpy."""
    kv = mx.kv.create("device")
    kv.set_bucketing(bucketed)
    kv.set_gradient_compression({"type": "2bit",
                                 "threshold": KV["threshold"]})
    if updater:
        kv.set_optimizer(mx.optimizer.SGD(**KV["sgd"]))
    keys = ["p%d" % i for i in range(len(KV["shapes"]))]
    rng = np.random.RandomState(SEED + 9)
    for k, s in zip(keys, KV["shapes"]):
        kv.init(k, mx.nd.array(rng.normal(0, 1, s), ctx=ctx))
    r = np.random.RandomState(SEED + 10)
    for _ in range(KV["steps"]):
        grads = [[mx.nd.array(r.normal(0, 0.3, s), ctx=ctx)
                  for _ in range(KV["streams"])] for s in KV["shapes"]]
        kv.push(keys, grads, priority=[-i for i in range(len(keys))])
    outs = [mx.nd.zeros(s, ctx=ctx) for s in KV["shapes"]]
    kv.pull(keys, out=outs)
    if kv._engine is not None:
        kv._engine.spill_residuals()
    res = {k: v.asnumpy() for k, v in kv._compression_residuals.items()}
    stats = dict(kv._engine.stats) if kv._engine is not None else None
    return [o.asnumpy() for o in outs], res, stats


def phase_kvstore(torch, mx):
    """The same numpy gradient streams through a store on the card and
    one on the CPU: with no updater the pulled values and the residuals
    are bit-identical, card against CPU and bucketed against eager on
    the card; with SGD they agree within KV's rtol/atol (FMA contraction
    in the update)."""
    from mxnet_tpu_torch.kernels import LAUNCHES, reset_counts
    reset_counts()
    card, card_res, stats = _kv_run(mx, mx.gpu(0), True, False)
    launches = LAUNCHES["two_bit_quantize_fused"]
    check(launches == KV["streams"] * stats["buckets"],
          "kvstore: %d quantize launches for %d buckets of %d streams"
          % (launches, stats["buckets"], KV["streams"]))
    eager, eager_res, _ = _kv_run(mx, mx.gpu(0), False, False)
    cpu, cpu_res, _ = _kv_run(mx, mx.cpu(), True, False)
    for what, (a, ar), (b, br) in (
            ("card vs CPU", (card, card_res), (cpu, cpu_res)),
            ("bucketed vs eager", (card, card_res), (eager, eager_res))):
        check(sorted(ar) == sorted(br), "kvstore %s: residual keys differ"
              % what)
        check(all(np.array_equal(x.view(np.int32), y.view(np.int32))
                  for x, y in zip(a, b))
              and all(np.array_equal(ar[k].view(np.int32),
                                     br[k].view(np.int32)) for k in ar),
              "kvstore %s: values or residuals not bit-identical" % what)
    sgd_card, sgd_res, _ = _kv_run(mx, mx.gpu(0), True, True)
    sgd_cpu, sgd_cpu_res, _ = _kv_run(mx, mx.cpu(), True, True)
    worst = 0.0
    for a, b in zip(sgd_card, sgd_cpu):
        check(np.allclose(a, b, rtol=KV["rtol"], atol=KV["atol"]),
              "kvstore SGD: card and CPU differ by %g"
              % float(np.abs(a - b).max()))
        worst = max(worst, float(np.abs(a - b).max()))
    emit({"phase": "kvstore", "shapes": KV["shapes"],
          "streams": KV["streams"], "steps": KV["steps"],
          "threshold": KV["threshold"], "buckets": stats["buckets"],
          "flushes": stats["flushes"], "quantize_launches": launches,
          "no_updater_bit_identical": True,
          "sgd_max_abs_diff": worst,
          "sgd_residuals_bit_identical": all(
              np.array_equal(sgd_res[k].view(np.int32),
                             sgd_cpu_res[k].view(np.int32))
              for k in sgd_res)})


# ----------------------------------------------------------------------
# ResNet training through Module.fit
# ----------------------------------------------------------------------
def seeded_resnet_params(sym, batch, image):
    """Random weights and BatchNorm statistics from a numpy seed, one
    stream per name: He-normal convolution and FC weights (fan-in),
    gammas 1 + N(0, 0.1), betas and biases N(0, 0.1) and 0, moving means
    N(0, 0.1), moving variances 1 + |N(0, 0.1)|."""
    from mxnet_tpu_torch.weights import symbol_shapes
    args, auxs = symbol_shapes(sym, data=(batch,) + tuple(image),
                               softmax_label=(batch,))
    out = ({}, {})
    for i, shapes in enumerate((args, auxs)):
        for name, shape in shapes.items():
            rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
            z = rng.standard_normal(shape, dtype=np.float32)
            if name.endswith("_weight"):
                a = z * np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
            elif name.endswith("_gamma"):
                a = 1 + z * np.float32(0.1)
            elif name.endswith("_bias"):
                a = np.zeros(shape, np.float32)
            elif name.endswith("_var"):
                a = 1 + np.abs(z) * np.float32(0.1)
            else:                                # betas, moving means
                a = z * np.float32(0.1)
            out[i][name] = a
    return out


def _image_batches(image, n, seed, classes):
    """common/fit.py's synthetic data: uniform(-1, 1) images and random
    labels."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n,) + tuple(image)).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def phase_train_resnet(torch, mx, ctx=None, cfg=RESNET, train=RESNET_TRAIN):
    """ResNet-50 through Module.fit with mx.kv.create('device'), a dense
    arm and a 2-bit arm from the same seeded weights.  Returns the 2-bit
    arm's launch counts."""
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.weights import convert_symbol_params
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    B = train["batch"]
    sym = resnet.get_symbol(**cfg)
    np_args, np_aux = seeded_resnet_params(sym, B, cfg["image_shape"])
    x, y = _image_batches(cfg["image_shape"], B * train["batches"],
                          SEED + 11, cfg["num_classes"])
    arms = {}
    for arm, comp in (("dense", None),
                      ("2bit", {"type": "2bit",
                                "threshold": train["threshold"]})):
        t0 = time.perf_counter()
        args, auxs = convert_symbol_params(
            np_args, np_aux, ctx, sym, data=(B,) + tuple(cfg["image_shape"]),
            softmax_label=(B,))
        mod = mx.Module(resnet.get_symbol(**cfg), context=ctx,
                        compression_params=comp)
        kv = mx.kv.create("device")
        sync()
        setup_s = time.perf_counter() - t0
        labels = torch.from_numpy(y).long()
        losses, stamps, buckets, quant = [], [], [], []
        # launches on the card; on the CPU (a rehearsal) the plain calls
        counts = LAUNCHES if on_card else PLAIN_CALLS

        def per_step(param):
            sync()
            stamps.append(time.perf_counter())
            prob = mod.get_outputs()[0]._data
            lab = labels[param.nbatch * B:(param.nbatch + 1) * B] \
                .to(prob.device)
            losses.append(float(-torch.log(prob.gather(
                1, lab[:, None]).clamp(min=1e-30)).mean()))
            buckets.append(kv._engine.stats["buckets"])
            quant.append(counts["two_bit_quantize_fused"])

        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stamps.append(time.perf_counter())
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=B),
                num_epoch=train["epochs"], kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": train["lr"],
                                  "momentum": train["momentum"],
                                  "wd": train["wd"]},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                arg_params=args, aux_params=auxs, eval_metric="acc",
                batch_end_callback=per_step)
        sync()
        launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        steps = len(losses)
        check(steps == train["batches"] * train["epochs"],
              "train_resnet %s: %d steps ran" % (arm, steps))
        check(all(np.isfinite(losses)), "train_resnet %s: non-finite loss %s"
              % (arm, losses))
        step_buckets = np.diff([0] + buckets).tolist()
        step_quant = np.diff([0] + quant).tolist()
        stats = kv._engine.stats
        check(stats["flushes"] > 0, "train_resnet %s: the bucketed kvstore "
              "never flushed" % arm)
        if comp is None:
            check(quant[-1] == 0, "train_resnet dense: the quantizer ran %d "
                  "times" % quant[-1])
            first, last = losses[0], losses[-train["batches"]]
            check(last < first, "train_resnet dense: the loss on the "
                  "repeated batch did not fall (%g -> %g)" % (first, last))
        else:
            check(step_quant == step_buckets,
                  "train_resnet 2bit: quantize launches per step %s, "
                  "buckets per step %s" % (step_quant, step_buckets))
            check(len(set(step_buckets[1:])) == 1,
                  "train_resnet 2bit: buckets per step vary after the first "
                  "%s" % step_buckets)
            flat = kv._engine._flat_res
            check(all(bool(torch.isfinite(r).all()) for rec in flat.values()
                      for r in rec["res"]),
                  "train_resnet 2bit: a flat residual is not finite")
            if on_card:
                check(not any(plain.values()), "train_resnet 2bit: plain "
                      "versions ran on the main path: %s" % plain)
            arms["launches"] = launches
        step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        p50 = statistics.median(sorted(step_ms[train["warmup"]:]))
        arms[arm] = {"setup_s": setup_s, "step_ms": step_ms,
                     "step_ms_p50": p50, "images_per_s": B / (p50 / 1e3),
                     "loss": losses, "buckets_per_step": step_buckets,
                     "quantize_launches_per_step": step_quant,
                     "kv_stats": dict(stats),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None}
        del mod, kv, args, auxs
    emit({"phase": "train_resnet", "config": cfg, "train": train,
          "dense": arms["dense"], "2bit": arms["2bit"]})
    return arms["launches"], train["batches"] * train["epochs"]


def phase_resnet_agreement(torch, mx, ctxs=None, cfg=RESNET_AGREE):
    """ResNet-18 (ImageNet layout, 7x7 stem and max-pool) at 3x64x64 from
    the same numpy weights on the card and on the CPU: the loss, every
    parameter's gradient and moving statistic after the train forward
    (within grad_rtol and aux_rtol of the CPU's largest value of that
    array), and
    one 2-bit Module.update with the threshold at the median of the
    CPU's |g|: q is equal wherever the CPU's |acc| lies farther than
    band * t from t, and the elements inside that band are counted."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.weights import convert_symbol_params
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    B, image = cfg["batch"], cfg["image_shape"]
    kw = {k: cfg[k] for k in ("num_classes", "num_layers", "image_shape")}
    sym = resnet.get_symbol(**kw)
    np_args, np_aux = seeded_resnet_params(sym, B, image)
    x, y = _image_batches(image, B, SEED + 12, cfg["num_classes"])
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y, ctx=mx.cpu())])
    shapes = dict(data=(B,) + tuple(image), softmax_label=(B,))

    def run(ctx, threshold):
        mod = mx.Module(resnet.get_symbol(**kw), context=ctx,
                        compression_params=None if threshold is None else
                        {"type": "2bit", "threshold": threshold})
        mod.bind(data_shapes=[("data", shapes["data"])],
                 label_shapes=[("softmax_label", shapes["softmax_label"])])
        mod.set_params(*convert_symbol_params(np_args, np_aux, ctx, sym,
                                              **shapes))
        kv = mx.kv.create("device")
        mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
        mod.forward_backward(batch)
        prob = mod.get_outputs()[0].asnumpy()
        loss = float(-np.log(prob[np.arange(B), y.astype(int)]).mean())
        group = mod._exec_group
        grads = {n: g[0].asnumpy() for n, g in zip(group.param_names,
                                                   group.grad_arrays)}
        aux = {n: a[0].asnumpy() for n, a in zip(group.aux_names,
                                                 group.aux_arrays)}
        q = None
        if threshold is not None:
            mod.update()
            kv._engine.spill_residuals()
            # residuals start at zero, so acc = g and new_r = g - q:
            # (g - new_r) / t rounds to q's sign class, -1, 0 or +1
            q = {n: np.rint((grads[n] - kv._compression_residuals[(n, 0)]
                             .asnumpy()) / np.float32(threshold))
                 for n in grads}
        return loss, grads, aux, q

    _, cpu_grads, _, _ = run(ctxs[1], None)
    t = float(np.median(np.abs(np.concatenate(
        [g.ravel() for g in cpu_grads.values()]))))
    (gl, gg, ga, gq), (cl, cg, ca, cq) = (run(c, t) for c in ctxs)
    check(abs(gl - cl) <= cfg["loss_rtol"] * abs(cl),
          "resnet_agreement: loss %g on the card, %g on the CPU" % (gl, cl))
    worst_grad = 0.0
    for name, ref in cg.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(gg[name] - ref).max())
        check(err <= cfg["grad_rtol"] * scale, "resnet_agreement: gradient "
              "of %s differs by %g (largest CPU value %g)" % (name, err, scale))
        worst_grad = max(worst_grad, err / scale if scale else 0.0)
    worst_aux = 0.0
    for name, ref in ca.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(ga[name] - ref).max())
        check(err <= cfg["aux_rtol"] * scale, "resnet_agreement: %s differs "
              "by %g after the train forward (largest CPU value %g)"
              % (name, err, scale))
        worst_aux = max(worst_aux, err / scale if scale else 0.0)
    band = total = 0
    t32 = np.float32(t)
    for name, ref in cq.items():
        near = np.abs(np.abs(cg[name]) - t32) <= cfg["band"] * t32
        band += int(near.sum())
        total += near.size
        diff = int((gq[name] != ref)[~near].sum())
        check(diff == 0, "resnet_agreement: q of %s differs in %d elements "
              "outside the band" % (name, diff))
    share = band / total
    check(share < cfg["band_share"], "resnet_agreement: %d of %d elements (%g) lie "
          "inside the band" % (band, total, share))
    emit({"phase": "resnet_agreement", "config": cfg, "loss_card": gl,
          "loss_cpu": cl, "worst_grad_rel_err": worst_grad,
          "worst_aux_rel_err": worst_aux, "threshold": t,
          "q_elements": total, "q_in_band": band, "q_in_band_share": share,
          "q_plus_minus_share": float(sum(int((v != 0).sum())
                                          for v in cq.values())) / total})


# ----------------------------------------------------------------------
# channel-last ResNet-50 through TrainStep, with the fused kernel
# ----------------------------------------------------------------------
def phase_fused_matmul(torch, mxk, dev, flush):
    """fused_scale_relu_matmul against its plain version at every shape
    of FUSED_SHAPES and FUSED_ODD, two runs bit-identical; times at the
    ResNet-50 shapes.  Returns the kernels-line row: times per launch
    averaged over one step's 28 launches."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    rows, errs = [], []
    for shape in list(FUSED_SHAPES) + [FUSED_ODD]:
        M, K, N, with_res = shape
        x = torch.randn(M, K, device=dev, generator=g)
        sc = 1 + 0.2 * torch.randn(K, device=dev, generator=g)
        sh = 0.2 * torch.randn(K, device=dev, generator=g)
        w = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
        res = torch.randn(M, N, device=dev, generator=g) if with_res \
            else None
        got = mxk.fused_scale_relu_matmul_fwd(x, sc, sh, w, res)
        again = mxk.fused_scale_relu_matmul_fwd(x, sc, sh, w, res)
        ref = mxk.fused_scale_relu_matmul_plain(x, sc, sh, w, res)
        torch.cuda.synchronize()
        check(close(torch, got, ref), "fused_scale_relu_matmul %s disagrees "
              "with its plain version (max abs err %g)"
              % (shape, max_err(got, ref)))
        check(torch.equal(got, again), "fused_scale_relu_matmul %s: two "
              "runs differ" % (shape,))
        errs.append(max_err(got, ref))
        del got, again, ref
        if shape == FUSED_ODD:
            continue
        a = torch.relu(x * sc + sh)
        ms = time_ms(torch, lambda: mxk.fused_scale_relu_matmul_fwd(
            x, sc, sh, w, res), flush)
        plain_ms = time_ms(torch, lambda: mxk.fused_scale_relu_matmul_plain(
            x, sc, sh, w, res), flush)
        wt = w.t()
        lib_ms = time_ms(torch, (lambda: torch.addmm(res, a, wt))
                         if with_res else (lambda: torch.matmul(a, wt)),
                         flush)
        # x, w, scale, shift (and the residual) read once, y written once;
        # the product's 2MNK, the prologue's 3 per x element, the add
        nbytes = 4 * (M * K + N * K + 2 * K + M * N * (2 if with_res else 1))
        flops = 2 * M * N * K + 3 * M * K + (M * N if with_res else 0)
        b_ms, b_by = bound(nbytes, flops)
        row = {"M": M, "K": K, "N": N, "residual": with_res,
               "sites": FUSED_SHAPES[shape], "max_abs_err": errs[-1],
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "tflops": 2 * M * N * K / ms / 1e9}
        emit({"phase": "kernel", "name": "fused_scale_relu_matmul", **row})
        rows.append(row)
        del x, a, res, w
    sites = sum(FUSED_SHAPES.values())
    per_launch = {k: sum(r[k] * r["sites"] for r in rows) / sites
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    # the step's bound is by operations when the sites bound by
    # operations make up most of it
    ops_ms = sum(r["sites"] * r["bound_ms"] for r in rows
                 if r["bound_by"] == "operations")
    emit({"phase": "fused_matmul", "shapes_checked": len(FUSED_SHAPES) + 1,
          "odd_shape": list(FUSED_ODD), "deterministic": True,
          "step_ms": per_launch["ms"] * sites,
          "step_plain_ms": per_launch["plain_ms"] * sites,
          "step_library_ms": per_launch["library_ms"] * sites,
          "step_bound_ms": per_launch["bound_ms"] * sites,
          "library_call": "torch.addmm / torch.matmul on relu(x*scale+shift)"
                          " (the product alone)"})
    return {"name": "fused_scale_relu_matmul", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/fused_matmul.cu",
            "replaces": "mxnet_tpu/ops/fused.py:91",
            "max_abs_err": max(errs),
            "bound_by": "operations" if ops_ms * 2 >= per_launch["bound_ms"]
            * sites else "bytes", **per_launch}


def _nhwc(a):
    """An NCHW array or OIHW weight as contiguous NHWC / OHWI."""
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1)) if a.ndim == 4 \
        else a


def phase_train_resnet_nhwc(torch, mx, ctx=None, cfg=RESNET,
                            train=NHWC_TRAIN):
    """ResNet-50 through TrainStep in three arms from the same seeded
    weights: NCHW, NHWC, NHWC with the fusion pass.  Returns the fused
    arm's launch counts and step count."""
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dev = ctx.torch_device
    B, steps, name = train["batch"], train["steps"], "fused_scale_relu_matmul"
    np_args, np_aux = seeded_resnet_params(resnet.get_symbol(**cfg), B,
                                           cfg["image_shape"])
    x, y = _image_batches(cfg["image_shape"], B * train["batches"],
                          SEED + 14, cfg["num_classes"])
    arms, result = {}, None
    for arm, layout, fuse in (("nchw", "NCHW", False), ("nhwc", "NHWC", False),
                              ("nhwc_fused", "NHWC", True)):
        t0 = time.perf_counter()
        sym = resnet.get_symbol(layout=layout, **cfg)
        if fuse:
            sym = fuse_conv_bn(sym)
            check(count_fused(sym) == train["sites"], "train_resnet_nhwc: "
                  "%d fused sites, not %d" % (count_fused(sym),
                                              train["sites"]))
        conv = _nhwc if layout == "NHWC" else (lambda a: a)
        data = conv(x)
        batches = [{"data": torch.from_numpy(data[i * B:(i + 1) * B]).to(dev),
                    "softmax_label": torch.from_numpy(
                        y[i * B:(i + 1) * B]).to(dev)}
                   for i in range(train["batches"])]
        ts = TrainStep(sym, mx.optimizer.SGD(
            learning_rate=train["lr"], momentum=train["momentum"],
            wd=train["wd"], rescale_grad=1.0 / B),
            data_shapes={"data": data[:B].shape},
            label_shapes={"softmax_label": (B,)}, ctx=ctx)
        ts.init_params(mx.init.Xavier(), arg_params={
            n: conv(a) for n, a in np_args.items()}, aux_params=np_aux)
        sync()
        setup_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        losses, stamps = [], [time.perf_counter()]
        reset_counts()
        for i in range(steps):
            batch = batches[i % train["batches"]]
            prob = ts.step(batch)[0]
            lab = batch["softmax_label"].long()
            losses.append(float(-torch.log(prob.gather(
                1, lab[:, None]).clamp(min=1e-30)).mean()))
            stamps.append(time.perf_counter())
        sync()
        launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        check(all(np.isfinite(losses)), "train_resnet_nhwc %s: non-finite "
              "loss %s" % (arm, losses))
        first, last = losses[0], losses[-train["batches"]]
        check(last < first, "train_resnet_nhwc %s: the loss on the repeated "
              "batch did not fall (%g -> %g)" % (arm, first, last))
        counts = launches if on_card else plain
        want = train["sites"] * steps if fuse else 0
        check(counts[name] == want, "train_resnet_nhwc %s: %d %s calls over "
              "%d steps, want %d" % (arm, counts[name], name, steps, want))
        if on_card:
            check(not any(plain.values()), "train_resnet_nhwc %s: plain "
                  "versions ran on the main path: %s" % (arm, plain))
        step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        p50 = statistics.median(step_ms[train["warmup"]:])
        arms[arm] = {"layout": layout, "fused_sites": train["sites"] if fuse
                     else 0, "setup_s": setup_s, "step_ms": step_ms,
                     "step_ms_p50": p50, "images_per_s": B / (p50 / 1e3),
                     "loss": losses, "kernel_launches_per_step":
                         launches[name] / steps,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None}
        if fuse:
            result = (launches, steps)
        del ts, batches
    firsts = [a["loss"][0] for a in arms.values()]
    check(max(firsts) - min(firsts) <= train["loss_rtol"] * abs(firsts[0]),
          "train_resnet_nhwc: first-step losses differ across arms: %s"
          % firsts)
    emit({"phase": "train_resnet_nhwc", "config": cfg, "train": train,
          **arms})
    return result


def phase_resnet_nhwc_agreement(torch, mx, ctxs=None, cfg=NHWC_AGREE):
    """Card against CPU on the fused path, in two parts.

    1. One fused site's backward (the autograd Function's dx, dscale,
       dshift, dW and dres for a fixed cotangent at the shape
       ``cfg['site']``) from the same numpy inputs: each within
       site_rtol of its largest CPU value (sums in another order).
    2. The fused NHWC ResNet-50 at 3x64x64, batch 4, one TrainStep step
       from the same numpy weights on the card and on the CPU, and once
       more on the CPU with the input scaled by 1 + perturb (a change
       at the rounding level): the loss (loss_rtol), the output
       probabilities (prob_atol) and every moving statistic after the
       train forward (aux_rtol of its largest CPU value) are held as in
       resnet_agreement.  The whole gradient is held by its relative L2
       error (grad_l2): at random initialisation the gradient of a
       BatchNorm ResNet-50 moves by percents under rounding-level
       changes (ReLU masks flip and BatchNorm's backward amplifies the
       difference), and the perturbed CPU run's own distance is printed
       beside the card's, so an element bound cannot hold."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops.fused import fused_scale_relu_matmul
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    rng = np.random.default_rng(SEED + 16)
    M, K, N = cfg["site"]
    x2d, sc, sh, w, res, dy = (rng.standard_normal(s, dtype=np.float32)
                               for s in ((M, K), (K,), (K,), (N, K), (M, N),
                                         (M, N)))
    site = [x2d, 1 + 0.2 * sc, 0.2 * sh, w / np.float32(np.sqrt(K)), res]
    site_grads = []
    for ctx in ctxs:
        dev = ctx.torch_device
        ins = [torch.from_numpy(a).to(dev).requires_grad_() for a in site]
        out = fused_scale_relu_matmul(*ins)
        site_grads.append([g.cpu().numpy() for g in torch.autograd.grad(
            out, ins, torch.from_numpy(dy).to(dev))])
    site_worst = {}
    for name, a, b in zip(("dx", "dscale", "dshift", "dW", "dres"),
                          *site_grads):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        check(err <= cfg["site_rtol"] * scale, "resnet_nhwc_agreement: "
              "fused site %s differs by %g (largest CPU value %g)"
              % (name, err, scale))
        site_worst[name] = err / scale

    B, image = cfg["batch"], cfg["image_shape"]
    kw = {k: cfg[k] for k in ("num_classes", "num_layers", "image_shape")}
    np_args, np_aux = seeded_resnet_params(resnet.get_symbol(**kw), B, image)
    np_args = {n: _nhwc(a) for n, a in np_args.items()}
    x, y = _image_batches(image, B, SEED + 15, cfg["num_classes"])
    runs = []
    for ctx, scale in ((ctxs[0], 1.0), (ctxs[1], 1.0),
                       (ctxs[1], 1.0 + cfg["perturb"])):
        sym = fuse_conv_bn(resnet.get_symbol(layout="NHWC", **kw))
        ts = TrainStep(sym, mx.optimizer.SGD(learning_rate=0.05,
                                             momentum=0.9, wd=1e-4,
                                             rescale_grad=1.0 / B),
                       data_shapes={"data": (B,) + _nhwc(x).shape[1:]},
                       label_shapes={"softmax_label": (B,)}, ctx=ctx)
        ts.init_params(mx.init.Xavier(), arg_params=np_args,
                       aux_params=np_aux)
        prob = ts.step({"data": _nhwc(x) * np.float32(scale),
                        "softmax_label": y})[0].cpu().numpy()
        loss = float(-np.log(prob[np.arange(B), y.astype(int)]).mean())
        grad = np.concatenate([g.cpu().numpy().ravel()
                               for g in ts.grads.values()])
        runs.append((loss, prob, grad,
                     {n: a.cpu().numpy() for n, a in ts.auxs.items()}))
        del ts
    (gl, gp, gg, ga), (cl, cp, cg, ca), (_, _, pg, _) = runs
    check(abs(gl - cl) <= cfg["loss_rtol"] * abs(cl),
          "resnet_nhwc_agreement: loss %g on the card, %g on the CPU"
          % (gl, cl))
    check(np.allclose(gp, cp, rtol=0, atol=cfg["prob_atol"]),
          "resnet_nhwc_agreement: probabilities differ by %g"
          % float(np.abs(gp - cp).max()))
    worst_aux = 0.0
    for name, ref in ca.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(ga[name] - ref).max())
        check(err <= cfg["aux_rtol"] * scale, "resnet_nhwc_agreement: %s "
              "differs by %g after the train forward (largest CPU value %g)"
              % (name, err, scale))
        worst_aux = max(worst_aux, err / scale if scale else 0.0)
    norm = float(np.linalg.norm(cg))
    grad_l2 = float(np.linalg.norm(gg - cg)) / norm
    check(grad_l2 <= cfg["grad_l2"], "resnet_nhwc_agreement: the gradient "
          "differs by %g (relative L2) between the card and the CPU"
          % grad_l2)
    emit({"phase": "resnet_nhwc_agreement", "config": cfg,
          "fused_sites": count_fused(sym), "site_worst_rel_err": site_worst,
          "loss_card": gl, "loss_cpu": cl,
          "prob_max_abs_err": float(np.abs(gp - cp).max()),
          "worst_aux_rel_err": worst_aux, "grad_rel_l2_card_vs_cpu": grad_l2,
          "grad_rel_l2_cpu_vs_perturbed_cpu":
              float(np.linalg.norm(pg - cg)) / norm})


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels as mxk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_device(torch)
    phase_build()
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)     # 256 MB: well past the 50 MB L2
    serve_kernels = [phase_decode(torch, mxk, dev, flush),
                     phase_chunk(torch, mxk, dev, flush),
                     phase_layernorm(torch, mxk, dev, flush)]
    train_kernels = [phase_layernorm_bwd(torch, mxk, dev, flush)] + \
        phase_flash(torch, mxk, dev, flush)
    quant_kernel = phase_quant(torch, mxk, dev, flush)
    fused_kernel = phase_fused_matmul(torch, mxk, dev, flush)
    del flush
    full = seeded_params(FULL)
    serve_launches, serve_steps = phase_serve(torch, mx, full)
    phase_agreement(torch, mx)
    train_launches, train_steps = phase_train(torch, mx, full)
    del full
    phase_train_agreement(torch, mx)
    phase_kvstore(torch, mx)
    resnet_launches, resnet_steps = phase_train_resnet(torch, mx)
    phase_resnet_agreement(torch, mx)
    nhwc_launches, nhwc_steps = phase_train_resnet_nhwc(torch, mx)
    phase_resnet_nhwc_agreement(torch, mx)
    # launches: the count of each kernel's main-path run (serve for the
    # serving kernels, the transformer's Module.fit for its training
    # kernels, the 2-bit ResNet-50 fit for the quantizer, the fused NHWC
    # ResNet-50 TrainStep arm for the fused kernel); LayerNorm's forward
    # runs on both of the first two and carries the train count beside it
    for k in serve_kernels:
        k["launches"] = serve_launches[k["name"]]
        k["launches_per_step"] = serve_launches[k["name"]] / serve_steps
    serve_kernels[2]["train_launches"] = train_launches["layernorm_fused"]
    for k in train_kernels:
        k["launches"] = train_launches[k["name"]]
        k["launches_per_step"] = train_launches[k["name"]] / train_steps
    quant_kernel["launches"] = resnet_launches[quant_kernel["name"]]
    quant_kernel["launches_per_step"] = quant_kernel["launches"] / resnet_steps
    fused_kernel["launches"] = nhwc_launches[fused_kernel["name"]]
    fused_kernel["launches_per_step"] = fused_kernel["launches"] / nhwc_steps
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{**{key: k[key] for key in keys},
                       **{key: k[key] for key in ("launches_per_step",
                                                  "train_launches")
                          if key in k}}
                      for k in serve_kernels + train_kernels
                      + [quant_kernel, fused_kernel]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
