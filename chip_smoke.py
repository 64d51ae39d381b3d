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
   a step where the CPU's top-2 logit margin is inside that tolerance).

Then the kernels' JSON line, and last ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no
result; it also exits non-zero when no CUDA device is present.
TF32 is off for every matrix product.
"""
import json
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


def phase_serve(torch, mx):
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.weights import convert_params
    t0 = time.perf_counter()
    params = convert_params(seeded_params(FULL), mx.gpu(0), FULL)
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
    return launches


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
    kernels = [phase_decode(torch, mxk, dev, flush),
               phase_chunk(torch, mxk, dev, flush),
               phase_layernorm(torch, mxk, dev, flush)]
    del flush
    launches = phase_serve(torch, mx)
    phase_agreement(torch, mx)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: k[key] for key in keys} for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
