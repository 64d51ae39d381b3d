#!/usr/bin/env python3
"""Time variants of the bf16 fused GEMM (rows 7 and 10) on one GPU.

    python3 tools/torch_fused_tune.py [--diagnose]

Each variant is ``mxnet_tpu_torch/csrc/fused_gemm_bf16.cuh`` with a few
text substitutions of its tuning constants or its tile rule
(``VARIANTS``), written with copies of ``fused_matmul.cu`` and
``fused_band4d.cu`` into ``build/fused_tune/<variant>/`` and built by
``nvcc`` with the port's flags (``tc_mma.cuh`` from ``csrc/``), all
builds started together.  Every variant is held against the plain
versions (``chip_smoke.close_bf16``) at ResNet-50's 8 fused-site shapes
at batch 256 (``chip_smoke.FUSED_SHAPES``, M doubled), the fused
sandwich's two bands and the edge shapes of ``chip_smoke``, its row-7
and row-10 outputs on the same band bit for bit; then each shape is
timed with ``chip_smoke.time_ms`` (median of 60 launches, L2 flushed),
the variants in turns and then in reverse order.  Prints one JSON line
per variant: the ``ptxas`` registers and spill bytes of its 128 x 128
instances, the mean of its two times per shape, the 28-launch step sum
and the bands' mean; then the card's name and power limit.  Needs a
CUDA device; the variants go through the port's wrappers with each
wrapper's library swapped for the variant's.  ``--diagnose`` adds the
``DIAGNOSTICS`` variants, which leave out the products, the prologue,
W's copies or Y's stores: wrong by design (reported, not failed), they
show what each part of the work costs.
"""
import ctypes
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "mxnet_tpu_torch", "csrc")
HEADER = "fused_gemm_bf16.cuh"
ENTRIES = ("fused_matmul", "fused_band4d")
OUT = os.path.join(HERE, "build", "fused_tune")
TUNED = "kStep = 64, kStages = 3, kWarps = 8, kMinBlocks = 2"


def _consts(step, stages, warps, min_blocks):
    return (TUNED, "kStep = %d, kStages = %d, kWarps = %d, kMinBlocks = %d"
            % (step, stages, warps, min_blocks))


# name: [(text in the header, its replacement), ...]
VARIANTS = {
    "tuned": [],
    "step32_ring_of_4": [_consts(32, 4, 8, 2)],
    "step32_ring_of_3": [_consts(32, 3, 8, 2)],
    # every chunk loop walked one chunk at a time, and every one unrolled
    "chunks_one_by_one": [("kChunkUnroll = W_KN ? 1 :", "kChunkUnroll = true ? 1 :")],
    "chunks_unrolled": [("kChunkUnroll = W_KN ? 1 :", "kChunkUnroll = false ? 1 :")],
    "one_block_an_sm": [_consts(64, 3, 8, 1)],
    "64_columns": [("if (a.N <= 64)", "if (true)")],
    # unpadded shared-memory rows: the 8 rows of every ldmatrix land on
    # the same bank groups
    "no_padding": [("constexpr int kPad = 8; ", "constexpr int kPad = 0; "),
                   ("constexpr int kCPad = 8; ", "constexpr int kCPad = 0; ")],
    # the epilogue reads the residual from memory, not from L2
    "no_residual_prefetch": [("if (VEC_X && p.res && p.vec_y && ck == 0) {",
                              "if (false) {")],
}


_MMA = "for (int nt = 0; nt < C::kNT; ++nt) tc::mma(acc[mt][nt], a, b[nt][0], b[nt][1]);"
# --diagnose: variants that leave a part of the work out, so their
# outputs are wrong by design; each one's time says what that part costs
DIAGNOSTICS = {
    # ldmatrix kept, mma.sync replaced by an integer op on the fragments
    "no_products": [(_MMA, "for (int nt = 0; nt < C::kNT; ++nt) "
                     "acc[mt][nt][0] += __uint_as_float(a[0] ^ b[nt][0]);")],
    "no_prologue": [("    transform(0, sv);", "    (void)sv;"),
                    ("      transform(st + 1, sv);", "      (void)sv;")],
    "no_w_copies": [("        tc::cp_async16(dst, ok ? p.w + at : p.w, ok);", "")],
    "no_y_stores": [("      *reinterpret_cast<uint4*>(p.y + m * N + n) =",
                     "      if (K < 0) *reinterpret_cast<uint4*>(p.y + m * N + n) =")],
}


def build(names):
    """Start one nvcc per (variant, entry source), then wait for all;
    returns {name: {source: (library path, nvcc output)}}."""
    from mxnet_tpu_torch.kernels import _build
    with open(os.path.join(CSRC, HEADER)) as f:
        header = f.read()
    procs = {}
    for name in names:
        text = header
        for old, new in {**VARIANTS, **DIAGNOSTICS}[name]:
            if old not in text:
                raise SystemExit("variant %s: %r not in the header" % (name, old))
            text = text.replace(old, new)
        vdir = os.path.join(OUT, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, HEADER), "w") as f:
            f.write(text)
        for src in ENTRIES:
            path = os.path.join(vdir, src + ".cu")
            shutil.copyfile(os.path.join(CSRC, src + ".cu"), path)
            procs[name, src] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
                 path[:-3] + ".so", path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for (name, src), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("nvcc failed for variant %s (%s.cu):\n%s"
                             % (name, src, log[-3000:]))
        built.setdefault(name, {})[src] = (
            os.path.join(OUT, name, src + ".so"), log)
    return built


def ptxas(log, w_kn):
    """Registers and spill bytes of the 128 x 128 instances (X by
    cp.async and element by element)."""
    lines = log.splitlines()
    found = {}
    for vec in (1, 0):
        entry = "fused_gemm_bf16_kernelILi128ELb%dELb%dE" % (w_kn, vec)
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and entry in line:
                block = " ".join(lines[i + 1:i + 4])
                found["cp_async" if vec else "elementwise"] = {
                    "registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                    "spill_stores": int(re.search(r"(\d+) bytes spill stores", block).group(1)),
                    "spill_loads": int(re.search(r"(\d+) bytes spill loads", block).group(1))}
    return found


def load(paths):
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fm = ctypes.CDLL(paths["fused_matmul"])
    fm.mx_fused_scale_relu_matmul.argtypes = [p, p, p, p, p, p, i64, i64, i64, i, i, p]
    fm.mx_fused_scale_relu_matmul.restype = i
    fb = ctypes.CDLL(paths["fused_band4d"])
    fb.mx_fused_band4d.argtypes = [p, p, p, p, p] + [i64] * 9 + [i, i, p]
    fb.mx_fused_band4d.restype = i
    return {"fused_matmul": fm, "fused_band4d": fb}


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_tune: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mxnet_tpu_torch.tools import fused_sandwich as fs
    mods = {"fused_matmul": importlib.import_module("mxnet_tpu_torch.kernels.fused_matmul"),
            "fused_band4d": importlib.import_module("mxnet_tpu_torch.kernels.fused_band4d")}
    fm, fb = mods["fused_matmul"], mods["fused_band4d"]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    names = list(VARIANTS) + (list(DIAGNOSTICS) if "--diagnose" in sys.argv else [])
    built = build(names)
    libs = {name: load({s: v[0] for s, v in srcs.items()}) for name, srcs in built.items()}
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 41)

    def site(M, K, N, res):
        x = torch.randn(M, K, device=dev, generator=g).to(bf)
        sc = 1 + 0.2 * torch.randn(K, device=dev, generator=g)
        sh = 0.2 * torch.randn(K, device=dev, generator=g)
        w = (torch.randn(N, K, device=dev, generator=g) / K ** 0.5).to(bf)
        r = torch.randn(M, N, device=dev, generator=g).to(bf) if res else None
        return x, sc, sh, w, r

    sites = {(M * 2, K, N, r): n for (M, K, N, r), n in cs.FUSED_SHAPES.items()}
    # timed: (name, fn(mods)) for the 8 sites and the 2 bands
    timed, checks = [], []
    for shape in sites:
        args = site(*shape)
        timed.append(("site_%dx%dx%d" % shape[:3],
                      lambda args=args: fm.fused_scale_relu_matmul_fwd(*args)))
        checks.append(("site_%dx%dx%d" % shape[:3], lambda args=args: (
            fm.fused_scale_relu_matmul_fwd(*args), fm.fused_scale_relu_matmul_plain(*args))))
    for shape in [cs.FUSED_ODD] + [e[:4] for e in cs.FUSED_BF16_EDGES]:
        args = site(*shape)
        checks.append(("edge_%dx%dx%d" % shape[:3], lambda args=args: (
            fm.fused_scale_relu_matmul_fwd(*args), fm.fused_scale_relu_matmul_plain(*args))))
    bands = fs.band_shapes(fs.inputs(dev))
    for name, x, s, t, w in bands:
        timed.append(("band_" + name, lambda a=(x, s, t, w): fb.fused_band4d(*a)))
        checks.append(("band_" + name, lambda a=(x, s, t, w): (
            fb.fused_band4d(*a), fb.fused_band4d_plain(*a))))
    bad = {}
    for name, lib in libs.items():
        with mock.patch.object(fm, "_lib", lambda lib=lib: lib["fused_matmul"]), \
                mock.patch.object(fb, "_lib", lambda lib=lib: lib["fused_band4d"]):
            for what, fn in checks:
                got, ref = fn()
                again = fn()[0]
                torch.cuda.synchronize()
                if not (cs.close_bf16(torch, got, ref) and torch.equal(got, again)):
                    bad.setdefault(name, []).append(
                        "%s: max abs err %g" % (what, cs.max_err(got, ref)))
                del got, ref, again
            for bname, x, s, t, w in bands:
                k = x.shape[3]
                y4 = fb.fused_band4d(x, s, t, w)
                y2 = fm.fused_scale_relu_matmul_fwd(x.reshape(-1, k), s, t,
                                                    w.t().contiguous())
                if not torch.equal(y4.reshape(y2.shape), y2):
                    bad.setdefault(name, []).append("band %s: rows 7 and 10 "
                                                    "differ" % bname)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    times = {name: {} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name]
        with mock.patch.object(fm, "_lib", lambda lib=lib: lib["fused_matmul"]), \
                mock.patch.object(fb, "_lib", lambda lib=lib: lib["fused_band4d"]):
            for what, fn in timed:
                times[name].setdefault(what, []).append(cs.time_ms(torch, fn, flush))
    for name in libs:
        ms = {k: sum(v) / len(v) for k, v in times[name].items()}
        step = sum(ms["site_%dx%dx%d" % s[:3]] * n for s, n in sites.items())
        print(json.dumps({
            "variant": name, "diagnostic": name in DIAGNOSTICS,
            "ptxas": {src: ptxas(built[name][src][1], int(src == "fused_band4d"))
                      for src in ENTRIES},
            "agrees": name not in bad, "disagreements": bad.get(name, []),
            "step_ms_28_launches": step,
            "band_mean_ms": (ms["band_up"] + ms["band_down"]) / 2, "ms": ms}),
            flush=True)
    cs.phase_device(torch)
    return 1 if set(bad) - set(DIAGNOSTICS) else 0


if __name__ == "__main__":
    sys.exit(main())
