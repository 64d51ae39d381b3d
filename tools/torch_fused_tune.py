#!/usr/bin/env python3
"""Time variants of the fused GEMMs (rows 7 and 10) on one GPU.

    python3 tools/torch_fused_tune.py [--dtype bfloat16|float16|float32] [--diagnose]
    python3 tools/torch_fused_tune.py --dtype float32 [--diagnose] --only V ...

bf16 (the default) and float16: each variant is
``mxnet_tpu_torch/csrc/fused_gemm_bf16.cuh`` (the 16-bit GEMM, a
template over the element type; both types' instances are built from
every variant, the given type's are checked and timed) with a few text
substitutions of its tuning constants or its tile rule (``VARIANTS``),
written with copies of ``fused_matmul.cu`` and ``fused_band4d.cu`` into
``build/fused_tune/<variant>/`` and built by ``nvcc`` with the port's
flags (``tc_mma.cuh`` from ``csrc/``), all builds started together.
Every variant is held against the plain versions
(``chip_smoke.close_bf16``, in f16 ``chip_smoke.close_f16_fused``) at
ResNet-50's 8 fused-site shapes at batch
256 (``chip_smoke.FUSED_SHAPES``, M doubled), the fused sandwich's two
bands and the edge shapes of ``chip_smoke``, its row-7 and row-10
outputs on the same band bit for bit; then each shape is timed with
``chip_smoke.time_ms`` (median of 60 launches, L2 flushed), the variants
in turns and then in reverse order.  Prints one JSON line per variant:
the ``ptxas`` registers and spill bytes of its 128 x 128 instances of
the type, the
mean of its two times per shape, the 28-launch step sum and the bands'
mean; then the card's name and power limit.

float32: the variants are of ``csrc/fused_gemm_f32.cuh``, the split-TF32
GEMM of rows 7 and 10 in f32 (``F32_VARIANTS``: K step, ring stages,
blocks an SM, the k8 steps an mma chain sums, the tile rule and the
warps' layout), built with copies of ``fused_matmul.cu`` and
``fused_band4d.cu`` into ``build/fused_tune/float32/<variant>/``, held
against the plain versions at the card's f32 tolerance
(``chip_smoke.close``, two runs bit-identical) at ResNet-50's 8 site
shapes at batch 128, ``FUSED_ODD``, ``F32_EDGES``, the fused sandwich's
two bands in f32 (row 10 bit-equal to row 7 on the 2-D view) and
``BAND_F32_EDGES``, and timed at the 8 sites and the two bands.

Needs a CUDA device; the variants go through the port's wrappers with
each wrapper's library swapped for the variant's.  ``--diagnose`` adds
the ``DIAGNOSTICS`` (bf16) or ``F32_DIAGNOSTICS`` variants, which leave
out a part of the work (the products, the prologue, W's copies, Y's
stores; in f32 the split pass, the cross products): wrong by design
(reported, not failed), they show what each part costs.
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
# the f32 GEMM's constants line in fused_gemm_f32.cuh
HEADER_F32 = "fused_gemm_f32.cuh"
TUNED_F32 = "kStep = 32, kStages = 2, kMinBlocks = 1, kGroup = 4"
# f32 shapes past chip_smoke's: M off the row tile at K = 2048 and 512,
# N 36 (not a multiple of 4: Y element by element), x 4 bytes off
# 16-byte alignment; (M, K, N, residual, x's element offset)
F32_EDGES = ((6272 + 37, 512, 2048, True, 0), (6272 + 37, 2048, 512, False, 0),
             (1000, 72, 36, True, 0), (4096, 256, 128, True, 1))
# row 10 in f32 past the sandwich's bands: chip_smoke's odd shape and the
# bf16 GEMM's edges (M off the row tile, K 72 with N 64, N 60); (B, H,
# W, K, N)
BAND_F32_EDGES = ((3, 7, 9, 37, 93), (64, 29, 29, 64, 256), (3, 13, 17, 72, 64),
                  (2, 9, 11, 64, 60))


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


def _consts_f32(step, stages, min_blocks, group):
    return (TUNED_F32, "kStep = %d, kStages = %d, kMinBlocks = %d, kGroup = %d"
            % (step, stages, min_blocks, group))


_WARPS8 = ("constexpr int kWarps = 16, kBM = 128;", "constexpr int kWarps = 8, kBM = 128;")
_TILE_RULE = "  if (a.N <= 64 || (a.M + kBM - 1) / kBM * ((a.N + 127) / 128) < 2 * kSMs)\n"
# 16 warps as 4 x 4 on a 128 x 128 tile (32 x 32 warp tiles) instead of
# 2 x 8 (64 x 16)
_WARPS4X4 = ("kWarpsM = kBM > BN ? kWarps / 2 : 2;", "kWarpsM = kBM > BN ? kWarps / 2 : 4;")
F32_VARIANTS = {
    "tuned": [],
    "ring_of_3": [_consts_f32(32, 3, 1, 4)],
    "group_2": [_consts_f32(32, 2, 1, 2)],
    # 128 x 128 tiles whenever N > 64, however few
    "wide_tiles": [(_TILE_RULE, "  if (a.N <= 64)\n")],
    # 128 x 64 tiles always
    "narrow_tiles": [(_TILE_RULE, "  if (true)\n")],
    "warps_4x4": [_WARPS4X4],
    "warps_4x4_group_2": [_WARPS4X4, _consts_f32(32, 2, 1, 2)],
    # two 8-warp blocks an SM on 128 x 64 tiles (32 x 32 warp tiles,
    # chains of 2 k8 steps): one block's ring fill and epilogue overlap
    # the other's products
    "eight_warps_two_blocks_narrow": [_WARPS8, _consts_f32(32, 2, 2, 2),
                                      (_TILE_RULE, "  if (true)\n")],
    # 8-warp blocks (64 x 32 warp tiles): one an SM, and two an SM with
    # 16-column stages, a ring of 2 and chains of one k8 step (spills)
    "eight_warps": [_WARPS8],
    "eight_warps_step16": [_WARPS8, _consts_f32(16, 3, 1, 2)],
    "eight_warps_two_blocks": [_WARPS8, _consts_f32(16, 2, 2, 1)],
}
_MMA3 = ("              tc::mma3(c[nt], ah[kk], al[kk], bh[nt][kk][0], bh[nt][kk][1], "
         "bl[nt][kk][0],\n                       bl[nt][kk][1]);")
F32_DIAGNOSTICS = {
    # one TF32 product a step (the two cross terms dropped)
    "one_product": [(_MMA3, "              tc::mma_tf32(c[nt], ah[kk], bh[nt][kk][0], "
                     "bh[nt][kk][1]);")],
    # the split and the prologue of the landed tiles left out
    "no_split_pass": [("    if (st + 1 < nst) transform(st + 1, sv);",
                       "    (void)sv;")],
    # mma.sync left out (ldmatrix kept)
    "no_products": [(_MMA3, "              c[nt][0] += __uint_as_float(ah[kk][0] ^ bh[nt][kk][0]);")],
}


_MMA = "for (int nt = 0; nt < C::kNT; ++nt) E::mma(acc[mt][nt], a, b[nt][0], b[nt][1]);"
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


def build(names, f32=False):
    """Start one nvcc per (variant, entry source), then wait for all;
    returns {name: {source: (library path, nvcc output)}}."""
    from mxnet_tpu_torch.kernels import _build
    header_name = HEADER_F32 if f32 else HEADER
    table = {**F32_VARIANTS, **F32_DIAGNOSTICS} if f32 else {**VARIANTS, **DIAGNOSTICS}
    entries = ENTRIES
    with open(os.path.join(CSRC, header_name)) as f:
        header = f.read()
    procs = {}
    for name in names:
        text = header
        for old, new in table[name]:
            if old not in text:
                raise SystemExit("variant %s: %r not in the header" % (name, old))
            text = text.replace(old, new)
        vdir = os.path.join(OUT, "float32", name) if f32 else os.path.join(OUT, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, header_name), "w") as f:
            f.write(text)
        # the f32 header includes the 16-bit one: both from the variant's
        # directory, so the edited header is the only one compiled
        other = HEADER if f32 else HEADER_F32
        shutil.copyfile(os.path.join(CSRC, other), os.path.join(vdir, other))
        for src in entries:
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
        built.setdefault(name, {})[src] = (path_of(name, src, f32), log)
    return built


def path_of(name, src, f32):
    vdir = os.path.join(OUT, "float32", name) if f32 else os.path.join(OUT, name)
    return os.path.join(vdir, src + ".so")


def ptxas(log, w_kn, f32=False, dtype="bfloat16"):
    """Registers and spill bytes of the instances (128 x 128 and, in f32,
    128 x 64 tiles; X by cp.async and element by element; the 16-bit
    GEMM's of ``dtype``)."""
    lines = log.splitlines()
    found = {}
    for bn in (128, 64) if f32 else (128,):
        for vec in (1, 0):
            entry = ("fused_gemm_f32_kernelILi%dELb%dELb%dE" % (bn, w_kn, vec)
                     if f32 else "fused_gemm16_kernelI%sLi%dELb%dELb%dE" % (
                         {"bfloat16": "13__nv_bfloat16", "float16": "6__half"}[dtype],
                         bn, w_kn, vec))
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and entry in line:
                    block = " ".join(lines[i + 1:i + 4])
                    key = "cp_async" if vec else "elementwise"
                    found[key if bn == 128 else "%s_128x64" % key] = {
                        "registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                        "spill_stores": int(re.search(r"(\d+) bytes spill stores", block).group(1)),
                        "spill_loads": int(re.search(r"(\d+) bytes spill loads", block).group(1))}
    return found


def load(paths):
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fm = ctypes.CDLL(paths["fused_matmul"])
    fm.mx_fused_scale_relu_matmul.argtypes = [p, p, p, p, p, p, i64, i64, i64, i, i, p]
    fm.mx_fused_scale_relu_matmul.restype = i
    if paths["fused_band4d"] is None:
        return {"fused_matmul": fm}
    fb = ctypes.CDLL(paths["fused_band4d"])
    fb.mx_fused_band4d.argtypes = [p, p, p, p, p] + [i64] * 9 + [i, i, p]
    fb.mx_fused_band4d.restype = i
    return {"fused_matmul": fm, "fused_band4d": fb}


def main_f32(torch, cs, fm, fb, diagnose, only=None):
    """The f32 GEMM's variants: checked at the sites, FUSED_ODD,
    F32_EDGES, the bands and BAND_F32_EDGES, timed at the 8 sites of a
    batch-128 step and the sandwich's two bands in f32.  ``only``: these
    variants (and tuned), given last on the command line."""
    from mxnet_tpu_torch.tools import fused_sandwich as fs
    dev = torch.device("cuda", 0)
    names = list(F32_VARIANTS) + (list(F32_DIAGNOSTICS) if diagnose else [])
    if only:
        unknown = set(only) - set(names)
        if unknown:
            raise SystemExit("unknown variants: %s" % sorted(unknown))
        names = [n for n in names if n == "tuned" or n in only]
    built = build(names, f32=True)
    libs = {name: load({src: v[src][0] for src in ENTRIES}) for name, v in built.items()}
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 43)

    def site(M, K, N, res, off=0):
        x = torch.randn(M * K + off, device=dev, generator=g)[off:].view(M, K)
        sc = 1 + 0.2 * torch.randn(K, device=dev, generator=g)
        sh = 0.2 * torch.randn(K, device=dev, generator=g)
        w = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
        r = torch.randn(M, N, device=dev, generator=g) if res else None
        return x, sc, sh, w, r

    def row7(*args):
        return fm.fused_scale_relu_matmul_fwd(*args), fm.fused_scale_relu_matmul_plain(*args)

    def row10(*args):
        return fb.fused_band4d(*args), fb.fused_band4d_plain(*args)

    timed, checks = [], []
    for shape in cs.FUSED_SHAPES:
        args = site(*shape)
        timed.append(("site_%dx%dx%d" % shape[:3],
                      lambda args=args: fm.fused_scale_relu_matmul_fwd(*args)))
        checks.append(("site_%dx%dx%d" % shape[:3], row7, args))
    for shape in [cs.FUSED_ODD] + list(F32_EDGES):
        checks.append(("edge_%dx%dx%d" % shape[:3], row7, site(*shape)))
    bands = fs.band_shapes(fs.inputs(dev, torch.float32))
    for name, x, s, t, w in bands:
        timed.append(("band_" + name, lambda a=(x, s, t, w): fb.fused_band4d(*a)))
        checks.append(("band_" + name, row10, (x, s, t, w)))
    for shape in BAND_F32_EDGES:
        checks.append(("band_edge_%s" % "x".join(map(str, shape)), row10,
                       cs._band_case(torch, g, dev, *shape, torch.float32)))
    x, s, t, w = checks[-1][2]
    checks.append(("band_nchw_view", row10, (x.permute(0, 3, 1, 2).contiguous()
                                             .permute(0, 2, 3, 1), s, t, w)))
    bad, failed = {}, {}
    for name, lib in libs.items():
        with mock.patch.object(fm, "_lib", lambda lib=lib: lib["fused_matmul"]), \
                mock.patch.object(fb, "_lib", lambda lib=lib: lib["fused_band4d"]):
            for what, pair, args in checks:
                try:
                    got, ref = pair(*args)
                    again = pair(*args)[0]
                except Exception as e:     # a variant the card refuses: reported
                    failed[name] = "%s: %s" % (what, e)
                    break
                torch.cuda.synchronize()
                if not (cs.close(torch, got, ref) and torch.equal(got, again)):
                    bad.setdefault(name, []).append(
                        "%s: max abs err %g" % (what, cs.max_err(got, ref)))
                del got, ref, again
            if name not in failed:
                for bname, x, s, t, w in bands:
                    k = x.shape[3]
                    y4 = fb.fused_band4d(x, s, t, w)
                    y2 = fm.fused_scale_relu_matmul_fwd(x.reshape(-1, k).contiguous(), s, t,
                                                        w.t().contiguous())
                    if not torch.equal(y4.reshape(y2.shape), y2):
                        bad.setdefault(name, []).append("band %s: rows 7 and 10 "
                                                        "differ" % bname)
    for name, why in failed.items():
        print(json.dumps({"variant": name, "dtype": "float32", "launch_failed": why}),
              flush=True)
        bad.setdefault(name, []).append(why)
        del libs[name]
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    times = {name: {} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        with mock.patch.object(fm, "_lib", lambda lib=libs[name]: lib["fused_matmul"]), \
                mock.patch.object(fb, "_lib", lambda lib=libs[name]: lib["fused_band4d"]):
            for what, fn in timed:
                times[name].setdefault(what, []).append(cs.time_ms(torch, fn, flush))
    for name in libs:
        ms = {k: sum(v) / len(v) for k, v in times[name].items()}
        step = sum(ms["site_%dx%dx%d" % s[:3]] * n for s, n in cs.FUSED_SHAPES.items())
        print(json.dumps({
            "variant": name, "dtype": "float32", "diagnostic": name in F32_DIAGNOSTICS,
            "ptxas": {src: ptxas(built[name][src][1], int(src == "fused_band4d"), f32=True)
                      for src in ENTRIES},
            "agrees": name not in bad, "disagreements": bad.get(name, []),
            "step_ms_28_launches": step, "mean_ms": step / sum(cs.FUSED_SHAPES.values()),
            "band_mean_ms": (ms["band_up"] + ms["band_down"]) / 2, "ms": ms}), flush=True)
    cs.phase_device(torch)
    return 1 if set(bad) - set(F32_DIAGNOSTICS) else 0


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
    if "--dtype" in sys.argv and sys.argv[sys.argv.index("--dtype") + 1] == "float32":
        only = sys.argv[sys.argv.index("--only") + 1:] if "--only" in sys.argv else None
        return main_f32(torch, cs, fm, fb, "--diagnose" in sys.argv, only)
    dev = torch.device("cuda", 0)
    dtype = sys.argv[sys.argv.index("--dtype") + 1] if "--dtype" in sys.argv else "bfloat16"
    bf = getattr(torch, dtype)
    near = cs.close_f16_fused if dtype == "float16" else cs.close_bf16
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
    bands = fs.band_shapes(fs.inputs(dev, bf))
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
                if not (near(torch, got, ref) and torch.equal(got, again)):
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
            "variant": name, "dtype": dtype, "diagnostic": name in DIAGNOSTICS,
            "ptxas": {src: ptxas(built[name][src][1], int(src == "fused_band4d"),
                                 dtype=dtype) for src in ENTRIES},
            "agrees": name not in bad, "disagreements": bad.get(name, []),
            "step_ms_28_launches": step,
            "band_mean_ms": (ms["band_up"] + ms["band_down"]) / 2, "ms": ms}),
            flush=True)
    cs.phase_device(torch)
    return 1 if set(bad) - set(DIAGNOSTICS) else 0


if __name__ == "__main__":
    sys.exit(main())
