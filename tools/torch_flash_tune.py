#!/usr/bin/env python3
"""Time variants of the flash-attention kernels on one GPU.

    python3 tools/torch_flash_tune.py [--dtype float32|bfloat16] [--only V ...]

Each variant is ``mxnet_tpu_torch/csrc/flash_attention.cu`` and
``attention_f32.cuh`` with a few text substitutions of their tuning
constants or code (``F32_VARIANTS`` for the f32 kernels, the split-TF32
tensor-core kernels of ``attention_f32.cuh``; ``BF16_VARIANTS`` for the
bf16 ones), written into ``build/flash_tune/<dtype>/<variant>/`` and
built by ``nvcc`` with the port's flags (``-I`` the source directory
for ``tc_mma.cuh``), all builds started together.  Every variant's
three kernels are held against their plain versions at the training
shape (4, 16, 1024, 128) and a ragged one (2, 4, 1000, 36): f32 at
rtol 1e-4 / atol 1e-5 (``chip_smoke.close``), bf16 with
``chip_smoke.close_bf16`` (lse at the f32 bound); then timed at the
training shape with ``chip_smoke.time_ms`` (median of 60 launches, L2
flushed), the variants in turns and then in reverse order.  The
``DIAGNOSE`` variants take work out (the split pass over each landed
tile, the split of the A fragments, the two cross products of each
split-TF32 step) to show what it costs: they are timed, and expected to
disagree.  Prints one JSON line per
variant: its ``ptxas`` registers and spill bytes per kernel and the
mean of its two times per kernel, then the card's name and power limit.
Needs a CUDA device; the variants go through the port's wrappers with
the wrapper's library swapped for the variant's.
"""
import argparse
import ctypes
import importlib
import json
import os
import re
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "mxnet_tpu_torch", "csrc")
FILES = ("flash_attention.cu", "attention_f32.cuh")
OUT = os.path.join(HERE, "build", "flash_tune")
TUNED = dict(fwd="kFwdWarps = 4, kFwdMinBlocks = 3, kFwdStep = 64, kFwdStages = 2",
             dkv="kDkvWarps = 4, kDkvMinBlocks = 1, kDkvStep = 32, kDkvStages = 2",
             dq="kDqWarps = 4, kDqMinBlocks = 1, kDqStep = 64, kDqStages = 2")
# the f32 kernels' constants, in attention_f32.cuh
TUNED_F32 = dict(fwd="kFwdWarps = 4, kFwdMinBlocks = 2, kFwdStep = 32, kFwdStages = 2",
                 dkv="kDkvWarps = 8, kDkvWideWarps = 4, kDkvStep = 16, kDkvStages = 2",
                 dq="kDqWarps = 8, kDqWideWarps = 4, kDqStep = 16, kDqStages = 2")


def _sizes(kernel, warps, min_blocks, step, stages, tuned=TUNED):
    prefix = dict(fwd="kFwd", dkv="kDkv", dq="kDq")[kernel]
    return (tuned[kernel], "%sWarps = %d, %sMinBlocks = %d, %sStep = %d, %sStages = %d"
            % (prefix, warps, prefix, min_blocks, prefix, step, prefix, stages))


def _f32(kernel, warps, second, step, stages):
    """f32 constants: warps, then blocks an SM (forward) or the warps at
    D > 128 (dK/dV, dQ), step rows, ring stages."""
    prefix = dict(fwd="kFwd", dkv="kDkv", dq="kDq")[kernel]
    return (TUNED_F32[kernel], "%sWarps = %d, %s = %d, %sStep = %d, %sStages = %d"
            % (prefix, warps, prefix + ("MinBlocks" if kernel == "fwd" else "WideWarps"),
               second, prefix, step, prefix, stages))


# name: [(text in a source, its replacement[, "all"]), ...]: the first
# occurrence in the one file that has it, or every one with "all"
BF16_VARIANTS = {
    "tuned": [],
    # the product loops with a branch per 16-column step (the form that
    # runs when D % 128 != 0) at D = 128 too
    "ragged_loops": [("const auto kernel = D % kDC == 0 ? tc::",
                      "const auto kernel = false ? tc::")] * 3,
    "fwd_4_blocks": [_sizes("fwd", 4, 4, 64, 2)],
    "8_warps": [_sizes("fwd", 8, 2, 64, 2), _sizes("dkv", 8, 1, 32, 2),
                _sizes("dq", 8, 1, 64, 2)],
    "32_row_steps": [_sizes("fwd", 4, 3, 32, 2), _sizes("dq", 4, 1, 32, 2)],
    "ring_of_3": [_sizes("fwd", 4, 3, 64, 3), _sizes("dkv", 4, 1, 32, 3),
                  _sizes("dq", 4, 1, 64, 3)],
    "32_row_steps_ring_of_4": [_sizes("fwd", 4, 4, 32, 4), _sizes("dkv", 4, 1, 32, 4),
                               _sizes("dq", 4, 2, 32, 4)],
    # blocks ordered tile-major (x = tile, y = batch * head); "all":
    # every occurrence in the file (the f32 kernels' too, not timed here)
    "tile_major_grid": [
        ("(int)blockIdx.y;          // longest rows first",
         "(int)blockIdx.x;          // longest rows first", "all"),
        ("const size_t bh = blockIdx.x;", "const size_t bh = blockIdx.y;", "all"),
        ("const int kt = blockIdx.y;", "const int kt = blockIdx.x;", "all"),
        ("\ndim3 grid_of(int BH, int S, int D, int warps) {\n"
         "  return dim3(BH, (S + 16 * warps - 1) / (16 * warps), (D + kDC - 1) / kDC);",
         "\ndim3 grid_of(int BH, int S, int D, int warps) {\n"
         "  return dim3((S + 16 * warps - 1) / (16 * warps), BH, (D + kDC - 1) / kDC);")],
}
F32_VARIANTS = {
    "tuned": [],
    "ragged_loops": [("const auto kernel = D % kDC == 0 ? attn32::",
                      "const auto kernel = false ? attn32::"),
                     ("(D % kDC == 0 ? full_narrow", "(false ? full_narrow")],
    "fwd_64_steps": [_f32("fwd", 4, 1, 64, 2)],
    "fwd_3_blocks": [_f32("fwd", 4, 3, 32, 2)],
    "fwd_ring_of_3": [_f32("fwd", 4, 1, 32, 3)],
    "dkv_4_warps": [_f32("dkv", 4, 4, 16, 2)],
    "dkv_4_warps_32_steps": [_f32("dkv", 4, 4, 32, 2)],
    "dq_4_warps": [_f32("dq", 4, 4, 16, 2)],
    "dq_4_warps_32_steps": [_f32("dq", 4, 4, 32, 2)],
    # B split at every fragment load (the tiles stay f32 as copied; the
    # same layout and shared memory): what storing the split saves
    "b_split_per_load": [
        ("void split_tile(float* t, float* lo, int w, bool vec) {\n",
         "void split_tile(float* t, float* lo, int w, bool vec) {\n  return;\n"),
        ("tc::ldsm_x4(fh, b + bo + np * 16 * kLd + kk * 8);\n"
         "            tc::ldsm_x4(fl, b_lo + bo + np * 16 * kLd + kk * 8);",
         "uint32_t f[4];\n            tc::ldsm_x4(f, b + bo + np * 16 * kLd + kk * 8);\n"
         "            for (int i = 0; i < 4; ++i) split(__uint_as_float(f[i]), fh[i], fl[i]);"),
        ("template <int KT, bool kSplitB = false>", "template <int KT, bool kSplitB = true>")],
    # the forward's V split as it lands, as K is (instead of at each load)
    "fwd_v_stored": [
        ("if (j < nch) split_tile<KT, TH>(tile, tile + kKSlot, min(kDC, D - j * kDC), vec);",
         "split_tile<KT, TH>(tile, tile + kKSlot, j < nch ? min(kDC, D - j * kDC) : ow, vec);"),
        ("mma_kn<KT / 8, true>(acc, s, tile, nullptr,", "mma_kn<KT / 8>(acc, s, tile, tile + kKSlot,")],
    # the split by cvt.rna.tf32.f32 for hi and lo (the conversion pipe)
    # instead of an integer round of hi and a truncated lo
    "cvt_split": [
        ("return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         "uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n  return r;"),
        ("lo = __float_as_uint(x - __uint_as_float(hi));",
         "lo = tf32_rna(x - __uint_as_float(hi));"),
        ("lo = x - hi;", "lo = __uint_as_float(tf32_rna(x - hi));")],
    # mma chains of 8 k steps, and of a whole 128-column chunk (16)
    "group_8": [("constexpr int kGroup = 4;", "constexpr int kGroup = 8;")],
    "group_16": [("constexpr int kGroup = 4;", "constexpr int kGroup = 16;")],
}
# take work out to see what it costs (results wrong by design)
DIAGNOSE = {
    # the split pass over each landed tile left out (hi = the f32 value,
    # lo = whatever the tile held)
    "no_split_pass": [("void split_tile(float* t, float* lo, int w, bool vec) {\n",
                       "void split_tile(float* t, float* lo, int w, bool vec) {\n  return;\n")],
    # the A fragments (Q, K, dO, V) used unsplit
    "no_a_split": [("for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ah[i], al[i]);",
                    "for (int i = 0; i < 4; ++i) ah[i] = a[i], al[i] = 0u;")],
    # one TF32 product a step (the two cross terms dropped)
    "one_product": [("  tc::mma_tf32(c, al, bh0, bh1);\n  tc::mma_tf32(c, ah, bl0, bl1);\n",
                     "")],
}
ENTRIES = {"bfloat16": {"flash_attention_fwd": "flash_fwd_bf16_kernelILb1",
                        "flash_attention_bwd_dkv": "flash_bwd_dkv_bf16_kernelILb1",
                        "flash_attention_bwd_dq": "flash_bwd_dq_bf16_kernelILb1"},
           "float32": {"flash_attention_fwd": "flash_fwd_f32_kernelILb1E",
                       "flash_attention_bwd_dkv": "flash_bwd_dkv_f32_kernelILb1E",
                       "flash_attention_bwd_dq": "flash_bwd_dq_f32_kernelILb1E"}}
CHECK_SHAPES = ((4, 16, 1024, 128), (2, 4, 1000, 36))


def build(variants, dtype):
    """Start one nvcc per variant, then wait for all; returns {name:
    (library path, nvcc output)}."""
    from mxnet_tpu_torch.kernels import _build
    texts = {}
    for name in FILES:
        with open(os.path.join(CSRC, name)) as f:
            texts[name] = f.read()
    procs = {}
    for name, subs in variants.items():
        files = dict(texts)
        for old, new, *every in subs:
            where = [n for n in FILES if old in files[n]]
            if len(where) != 1:
                raise SystemExit("variant %s: %r in %d of the sources, not 1"
                                 % (name, old, len(where)))
            files[where[0]] = files[where[0]].replace(old, new, -1 if every else 1)
        out = os.path.join(OUT, dtype, name)
        os.makedirs(out, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(out, fname), "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(out, "lib.so"), os.path.join(out, FILES[0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("nvcc failed for variant %s:\n%s" % (name, log[-3000:]))
        built[name] = (os.path.join(OUT, dtype, name, "lib.so"), log)
    return built


def ptxas(log, dtype):
    """{kernel: {instance: {registers, spill_stores, spill_loads}}} of the
    D % 128 == 0 instantiations (the f32 backward kernels have one per
    warp count)."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        for kernel, entry in ENTRIES[dtype].items():
            if "Compiling entry function" in line and entry in line:
                block = " ".join(lines[i + 1:i + 4])
                inst = re.search(entry + r"\w*?E(?=E)", line)
                found.setdefault(kernel, {})[inst.group(0) if inst else entry] = {
                    "registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                    "spill_stores": int(re.search(r"(\d+) bytes spill stores", block).group(1)),
                    "spill_loads": int(re.search(r"(\d+) bytes spill loads", block).group(1))}
    return found


def load(path):
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mx_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, f, i, i, p]
    lib.mx_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, i, i, p]
    lib.mx_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, f, i, i, p]
    for fn in (lib.mx_flash_fwd, lib.mx_flash_bwd_dkv, lib.mx_flash_bwd_dq):
        fn.restype = i
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--only", nargs="+", metavar="VARIANT",
                    help="these variants (and tuned) only")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_tune: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    fa = importlib.import_module("mxnet_tpu_torch.kernels.flash_attention")
    dev = torch.device("cuda", 0)
    dt = getattr(torch, args.dtype)
    variants = dict(F32_VARIANTS, **DIAGNOSE) if dt == torch.float32 else BF16_VARIANTS
    if args.only:
        unknown = set(args.only) - set(variants)
        if unknown:
            raise SystemExit("unknown variants: %s" % sorted(unknown))
        variants = {n: v for n, v in variants.items() if n == "tuned" or n in args.only}
    built = build(variants, args.dtype)
    libs = {name: load(path) for name, (path, _) in built.items()}
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 31)
    cases = [[torch.randn(*shape, generator=g).to(dev).to(dt) for _ in range(4)]
             for shape in CHECK_SHAPES]
    bad = {}
    for name, lib in libs.items():
        with mock.patch.object(fa, "_lib", lambda lib=lib: lib):
            for shape, ins in zip(CHECK_SHAPES, cases):
                for what, a, b in cs._flash_pairs(torch, fa, *ins,
                                                       1.0 / shape[-1] ** 0.5):
                    ok = cs.close(torch, a, b) if what == "lse" or dt == torch.float32 \
                        else cs.close_bf16(torch, a, b)
                    if not ok:
                        bad.setdefault(name, []).append(
                            "%s at %s: max abs err %g" % (what, shape, cs.max_err(a, b)))
    q, k, v, do = cases[0]
    sc = 1.0 / q.shape[-1] ** 0.5
    o, lse = fa.flash_attention_fwd_plain(q, k, v, scale=sc)
    delta = (do.float() * o.float()).sum(-1)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        with mock.patch.object(fa, "_lib", lambda lib=libs[name]: lib):
            times[name].append((
                cs.time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale=sc), flush),
                cs.time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, scale=sc), flush),
                cs.time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, scale=sc), flush)))
    for name in libs:
        ms = [sum(t[i] for t in times[name]) / len(times[name]) for i in range(3)]
        print(json.dumps({"variant": name, "dtype": args.dtype,
                          "substitutions": len(variants[name]),
                          "diagnostic": name in DIAGNOSE,
                          "ptxas": ptxas(built[name][1], args.dtype),
                          "agrees": name not in bad,
                          "disagreements": bad.get(name, []),
                          "ms": dict(zip(ENTRIES[args.dtype], ms)),
                          "shape": list(q.shape)}), flush=True)
    cs.phase_device(torch)
    return 1 if set(bad) - set(DIAGNOSE) else 0


if __name__ == "__main__":
    sys.exit(main())
