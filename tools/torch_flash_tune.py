#!/usr/bin/env python3
"""Time variants of the flash-attention kernels on one GPU.

    python3 tools/torch_flash_tune.py [--dtype float32|bfloat16] [--only V ...]
    python3 tools/torch_flash_tune.py --chunk [--only V ...]
    python3 tools/torch_flash_tune.py --decode [--only V ...]
    python3 tools/torch_flash_tune.py --paged-bf16 [--only V ...]

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

``--chunk`` tunes row 2's chunked prefill instead
(``csrc/paged_attention.cu``): its ``CHUNK_VARIANTS`` (ring depth, and
``CHUNK_DIAGNOSE`` variants that leave out the combine or the attention)
are built the same way, each held against the plain version at the
mixed step's chunk and the spec step's spans (``chip_smoke``'s shapes,
f32, rtol 1e-4 / atol 1e-5, caches exact), spans over the short
contexts of ``chip_smoke``'s serve_spec phase and an empty chunk, and
timed there, each alone (``chip_smoke.time_ms``) and over 100 calls
launched back to back ("pipelined", as a serving step runs them); the tuned
library is also run at every key range of ``CHUNK_RANGES`` (the launch
plan's ``key_range``, patched: no rebuild), so the plan's choice can be
read against the others.

``--decode`` tunes row 1's paged decode (``csrc/paged_attention.cu``):
its ``DECODE_VARIANTS`` (keys a warp takes a step, warps a block) and
``DECODE_DIAGNOSE`` variants (return at entry; no key step) are built
the same way and run through the plan (``decode_plan``); the tuned
library is also run at every cluster size of ``DECODE_RANGES`` (the
plan's ``ranges``, patched: no rebuild).  Each arm is held against the
plain version (f32, rtol 1e-4 / atol 1e-5) and timed at
``chip_smoke``'s served shape over long contexts (positions 20-731) and
serve's short ones (20-145), and over one slot: alone
(``chip_smoke.time_ms``), alone after a flush that reads instead of
writing (``:clean``: no dirty L2 lines to write back first), and over
200 calls back to back (``chip_smoke.pipelined_ms``), in turns and then
in reverse order.

``--paged-bf16`` tunes the bf16 instances (bf16 q/k/v over bf16 caches)
of rows 5 and 2, the tile of ``csrc/attention_bf16.cuh``: its
``PAGED_BF16_VARIANTS`` (blocks an SM, key steps and ring depth of the
one-shot prefill, and ``one_term_p``, P V on P rounded to one bf16 term,
FlashAttention's rounding, as a design variant beside the kept hi + lo
split) are built the same way, each held against the plain versions
(``chip_smoke.close_bf16_out``, caches exact) and timed at
``chip_smoke``'s served prefill (8 x 1024, 16 heads of 128), the mixed
step's chunk and the spec step's spans, alone and back to back, in turns
and then in reverse order; each line carries the variant's largest
error against the plain version and its relative L2 error, so the
one-term P's cost in accuracy reads beside its time.
"""
import argparse
import contextlib
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
FILES = ("flash_attention.cu", "attention_f32.cuh", "tc_mma.cuh")
CHUNK_FILES = ("paged_attention.cu", "attention_f32.cuh", "tc_mma.cuh")
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
    "one_product": [("  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n",
                     "")],
}
# row 2's chunked prefill (paged_attention.cu)
CHUNK_VARIANTS = {
    "tuned": [],
    "ring_of_3": [("kChunkStages = 2;", "kChunkStages = 3;")],
    "16_key_stages": [("kChunkStep = 32,", "kChunkStep = 16,")],
    # mma_nk issues each term across its n8 tiles before the next term
    # (independent mma back to back; the same sums in the same order)
    "interleaved_nk": [(
        "#pragma unroll\n          for (int np = 0; np < NT / 2; ++np) {\n"
        "            uint32_t fh[4], fl[4];\n"
        "            tc::ldsm_x4(fh, b + bo + np * 16 * kLd + kk * 8);\n"
        "            tc::ldsm_x4(fl, b_lo + bo + np * 16 * kLd + kk * 8);\n"
        "            mma3(c[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);\n"
        "            mma3(c[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);\n"
        "          }",
        "uint32_t fh[NT / 2][4], fl[NT / 2][4];\n#pragma unroll\n"
        "          for (int np = 0; np < NT / 2; ++np) {\n"
        "            tc::ldsm_x4(fh[np], b + bo + np * 16 * kLd + kk * 8);\n"
        "            tc::ldsm_x4(fl[np], b_lo + bo + np * 16 * kLd + kk * 8);\n"
        "          }\n#pragma unroll\n          for (int np = 0; np < NT / 2; ++np) {\n"
        "            tc::mma_tf32(c[2 * np], al, fh[np][0], fh[np][1]);\n"
        "            tc::mma_tf32(c[2 * np + 1], al, fh[np][2], fh[np][3]);\n          }\n"
        "#pragma unroll\n          for (int np = 0; np < NT / 2; ++np) {\n"
        "            tc::mma_tf32(c[2 * np], ah, fl[np][0], fl[np][1]);\n"
        "            tc::mma_tf32(c[2 * np + 1], ah, fl[np][2], fl[np][3]);\n          }\n"
        "#pragma unroll\n          for (int np = 0; np < NT / 2; ++np) {\n"
        "            tc::mma_tf32(c[2 * np], ah, fh[np][0], fh[np][1]);\n"
        "            tc::mma_tf32(c[2 * np + 1], ah, fh[np][2], fh[np][3]);\n          }")],
    # the shared-memory attribute set once per kernel, not at every launch
    "smem_once": [("  cudaError_t err = cudaFuncSetAttribute(\n"
                   "      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\n"
                   "  if (err != cudaSuccess) return (int)err;",
                   "  static const void* allowed[16];\n  static int nallowed = 0;\n"
                   "  bool known = false;\n"
                   "  for (int i = 0; i < nallowed; ++i) known |= allowed[i] == (const void*)fn;\n"
                   "  cudaError_t err = cudaSuccess;\n  if (!known) {\n"
                   "    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, "
                   "232448);\n    if (err != cudaSuccess) return (int)err;\n"
                   "    if (nallowed < 16) allowed[nallowed++] = (const void*)fn;\n  }", "all")],
}
CHUNK_DIAGNOSE = {
    # the first kernel alone (the combine and its scatter not launched)
    "no_combine": [("  paged_chunk_combine_kernel<TQ, TKV><<<",
                    "  if (K < 0) paged_chunk_combine_kernel<TQ, TKV><<<")],
    # the first kernel stops before its attention (launch, table, first copies)
    "no_attention": [("  float sc[KT / 8][4], acc[kDC / 8][4];",
                      "  if (K > 0) return;\n  float sc[KT / 8][4], acc[kDC / 8][4];")],
    # the first kernel returns at entry (launch alone, then the combine)
    "empty_first": [("  constexpr int R = 16 * kW, TH = 32 * kW, KT = kChunkStep, NS = kChunkStages;",
                     "  if (K > 0) return;\n"
                     "  constexpr int R = 16 * kW, TH = 32 * kW, KT = kChunkStep, NS = kChunkStages;")],
    # the products left out (copies, split, softmax and stores kept)
    "no_products": [("      attn32::mma_nk<KT / 8>(sc,", "      if (K < 0) attn32::mma_nk<KT / 8>(sc,"),
                    ("    attn32::mma_kn<KT / 8, true>(acc,", "    if (K < 0) attn32::mma_kn<KT / 8, true>(acc,")],
    # the split pass over each landed K tile left out
    "no_split_pass": [("    if (j < nch) attn32::split_tile<KT, TH>(tile,",
                       "    if (K < 0) attn32::split_tile<KT, TH>(tile,")],
    # nothing launched: the wrapper's host work alone
    "no_launch": [("  float* pf = (float*)part;\n", "  if (K > 0) return 0;\n  float* pf = (float*)part;\n")],
}
CHUNK_RANGES = (32, 64, 128, 256, 512)
# the bf16 tile of rows 5 and 2 (attention_bf16.cuh, paged_attention.cu)
PAGED_BF16_FILES = ("paged_attention.cu", "attention_bf16.cuh", "attention_f32.cuh",
                    "tc_mma.cuh")
TUNED_BF16 = "kFwdWarps = 4, kFwdMinBlocks = 3, kFwdStep = 64, kFwdStages = 2"
PAGED_BF16_VARIANTS = {
    "tuned": [],
    # P V on bf16(P) alone (one product a step, FlashAttention's
    # rounding): the design variant the hi + lo split is held against
    "one_term_p": [("        tc::mma(acc[2 * dp], lo, f[0], f[1]);\n"
                    "        tc::mma(acc[2 * dp + 1], lo, f[2], f[3]);\n", "")],
    "fwd_2_blocks": [(TUNED_BF16, TUNED_BF16.replace("MinBlocks = 3", "MinBlocks = 2"))],
    "fwd_1_block": [(TUNED_BF16, TUNED_BF16.replace("MinBlocks = 3", "MinBlocks = 1"))],
    "fwd_32_steps": [(TUNED_BF16, TUNED_BF16.replace("Step = 64", "Step = 32"))],
    "fwd_ring_of_3": [(TUNED_BF16, TUNED_BF16.replace("Stages = 2", "Stages = 3"))],
}
# row 1's paged decode (paged_attention.cu)
DECODE_VARIANTS = {
    "tuned": [],
    "2_keys": [("constexpr int kDecKeys = 4;", "constexpr int kDecKeys = 2;")],
    "8_keys": [("constexpr int kDecKeys = 4;", "constexpr int kDecKeys = 8;")],
    "8_warps": [("constexpr int kDecWarps = 4;", "constexpr int kDecWarps = 8;")],
    "2_warps": [("constexpr int kDecWarps = 4;", "constexpr int kDecWarps = 2;")],
}
DECODE_DIAGNOSE = {
    # the kernel returns at entry (the cluster launch alone)
    "return_at_entry": [("  const int rg = (int)blockIdx.x % nr, oc = (int)blockIdx.x / nr * W;",
                         "  if (D > 0) return;\n"
                         "  const int rg = (int)blockIdx.x % nr, oc = (int)blockIdx.x / nr * W;")],
    # no key tile: staging, the warps' and the ranges' combines only
    "no_tiles": [("t0 < k1; t0 += kDecStep) {", "t0 < k1 && D < 0; t0 += kDecStep) {")],
}
# the cluster sizes (ranges a slot) the tuned library runs at
DECODE_RANGES = (1, 2, 4, 8)
ENTRIES = {"bfloat16": {"flash_attention_fwd":
                        "flash_fwd16_kernelI13__nv_bfloat16Lb1",
                        "flash_attention_bwd_dkv":
                        "flash_bwd_dkv16_kernelI13__nv_bfloat16Lb1",
                        "flash_attention_bwd_dq":
                        "flash_bwd_dq16_kernelI13__nv_bfloat16Lb1"},
           "float32": {"flash_attention_fwd": "flash_fwd_f32_kernelILb1E",
                       "flash_attention_bwd_dkv": "flash_bwd_dkv_f32_kernelILb1E",
                       "flash_attention_bwd_dq": "flash_bwd_dq_f32_kernelILb1E"}}
CHECK_SHAPES = ((4, 16, 1024, 128), (2, 4, 1000, 36))


def build(variants, dtype, files=FILES):
    """Start one nvcc per variant, then wait for all; returns {name:
    (library path, nvcc output)}."""
    from mxnet_tpu_torch.kernels import _build
    texts = {}
    for name in files:
        with open(os.path.join(CSRC, name)) as f:
            texts[name] = f.read()
    procs = {}
    names = tuple(files)
    for name, subs in variants.items():
        texts_v = dict(texts)
        for old, new, *every in subs:
            where = [n for n in names if old in texts_v[n]]
            if len(where) != 1:
                raise SystemExit("variant %s: %r in %d of the sources, not 1"
                                 % (name, old, len(where)))
            texts_v[where[0]] = texts_v[where[0]].replace(old, new, -1 if every else 1)
        out = os.path.join(OUT, dtype, name)
        os.makedirs(out, exist_ok=True)
        for fname, text in texts_v.items():
            with open(os.path.join(out, fname), "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(out, "lib.so"), os.path.join(out, names[0])],
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


def chunk_ptxas(log):
    """{instance: {registers, spill_stores, spill_loads}} of the chunk
    kernel's f32 instances (1 and 4 warps, D % 128 == 0 or not)."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        m = re.search(r"paged_chunk_kernelILi\d+ELb[01]Eff", line)
        if "Compiling entry function" in line and m:
            block = " ".join(lines[i + 1:i + 4])
            found[m.group(0)] = {
                "registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                "spill_stores": int(re.search(r"(\d+) bytes spill stores", block).group(1)),
                "spill_loads": int(re.search(r"(\d+) bytes spill loads", block).group(1))}
    return found


def main_chunk(args, torch, cs):
    """Row 2's variants and key ranges at the two served shapes."""
    pa = importlib.import_module("mxnet_tpu_torch.kernels.paged_attention")
    variants = dict(CHUNK_VARIANTS, **CHUNK_DIAGNOSE)
    if args.only:
        unknown = set(args.only) - set(variants)
        if unknown:
            raise SystemExit("unknown variants: %s" % sorted(unknown))
        variants = {n: v for n, v in variants.items() if n == "tuned" or n in args.only}
    built = build(variants, "chunk", CHUNK_FILES)
    libs = {name: pa._bind(ctypes.CDLL(path)) for name, (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 33)
    H, D, nb, bs, M = 16, 128, 512, 16, 64
    kc = torch.randn(nb, bs, H, D, generator=g).to(dev)
    vc = torch.randn(nb, bs, H, D, generator=g).to(dev)
    cases = {}
    for case, B, K, starts, lens in (
            ("mixed", 1, 64, [576], [64]),
            ("spec_spans", 8, 5, [37, 700, 0, 1018, 255, 512, 96, 3],
             [5, 3, 0, 5, 1, 2, 4, 5]),
            # the serve_spec phase's contexts: short prompts, full spans
            ("spec_short", 8, 5, [60, 90, 130, 70, 100, 120, 140, 80], [5] * 8),
            ("chunk_empty", 1, 64, [0], [0])):
        q, k, v = (torch.randn(B, K, H, D, generator=g).to(dev) for _ in range(3))
        table = torch.randperm(nb, generator=g)[:B * M].reshape(B, M).to(torch.int32).to(dev)
        st, ln = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (starts, lens))
        real = (torch.arange(K, device=dev)[None, :] < ln[:, None].long())
        cases[case] = (q, k, v, table, st, ln, real)
    sc = 1.0 / D ** 0.5
    plan = pa.chunk_plan

    @contextlib.contextmanager
    def arm(name, key_range):
        """The wrapper on the variant's library, at a forced key range or
        the plan's (patched once around an arm's calls, not per call)"""
        def fixed(*a):
            p = plan(*a)
            if key_range is None:
                return p
            return dict(p, key_range=key_range, ranges=-(-a[4] // key_range))
        with mock.patch.object(pa, "_lib", lambda: libs[name]), \
                mock.patch.object(pa, "chunk_plan", fixed):
            yield

    def runs():
        out = []
        for case, (q, k, v, table, st, ln, real) in cases.items():
            kk, vk = kc.clone(), vc.clone()

            def fn(q=q, k=k, v=v, table=table, st=st, ln=ln, kk=kk, vk=vk):
                return pa.paged_chunk_prefill_attend(q, k, v, kk, vk, table, st, ln, scale=sc)
            out.append((case, fn, (q, k, v, table, st, ln, real, kk, vk)))
        return out

    arms = [(name, None) for name in libs] + [("tuned", kr) for kr in CHUNK_RANGES]
    bad = {}
    for name, kr in arms:
        for case, fn, (q, k, v, table, st, ln, real, kk, vk) in runs():
            with arm(name, kr):
                out, _, _ = fn()
            kp, vp = kc.clone(), vc.clone()
            ref, _, _ = pa.paged_chunk_prefill_attend_plain(q, k, v, kp, vp, table, st, ln,
                                                            scale=sc)
            torch.cuda.synchronize()
            if not (cs.close(torch, out[real], ref[real]) and torch.equal(kk, kp)):
                bad.setdefault((name, kr), []).append(
                    "%s: max abs err %g" % (case, cs.max_err(out[real], ref[real])))
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)

    def pipelined_ms(fn, n=100):
        """Device ms a call over n calls launched back to back (as a
        serving step launches them): CUDA events around the run."""
        for _ in range(5):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    times = {a: {} for a in arms}
    for a in arms + arms[::-1]:
        with arm(*a):
            for case, fn, _ in runs():
                times[a].setdefault(case, []).append(cs.time_ms(torch, fn, flush))
                times[a].setdefault(case + ":pipelined", []).append(pipelined_ms(fn))
    for name, kr in arms:
        ms = {c: sum(t) / len(t) for c, t in times[name, kr].items()}
        print(json.dumps({"variant": name, "key_range": kr if kr else "plan",
                          "plan": {c: plan(cases[c][0].shape[0], cases[c][0].shape[1], H, D,
                                           M * bs) for c in cases},
                          "diagnostic": name in CHUNK_DIAGNOSE,
                          "ptxas": chunk_ptxas(built[name][1]),
                          "agrees": (name, kr) not in bad,
                          "disagreements": bad.get((name, kr), []), "ms": ms}), flush=True)
    cs.phase_device(torch)
    return 1 if {n for n, _ in bad} - set(CHUNK_DIAGNOSE) else 0


def main_decode(args, torch, cs):
    """Row 1's variants, combine forms and key ranges at the served
    shapes."""
    pa = importlib.import_module("mxnet_tpu_torch.kernels.paged_attention")
    variants = dict(DECODE_VARIANTS, **DECODE_DIAGNOSE)
    if args.only:
        unknown = set(args.only) - set(variants)
        if unknown:
            raise SystemExit("unknown variants: %s" % sorted(unknown))
        variants = {n: v for n, v in variants.items() if n == "tuned" or n in args.only}
    built = build(variants, "decode", CHUNK_FILES)
    libs = {name: pa._bind(ctypes.CDLL(path)) for name, (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 34)
    C, H, D, nb, bs, M = 8, 16, 128, 512, 16, 64
    q = torch.randn(C, H, D, generator=g).to(dev)
    kc = torch.randn(nb, bs, H, D, generator=g).to(dev)
    vc = torch.randn(nb, bs, H, D, generator=g).to(dev)
    table = torch.randperm(nb, generator=g)[:C * M].reshape(C, M).to(torch.int32).to(dev)
    cases = {
        "long": (q, table, torch.randint(20, 732, (C,), generator=g)),
        "short": (q, table, torch.randint(20, 146, (C,), generator=g)),
        "one_slot": (q[:1], table[:1], torch.randint(600, 732, (1,), generator=g))}
    cases = {c: (qq, tb, p.to(torch.int32).to(dev)) for c, (qq, tb, p) in cases.items()}
    sc = 1.0 / D ** 0.5
    plan = pa.decode_plan

    @contextlib.contextmanager
    def arm(name, ranges):
        """The wrapper on the variant's library, at a forced cluster size
        or the plan's"""
        def fixed(*a):
            p = plan(*a)
            return p if ranges is None else dict(p, ranges=ranges)
        with mock.patch.object(pa, "_lib", lambda: libs[name]), \
                mock.patch.object(pa, "decode_plan", fixed):
            yield

    arms = [(name, None) for name in libs] + [("tuned", r) for r in DECODE_RANGES]
    bad = {}
    for a in arms:
        for case, (qq, tb, pos) in cases.items():
            with arm(*a):
                out = pa.paged_decode_attend(qq, kc, vc, tb, pos, scale=sc)
            ref = pa.paged_decode_attend_plain(qq, kc, vc, tb, pos, scale=sc)
            torch.cuda.synchronize()
            if not cs.close(torch, out, ref):
                bad.setdefault(a, []).append("%s: max abs err %g"
                                             % (case, cs.max_err(out, ref)))
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    clean = cs.ReadFlush(flush)
    times = {a: {} for a in arms}
    for a in arms + arms[::-1]:
        with arm(*a):
            for case, (qq, tb, pos) in cases.items():
                def fn(qq=qq, tb=tb, pos=pos):
                    return pa.paged_decode_attend(qq, kc, vc, tb, pos, scale=sc)
                times[a].setdefault(case, []).append(cs.time_ms(torch, fn, flush))
                times[a].setdefault(case + ":clean", []).append(cs.time_ms(torch, fn, clean))
                times[a].setdefault(case + ":back_to_back", []).append(
                    cs.pipelined_ms(torch, fn))
    for a in arms:
        name, ranges = a
        ms = {c: sum(t) / len(t) for c, t in times[a].items()}
        print(json.dumps({"variant": name, "ranges": ranges or "plan",
                          "plan": {c: plan(v[0].shape[0], H, D, bs, M)
                                   for c, v in cases.items()},
                          "diagnostic": name in DECODE_DIAGNOSE,
                          "ptxas": decode_ptxas(built[name][1]),
                          "agrees": a not in bad, "disagreements": bad.get(a, []),
                          "ms": ms}), flush=True)
    cs.phase_device(torch)
    return 1 if {n for n, _ in bad} - set(DECODE_DIAGNOSE) else 0


def decode_ptxas(log):
    """{instance: {registers, spill_stores, spill_loads}} of the decode
    kernel's f32 instances (both load forms)."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        m = re.search(r"paged_decode_kernelIffLb[01]E", line)
        if "Compiling entry function" in line and m:
            block = " ".join(lines[i + 1:i + 4])
            found[m.group(0)] = {
                "registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                "spill_stores": int(re.search(r"(\d+) bytes spill stores", block).group(1)),
                "spill_loads": int(re.search(r"(\d+) bytes spill loads", block).group(1))}
    return found


def paged_bf16_ptxas(log):
    """{instance: {registers, spill_stores, spill_loads}} of the bf16
    prefill and chunk kernels."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        m = re.search(r"paged_(?:prefill|chunk)16_kernelI13__nv_bfloat16\w+?E(?=E)",
                      line)
        if "Compiling entry function" in line and m:
            block = " ".join(lines[i + 1:i + 4])
            found[m.group(0)] = {
                "registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                "spill_stores": int(re.search(r"(\d+) bytes spill stores", block).group(1)),
                "spill_loads": int(re.search(r"(\d+) bytes spill loads", block).group(1))}
    return found


def main_paged_bf16(args, torch, cs):
    """The bf16 prefill and chunk kernels' variants at the served
    shapes."""
    pa = importlib.import_module("mxnet_tpu_torch.kernels.paged_attention")
    variants = PAGED_BF16_VARIANTS
    if args.only:
        unknown = set(args.only) - set(variants)
        if unknown:
            raise SystemExit("unknown variants: %s" % sorted(unknown))
        variants = {n: v for n, v in variants.items() if n == "tuned" or n in args.only}
    built = build(variants, "paged_bf16", PAGED_BF16_FILES)
    libs = {name: pa._bind(ctypes.CDLL(path)) for name, (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 35)
    H, D, nb, bs, M = 16, 128, 512, 16, 64
    sc = 1.0 / D ** 0.5
    served = [20, 960, 0, 1024, 513, 77, 300, 641]
    q, k, v, kc, vc, table, L = (
        t.to(dev) for t in cs._prefill_inputs(torch, g, 8, 1024, H, D, nb, bs, M, served))
    q, k, v, kc, vc = (t.to(bf) for t in (q, k, v, kc, vc))
    cases = {"prefill": ("prefill", (q, k, v, kc, vc, table, L))}
    for case, B, K, starts, lens in (
            ("mixed", 1, 64, [576], [64]),
            ("spec_spans", 8, 5, [37, 700, 0, 1018, 255, 512, 96, 3],
             [5, 3, 0, 5, 1, 2, 4, 5])):
        qc, kk, vv = (torch.randn(B, K, H, D, generator=g).to(dev).to(bf) for _ in range(3))
        tb = torch.randperm(nb, generator=g)[:B * M].reshape(B, M).to(torch.int32).to(dev)
        st, ln = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (starts, lens))
        cases[case] = ("chunk", (qc, kk, vv, kc, vc, tb, st, ln))

    def call(kind, ins, caches, fn_kind=""):
        fn = getattr(pa, ("paged_prefill_attend" if kind == "prefill"
                          else "paged_chunk_prefill_attend") + fn_kind)
        return fn(*ins[:3], *caches, *ins[5:], scale=sc)

    refs = {}
    for case, (kind, ins) in cases.items():
        caches = (ins[3].clone(), ins[4].clone())
        out = call(kind, ins, caches, "_plain")[0]
        real = torch.ones(out.shape[:2], dtype=torch.bool, device=dev)
        if kind == "chunk":
            real = torch.arange(out.shape[1], device=dev)[None, :] < ins[7][:, None].long()
        refs[case] = (out, caches, real)
    bad, errs = {}, {}
    for name, lib in libs.items():
        with mock.patch.object(pa, "_lib", lambda lib=lib: lib):
            for case, (kind, ins) in cases.items():
                ref, rcaches, real = refs[case]
                caches = (ins[3].clone(), ins[4].clone())
                out = call(kind, ins, caches)[0]
                torch.cuda.synchronize()
                a, b = out[real].float(), ref[real].float()
                errs.setdefault(name, {})[case] = {
                    "max_abs_err": cs.max_err(a, b),
                    "rel_l2": float((a - b).norm() / b.norm())}
                if not (cs.close_bf16_out(torch, a, b)
                        and all(torch.equal(x, y) for x, y in zip(caches, rcaches))):
                    bad.setdefault(name, []).append(case)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    times = {name: {} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        with mock.patch.object(pa, "_lib", lambda lib=libs[name]: lib):
            for case, (kind, ins) in cases.items():
                caches = (ins[3].clone(), ins[4].clone())

                def fn(kind=kind, ins=ins, caches=caches):
                    return call(kind, ins, caches)
                times[name].setdefault(case, []).append(cs.time_ms(torch, fn, flush))
                times[name].setdefault(case + ":back_to_back", []).append(
                    cs.pipelined_ms(torch, fn))
    for name in libs:
        print(json.dumps({"variant": name, "ptxas": paged_bf16_ptxas(built[name][1]),
                          "agrees": name not in bad, "disagreements": bad.get(name, []),
                          "errors": errs[name],
                          "ms": {c: sum(t) / len(t) for c, t in times[name].items()}}),
              flush=True)
    cs.phase_device(torch)
    return 1 if set(bad) - {"one_term_p"} else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--chunk", action="store_true",
                    help="tune row 2's chunked prefill instead")
    ap.add_argument("--decode", action="store_true",
                    help="tune row 1's paged decode instead")
    ap.add_argument("--paged-bf16", action="store_true",
                    help="tune the bf16 prefill and chunk kernels instead")
    ap.add_argument("--only", nargs="+", metavar="VARIANT",
                    help="these variants (and tuned) only")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_tune: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    if args.chunk:
        return main_chunk(args, torch, cs)
    if args.decode:
        return main_decode(args, torch, cs)
    if args.paged_bf16:
        return main_paged_bf16(args, torch, cs)
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
