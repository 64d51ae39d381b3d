#!/usr/bin/env python3
"""Time variants of the LayerNorm kernels (TPU kernel rows 3 and 4) on one GPU.

    python3 tools/torch_layernorm_tune.py [--only V ...]
    python3 tools/torch_layernorm_tune.py --fwd [--only V ...]

``--fwd``: the forward (row 3).  Each variant of ``FWD_VARIANTS`` (the
blocks an SM the grid holds, threads a block, values a thread, so warps a
row, the next row's prefetch; ``FWD_DIAGNOSE``'s kernel that returns at
entry, expected to disagree) is held against ``layernorm_plain``, with
and without a residual, at ``FWD_SHAPES`` (the serve steps' 8, 40 and 64
rows, the draft model's 1024, ``Module.fit``'s 4096 and the one-shot
prefill's 8192, at 2048 columns; bf16 at 8, 64 and 4096) in f32 (rtol
1e-4 / atol 1e-5) and bf16 (``chip_smoke.close_bf16``, statistics at the
f32 bound), then timed there alone after the usual flush, after a flush
that reads, and 200 calls back to back (``chip_smoke.pipelined_ms``), the
variants in turns and then in reverse order.

Without ``--fwd``: the backward (row 4).

Each variant is ``mxnet_tpu_torch/csrc/layernorm.cu`` with a few text
substitutions of its constants or code (``VARIANTS``), written into
``build/flash_tune/layernorm/<variant>/`` and built by ``nvcc`` with the
port's flags, all builds started together (``torch_flash_tune.build``).
Every variant is held against ``layernorm_bwd_plain`` at the training
shape (4096 x 2048, with and without a residual) in f32 (dx at rtol 1e-4
/ atol 1e-5, dgamma and dbeta at atol 2e-4, ``chip_smoke.py``'s) and in
bf16 (``chip_smoke.close_bf16``), then timed there in both types alone
(``chip_smoke.time_ms``: median of 60 launches, L2 flushed), in turns
and then in reverse order.  The tuned library also runs with other
counts of stage-1 blocks (``BLOCKS``: the wrapper's ``_BWD_BLOCKS``,
patched).  ``DIAGNOSE`` variants take work out (the second stage, the
first stage's work) to show what it costs: they are timed and expected
to disagree.  Each arm is also timed after a flush that reads 256 MB
instead of writing it (``clean``), which leaves the L2 without dirty
lines to write back: the gap is what the usual flush's write-backs add.
Prints one JSON line per arm with its ``ptxas`` registers and spills,
then the card's name and power limit.  Needs a CUDA device.
"""
import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import re
import sys
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("layernorm.cu",)
TUNED = "__launch_bounds__(kBwdThreads, 2)\nlayernorm_bwd_rows_kernel"
# name: [(text in the source, its replacement[, "all"]), ...]
VARIANTS = {
    "tuned": [],
    # the next row's loads issued at the top of its own iteration
    "no_prefetch": [("  if (r < r1) fetch(r);\n  for (int it = 0; r < r1; r += NG, ++it) {\n",
                     "  for (int it = 0; r < r1; r += NG, ++it) {\n    fetch(r);\n"),
                    ("    if (r + NG < r1) fetch(r + NG);", "")],
    # 8 values a thread in bf16 too, or 16 in f32 too
    "vals_8": [("return kVec && sizeof(T) == 2 ? 16 : 8;", "return 8;")],
    "vals_16": [("return kVec && sizeof(T) == 2 ? 16 : 8;", "return 16;")],
    "min_blocks_1": [(TUNED, TUNED.replace(", 2)", ", 1)"))],
    # stage 2 in 8 slices a column
    "slices_8": [("constexpr int kReduceSlices = 32;", "constexpr int kReduceSlices = 8;")],
    # stage 2 over 16-column blocks (twice the blocks) in 64 slices
    "reduce_16_cols": [("constexpr int kReduceCols = 32;", "constexpr int kReduceCols = 16;"),
                       ("constexpr int kReduceSlices = 32;", "constexpr int kReduceSlices = 64;")],
    # one 512-thread block an SM (run with 132 stage-1 blocks too: half
    # the partial rows for stage 2)
    "threads_512": [("constexpr int kBwdThreads = 256;", "constexpr int kBwdThreads = 512;"),
                    (TUNED, TUNED.replace(", 2)", ", 1)"))],
}
DIAGNOSE = {
    # stage 1 alone
    "no_stage2": [("  layernorm_bwd_reduce_kernel<G><<<", "  if (cols < 0) layernorm_bwd_reduce_kernel<G><<<")],
    # stage 1 returns at entry (launch alone, then stage 2)
    "empty_stage1": [("  constexpr int VALS = bwd_vals<T, kVec>(), N = Vec16<T>::N, NV = VALS / N;",
                      "  if (cols > 0) return;\n"
                      "  constexpr int VALS = bwd_vals<T, kVec>(), N = Vec16<T>::N, NV = VALS / N;")],
}
BLOCKS = (132, 264, 512)
SHAPE = (4096, 2048)
_FWD_CONSTS = "constexpr int kFwdThreads = 256, kFwdBlocksPerSM = 4;"
_FWD_ROW = "  constexpr int VALS = kFwdVals, N = Vec16<T>::N, NV = VALS / N;"


def _fwd_consts(threads, blocks):
    return (_FWD_CONSTS, "constexpr int kFwdThreads = %d, kFwdBlocksPerSM = %d;"
            % (threads, blocks))


def _fwd_vals(expr):
    """Values a thread keeps: ``expr`` of T in the kernel and its launch."""
    return [(_FWD_ROW, _FWD_ROW.replace("kFwdVals", expr)),
            ("  constexpr int V = kFwdVals,", "  constexpr int V = %s," % expr)]


FWD_VARIANTS = {
    "tuned": [],
    # blocks an SM the grid holds (rows past that loop in each group)
    "blocks_2": [_fwd_consts(256, 2)],
    "blocks_8": [_fwd_consts(256, 8)],
    "blocks_32": [_fwd_consts(256, 32)],
    # 512-thread blocks (two 8-warp groups a block at 2048 f32 columns)
    "threads_512": [_fwd_consts(512, 2)],
    # the next row's loads issued at the top of its own iteration
    "no_prefetch": [("  if (r < rows) fetch(r);\n  for (; r < rows; r += stride) {\n",
                     "  for (; r < rows; r += stride) {\n    fetch(r);\n"),
                    ("    if (r + stride < rows) fetch(r + stride);      "
                     "// the next row's loads fly from here\n", "")],
    # values a thread: 16 in bf16 (4 warps a 2048-column row, two
    # vectors), 16 in both (4 warps), or 4 in f32 (16 warps, 512-thread
    # blocks)
    "vals_16_bf16": _fwd_vals("(sizeof(T) == 2 ? 16 : 8)"),
    "vals_16": _fwd_vals("16"),
    "vals_4_threads_512": _fwd_vals("(sizeof(T) == 4 ? 4 : 8)") + [_fwd_consts(512, 2)],
}
# the forward's work taken out: the register form returns at entry (the
# launch and the grid alone); timed and expected to disagree
FWD_DIAGNOSE = {
    "empty": [(_FWD_ROW, "  if (cols > 0) return;\n" + _FWD_ROW)],
}
# (dtype, rows) at 2048 columns
FWD_SHAPES = [("float32", r) for r in (8, 40, 64, 1024, 4096, 8192)] + \
    [("bfloat16", r) for r in (8, 64, 4096)]


def _flash_tune():
    spec = importlib.util.spec_from_file_location(
        "torch_flash_tune", os.path.join(HERE, "tools", "torch_flash_tune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ln_ptxas(log):
    """{instance: {registers, spill_stores, spill_loads}} of the stage-1
    and stage-2 kernels."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        m = re.search(r"layernorm_bwd_\w+?_kernelI\w+?E(?=Ev)", line)
        if "Compiling entry function" in line and m:
            block = " ".join(lines[i + 1:i + 4])
            found[m.group(0)] = {
                "registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                "spill_stores": int(re.search(r"(\d+) bytes spill stores", block).group(1)),
                "spill_loads": int(re.search(r"(\d+) bytes spill loads", block).group(1))}
    return found


def fwd_ptxas(log):
    """{instance: {registers, spill_stores, spill_loads}} of the forward's
    kernels."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        m = re.search(r"layernorm_fwd_\w+?_kernelI\w+?E(?=Ev)", line)
        if "Compiling entry function" in line and m:
            block = " ".join(lines[i + 1:i + 4])
            found[m.group(0)] = {
                "registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                "spill_stores": int(re.search(r"(\d+) bytes spill stores", block).group(1)),
                "spill_loads": int(re.search(r"(\d+) bytes spill loads", block).group(1))}
    return found


def _load(path):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mx_layernorm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.mx_layernorm_bwd.restype = i
    lib.mx_layernorm_fwd.argtypes = [p, p, p, p, p, p, p, i, i, ctypes.c_float, i, i, i, p]
    lib.mx_layernorm_fwd.restype = i
    return lib


def main_fwd(torch, cs, ln, only):
    """The forward's variants at FWD_SHAPES."""
    import torch.nn.functional as F
    variants = dict(FWD_VARIANTS, **FWD_DIAGNOSE)
    if only:
        unknown = set(only) - set(variants)
        if unknown:
            raise SystemExit("unknown variants: %s" % sorted(unknown))
        variants = {n: v for n, v in variants.items() if n == "tuned" or n in only}
    tune = _flash_tune()
    built = tune.build(variants, "layernorm_fwd", FILES)
    libs = {name: _load(path) for name, (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 37)
    cols = SHAPE[1]
    cases = {}
    for dt, rows in FWD_SHAPES:
        d = getattr(torch, dt)
        x, res = (torch.randn(rows, cols, generator=g).to(dev).to(d) for _ in range(2))
        gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(d)
        beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(d)
        cases["%s:%d" % (dt, rows)] = (x, gamma, beta, res)
    bad = {}
    for name, lib in libs.items():
        with mock.patch.object(ln, "_lib", lambda lib=lib: lib):
            for case, (x, gamma, beta, res) in cases.items():
                for r in (None, res):
                    got = ln.layernorm_fused(x, gamma, beta, residual=r)
                    again = ln.layernorm_fused(x, gamma, beta, residual=r)
                    ref = ln.layernorm_plain(x, gamma, beta, residual=r)
                    torch.cuda.synchronize()
                    for what, u, v in zip(("out", "mean", "rstd"), got, ref):
                        ok = (cs.close(torch, u, v) if what != "out" or x.dtype == torch.float32
                              else cs.close_bf16(torch, u, v))
                        if not ok:
                            bad.setdefault(name, []).append("%s%s %s: max abs err %g" % (
                                case, "" if r is None else " res", what, cs.max_err(u, v)))
                    if not all(torch.equal(u, v) for u, v in zip(got, again)):
                        bad.setdefault(name, []).append("%s: two runs differ" % case)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    clean = cs.ReadFlush(flush)
    times = {name: {} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        with mock.patch.object(ln, "_lib", lambda lib=libs[name]: lib):
            for case, (x, gamma, beta, _) in cases.items():
                fn = lambda: ln.layernorm_fused(x, gamma, beta)
                times[name].setdefault(case, []).append(cs.time_ms(torch, fn, flush))
                times[name].setdefault(case + ":clean", []).append(cs.time_ms(torch, fn, clean))
                times[name].setdefault(case + ":back_to_back", []).append(
                    cs.pipelined_ms(torch, fn))
    lib_ms = {}
    for case, (x, gamma, beta, _) in cases.items():
        fn = lambda: F.layer_norm(x, (cols,), gamma, beta, 1e-5)
        lib_ms[case] = cs.time_ms(torch, fn, flush)
        lib_ms[case + ":clean"] = cs.time_ms(torch, fn, clean)
        lib_ms[case + ":back_to_back"] = cs.pipelined_ms(torch, fn)
    for name in libs:
        print(json.dumps({"variant": name, "diagnostic": name in FWD_DIAGNOSE,
                          "ptxas": fwd_ptxas(built[name][1]),
                          "agrees": name not in bad, "disagreements": bad.get(name, [])[:4],
                          "ms": {c: sum(t) / len(t) for c, t in times[name].items()}}),
              flush=True)
    print(json.dumps({"library": "F.layer_norm", "ms": lib_ms}), flush=True)
    cs.phase_device(torch)
    return 1 if set(bad) - set(FWD_DIAGNOSE) else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", metavar="VARIANT",
                    help="these variants (and tuned) only")
    ap.add_argument("--fwd", action="store_true", help="the forward's variants")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_layernorm_tune: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    ln = importlib.import_module("mxnet_tpu_torch.kernels.layernorm")
    if args.fwd:
        return main_fwd(torch, cs, ln, args.only)
    variants = dict(VARIANTS, **DIAGNOSE)
    if args.only:
        unknown = set(args.only) - set(variants)
        if unknown:
            raise SystemExit("unknown variants: %s" % sorted(unknown))
        variants = {n: v for n, v in variants.items() if n == "tuned" or n in args.only}
    tune = _flash_tune()
    built = tune.build(variants, "layernorm", FILES)
    libs = {name: _load(path) for name, (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 35)
    rows, cols = SHAPE
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        x, res, dy = (torch.randn(rows, cols, generator=g).to(dev).to(dt) for _ in range(3))
        gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(dt)
        beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(dt)
        for r in (None, res):
            _, mean, rstd = ln.layernorm_plain(x, gamma, beta, residual=r)
            cases["%s%s" % (str(dt)[6:], "" if r is None else "_res")] = (
                x, gamma, mean, rstd, dy, r)
    arms = [(name, None) for name in libs] + [("tuned", b) for b in BLOCKS] + \
        [("threads_512", 132)] * ("threads_512" in libs)

    def arm(name, blocks):
        patches = [mock.patch.object(ln, "_lib", lambda: libs[name])]
        if blocks is not None:
            patches.append(mock.patch.object(ln, "_BWD_BLOCKS", blocks))
        return patches

    bad = {}
    for a in arms:
        patches = arm(*a)
        for p in patches:
            p.start()
        try:
            for case, (x, gamma, mean, rstd, dy, r) in cases.items():
                got = ln.layernorm_fused_bwd(x, gamma, mean, rstd, dy, residual=r)
                ref = ln.layernorm_bwd_plain(x, gamma, mean, rstd, dy, residual=r)
                torch.cuda.synchronize()
                for what, u, v in zip(("dx", "dgamma", "dbeta"), got, ref):
                    ok = (torch.allclose(u, v, rtol=cs.RTOL, atol=cs.ATOL if what == "dx"
                                         else 2e-4) if x.dtype == torch.float32
                          else cs.close_bf16(torch, u, v))
                    if not ok:
                        bad.setdefault(a, []).append("%s %s: max abs err %g"
                                                     % (case, what, cs.max_err(u, v)))
        finally:
            for p in patches:
                p.stop()
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    clean = cs.ReadFlush(flush)
    times = {a: {} for a in arms}
    for a in arms + arms[::-1]:
        patches = arm(*a)
        for p in patches:
            p.start()
        try:
            for case in ("float32", "bfloat16"):
                x, gamma, mean, rstd, dy, r = cases[case]
                fn = lambda: ln.layernorm_fused_bwd(x, gamma, mean, rstd, dy)
                times[a].setdefault(case, []).append(cs.time_ms(torch, fn, flush))
                times[a].setdefault(case + ":clean", []).append(
                    cs.time_ms(torch, fn, clean))
        finally:
            for p in patches:
                p.stop()
    for a in arms:
        name, blocks = a
        ms = {c: sum(t) / len(t) for c, t in times[a].items()}
        print(json.dumps({"variant": name, "blocks": blocks or "wrapper",
                          "diagnostic": name in DIAGNOSE,
                          "ptxas": ln_ptxas(built[name][1]),
                          "agrees": a not in bad, "disagreements": bad.get(a, [])[:4],
                          "ms": ms}), flush=True)
    cs.phase_device(torch)
    return 1 if {n for n, _ in bad} - set(DIAGNOSE) else 0


if __name__ == "__main__":
    sys.exit(main())
