#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention kernels on one GPU.

    python3 tools/torch_flash_tune.py

Each variant is ``mxnet_tpu_torch/csrc/flash_attention.cu`` with a few
text substitutions of its tuning constants or dispatch (``VARIANTS``),
built by ``nvcc`` with the port's flags into ``build/flash_tune/``, all
builds started together.  Every variant's three bf16 kernels are held
against their plain versions (``chip_smoke.close_bf16``, lse at rtol
1e-4 / atol 1e-5) at the training shape (4, 16, 1024, 128) and a
ragged one (2, 4, 1000, 36), then timed at the training shape with
``chip_smoke.time_ms`` (median of 60 launches, L2 flushed), the
variants in turns and then in reverse order.  Prints one JSON line per
variant: its ``ptxas`` registers and spill bytes per kernel and the
mean of its two times per kernel, then the card's name and power limit.
Needs a CUDA device; the variants go through the port's wrappers with
the wrapper's library swapped for the variant's.
"""
import ctypes
import importlib
import json
import os
import re
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "mxnet_tpu_torch", "csrc", "flash_attention.cu")
OUT = os.path.join(HERE, "build", "flash_tune")
TUNED = dict(fwd="kFwdWarps = 4, kFwdMinBlocks = 3, kFwdStep = 64, kFwdStages = 2",
             dkv="kDkvWarps = 4, kDkvMinBlocks = 1, kDkvStep = 32, kDkvStages = 2",
             dq="kDqWarps = 4, kDqMinBlocks = 1, kDqStep = 64, kDqStages = 2")


def _sizes(kernel, warps, min_blocks, step, stages):
    prefix = dict(fwd="kFwd", dkv="kDkv", dq="kDq")[kernel]
    return (TUNED[kernel], "%sWarps = %d, %sMinBlocks = %d, %sStep = %d, %sStages = %d"
            % (prefix, warps, prefix, min_blocks, prefix, step, prefix, stages))


# name: [(text in the source, its replacement), ...]
VARIANTS = {
    "tuned": [],
    # the product loops with a branch per 16-column step (the form that
    # runs when D % 128 != 0) at D = 128 too
    "ragged_loops": [("const auto kernel = D % kDC == 0 ?",
                      "const auto kernel = false ?")],
    "fwd_4_blocks": [_sizes("fwd", 4, 4, 64, 2)],
    "8_warps": [_sizes("fwd", 8, 2, 64, 2), _sizes("dkv", 8, 1, 32, 2),
                _sizes("dq", 8, 1, 64, 2)],
    "32_row_steps": [_sizes("fwd", 4, 3, 32, 2), _sizes("dq", 4, 1, 32, 2)],
    "ring_of_3": [_sizes("fwd", 4, 3, 64, 3), _sizes("dkv", 4, 1, 32, 3),
                  _sizes("dq", 4, 1, 64, 3)],
    "32_row_steps_ring_of_4": [_sizes("fwd", 4, 4, 32, 4), _sizes("dkv", 4, 1, 32, 4),
                               _sizes("dq", 4, 2, 32, 4)],
    # blocks ordered tile-major (x = tile, y = batch * head)
    "tile_major_grid": [
        ("(int)blockIdx.y;          // longest rows first",
         "(int)blockIdx.x;          // longest rows first"),
        ("const size_t bh = blockIdx.x;", "const size_t bh = blockIdx.y;"),
        ("const int kt = blockIdx.y;", "const int kt = blockIdx.x;"),
        ("return dim3(BH, (S + 16 * warps - 1) / (16 * warps), (D + kDC - 1) / kDC);",
         "return dim3((S + 16 * warps - 1) / (16 * warps), BH, (D + kDC - 1) / kDC);")],
}
ENTRIES = {"flash_attention_fwd": "flash_fwd_bf16_kernelILb1",
           "flash_attention_bwd_dkv": "flash_bwd_dkv_bf16_kernelILb1",
           "flash_attention_bwd_dq": "flash_bwd_dq_bf16_kernelILb1"}
CHECK_SHAPES = ((4, 16, 1024, 128), (2, 4, 1000, 36))


def build(names):
    """Start one nvcc per variant, then wait for all; returns {name:
    (library path, nvcc output)}."""
    from mxnet_tpu_torch.kernels import _build
    with open(SOURCE) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit("variant %s: %r not in the source" % (name, old))
            text = text.replace(old, new)
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("nvcc failed for variant %s:\n%s" % (name, log[-3000:]))
        built[name] = (os.path.join(OUT, name + ".so"), log)
    return built


def ptxas(log):
    """{kernel: {registers, spill_stores, spill_loads}} of the D % 128 == 0
    instantiations."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        for kernel, entry in ENTRIES.items():
            if "Compiling entry function" in line and entry in line:
                block = " ".join(lines[i + 1:i + 4])
                found[kernel] = {
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_tune: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    fa = importlib.import_module("mxnet_tpu_torch.kernels.flash_attention")
    dev = torch.device("cuda", 0)
    built = build(list(VARIANTS))
    libs = {name: load(path) for name, (path, _) in built.items()}
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 31)
    cases = [[torch.randn(*shape, generator=g).to(dev).to(torch.bfloat16)
              for _ in range(4)] for shape in CHECK_SHAPES]
    bad = {}
    for name, lib in libs.items():
        with mock.patch.object(fa, "_lib", lambda lib=lib: lib):
            for shape, ins in zip(CHECK_SHAPES, cases):
                for what, a, b in cs._flash_bf16_pairs(torch, fa, *ins,
                                                       1.0 / shape[-1] ** 0.5):
                    ok = cs.close(torch, a, b) if what == "lse" \
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
        print(json.dumps({"variant": name, "substitutions": len(VARIANTS[name]),
                          "ptxas": ptxas(built[name][1]), "agrees": name not in bad,
                          "disagreements": bad.get(name, []),
                          "ms": dict(zip(ENTRIES, ms)), "shape": list(q.shape)}),
              flush=True)
    cs.phase_device(torch)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
