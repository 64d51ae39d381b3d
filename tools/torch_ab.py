#!/usr/bin/env python3
"""Two trees of the repository, in turns on one GPU.

    python3 tools/torch_ab.py serve PARENT_DIR CHANGE_DIR [ROUNDS]
    python3 tools/torch_ab.py kernels PARENT_DIR CHANGE_DIR [ROUNDS]
    python3 tools/torch_ab.py paged_bf16 PARENT_DIR CHANGE_DIR [ROUNDS]
    python3 tools/torch_ab.py train PARENT_DIR CHANGE_DIR [ROUNDS] \
        --dtype bfloat16|float16
    python3 tools/torch_ab.py MODE PARENT_DIR CHANGE_DIR [ROUNDS] \
        --dtype float16

Runs one workload from each tree in a process of its own, in the order
parent, change, change, parent, ROUNDS times (default 1), and prints one
JSON line a run.  Two trees are compared only inside one call, in turns:
the serving steps are host-bound and their p50s swing by tens of percent
between runs of one tree.  Each tree builds its own kernels (its
``build/kernels``).  Needs a CUDA device.

serve: ``chip_smoke.py``'s serve and serve_spec phases of the tree (the
full-width transformer through the mixed-step engine, then the
speculative engine's n-gram and draft arms): the serve step p50, wall and
TTFT p50, and each spec arm's p50s, tokens per launch and accept rate.
Where the tree's phases run the step as a captured CUDA graph with an
eager arm beside it (``MXNET_DECODE_DONATE=0``), both arms are printed,
each with the CUDA runtime's launch calls per steady step
(``runtime_calls_per_step``, from the phase's profiled window).

kernels: the tree's ``layernorm_fused`` at 2048 columns (f32 at the rows
of every path that runs it, 8, 40, 64, 1024, 4096 and 8192; bf16 at 8, 64
and 4096) after ``time_ms``'s flush, after a flush that reads and 200
calls back to back, and its ``fused_band4d`` in f32 at the fused
sandwich's two bands beside ``torch.matmul`` (TF32 off) on the activated
input.

paged_bf16: the tree's one-shot prefill (row 5) and chunked prefill (row
2) on bf16 q/k/v over bf16 caches, the bf16 serving path: the prefill at
8 x 1024 (16 heads of 128, ``chip_smoke``'s served lengths), the chunk at
the mixed step's 64 rows and the spec step's 8 x 5-row spans over long
and short contexts, alone and 200 calls back to back.

train: ``chip_smoke.py``'s train_bf16 or train_f16 phase of the tree
(the full-width transformer through ``parallel.TrainStep`` in that
type): step p50, tokens/s and peak memory.

``--dtype float16`` (or ``bfloat16``): serve runs the tree's 16-bit
serve and serve_spec phases in that type (``phase_serve_f16`` and
``phase_serve_spec_f16``, or the bf16 ones) in place of the f32 ones;
paged_bf16 times the same kernels on q/k/v and caches of that type (the
f16 serving path).  A tree without that type's forms fails its runs,
and the failure is printed.

The timing helpers (and the prefill's inputs) are this tree's
``chip_smoke.py`` for both trees, so both are timed alike."""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
"""

SERVE = PRELUDE + r"""
import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import _build
_build.build_all()
full = cs.seeded_params(cs.FULL)
short = {"float32": "", "bfloat16": "_bf16", "float16": "_f16"}[sys.argv[2]]
getattr(cs, "phase_serve" + short)(torch, mx, full)
getattr(cs, "phase_serve_spec" + short)(torch, mx, full)
"""

TRAIN = PRELUDE + r"""
import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import _build
_build.build_all()
short = {"bfloat16": "_bf16", "float16": "_f16"}[sys.argv[2]]
getattr(cs, "phase_train" + short)(torch, mx, cs.seeded_params(cs.FULL))
"""

KERNELS = PRELUDE + r"""
import importlib.util
spec = importlib.util.spec_from_file_location("ab_timing", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from mxnet_tpu_torch import kernels as mxk
from mxnet_tpu_torch.tools import fused_sandwich as fs
dev = torch.device("cuda", 0)
flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
out = {}
g = torch.Generator(device="cpu").manual_seed(7)
for dt, rows in [("float32", r) for r in (8, 40, 64, 1024, 4096, 8192)] + \
        [("bfloat16", r) for r in (8, 64, 4096)]:
    d = getattr(torch, dt)
    x = torch.randn(rows, 2048, generator=g).to(dev).to(d)
    gamma = (1 + 0.02 * torch.randn(2048, generator=g)).to(dev).to(d)
    beta = (0.02 * torch.randn(2048, generator=g)).to(dev).to(d)
    fn = lambda: mxk.layernorm_fused(x, gamma, beta)
    key = "layernorm:%s:%d" % (dt, rows)
    out[key] = cs.time_ms(torch, fn, flush)
    out[key + ":read_flush"] = cs.time_ms(torch, fn, cs.ReadFlush(flush))
    out[key + ":back_to_back"] = cs.pipelined_ms(torch, fn)
for name, x, s, t, w in fs.band_shapes(fs.inputs(dev, torch.float32)):
    out["band_f32:" + name] = cs.time_ms(
        torch, lambda: mxk.fused_band4d(x, s, t, w), flush)
    a = torch.relu(x * s + t)
    out["matmul_f32:" + name] = cs.time_ms(torch, lambda: torch.matmul(a, w),
                                           flush)
print(json.dumps(out), flush=True)
"""


PAGED_BF16 = PRELUDE + r"""
import importlib.util
spec = importlib.util.spec_from_file_location("ab_timing", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from mxnet_tpu_torch import kernels as mxk
dev = torch.device("cuda", 0)
bf = getattr(torch, sys.argv[2] if sys.argv[2] != "float32" else "bfloat16")
flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
g = torch.Generator(device="cpu").manual_seed(cs.SEED + 40)
H, D, nb, bs, M = 16, 128, 512, 16, 64
sc = D ** -0.5
served = [20, 960, 0, 1024, 513, 77, 300, 641]
q, k, v, kc, vc, table, L = (t.to(dev) for t in cs._prefill_inputs(
    torch, g, 8, 1024, H, D, nb, bs, M, served))
q, k, v, kc, vc = (t.to(bf) for t in (q, k, v, kc, vc))
out = {"prefill": cs.time_ms(torch, lambda: mxk.paged_prefill_attend(
    q, k, v, kc, vc, table, L, scale=sc), flush)}
for case, B, K, starts, lens in (
        ("mixed", 1, 64, [576], [64]),
        ("spec_spans", 8, 5, [37, 700, 0, 1018, 255, 512, 96, 3],
         [5, 3, 0, 5, 1, 2, 4, 5]),
        ("spec_short", 8, 5, [60, 90, 130, 70, 100, 120, 140, 80], [5] * 8)):
    qc, kk, vv = (torch.randn(B, K, H, D, generator=g).to(dev).to(bf)
                  for _ in range(3))
    tb = torch.randperm(nb, generator=g)[:B * M].reshape(B, M) \
        .to(torch.int32).to(dev)
    st, ln = (torch.tensor(x, dtype=torch.int32, device=dev)
              for x in (starts, lens))
    fn = lambda: mxk.paged_chunk_prefill_attend(qc, kk, vv, kc, vc, tb, st,
                                                ln, scale=sc)
    out[case] = cs.time_ms(torch, fn, flush)
    out[case + ":back_to_back"] = cs.pipelined_ms(torch, fn)
print(json.dumps({"dtype": str(bf)[6:], **out}), flush=True)
"""


def _serve_arm(d):
    out = {k: d[k] for k in ("step_ms_p50", "wall_s", "ttft_ms_p50",
                             "decode_tokens_per_s", "tokens_per_s",
                             "tokens_per_launch", "accept_rate") if k in d}
    if "window" in d:
        out["runtime_calls_per_step"] = d["window"]["runtime_calls_per_step"]
    return out


def serve_result(lines):
    res = {}
    for d in lines:
        phase = d.get("phase", "")
        if phase in ("serve", "serve_bf16", "serve_f16"):
            res["serve"] = _serve_arm(d)
            if "eager_arm" in d:
                res["serve_eager_arm"] = _serve_arm(d["eager_arm"])
        elif phase in ("serve_spec", "serve_spec_bf16", "serve_spec_f16"):
            res["serve_spec"] = {}
            for arm in ("ngram", "draft"):
                if arm in d:
                    res["serve_spec"][arm] = _serve_arm(d[arm])
                    if "eager_arm" in d[arm]:
                        res["serve_spec"][arm + "_eager_arm"] = \
                            _serve_arm(d[arm]["eager_arm"])
    return res


def train_result(lines):
    return {k: d[k] for d in lines
            if d.get("phase") in ("train_bf16", "train_f16")
            for k in ("step_ms_p50", "tokens_per_s", "peak_mem_gb")}


def kernels_result(lines):
    res = {}
    for d in lines:
        res.update(d)
    return res


MODES = {"serve": (SERVE, serve_result), "kernels": (KERNELS, kernels_result),
         "paged_bf16": (PAGED_BF16, kernels_result),
         "train": (TRAIN, train_result)}


def run(tree, mode, dtype):
    code, result = MODES[mode]
    out = subprocess.run([sys.executable, "-c", code, os.path.join(HERE, "chip_smoke.py"),
                          dtype], cwd=tree, capture_output=True, text=True, timeout=1200)
    lines = [json.loads(t) for t in out.stdout.splitlines() if t.startswith("{")]
    res = {"tree": tree, "mode": mode, "dtype": dtype, "rc": out.returncode,
           **result(lines)}
    if out.returncode:
        res["stderr"] = out.stderr[-2000:]
    print(json.dumps(res), flush=True)


def main():
    args = sys.argv[1:]
    dtype = "float32"
    if "--dtype" in args:
        i = args.index("--dtype")
        dtype = args[i + 1]
        del args[i:i + 2]
    if len(args) < 3 or args[0] not in MODES or \
            dtype not in ("float32", "bfloat16", "float16") or \
            (args[0] == "train" and dtype == "float32"):
        raise SystemExit(__doc__)
    mode, parent, change = args[:3]
    rounds = int(args[3]) if len(args) > 3 else 1
    for _ in range(rounds):
        for tree in (parent, change, change, parent):
            run(tree, mode, dtype)


if __name__ == "__main__":
    main()
