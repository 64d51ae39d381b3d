#!/usr/bin/env python3
"""Serve and serve_spec p50s of two trees of the repository, in turns on
one GPU.

    python3 tools/torch_serve_ab.py PARENT_DIR CHANGE_DIR [ROUNDS]

Runs ``chip_smoke.py``'s serve and serve_spec phases (the full-width
transformer through the mixed-step engine, then the speculative engine's
n-gram and draft arms) from each tree in a process of its own, in the
order parent, change, change, parent, ROUNDS times (default 1), and
prints one JSON line a run: the serve step p50, wall and TTFT p50, and
each spec arm's p50s, tokens per launch and accept rate.  The serving
steps are host-bound and their p50s swing by tens of percent between
runs of one tree, so two trees are compared only inside one call, in
turns.  Each tree builds its own kernels (its ``build/kernels``).
Needs a CUDA device."""
import json
import subprocess
import sys

CODE = r"""
import sys, json, os
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
import mxnet_tpu_torch as mx
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from mxnet_tpu_torch.kernels import _build
_build.build_all()
full = cs.seeded_params(cs.FULL)
cs.phase_serve(torch, mx, full)
cs.phase_serve_spec(torch, mx, full)
"""


def run(tree):
    out = subprocess.run([sys.executable, "-c", CODE], cwd=tree, capture_output=True,
                         text=True, timeout=1200)
    res = {"tree": tree, "rc": out.returncode}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            if d.get("phase") == "serve":
                res["serve_step_ms_p50"] = d["step_ms_p50"]
                res["serve_wall_s"] = d["wall_s"]
                res["serve_ttft_ms_p50"] = d["ttft_ms_p50"]
            elif d.get("phase") == "serve_spec":
                res["serve_spec"] = {
                    arm: {k: v for k, v in d[arm].items()
                          if "p50" in k or k in ("tokens_per_launch", "accept_rate")}
                    for arm in ("ngram", "draft") if arm in d}
    if out.returncode:
        res["stderr"] = out.stderr[-2000:]
    print(json.dumps(res), flush=True)


parent, change = sys.argv[1], sys.argv[2]
rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 1
for _ in range(rounds):
    for tree in (parent, change, change, parent):
        run(tree)
