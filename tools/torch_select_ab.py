#!/usr/bin/env python3
"""Ways to skip a non-finite step inside the fused fit step's graph, at
the full-width bf16 transformer's parameter set, on one GPU.

    python3 tools/torch_select_ab.py [REPLAYS]

The fused ``Module.fit`` step (``mxnet_tpu_torch/module/fused_fit.py``)
checks that every gradient's f32 view is finite and then commits each
new weight, master and momentum into the live tensor only on a finite
step.  This tool builds the transformer's parameter set (``chip_smoke``'s
FULL config: bf16 weight matrices and LayerNorm vectors with f32 masters
and momenta, f32 embeddings with f32 momenta), bf16 gradients widened to
f32, and new values, and times each variant as one captured CUDA graph
(``REPLAYS`` replays, default 20, between CUDA events), so the host's
launches do not count:

finiteness checks (one 0-d bool):
  isfinite_all: ``stack([isfinite(g).all() ...]).all()``;
  aminmax: ``isfinite(stack([aminmax(g) ...])).all()`` (a NaN or an
    infinity reaches the minimum or the maximum, so the same answer from
    one reduction that writes no mask);
commits of the new values:
  copy: ``dst.copy_(new)``, no select (the scaler off);
  where_out: ``torch.where(finite, new, dst, out=dst)``;
  where_mask: the same with the condition expanded once per step into a
    contiguous bool buffer and viewed per tensor, so every operand is
    contiguous.

Prints one JSON line: ms per replay of each variant, with the card's
name and power limit.  Needs a CUDA device."""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(torch, dev):
    """(weights, masters, momenta, grads32, new values) of the
    full-width bf16 transformer, each a list aligned by parameter."""
    sys.path.insert(0, HERE)
    from chip_smoke import FULL
    from mxnet_tpu_torch.weights import param_shapes
    g = torch.Generator(device=dev).manual_seed(0)
    ws, w32s, moms, gs, news = [], [], [], [], []
    for name, shape in sorted(param_shapes(FULL).items()):
        low = not name.endswith("_embed_weight")
        w32 = torch.randn(shape, device=dev, generator=g) * 0.02
        ws.append(w32.to(torch.bfloat16) if low else w32.clone())
        w32s.append(w32 if low else None)
        moms.append(torch.zeros(shape, device=dev))
        gs.append((torch.randn(shape, device=dev, generator=g)
                   .to(torch.bfloat16) if low
                   else torch.randn(shape, device=dev, generator=g)).float())
        news.append([t.clone() for t in (ws[-1], moms[-1])]
                    + ([w32.clone()] if low else []))
    return ws, w32s, moms, gs, news


def _time(torch, fn, replays):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                              # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_select_ab: needs a CUDA device", file=sys.stderr)
        return 2
    replays = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    dev = torch.device("cuda", 0)
    ws, w32s, moms, gs, news = _params(torch, dev)
    dsts = [[w, m] + ([w32] if w32 is not None else [])
            for w, m, w32 in zip(ws, moms, w32s)]
    largest = max(t.numel() for t in ws)
    mask = torch.empty(largest, dtype=torch.bool, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def isfinite_all():
        finite.copy_(torch.stack([torch.isfinite(x).all() for x in gs]).all())

    def aminmax():
        ext = [torch.aminmax(x) for x in gs]
        finite.copy_(torch.isfinite(torch.stack(
            [v for mm in ext for v in mm])).all())

    def copy():
        for ds, ns in zip(dsts, news):
            for d, n in zip(ds, ns):
                d.copy_(n)

    def where_out():
        for ds, ns in zip(dsts, news):
            for d, n in zip(ds, ns):
                torch.where(finite, n, d, out=d)

    def where_mask():
        mask.copy_(finite.expand(largest))
        for ds, ns in zip(dsts, news):
            for d, n in zip(ds, ns):
                torch.where(mask[:d.numel()].view(d.shape), n, d, out=d)

    out = {}
    for fn in (isfinite_all, aminmax, copy, where_out, where_mask):
        out[fn.__name__ + "_ms"] = _time(torch, fn, replays)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"tool": "torch_select_ab", "device": smi,
                      "params": sum(t.numel() for t in ws),
                      "replays": replays, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
