#!/usr/bin/env python3
"""``chip_smoke.py``'s checkpoint phase alone, on one GPU.

    python3 tools/torch_checkpoint.py

Prints the card (``nvidia-smi`` name and power limit), builds the CUDA
kernels, then runs ``chip_smoke.phase_checkpoint``: ``mx.checkpoint``
through the fused bf16 ``Module.fit`` of the 2-bit ResNet-50 and of the
2-layer full-width transformer (run A with ``checkpoint_every``, run B
restored from tag 4, bit-equal at the end), the snapshot block, save
and restore times, ``DecodeEngine.reload`` and the ``Module.load`` of
an f32 checkpoint, printed as ``chip_smoke`` prints it.  A quicker check
of the checkpoint path than the whole smoke run.  Needs a CUDA device."""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_checkpoint: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_device(torch)
    cs.phase_build()
    cs.phase_checkpoint(torch, mx, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
