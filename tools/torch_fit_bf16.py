#!/usr/bin/env python3
"""``chip_smoke.py``'s fit_bf16 phase alone, on one GPU.

    python3 tools/torch_fit_bf16.py

Prints the card (``nvidia-smi`` name and power limit), builds the CUDA
kernels, then runs ``chip_smoke.phase_fit_bf16`` at full width: bf16
``Module.fit`` of the transformer and of the 2-bit ResNet-50, fused
against eager, the loss scaler's device ms a step and the injected-inf
case, each printed as ``chip_smoke`` prints it.  A quicker check of the
bf16 training path than the whole smoke run.  Needs a CUDA device."""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_fit_bf16: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device(torch)
    cs.phase_build()
    cs.phase_fit_bf16(torch, mx, cs.seeded_params(cs.FULL))
    return 0


if __name__ == "__main__":
    sys.exit(main())
