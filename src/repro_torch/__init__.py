"""PyTorch/CUDA port of the CIMple reproduction (``src/repro`` is the JAX
reference it is held against).

The module tree mirrors ``repro/`` file for file.  Plain tensor code is
PyTorch; every Pallas kernel of the reference is hand-written CUDA for
Hopper (``kernels/csrc``), built at first use.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; ``cuda`` must really be there.

    On the card, TF32 is switched off for matmuls and cuDNN: the int8
    datapath's float stages (scores of int8 products, the PV sums) and the
    f32 LM head are specified in full float32, and TF32 keeps ~3 digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no "
                               "CUDA device (pass device='cpu' explicitly)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
