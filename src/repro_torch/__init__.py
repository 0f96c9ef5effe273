"""PyTorch / CUDA port of the OCTOPUS reproduction.

Module paths mirror the JAX package ``repro`` one for one (``repro_torch
.wire.session`` is the port of ``repro.wire.session``, and so on). The
port imports ``torch`` and numpy only — never ``jax`` and never ``repro``.

Every kernel that the JAX package wrote in Pallas for the TPU is a CUDA
C++ kernel here (``repro_torch/kernels/csrc``), built with ``nvcc`` at
first use. Its plain PyTorch version sits beside it and runs only for a
tensor that lies on the CPU.

Entry points take ``device=``: they run on ``cuda`` unless the caller
passes ``device="cpu"``, and they raise on a host without a GPU instead
of falling back to the CPU quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Picking a CUDA device also turns TF32 off for both matrix products and
    cuDNN convolutions. cuDNN runs float32 convolutions in TF32 by
    default, which moves the encoder's latents far enough to flip codes
    against the float32 reference; the port computes in full float32.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU with the kernels' plain versions")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type not in ("cpu", "meta"):    # meta: shapes, no memory
        raise ValueError(f"the port runs on cuda or cpu, got {dev}")
    return dev
