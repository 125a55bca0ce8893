"""PyTorch/CUDA port of the ``repro`` package (TrainingCXL on an NVIDIA H100).

Module names follow the JAX package, so ``repro_torch.X.Y`` is the
counterpart of ``repro.X.Y``. The port imports torch, numpy and the standard
library only; it shares no code with the JAX package.

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises rather than falling back.

    A CUDA device with no card present is an error: the caller passes
    ``device="cpu"`` to run the plain versions on the CPU.
    """
    import torch     # here: a memory node imports this package without it
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
