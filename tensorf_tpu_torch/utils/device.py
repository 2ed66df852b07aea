"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks.

    Raises when CUDA is requested (or defaulted to) and no GPU is present —
    the port never carries on quietly on the CPU.  Also pins float32 matmuls
    and convolutions to full float32 (TF32 off for both): the JAX reference
    computes in float32, and cuDNN would otherwise use TF32 by default.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
