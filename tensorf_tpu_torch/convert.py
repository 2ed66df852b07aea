"""Carry weights across from the JAX package.

The JAX params pytree flattens (tensorf_tpu/utils/ckpt.py::_flatten) to
``{"density_plane/0": ndarray, ..., "render/l1/w": ndarray}``.  Both
packages keep the same layout, so the port's state-dict names are those
keys with '/' -> '.', and the arrays cross unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX params -> a state dict for ``TensorVMSplit.load_state_dict``
    (float32 CPU tensors; ``load_state_dict`` copies them to the field's
    device and rejects missing or unexpected names)."""
    return {
        key.replace("/", "."): torch.from_numpy(np.array(value, dtype=np.float32))
        for key, value in flat.items()
    }
