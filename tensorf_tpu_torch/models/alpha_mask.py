"""Binary occupancy grid ("alpha mask") for sample culling (counterpart of
tensorf_tpu/models/alpha_mask.py).

The volume is a (Z, Y, X) float {0, 1} tensor with its own aabb.  The
renderer uses it as a gate on sample validity: a nearest lookup in the
volume dilated by one voxel, which keeps every sample the trilinear
lookup of the reference would keep.  The strided coarse pre-gate and its
count helpers serve the sample budgets, which are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample_3d

# Ray samples one coarse-gate lookup covers (tensorf_tpu's COARSE_STRIDE);
# coarse_gate_valid checks the step-size precondition of that gate.
COARSE_STRIDE = 4


class AlphaGridMask:
    """aabb (2, 3) and volume (Z, Y, X) float {0, 1}, plus ``dilated``, the
    volume max-pooled over 3x3x3 (None until with_dilation builds it;
    checkpoints store only the volume)."""

    def __init__(self, aabb: torch.Tensor, volume: torch.Tensor,
                 dilated: Optional[torch.Tensor] = None):
        self.aabb = aabb
        self.volume = volume
        self.dilated = dilated

    @property
    def grid_size(self):
        # (X, Y, Z), matching reference tensorBase.py:39
        return tuple(self.volume.shape[::-1])

    def to(self, device) -> "AlphaGridMask":
        return AlphaGridMask(
            self.aabb.to(device),
            self.volume.to(device),
            None if self.dilated is None else self.dilated.to(device),
        )


def max_pool_3d_same(volume: torch.Tensor, ks: int = 3) -> torch.Tensor:
    """ks-window max dilation of a (D, H, W) volume, same padding (the
    padding never wins the max, as reduce_window's -inf init)."""
    return F.max_pool3d(volume[None, None], kernel_size=ks, stride=1, padding=ks // 2)[0, 0]


def with_dilation(mask: AlphaGridMask) -> AlphaGridMask:
    if mask.dilated is not None:
        return mask
    return AlphaGridMask(mask.aabb, mask.volume, max_pool_3d_same(mask.volume, ks=3))


def sample_alpha(mask: AlphaGridMask, xyz: torch.Tensor) -> torch.Tensor:
    """xyz (..., 3) world coords -> (...,) trilinear mask values
    (reference AlphaGridMask.sample_alpha, tensorBase.py:41-45)."""
    inv_size = 2.0 / (mask.aabb[1] - mask.aabb[0])
    norm = (xyz - mask.aabb[0]) * inv_size - 1.0
    return grid_sample_3d(mask.volume, norm)


def sample_alpha_gate(mask: AlphaGridMask, xyz: torch.Tensor) -> torch.Tensor:
    """Conservative occupancy gate: nearest lookup in the dilated volume,
    0 outside the mask's aabb.  Rounds half to even, as jnp.round does."""
    vol = mask.dilated if mask.dilated is not None else max_pool_3d_same(mask.volume, ks=3)
    D, H, W = vol.shape
    inv_size = 2.0 / (mask.aabb[1] - mask.aabb[0])
    norm = torch.clamp((xyz - mask.aabb[0]) * inv_size - 1.0, -1.0, 1.0)
    sizes = torch.tensor([W, H, D], dtype=norm.dtype, device=norm.device)
    ijk = torch.round((norm + 1.0) * 0.5 * (sizes - 1)).to(torch.int64)
    flat = ijk[..., 2] * (H * W) + ijk[..., 1] * W + ijk[..., 0]
    out_of_box = torch.any((xyz < mask.aabb[0]) | (xyz > mask.aabb[1]), dim=-1)
    return torch.where(out_of_box, torch.zeros((), device=vol.device), vol.reshape(-1)[flat])


def coarse_gate_valid(mask: Optional[AlphaGridMask], step_size: float, ndc_ray: bool) -> bool:
    """Whether the strided coarse pre-gate stays a superset of the exact
    gate: (COARSE_STRIDE/2)·step_size must not exceed one mask voxel, and
    NDC rays break it outright."""
    if mask is None:
        return True
    if ndc_ray:
        return False
    aabb = np.asarray(mask.aabb.cpu(), np.float64).reshape(2, 3)
    shape = np.asarray(mask.volume.shape[::-1], np.float64)  # (X, Y, Z)
    voxel = (aabb[1] - aabb[0]) / np.maximum(shape - 1.0, 1.0)
    return (COARSE_STRIDE / 2) * float(step_size) <= float(voxel.min()) * (1.0 + 1e-6)


def pack_mask(mask: AlphaGridMask) -> Dict[str, np.ndarray]:
    """Bit-packed checkpoint entries (reference tensorBase.py:160-168)."""
    vol = mask.volume.detach().cpu().numpy() > 0.5
    return {
        "alphaMask.shape": np.asarray(vol.shape, dtype=np.int64),
        "alphaMask.mask": np.packbits(vol.reshape(-1)),
        "alphaMask.aabb": np.asarray(mask.aabb.detach().cpu().numpy(), dtype=np.float32),
    }


def unpack_mask(entries, device=None) -> AlphaGridMask:
    shape = tuple(int(s) for s in entries["alphaMask.shape"])
    length = int(np.prod(shape))
    bits = np.unpackbits(entries["alphaMask.mask"])[:length].reshape(shape)
    aabb = np.array(entries["alphaMask.aabb"], np.float32).reshape(2, 3)
    return with_dilation(
        AlphaGridMask(
            aabb=torch.as_tensor(aabb, device=device),
            volume=torch.as_tensor(bits.astype(np.float32), device=device),
        )
    )
