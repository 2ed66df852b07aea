"""Binary occupancy grid ("alpha mask") for sample culling (counterpart of
tensorf_tpu/models/alpha_mask.py).

The volume is a (Z, Y, X) float {0, 1} tensor with its own aabb.  The
renderer uses it as a gate on sample validity: a nearest lookup in the
volume dilated by one voxel, which keeps every sample the trilinear
lookup of the reference would keep.  The strided coarse pre-gate (one
lookup of a further-dilated volume per COARSE_STRIDE samples) picks the
candidates of a sample budget; the exact gate still runs on what it keeps.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample_3d

# Ray samples one coarse-gate lookup covers.  The probe sits at the middle
# sample of each window, so with step_ratio 0.5 every window sample lies
# within one voxel of it; with the nearest rounding at both ends a further
# 2-voxel dilation (ks=5) keeps the coarse gate a superset of the exact one.
# coarse_gate_valid checks that step-size precondition.
COARSE_STRIDE = 4


class AlphaGridMask:
    """aabb (2, 3) and volume (Z, Y, X) float {0, 1}, plus ``dilated``, the
    volume max-pooled over 3x3x3, and ``coarse``, ``dilated`` max-pooled
    over 5x5x5 (both None until with_dilation builds them; checkpoints
    store only the volume)."""

    def __init__(self, aabb: torch.Tensor, volume: torch.Tensor,
                 dilated: Optional[torch.Tensor] = None,
                 coarse: Optional[torch.Tensor] = None):
        self.aabb = aabb
        self.volume = volume
        self.dilated = dilated
        self.coarse = coarse
        self._aabb_np = None

    @property
    def aabb_np(self) -> np.ndarray:
        """The aabb on the host, read from the device once per mask."""
        if self._aabb_np is None:
            self._aabb_np = np.asarray(self.aabb.detach().cpu(), np.float64).reshape(2, 3)
        return self._aabb_np

    @property
    def grid_size(self):
        # (X, Y, Z), matching reference tensorBase.py:39
        return tuple(self.volume.shape[::-1])

    def to(self, device) -> "AlphaGridMask":
        return AlphaGridMask(
            self.aabb.to(device),
            self.volume.to(device),
            None if self.dilated is None else self.dilated.to(device),
            None if self.coarse is None else self.coarse.to(device),
        )


def max_pool_3d_same(volume: torch.Tensor, ks: int = 3) -> torch.Tensor:
    """ks-window max dilation of a (D, H, W) volume, same padding (the
    padding never wins the max, as reduce_window's -inf init)."""
    return F.max_pool3d(volume[None, None], kernel_size=ks, stride=1, padding=ks // 2)[0, 0]


def group_padded_count(cand: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B,) int32: COARSE_STRIDE times the number of stride
    windows with any set sample — what the window-granular budget
    compaction (render/volume.py) pays, so budgets sized from it cover
    every kept sample.  The windows start at index 0, as there."""
    B, N = cand.shape
    S = COARSE_STRIDE
    G = -(-N // S)
    cand = F.pad(cand, (0, G * S - N))
    gk = cand.reshape(B, G, S).any(dim=-1)
    return S * torch.sum(gk.to(torch.int32), dim=-1, dtype=torch.int32)


def with_dilation(mask: AlphaGridMask) -> AlphaGridMask:
    if mask.dilated is not None and mask.coarse is not None:
        return mask
    dilated = mask.dilated if mask.dilated is not None else max_pool_3d_same(mask.volume, ks=3)
    coarse = mask.coarse if mask.coarse is not None else max_pool_3d_same(dilated, ks=5)
    return AlphaGridMask(mask.aabb, mask.volume, dilated, coarse)


def sample_alpha(mask: AlphaGridMask, xyz: torch.Tensor) -> torch.Tensor:
    """xyz (..., 3) world coords -> (...,) trilinear mask values
    (reference AlphaGridMask.sample_alpha, tensorBase.py:41-45)."""
    inv_size = 2.0 / (mask.aabb[1] - mask.aabb[0])
    norm = (xyz - mask.aabb[0]) * inv_size - 1.0
    return grid_sample_3d(mask.volume, norm)


def _nearest_flat(shape, norm: torch.Tensor) -> torch.Tensor:
    """Flat index into a (D, H, W) volume of the nearest voxel to normalized
    points (..., 3) in [-1, 1]; rounds half to even, as jnp.round does.  The
    sizes enter as Python scalars (no host-to-device copy), each axis by the
    same float32 product as JAX's (norm + 1) * 0.5 * (sizes - 1)."""
    D, H, W = shape
    half = (norm + 1.0) * 0.5
    ix, iy, iz = (torch.round(half[..., a] * float(n - 1)).to(torch.int64)
                  for a, n in enumerate((W, H, D)))
    return iz * (H * W) + iy * W + ix


def sample_alpha_gate(mask: AlphaGridMask, xyz: torch.Tensor) -> torch.Tensor:
    """Conservative occupancy gate: nearest lookup in the dilated volume,
    0 outside the mask's aabb.  Rounds half to even, as jnp.round does."""
    vol = mask.dilated if mask.dilated is not None else max_pool_3d_same(mask.volume, ks=3)
    inv_size = 2.0 / (mask.aabb[1] - mask.aabb[0])
    norm = torch.clamp((xyz - mask.aabb[0]) * inv_size - 1.0, -1.0, 1.0)
    flat = _nearest_flat(vol.shape, norm)
    out_of_box = torch.any((xyz < mask.aabb[0]) | (xyz > mask.aabb[1]), dim=-1)
    return torch.where(out_of_box, torch.zeros((), device=vol.device), vol.reshape(-1)[flat])


def coarse_probe_hits(mask: AlphaGridMask, probe: torch.Tensor) -> torch.Tensor:
    """Nearest lookup of the coarse volume at probe points (..., 3) ->
    (...,) bool: the primitive of the strided pre-gate and of the
    probe-only count pass (render/culling.py)."""
    vol = mask.coarse
    if vol is None:
        dilated = mask.dilated if mask.dilated is not None else max_pool_3d_same(mask.volume, ks=3)
        vol = max_pool_3d_same(dilated, ks=5)
    inv_size = 2.0 / (mask.aabb[1] - mask.aabb[0])
    norm = torch.clamp((probe - mask.aabb[0]) * inv_size - 1.0, -1.0, 1.0)
    return vol.reshape(-1)[_nearest_flat(vol.shape, norm)] > 0


def coarse_probe_indices(n_samples: int, device=None) -> torch.Tensor:
    """Lattice indices the coarse gate probes: the middle sample of each
    COARSE_STRIDE window, clipped at the lattice end; int64, built on
    ``device``."""
    n_probe = -(-n_samples // COARSE_STRIDE)
    idx = torch.arange(n_probe, device=device) * COARSE_STRIDE + COARSE_STRIDE // 2
    return torch.clamp(idx, max=n_samples - 1)


def sample_alpha_gate_coarse(mask: AlphaGridMask, xyz: torch.Tensor) -> torch.Tensor:
    """Strided occupancy pre-gate over the full lattice xyz (B, N, 3) ->
    (B, N) bool: one probe per COARSE_STRIDE window, repeated over the
    window; a superset of sample_alpha_gate where coarse_gate_valid holds."""
    B, N, _ = xyz.shape
    hit = coarse_probe_hits(mask, xyz[:, coarse_probe_indices(N, xyz.device), :])  # (B, n_probe)
    return torch.repeat_interleave(hit, COARSE_STRIDE, dim=1)[:, :N]


def coarse_gate_valid(mask: Optional[AlphaGridMask], step_size: float, ndc_ray: bool) -> bool:
    """Whether the strided coarse pre-gate stays a superset of the exact
    gate: (COARSE_STRIDE/2)·step_size must not exceed one mask voxel, and
    NDC rays break it outright."""
    if mask is None:
        return True
    if ndc_ray:
        return False
    aabb = mask.aabb_np
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
