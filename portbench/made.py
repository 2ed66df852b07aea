"""The made state: a late training segment's field, mask and geometry,
built from the seed and the scene's analytic geometry instead of being
trained.

A run cannot afford the thousands of steps that lead to a late segment, so
the set-up walks the configuration's schedule (its voxel counts, alpha-mask
and upsample events) with the benchmark's own arithmetic and makes what
each event would have left behind:

* the first alpha-mask event shrinks the box to the occupied region,
  voxel-aligned on the grid of that time;
* the grid is ``n_to_reso`` of the segment's voxel count on that box;
* the alpha mask is the scene's occupancy on the mask's lattice, dilated
  3x3x3 as the mask update dilates it;
* the density factors hold signed slab profiles of the occupancy: rank r of
  axis i is +A on the columns of slab r that meet an object and -A on the
  others, times the slab's indicator along the line, so the sum over the
  three axes reaches 3A inside the objects and stays at or below A outside
  the visual hull of the slabs; only the ranks that FreeNeRF's mask leaves
  visible at the segment's first step get a slab;
* every factor adds the init draw (0.1 randn) from the seed, the basis and
  the MLP take the port's init distributions from the seed; the first
  segment is that init draw alone, step 0 of a reconstruction;
* Adam's moments are zero and the LR is the segment's own.

Everything here is the benchmark's: the port gets the result
(``install``), the reference gets the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .scene import Scene, occupancy

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def n_to_reso(n_voxels: int, aabb) -> tuple:
    """Voxel count -> per-axis resolution, in float32 as TensoRF computes it."""
    aabb = np.asarray(aabb, np.float32).reshape(2, 3)
    size = aabb[1] - aabb[0]
    voxel = np.float32((size.prod() / n_voxels) ** (1.0 / 3))
    return tuple(int(v) for v in (size / voxel).astype(np.int64))


def voxel_schedule(n_init: int, n_final: int, n_events: int) -> List[int]:
    """TensoRF's log-spaced voxel counts, one per upsample."""
    return [int(round(v)) for v in
            np.exp(np.linspace(math.log(n_init), math.log(n_final), n_events + 1))][1:]


def lattice(aabb: np.ndarray, grid, device, z_slice: Optional[slice] = None) -> torch.Tensor:
    """(X, Y, Z', 3) float32 lattice points of ``grid`` (X, Y, Z) over
    ``aabb``, align_corners (index 0 at aabb[0], index n-1 at aabb[1])."""
    axes = [torch.linspace(float(aabb[0][a]), float(aabb[1][a]), int(grid[a]), device=device)
            for a in range(3)]
    if z_slice is not None:
        axes[2] = axes[2][z_slice]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def occupancy_grid(scene: Scene, aabb: np.ndarray, grid, device, chunk: int = 8) -> torch.Tensor:
    """(X, Y, Z) bool occupancy of the scene at the lattice points."""
    cell = torch.as_tensor((aabb[1] - aabb[0]) / (np.asarray(grid, np.float32) - 1),
                           device=device)
    out = torch.empty(tuple(int(g) for g in grid), dtype=torch.bool, device=device)
    for z0 in range(0, int(grid[2]), chunk):
        sl = slice(z0, min(z0 + chunk, int(grid[2])))
        out[:, :, sl] = occupancy(scene, lattice(aabb, grid, device, sl), cell)
    return out


def mask_volume(occ_xyz: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) float {0, 1}: the occupancy dilated 3x3x3, as the mask
    update max-pools the alpha grid before it thresholds."""
    vol = occ_xyz.permute(2, 1, 0).float()
    return F.max_pool3d(vol[None, None], 3, stride=1, padding=1)[0, 0]


class Segment(NamedTuple):
    iteration: int  # the segment's first step
    aabb: np.ndarray  # (2, 3) float32
    grid: tuple  # (X, Y, Z)
    n_samples: int
    # the alpha mask: (aabb, lattice (X, Y, Z)) or None
    mask: Optional[tuple]
    l1_weight: float
    # (aabb, step size) of the event that re-filtered the ray store by the
    # mask, or None
    refilter: Optional[tuple]


def step_size(aabb: np.ndarray, grid, step_ratio: float) -> float:
    units = (aabb[1] - aabb[0]) / (np.asarray(grid, np.float32) - 1)
    return float(np.mean(units) * step_ratio)


def walk_schedule(cfg, scene_aabb: np.ndarray, scene: Scene, which: str, device) -> Segment:
    """The geometry that ``cfg``'s schedule reaches at the start of its first
    or last segment."""
    aabb = np.asarray(scene_aabb, np.float32).reshape(2, 3)
    grid = n_to_reso(cfg.N_voxel_init, aabb)
    counts = voxel_schedule(cfg.N_voxel_init, cfg.N_voxel_final, len(cfg.upsamp_list))
    n_samples = min(int(cfg.nSamples), int(np.linalg.norm(grid) / cfg.step_ratio))
    mask, l1, refilter = None, float(cfg.L1_weight_inital), None
    events = sorted(set(cfg.upsamp_list) | set(cfg.update_AlphaMask_list))
    if which == "first":
        events = []
    for it in events:
        if it in cfg.update_AlphaMask_list:
            reso = grid if int(np.prod(grid)) < 256 ** 3 else tuple(min(g, 256) for g in grid)
            mask = (aabb.copy(), tuple(reso))
            if it == cfg.update_AlphaMask_list[0]:
                aabb, grid = shrink(scene, aabb, grid, reso, device)
            elif it == cfg.update_AlphaMask_list[1] and not cfg.ndc_ray:
                refilter = (aabb.copy(), step_size(aabb, grid, cfg.step_ratio))
            if cfg.L1_weight_rest >= 0:
                l1 = float(cfg.L1_weight_rest)
        if it in cfg.upsamp_list:
            grid = n_to_reso(counts.pop(0), aabb)
            n_samples = min(int(cfg.nSamples), int(np.linalg.norm(grid) / cfg.step_ratio))
    start = events[-1] + 1 if events else 0
    return Segment(start, aabb, tuple(grid), n_samples, mask, l1, refilter)


def shrink(scene: Scene, aabb: np.ndarray, grid, reso, device):
    """The first mask event's shrink: the occupied lattice points of the
    dilated mask bound the new box, aligned to the grid's voxels."""
    vol = mask_volume(occupancy_grid(scene, aabb, reso, device)) > 0.5  # (Z, Y, X)
    idx = torch.nonzero(vol)
    if idx.numel() == 0:
        return aabb, grid
    lo_i = idx.min(0).values.flip(0).cpu().numpy()  # (x, y, z)
    hi_i = idx.max(0).values.flip(0).cpu().numpy()
    unit_m = (aabb[1] - aabb[0]) / (np.asarray(reso, np.float32) - 1)
    tight = np.stack([aabb[0] + lo_i * unit_m, aabb[0] + hi_i * unit_m]).astype(np.float32)
    units = (aabb[1] - aabb[0]) / (np.asarray(grid, np.float32) - 1)
    t_l = np.round(np.round((tight[0] - aabb[0]) / units)).astype(np.int64)
    b_r = np.minimum(np.round((tight[1] - aabb[0]) / units).astype(np.int64) + 1,
                     np.asarray(grid))
    g = np.asarray(grid, np.float64)
    lo_r, hi_r = t_l / (g - 1), (b_r - 1) / (g - 1)
    new = np.stack([(1 - lo_r) * aabb[0] + lo_r * aabb[1],
                    (1 - hi_r) * aabb[0] + hi_r * aabb[1]]).astype(np.float32)
    return new, tuple(int(v) for v in (b_r - t_l))


def visible_ranks(cfg, n_comp: int, step: int) -> int:
    """Ranks FreeNeRF's decomposition mask leaves fully visible at ``step``
    (all of them without it)."""
    if not (cfg.free_reg and cfg.free_decomp):
        return n_comp
    eff = n_comp * float(cfg.freq_reg_ratio)
    ptr = min(eff / 4 * step / cfg.n_iters + 1.0, eff / 4)
    return max(1, min(n_comp, int(math.floor(ptr)) * 4))


def slab_profiles(occ_xyz: torch.Tensor, axis: int, ranks: int, amplitude: float):
    """Signed slab profiles of one axis: (plane (H, W, ranks), line (L, ranks))."""
    m0, m1 = MAT_MODE[axis]
    a = VEC_MODE[axis]
    L = occ_xyz.shape[a]
    planes, lines = [], []
    edges = np.linspace(0, L, ranks + 1).round().astype(int)
    for r in range(ranks):
        sl = [slice(None)] * 3
        sl[a] = slice(int(edges[r]), int(max(edges[r + 1], edges[r] + 1)))
        proj = occ_xyz[tuple(sl)].any(dim=a)  # over the two plane axes, in axis order
        # axes left after the reduction, in order; the plane is (m1, m0)
        left = [x for x in range(3) if x != a]
        plane = proj if left == [m1, m0] else proj.T
        planes.append(torch.where(plane, amplitude, -amplitude))
        line = torch.zeros(L, device=occ_xyz.device)
        line[sl[a]] = 1.0
        lines.append(line)
    return torch.stack(planes, -1), torch.stack(lines, -1)


class Made(NamedTuple):
    segment: Segment
    params: Dict[str, torch.Tensor]  # the port's parameter names
    mask: Optional[torch.Tensor]  # (Z, Y, X) float {0, 1}, or None


def make(cfg, spec: dict, scene: Scene, segment: Segment, seed: int, device) -> Made:
    """The segment's field and mask from ``seed``: a card-side generator,
    one draw per factor."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    grid = segment.grid
    occ = occupancy_grid(scene, segment.aabb, grid, device) if segment.iteration > 0 else None
    params: Dict[str, torch.Tensor] = {}
    amp = float(spec["density_amplitude"])
    for field, ranks in (("density", cfg.n_lamb_sigma), ("app", cfg.n_lamb_sh)):
        for i, (m0, m1) in enumerate(MAT_MODE):
            H, W, L, R = grid[m1], grid[m0], grid[VEC_MODE[i]], int(ranks[i])
            plane = 0.1 * torch.randn((H, W, R), generator=g, device=device)
            line = 0.1 * torch.randn((L, R), generator=g, device=device)
            if field == "density" and segment.iteration > 0:
                # a late segment's field; the first segment starts from the
                # init draw alone, as a reconstruction does
                k = visible_ranks(cfg, R, segment.iteration)
                p, l = slab_profiles(occ, i, k, amp)
                plane[..., :k] += p
                line[:, :k] += l
            params[f"{field}_plane.{i}"] = plane
            params[f"{field}_line.{i}"] = line
    del occ
    fan = int(sum(cfg.n_lamb_sh))
    params["basis"] = uniform(g, (fan, cfg.data_dim_color), fan, device)
    d_in = (2 * cfg.view_pe * 3 + 2 * cfg.fea_pe * cfg.data_dim_color + 3 + cfg.data_dim_color)
    c = int(cfg.featureC)
    for name, (fi, fo) in (("l1", (d_in, c)), ("l2", (c, c)), ("l3", (c, 3))):
        params[f"render.{name}.w"] = uniform(g, (fi, fo), fi, device)
        params[f"render.{name}.b"] = (torch.zeros(fo, device=device) if name == "l3"
                                      else uniform(g, (fo,), fi, device))
    mask = None
    if segment.mask is not None:
        m_aabb, reso = segment.mask
        mask = mask_volume(occupancy_grid(scene, m_aabb, reso, device))
    return Made(segment, params, mask)


def uniform(g: torch.Generator, shape, fan_in: int, device) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * bound


def install(state, made: Made, log=lambda s: None) -> None:
    """Hand the made field, geometry and mask to the port's ``TrainState``,
    as the schedule's events would have left them, and give it the
    segment's fresh optimizer."""
    from torch import nn

    from tensorf_tpu_torch.models.alpha_mask import AlphaGridMask, with_dilation
    from tensorf_tpu_torch.models.config import GridGeometry
    from tensorf_tpu_torch.render.culling import filter_rays_alpha

    cfg, seg = state.cfg, made.segment
    field = state.field
    state.drop_optimizer()
    for name, t in made.params.items():
        parts = name.split(".")
        if parts[0] == "render":
            setattr(getattr(field.render, parts[1]), parts[2], nn.Parameter(t.clone()))
        elif len(parts) == 2:
            getattr(field, parts[0])[int(parts[1])] = nn.Parameter(t.clone())
        else:
            field.basis = nn.Parameter(t.clone())
    state.geometry = GridGeometry.create(seg.aabb, seg.grid, cfg.step_ratio)
    state.n_samples = seg.n_samples
    state.l1_weight = seg.l1_weight
    state.n_voxel_list = []
    if made.mask is not None:
        m_aabb = torch.as_tensor(seg.mask[0], device=state.device)
        state.alpha_mask = with_dilation(AlphaGridMask(m_aabb, made.mask.clone()))
    if seg.refilter is not None:
        state.rays, state.rgbs = filter_rays_alpha(
            state.rays, state.rgbs, state.alpha_mask, seg.refilter[0], seg.refilter[1],
            state.near_far)
        state.sampler = state.simple_sampler(seg.iteration)
    state.reset_optimizer(1.0)
