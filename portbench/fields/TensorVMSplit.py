"""TensorVMSplit's factor layout (``portbench/fields/__init__.py`` has the
interface): per axis i, a plane ``{kind}_plane.i`` (H, W, R_i) with
H = grid[MAT_MODE[i][1]], W = grid[MAT_MODE[i][0]], and a line
``{kind}_line.i`` (L, R_i) with L = grid[VEC_MODE[i]], for kind density
(``n_lamb_sigma``) and app (``n_lamb_sh``).

* density = sum over the axes and ranks of plane_ir(u, v) line_ir(w),
  bilinear / linear, align_corners, zeros outside; the appearance features
  are the concatenated plane x line products; FreeNeRF's decomposition
  masks multiply both factors of rank r.
* made factors: 0.1 randn, plane then line, axis by axis, density before
  appearance; in a late segment the density factors add signed slab
  profiles of the occupancy: rank r of axis i is +A on the columns of slab
  r that meet an object and -A on the others, times the slab's indicator
  along the line, so the sum over the three axes reaches 3A inside the
  objects and stays at or below A outside the visual hull of the slabs.
* regularizers: ortho over every line's rank Gram matrix, L1 over the
  density planes and lines, TV on the planes x 1e-2.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import bilinear, linear, tv2d

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
HAS_ORTHO = True


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


def make_factors(cfg, grid, occ, visible, amplitude: float, gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    params: Dict[str, torch.Tensor] = {}
    for field, ranks in (("density", cfg.n_lamb_sigma), ("app", cfg.n_lamb_sh)):
        for i, (m0, m1) in enumerate(MAT_MODE):
            H, W, L, R = grid[m1], grid[m0], grid[VEC_MODE[i]], int(ranks[i])
            plane = 0.1 * torch.randn((H, W, R), generator=gen, device=device)
            line = 0.1 * torch.randn((L, R), generator=gen, device=device)
            if field == "density" and occ is not None:
                k = visible(R)
                p, l = slab_profiles(occ, i, k, amplitude)
                plane[..., :k] += p
                line[:, :k] += l
            params[f"{field}_plane.{i}"] = plane
            params[f"{field}_line.{i}"] = line
    return params


def _products(P, kind: str, xyz: torch.Tensor, masks):
    out = []
    for i, (m0, m1) in enumerate(MAT_MODE):
        p = bilinear(P[f"{kind}_plane.{i}"], xyz[:, m0], xyz[:, m1])
        l = linear(P[f"{kind}_line.{i}"], xyz[:, VEC_MODE[i]])
        if masks is not None:
            p, l = p * masks[i], l * masks[i]
        out.append(p * l)
    return out


def density_feature(P, xyz: torch.Tensor, masks) -> torch.Tensor:
    return sum(torch.sum(x, dim=-1) for x in _products(P, "density", xyz, masks))


def app_features(P, xyz: torch.Tensor, masks) -> torch.Tensor:
    return torch.cat(_products(P, "app", xyz, masks), dim=-1)


def ortho(P, prec) -> torch.Tensor:
    reg = 0.0
    for line in [P[f"{k}_line.{i}"] for k in ("density", "app") for i in range(3)]:
        gram = prec.matmul(line.T, line)
        r = gram.shape[0]
        reg = reg + (torch.sum(torch.abs(gram)) - torch.sum(torch.abs(torch.diagonal(gram)))
                     ) / (r * r - r)
    return reg


def l1(P) -> torch.Tensor:
    return sum(torch.mean(torch.abs(P[f"density_{k}.{i}"]))
               for i in range(3) for k in ("plane", "line"))


def tv(P, kind: str) -> torch.Tensor:
    return sum(tv2d(P[f"{kind}_plane.{i}"]) * 1e-2 for i in range(3))


def density_flops(cfg) -> int:
    """Per axis with R ranks: a bilinear plane read (4 taps) and a linear
    line read (2 taps), a multiply-add each, their product and the sum over
    ranks: (2*4 + 2*2 + 1 + 1) R."""
    return sum(14 * int(r) for r in cfg.n_lamb_sigma)


def app_read_flops(cfg) -> int:
    """The same reads and products of the appearance ranks, no sum."""
    return sum(13 * int(r) for r in cfg.n_lamb_sh)
