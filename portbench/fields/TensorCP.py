"""TensorCP's factor layout (``portbench/fields/__init__.py`` has the
interface): per axis i, a line ``{kind}_line.i`` (L, R) with
L = grid[VEC_MODE[i]], for kind density (R = ``n_lamb_sigma[0]``) and app
(R = ``n_lamb_sh[0]``); no planes.

* density = sum over the ranks r of line_0r(z) line_1r(y) line_2r(x),
  each linear, align_corners, zeros outside; the appearance features are
  the R products themselves, which the reference multiplies by the basis.
* made factors: 0.2 randn, line by line, axis 0..2, density before
  appearance; in a late segment the first ``visible(R)`` density ranks
  add a profile of the occupancy, one slab each (below).
* regularizers: no ortho term; L1 over the three density lines; TV on the
  lines, 1-D, x 1e-3.

Departures from apchenstu/TensoRF ``models/tensoRF.py::TensorCP``, each
the FreeNeRF fork's that the port follows
(``tensorf_tpu_torch/models/tensorf.py::TensorCP``): FreeNeRF's rank mask
multiplies the product of the three lines once, its one entry over the R
ranks (upstream has no rank mask); the lines are channels-last (L, R)
instead of (1, R, L, 1); the lines' TV term (2 x the squared differences
over (L - 1) R, x 1e-3) is the fork's, and counts only because the
configuration gives it the fork's weights (upstream's ``configs/lego.txt``
sets none).

The made profile.  The density ranks 0..k-1 (k = ``visible(R)``) each take
one slab of the line along grid axis ``VEC_MODE[0]`` (z): slab r is the
r-th of k equal runs of texels.  Rank r's three lines add (3A)^(1/3) on
the slab along that axis and, along each other axis, on the run of texels
between the first and the last occupied lattice point inside the slab; a
slab with no occupied point adds nothing.  The slabs are disjoint, so the
density feature reaches 3A throughout each slab's bounding box of the
objects: a box, not the objects, so it covers more than they do (the alpha
mask still gates every sample to the dilated occupancy).
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import linear

VEC_MODE = (2, 1, 0)
HAS_ORTHO = False
# the made profile's slabs run along the line of axis 0
SLAB_LINE = 0


def _extent(occ: torch.Tensor, dim: int) -> torch.Tensor:
    """(n,) bool: the texels along ``dim`` from the first to the last one
    that ``occ`` (any dims) holds set."""
    others = tuple(d for d in range(occ.dim()) if d != dim)
    hit = occ.any(dim=others) if others else occ
    idx = torch.nonzero(hit).squeeze(-1)
    run = torch.zeros_like(hit)
    if idx.numel():
        run[int(idx.min()):int(idx.max()) + 1] = True
    return run


def slab_profiles(occ_xyz: torch.Tensor, ranks: int, amplitude: float):
    """The made profile's three lines, ``[(L_i, ranks)]`` in axis order:
    rank r is the product of one indicator a line, each (3A)^(1/3)."""
    a = VEC_MODE[SLAB_LINE]
    L = occ_xyz.shape[a]
    scale = (3.0 * amplitude) ** (1.0 / 3.0)
    lines = [torch.zeros(occ_xyz.shape[VEC_MODE[i]], ranks, device=occ_xyz.device)
             for i in range(3)]
    for r in range(ranks):
        lo, hi = r * L // ranks, max((r + 1) * L // ranks, r * L // ranks + 1)
        sl = [slice(None)] * 3
        sl[a] = slice(lo, hi)
        part = occ_xyz[tuple(sl)]
        if not bool(part.any()):
            continue
        lines[SLAB_LINE][lo:hi, r] = scale
        for i in range(3):
            if i != SLAB_LINE:
                lines[i][:, r] = scale * _extent(part, VEC_MODE[i]).float()
    return lines


def make_factors(cfg, grid, occ, visible, amplitude: float, gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    params: Dict[str, torch.Tensor] = {}
    for field, ranks in (("density", cfg.n_lamb_sigma), ("app", cfg.n_lamb_sh)):
        R = int(ranks[0])
        for i in range(3):
            params[f"{field}_line.{i}"] = 0.2 * torch.randn((grid[VEC_MODE[i]], R),
                                                            generator=gen, device=device)
        if field == "density" and occ is not None:
            k = visible(R)
            for i, prof in enumerate(slab_profiles(occ, k, amplitude)):
                params[f"density_line.{i}"][:, :k] += prof
    return params


def _product(P, kind: str, xyz: torch.Tensor, masks) -> torch.Tensor:
    prod = linear(P[f"{kind}_line.0"], xyz[:, VEC_MODE[0]])
    prod = prod * linear(P[f"{kind}_line.1"], xyz[:, VEC_MODE[1]])
    prod = prod * linear(P[f"{kind}_line.2"], xyz[:, VEC_MODE[2]])
    return prod if masks is None else prod * masks[0]


def density_feature(P, xyz: torch.Tensor, masks) -> torch.Tensor:
    return torch.sum(_product(P, "density", xyz, masks), dim=-1)


def app_features(P, xyz: torch.Tensor, masks) -> torch.Tensor:
    return _product(P, "app", xyz, masks)


def ortho(P, prec) -> torch.Tensor:
    raise ValueError("TensorCP has no ortho term (HAS_ORTHO is False)")


def l1(P) -> torch.Tensor:
    return sum(torch.mean(torch.abs(P[f"density_line.{i}"])) for i in range(3))


def tv(P, kind: str) -> torch.Tensor:
    total = 0.0
    for i in range(3):
        line = P[f"{kind}_line.{i}"]
        L, C = line.shape
        total = total + 2.0 * torch.sum(torch.square(line[1:] - line[:-1])) / ((L - 1) * C) * 1e-3
    return total


def density_flops(cfg) -> int:
    """Per rank: three linear line reads (2 taps, a multiply-add each), the
    two multiplies of their product, and the add of the sum over ranks:
    (3*2*2 + 2 + 1) R."""
    return 15 * int(cfg.n_lamb_sigma[0])


def app_read_flops(cfg) -> int:
    """The same reads and products of the appearance ranks, no sum:
    (3*2*2 + 2) R."""
    return 14 * int(cfg.n_lamb_sh[0])
