"""Tensor factorizations: TensorVMSplit (counterpart of
tensorf_tpu/models/tensorf.py), with the shape-changing schedule events
(upsample, shrink).  TensorCP and TensorVM are not ported yet.

Layout, as in the JAX package:
  * plane factor i: (H, W, R) with H = grid[mat_mode[i][1]],
    W = grid[mat_mode[i][0]];
  * line factor i: (L, R) with L = grid[vec_mode[i]].

Init scales follow the reference: 0.1·randn for planes and lines, and a
bias-free linear basis with torch's default init.  Random init draws from
a CPU generator, so a seed gives the same field on every device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.grid_sample import (
    footprint_sample_2d,
    grid_sample_1d,
    grid_sample_2d,
    line_sample_matmul,
    make_footprint_2d,
)
from ..ops.resize import resize_bilinear_align_corners, resize_linear_align_corners
from ..utils.device import resolve_device
from .config import MAT_MODE, VEC_MODE, ModelConfig
from .shading import init_shading

# Lines up to this length sample as a one-hot-lerp matmul, as in the JAX
# package; longer lines take a footprint gather there, not ported yet.
_LINE_MATMUL_MAX_LEN = 1024


def _sample_line_packed(lpacked: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    if lpacked.shape[0] > _LINE_MATMUL_MAX_LEN:
        raise NotImplementedError(
            f"lines longer than {_LINE_MATMUL_MAX_LEN} (footprint_sample_1d) "
            "are not ported yet"
        )
    return line_sample_matmul(lpacked, coord)


def _off_diag_mean_abs(line: torch.Tensor) -> torch.Tensor:
    """Mean |off-diagonal| of the rank Gram matrix of one (L, R) line."""
    a = line.T
    gram = a @ a.T
    r = gram.shape[0]
    off = torch.sum(torch.abs(gram)) - torch.sum(torch.abs(torch.diagonal(gram)))
    return off / (r * r - r)


def _tv_2d(plane: torch.Tensor) -> torch.Tensor:
    """Anisotropic squared-difference TV on an (H, W, C) plane; the counts
    include the channel dimension, as the reference's TVLoss does."""
    H, W, C = plane.shape
    h_tv = torch.sum(torch.square(plane[1:] - plane[:-1]))
    w_tv = torch.sum(torch.square(plane[:, 1:] - plane[:, :-1]))
    return 2.0 * (h_tv / ((H - 1) * W * C) + w_tv / (H * (W - 1) * C))


def _plane_shapes(ranks, grid_size):
    for i, (m0, m1) in enumerate(MAT_MODE):
        yield i, grid_size[m1], grid_size[m0], ranks[i]


class TensorVMSplit(nn.Module):
    """Per-axis plane+line factors, separate density/appearance grids.

    Parameters (state-dict names match the JAX params' flat keys with
    '/' -> '.'): ``density_plane.i``, ``density_line.i``, ``app_plane.i``,
    ``app_line.i``, ``basis (sum(app_n_comp), app_dim)`` and the shading
    MLP under ``render``.
    """

    name = "TensorVMSplit"
    has_ortho = True

    def __init__(
        self,
        cfg: ModelConfig,
        grid_size,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if cfg.model_name != self.name:
            raise NotImplementedError(f"model {cfg.model_name!r} is not ported yet")
        if cfg.grid_dtype != "float32" or cfg.line_dtype != "float32":
            raise NotImplementedError("factor grids and lines run in float32 only")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        grid_size = tuple(int(g) for g in grid_size)

        def normal(*shape):
            return nn.Parameter(0.1 * torch.randn(shape, generator=generator))

        for field, ranks in (("density", cfg.density_n_comp), ("app", cfg.app_n_comp)):
            planes, lines = [], []
            for i, H, W, R in _plane_shapes(ranks, grid_size):
                planes.append(normal(H, W, R))
                lines.append(normal(grid_size[VEC_MODE[i]], R))
            setattr(self, f"{field}_plane", nn.ParameterList(planes))
            setattr(self, f"{field}_line", nn.ParameterList(lines))
        fan_in = sum(cfg.app_n_comp)
        bound = 1.0 / math.sqrt(fan_in)
        self.basis = nn.Parameter(
            (torch.rand((fan_in, cfg.app_dim), generator=generator) * 2.0 - 1.0) * bound
        )
        self.render = init_shading(cfg, generator)
        self.to(device)

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        # line i spans grid axis VEC_MODE[i]; VEC_MODE = (2, 1, 0).
        ls = [self.density_line[i].shape[0] for i in range(3)]
        return (ls[2], ls[1], ls[0])

    # ---- features ---------------------------------------------------------

    def density_feature(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        """xyz (M, 3) normalized -> (M,), one grid_sample per factor."""
        feat = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p = grid_sample_2d(self.density_plane[i], xyz[..., [m0, m1]])
            l = grid_sample_1d(self.density_line[i], xyz[..., VEC_MODE[i]])
            if mask is not None:
                # mask applied to both factors (squared), as the reference intends
                p = p * mask[i]
                l = l * mask[i]
            feat = feat + torch.sum(p * l, dim=-1)
        return feat

    def app_feature(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        """xyz (M, 3) -> (M, app_dim), one grid_sample per factor."""
        coefs = []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p = grid_sample_2d(self.app_plane[i], xyz[..., [m0, m1]])
            l = grid_sample_1d(self.app_line[i], xyz[..., VEC_MODE[i]])
            if mask is not None:
                p = p * mask[i]
                l = l * mask[i]
            coefs.append(p * l)
        return torch.cat(coefs, dim=-1) @ self.basis

    def fused_features(self, xyz: torch.Tensor, den_mask, app_mask):
        """One gather pass -> (density_feature (M,), app_feature (M, app_dim)).

        Per axis, density+appearance planes are packed channel-wise into one
        footprint table, so each sample gathers 3 plane rows and 3 line
        matmul rows.  Equal to density_feature + app_feature for in-bbox
        samples.
        """
        den_feat = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
        app_coefs = []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            rd = self.cfg.density_n_comp[i]
            packed = torch.cat([self.density_plane[i], self.app_plane[i]], dim=-1)
            H, W, _ = packed.shape
            pv = footprint_sample_2d(make_footprint_2d(packed), H, W, xyz[..., [m0, m1]])
            lpacked = torch.cat([self.density_line[i], self.app_line[i]], dim=-1)
            lv = _sample_line_packed(lpacked, xyz[..., VEC_MODE[i]])
            dp, ap = pv[..., :rd], pv[..., rd:]
            dl, al = lv[..., :rd], lv[..., rd:]
            if den_mask is not None:
                dp = dp * den_mask[i]
                dl = dl * den_mask[i]
            if app_mask is not None:
                ap = ap * app_mask[i]
                al = al * app_mask[i]
            den_feat = den_feat + torch.sum(dp * dl, dim=-1)
            app_coefs.append(ap * al)
        return den_feat, torch.cat(app_coefs, dim=-1) @ self.basis

    def density_feature_fused(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        """Density-only footprint path: 3 plane rows + 3 line matmuls."""
        feat = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane = self.density_plane[i]
            H, W, _ = plane.shape
            p = footprint_sample_2d(make_footprint_2d(plane), H, W, xyz[..., [m0, m1]])
            l = _sample_line_packed(self.density_line[i], xyz[..., VEC_MODE[i]])
            if mask is not None:
                p = p * mask[i]
                l = l * mask[i]
            feat = feat + torch.sum(p * l, dim=-1)
        return feat

    def app_feature_fused(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        """Appearance-only footprint path (see density_feature_fused)."""
        coefs = []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane = self.app_plane[i]
            H, W, _ = plane.shape
            p = footprint_sample_2d(make_footprint_2d(plane), H, W, xyz[..., [m0, m1]])
            l = _sample_line_packed(self.app_line[i], xyz[..., VEC_MODE[i]])
            if mask is not None:
                p = p * mask[i]
                l = l * mask[i]
            coefs.append(p * l)
        return torch.cat(coefs, dim=-1) @ self.basis

    # ---- regularizers -----------------------------------------------------

    def ortho_reg(self) -> torch.Tensor:
        return sum(_off_diag_mean_abs(l) for l in [*self.density_line, *self.app_line])

    def density_l1(self) -> torch.Tensor:
        total = 0.0
        for i in range(3):
            total = total + torch.mean(torch.abs(self.density_plane[i]))
            total = total + torch.mean(torch.abs(self.density_line[i]))
        return total

    def tv_density(self) -> torch.Tensor:
        # Planes only, with the in-model 1e-2 factor (reference tensoRF.py:195-199).
        return sum(_tv_2d(p) * 1e-2 for p in self.density_plane)

    def tv_app(self) -> torch.Tensor:
        return sum(_tv_2d(p) * 1e-2 for p in self.app_plane)

    # ---- shape-changing schedule events -----------------------------------
    # Each replaces the factor Parameters with new ones (an optimizer built
    # before the event holds the old ones and must be rebuilt).

    def _replace_factors(self, make_plane, make_line) -> None:
        for field in ("density", "app"):
            planes = getattr(self, f"{field}_plane")
            lines = getattr(self, f"{field}_line")
            for i in range(3):
                planes[i] = nn.Parameter(make_plane(i, planes[i].detach()))
                lines[i] = nn.Parameter(make_line(i, lines[i].detach()))

    @torch.no_grad()
    def upsample(self, grid_size) -> None:
        """Bilinear align_corners resize of every factor to ``grid_size``
        (X, Y, Z) (reference tensoRF.py:267-288)."""
        g = tuple(int(v) for v in grid_size)
        self._replace_factors(
            lambda i, p: resize_bilinear_align_corners(p, g[MAT_MODE[i][1]], g[MAT_MODE[i][0]]),
            lambda i, l: resize_linear_align_corners(l, g[VEC_MODE[i]]),
        )

    @torch.no_grad()
    def shrink(self, t_l, b_r) -> None:
        """Voxel-aligned crop of every factor to [t_l, b_r) per axis
        (reference tensoRF.py:290-314)."""

        def plane(i, p):
            m0, m1 = MAT_MODE[i]
            return p[t_l[m1] : b_r[m1], t_l[m0] : b_r[m0], :].clone()

        def line(i, l):
            return l[t_l[VEC_MODE[i]] : b_r[VEC_MODE[i]], :].clone()

        self._replace_factors(plane, line)


FIELD_MODELS = {TensorVMSplit.name: TensorVMSplit}


def spatial_label_tree(field: nn.Module) -> Dict[str, str]:
    """Optimizer group of each parameter: 'spatial' for planes and lines,
    'network' for the rest (the basis and the shading MLP)."""

    def label_for(top: str) -> str:
        return "spatial" if ("plane" in top or "line" in top) else "network"

    return {name: label_for(name.split(".")[0]) for name, _ in field.named_parameters()}
