"""Tensor factorizations (counterpart of tensorf_tpu/models/tensorf.py):
TensorVMSplit, TensorCP and TensorVM, with the shape-changing schedule
events (upsample, shrink).

Layout, as in the JAX package:
  * plane factor i: (H, W, R) with H = grid[mat_mode[i][1]],
    W = grid[mat_mode[i][0]];
  * line factor i: (L, R) with L = grid[vec_mode[i]].

Init scales follow the reference: 0.1·randn for VM planes and lines,
0.2·randn for CP lines, and a bias-free linear basis with torch's default
init.  Random init draws from a CPU generator, so a seed gives the same
field on every device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.grid_sample import (
    footprint_sample_1d,
    footprint_sample_2d,
    grid_sample_1d,
    grid_sample_2d,
    line_sample_matmul,
    make_footprint_1d,
    make_footprint_2d,
)
from ..ops.line_lerp import line_lerp
from ..ops.resize import resize_bilinear_align_corners, resize_linear_align_corners
from ..utils import tracing
from ..utils.device import resolve_device
from .config import MAT_MODE, VEC_MODE, ModelConfig
from .shading import init_shading, torch_dtype

# A line samples as a one-hot-lerp matmul, as the JAX package samples
# lines up to _LINE_MATMUL_MAX_LEN, while its (M, L) one-hot matrix stays
# within _ONE_HOT_MAX_BYTES at its element size (4 B in float32, 2 B when
# ``line_dtype`` or ``grid_dtype`` is bfloat16): eager PyTorch materializes
# that matrix (and about twice it again while building it, and a float32
# copy of a bf16 one inside each product) and keeps it for the backward.
# Above either bound the line takes the 2-tap footprint gather, whose
# backward is the row scatter-add.  6 GiB is above every float32 one-hot
# the synth_full, synth_sphere and lego paths build (the largest: the
# unstratified last segment's 4,292,608 samples x 345 x 4 B = 5.92e9 B) and
# below the ones of flower's last two segments (6,336,512 x 315 x 4 B =
# 7.98e9 B and up).  In bf16 the same bound keeps twice the points: flower's
# 351..400 segment (6,336,512 samples) samples its lines of 315 and 472
# texels by the one-hot (3.99e9 and 5.98e9 B) and that of 526 by the
# footprint (6.67e9 B); its last segment (9,474,048 samples; 471, 706, 786
# texels: 8.92e9 B and up) takes the footprint throughout.  On the card a
# float32 read within both bounds builds no matrix: it takes the line-lerp
# kernel (``_sample_line_packed``), and the bounds still decide which reads
# do.
_LINE_MATMUL_MAX_LEN = 1024
_ONE_HOT_MAX_BYTES = 6 * 2**30


def line_a_dtype(cfg: ModelConfig) -> Optional[torch.dtype]:
    """The one-hot matrix dtype of line matmuls: bfloat16 when the model
    opts in through ``line_dtype`` (or the legacy blanket ``grid_dtype``),
    else None (float32), as JAX's tensorf.py::_line_a_dtype."""
    for name in (cfg.line_dtype, cfg.grid_dtype):
        if torch_dtype(name) == torch.bfloat16:
            return torch.bfloat16
    return None


def line_uses_matmul(n_points: int, length: int, a_dtype: Optional[torch.dtype] = None) -> bool:
    """Whether sampling a line of ``length`` at ``n_points`` points takes
    the one-hot matmul (else the footprint gather); ``a_dtype`` is the
    one-hot's dtype (None: float32)."""
    size = 2 if a_dtype == torch.bfloat16 else 4
    return length <= _LINE_MATMUL_MAX_LEN and n_points * length * size <= _ONE_HOT_MAX_BYTES


# Every line read runs inside the span ``tftorch.field.line`` and, while a
# profiler runs, records its shape as ``line``: (points, texels, channels,
# route), route 1 for the one-hot matmul, 2 for the line-lerp kernel and 0
# for the taps or the footprint gather (utils/tracing.py).
LINE_SPAN = "tftorch.field.line"


def _sample_line_packed(lpacked: torch.Tensor, coord: torch.Tensor,
                        a_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    L, C = lpacked.shape
    matmul = line_uses_matmul(coord.numel(), L, a_dtype)
    # on the card a float32 read that the one-hot would take reads its two
    # texels by the line-lerp kernel (ops/line_lerp.py); the CPU keeps the
    # one-hot, the JAX package's arithmetic
    lerp = matmul and a_dtype is None and lpacked.is_cuda
    with tracing.span(LINE_SPAN):
        if tracing.enabled():
            tracing.count_shape("line", (coord.numel(), L, C, 2 if lerp else int(matmul)))
        if lerp:
            return line_lerp(lpacked, coord)
        if matmul:
            return line_sample_matmul(lpacked, coord, a_dtype)
        return footprint_sample_1d(make_footprint_1d(lpacked), L, coord)


def _line_taps(line: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """A line read by its two taps a point (grid_sample_1d)."""
    with tracing.span(LINE_SPAN):
        if tracing.enabled():
            tracing.count_shape("line", (coord.numel(), *line.shape, 0))
        return grid_sample_1d(line, coord)


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


def _tv_1d(line: torch.Tensor) -> torch.Tensor:
    """TV over the length axis of an (L, C) line: the reference's TVLoss on
    a (1, R, L, 1) line, whose degenerate width term (0/0) is left out, as
    the JAX package leaves it out."""
    L, C = line.shape
    return 2.0 * (torch.sum(torch.square(line[1:] - line[:-1])) / ((L - 1) * C))


def _plane_shapes(ranks, grid_size):
    for i, (m0, m1) in enumerate(MAT_MODE):
        yield i, grid_size[m1], grid_size[m0], ranks[i]


class _Field(nn.Module):
    """What the factorizations share: the config checks, the factor lists
    the schedule events act on (``PLANES`` and ``LINES``, ParameterLists of
    three per axis), the grid size they span, upsample and shrink."""

    name = "base"
    PLANES: Tuple[str, ...] = ()
    LINES: Tuple[str, ...] = ()

    def _setup(self, cfg: ModelConfig, device, generator):
        if cfg.model_name != self.name:
            raise ValueError(f"a {cfg.model_name!r} config given to {self.name}")
        # an unknown dtype name is refused here (the shading head checks ``dtype``)
        for name in (cfg.grid_dtype, cfg.line_dtype):
            torch_dtype(name)
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return resolve_device(device), generator

    def _basis(self, fan_in: int, generator: torch.Generator) -> nn.Parameter:
        bound = 1.0 / math.sqrt(fan_in)
        return nn.Parameter(
            (torch.rand((fan_in, self.cfg.app_dim), generator=generator) * 2.0 - 1.0) * bound
        )

    # Parameters, Adam state, regularizers and checkpoints stay float32; the
    # fused feature paths cast the plane tables to grid_dtype (TensorVMSplit)
    # and the line one-hot to line_a_dtype (every model), as the JAX
    # package does.
    @property
    def grid_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.grid_dtype)

    @property
    def line_a_dtype(self) -> Optional[torch.dtype]:
        return line_a_dtype(self.cfg)

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        # line i spans grid axis VEC_MODE[i]; VEC_MODE = (2, 1, 0).
        lines = getattr(self, self.LINES[0])
        ls = [lines[i].shape[0] for i in range(3)]
        return (ls[2], ls[1], ls[0])

    # ---- shape-changing schedule events -----------------------------------
    # Each replaces the factor Parameters with new ones (an optimizer built
    # before the event holds the old ones and must be rebuilt).

    def _replace_factors(self, make_plane, make_line) -> None:
        for names, make in ((self.PLANES, make_plane), (self.LINES, make_line)):
            for name in names:
                factors = getattr(self, name)
                for i in range(3):
                    factors[i] = nn.Parameter(make(i, factors[i].detach()))

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


class TensorVMSplit(_Field):
    """Per-axis plane+line factors, separate density/appearance grids.

    Parameters (state-dict names match the JAX params' flat keys with
    '/' -> '.'): ``density_plane.i``, ``density_line.i``, ``app_plane.i``,
    ``app_line.i``, ``basis (sum(app_n_comp), app_dim)`` and the shading
    MLP under ``render``.
    """

    name = "TensorVMSplit"
    has_ortho = True
    PLANES = ("density_plane", "app_plane")
    LINES = ("density_line", "app_line")

    def __init__(
        self,
        cfg: ModelConfig,
        grid_size,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device, generator = self._setup(cfg, device, generator)
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
        self.basis = self._basis(sum(cfg.app_n_comp), generator)
        self.render = init_shading(cfg, generator)
        self.to(device)

    # ---- features ---------------------------------------------------------

    def density_feature(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        """xyz (M, 3) normalized -> (M,), one grid_sample per factor."""
        feat = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p = grid_sample_2d(self.density_plane[i], xyz[..., [m0, m1]])
            l = _line_taps(self.density_line[i], xyz[..., VEC_MODE[i]])
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
            l = _line_taps(self.app_line[i], xyz[..., VEC_MODE[i]])
            if mask is not None:
                p = p * mask[i]
                l = l * mask[i]
            coefs.append(p * l)
        return torch.cat(coefs, dim=-1) @ self.basis

    def density_feature_fused(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        """Density-only footprint path: 3 plane rows + 3 line matmuls."""
        feat = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane = self.density_plane[i].to(self.grid_dtype)
            H, W, _ = plane.shape
            p = footprint_sample_2d(make_footprint_2d(plane), H, W, xyz[..., [m0, m1]])
            l = _sample_line_packed(self.density_line[i], xyz[..., VEC_MODE[i]],
                                    self.line_a_dtype)
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
            plane = self.app_plane[i].to(self.grid_dtype)
            H, W, _ = plane.shape
            p = footprint_sample_2d(make_footprint_2d(plane), H, W, xyz[..., [m0, m1]])
            l = _sample_line_packed(self.app_line[i], xyz[..., VEC_MODE[i]], self.line_a_dtype)
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


class TensorCP(_Field):
    """Rank-R CP decomposition: three line factors per field (reference
    tensoRF.py:330-484).

    Parameters: ``density_line.i (L, R_den)``, ``app_line.i (L, R_app)``,
    ``basis (R_app, app_dim)`` and the shading head under ``render``.  The
    ranks are the first entries of the config's per-axis lists.
    """

    name = "TensorCP"
    has_ortho = False
    LINES = ("density_line", "app_line")

    def __init__(self, cfg: ModelConfig, grid_size, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device, generator = self._setup(cfg, device, generator)
        grid_size = tuple(int(g) for g in grid_size)
        for field, r in (("density", cfg.density_n_comp[0]), ("app", cfg.app_n_comp[0])):
            setattr(self, f"{field}_line", nn.ParameterList(
                nn.Parameter(0.2 * torch.randn((grid_size[VEC_MODE[i]], r), generator=generator))
                for i in range(3)))
        self.basis = self._basis(cfg.app_n_comp[0], generator)
        self.render = init_shading(cfg, generator)
        self.to(device)

    @staticmethod
    def _line_product(lines, xyz: torch.Tensor) -> torch.Tensor:
        prod = _line_taps(lines[0], xyz[..., VEC_MODE[0]])
        prod = prod * _line_taps(lines[1], xyz[..., VEC_MODE[1]])
        return prod * _line_taps(lines[2], xyz[..., VEC_MODE[2]])  # (M, R)

    def _line_product_fused(self, lines, xyz: torch.Tensor) -> torch.Tensor:
        prod = None
        for i in range(3):
            lv = _sample_line_packed(lines[i], xyz[..., VEC_MODE[i]], self.line_a_dtype)
            prod = lv if prod is None else prod * lv
        return prod

    # The FreeNeRF rank mask applies once, its first axis's entry, to the
    # product of the three lines (JAX tensorf.py:400-402, :430-433).

    def density_feature(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        prod = self._line_product(self.density_line, xyz)
        if mask is not None:
            prod = prod * mask[0]
        return torch.sum(prod, dim=-1)

    def app_feature(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        prod = self._line_product(self.app_line, xyz)
        if mask is not None:
            prod = prod * mask[0]
        return prod @ self.basis

    def density_feature_fused(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        """Lines only: already the matmul path."""
        prod = self._line_product_fused(self.density_line, xyz)
        if mask is not None:
            prod = prod * mask[0]
        return torch.sum(prod, dim=-1)

    def app_feature_fused(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        prod = self._line_product_fused(self.app_line, xyz)
        if mask is not None:
            prod = prod * mask[0]
        return prod @ self.basis

    def density_l1(self) -> torch.Tensor:
        return sum(torch.mean(torch.abs(l)) for l in self.density_line)

    def tv_density(self) -> torch.Tensor:
        # CP's in-model factor is 1e-3 (reference tensoRF.py:474-478)
        return sum(_tv_1d(l) * 1e-3 for l in self.density_line)

    def tv_app(self) -> torch.Tensor:
        return sum(_tv_1d(l) * 1e-3 for l in self.app_line)


class TensorVM(_Field):
    """The legacy shared-tensor VM variant (reference tensoRF.py:6-138):
    one plane and one line per axis, each of ``R_app + R_den`` channels,
    appearance in ``[:R_app]`` and density in ``[-R_den:]``.

    Parameters: ``plane.i (H, W, R_app + R_den)``, ``line.i (L, R_app +
    R_den)``, ``basis (3 R_app, app_dim)`` and the shading head under
    ``render``.  Per-axis factors, as in the JAX package, so shrink crops
    each axis on its own.

    Its features ignore the FreeNeRF rank masks: the JAX package's
    TensorVM never reads them (tensorf.py:554-628), and the port keeps
    that.
    """

    name = "TensorVM"
    has_ortho = True
    PLANES = ("plane",)
    LINES = ("line",)

    def __init__(self, cfg: ModelConfig, grid_size, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device, generator = self._setup(cfg, device, generator)
        grid_size = tuple(int(g) for g in grid_size)
        r = cfg.app_n_comp[0] + cfg.density_n_comp[0]

        def normal(*shape):
            return nn.Parameter(0.1 * torch.randn(shape, generator=generator))

        self.plane = nn.ParameterList(normal(H, W, r) for _, H, W, _ in
                                      _plane_shapes((r,) * 3, grid_size))
        self.line = nn.ParameterList(normal(grid_size[VEC_MODE[i]], r) for i in range(3))
        self.basis = self._basis(3 * cfg.app_n_comp[0], generator)
        self.render = init_shading(cfg, generator)
        self.to(device)

    # Every feature method below takes the rank masks and reads none, as
    # the JAX package's TensorVM (tensorf.py:554-628).

    def _gather(self, xyz: torch.Tensor, lo: int, hi: int):
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p = grid_sample_2d(self.plane[i][:, :, lo:hi], xyz[..., [m0, m1]])
            l = _line_taps(self.line[i][:, lo:hi], xyz[..., VEC_MODE[i]])
            yield p * l

    def _fused(self, xyz: torch.Tensor, lo: int, hi: int):
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane = self.plane[i][:, :, lo:hi]
            H, W, _ = plane.shape
            p = footprint_sample_2d(make_footprint_2d(plane), H, W, xyz[..., [m0, m1]])
            l = _sample_line_packed(self.line[i][:, lo:hi], xyz[..., VEC_MODE[i]],
                                    self.line_a_dtype)
            yield p * l

    def density_feature(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        r = self.plane[0].shape[-1]
        feat = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
        for pl in self._gather(xyz, r - self.cfg.density_n_comp[0], r):
            feat = feat + torch.sum(pl, dim=-1)
        return feat

    def app_feature(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        return torch.cat(list(self._gather(xyz, 0, self.cfg.app_n_comp[0])), dim=-1) @ self.basis

    def density_feature_fused(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        """The density channel range's own footprint tables."""
        r = self.plane[0].shape[-1]
        feat = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
        for pl in self._fused(xyz, r - self.cfg.density_n_comp[0], r):
            feat = feat + torch.sum(pl, dim=-1)
        return feat

    def app_feature_fused(self, xyz: torch.Tensor, mask) -> torch.Tensor:
        return torch.cat(list(self._fused(xyz, 0, self.cfg.app_n_comp[0])), dim=-1) @ self.basis

    def ortho_reg(self) -> torch.Tensor:
        return sum(_off_diag_mean_abs(l) for l in self.line)

    def density_l1(self) -> torch.Tensor:
        # mean |.| over all plane entries plus over all line entries, whose
        # per-axis shapes differ (JAX tensorf.py:638-646)
        p_sum = sum(torch.sum(torch.abs(p)) for p in self.plane)
        l_sum = sum(torch.sum(torch.abs(l)) for l in self.line)
        return (p_sum / sum(p.numel() for p in self.plane)
                + l_sum / sum(l.numel() for l in self.line))

    def tv_density(self) -> torch.Tensor:
        return sum(_tv_2d(p) * 1e-2 for p in self.plane)

    def tv_app(self) -> torch.Tensor:
        return torch.zeros((), device=self.basis.device)


FIELD_MODELS = {m.name: m for m in (TensorVMSplit, TensorCP, TensorVM)}


def spatial_label_tree(field: nn.Module) -> Dict[str, str]:
    """Optimizer group of each parameter: 'spatial' for planes and lines,
    'network' for the rest (the basis and the shading MLP)."""

    def label_for(top: str) -> str:
        return "spatial" if ("plane" in top or "line" in top) else "network"

    return {name: label_for(name.split(".")[0]) for name, _ in field.named_parameters()}
