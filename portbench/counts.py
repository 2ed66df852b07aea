"""Operations and bytes the model's work needs, from the configuration's
widths and the cell's inputs, never from the program's internals, so the
count reads the same work whatever implements it.

FLOPs a sample (a multiply-add counts 2):
* density: per axis i with R_i ranks, a bilinear plane read (4 taps) and a
  linear line read (2 taps) of R_i channels, their product and the sum
  over ranks: (2*4 + 2*2 + 1 + 1) R_i;
* appearance: the same reads and products of the appearance ranks, then
  the basis (sum R_app x app_dim) and the shading MLP (its three layers);
  a shaded sample pays density and appearance.
A training step's backward counts twice its forward.

The scatter-add's bytes bound (chip_smoke.py's ``kernel_case``): each
gradient row read once at ``s`` bytes a channel, each index once at 4
bytes, and the output table written once in float32.
"""

from __future__ import annotations

# the H100 SXM's published dense peaks (700 W)
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def density_flops(density_ranks) -> int:
    return sum(14 * int(r) for r in density_ranks)


def mlp_in(view_pe: int, fea_pe: int, app_dim: int) -> int:
    return 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim


def shade_flops(app_ranks, app_dim: int, view_pe: int, fea_pe: int, width: int) -> int:
    reads = sum(13 * int(r) for r in app_ranks)
    basis = 2 * int(sum(app_ranks)) * app_dim
    d_in = mlp_in(view_pe, fea_pe, app_dim)
    mlp = 2 * (d_in * width + width * width + width * 3)
    return reads + basis + mlp


def forward_flops(cfg, alive: int, shaded: int) -> int:
    """Forward FLOPs of ``alive`` density samples of which ``shaded`` are
    shaded, for a TrainConfig-like ``cfg``."""
    return (alive * density_flops(cfg.n_lamb_sigma)
            + shaded * shade_flops(cfg.n_lamb_sh, cfg.data_dim_color, cfg.view_pe, cfg.fea_pe,
                                   cfg.featureC))


def step_flops(cfg, alive: int, shaded: int) -> int:
    """A training step: the forward and a backward of twice its cost."""
    return 3 * forward_flops(cfg, alive, shaded)


def scatter_bound_bytes(m: int, c: int, elem: int, n_rows: int) -> int:
    """The scatter-add's least traffic: M rows of C channels at ``elem``
    bytes, M int32 indices, the (n_rows, C) float32 output."""
    return m * c * elem + m * 4 + n_rows * c * 4
