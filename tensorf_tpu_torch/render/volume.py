"""Fixed-shape masked volume renderer (counterpart of
tensorf_tpu/render/volume.py).

Dead samples contribute exactly zero density / radiance through ``where``
gates.  With an alpha mask, a sample lives only where the mask's
nearest-neighbour gate is set; where that gate runs over the whole lattice
(no budget), the density runs on just the live samples, compacted to rows
(a read-back of their number), and every other slot's sigma is zero.  A
``sample_budget`` K below the lattice compacts each ray to its K nearest
candidate samples before the field is queried (the reference's boolean
compaction, with a fixed K): exact whenever K covers every candidate, and
``budget_overflow_frac`` reports the rays where it does not.  Shading runs
only where the weight passes ``ray_march_weight_thres``: on exactly those
samples, compacted to rows (one read-back of their number a render, the
other shape here that the data sets), or (``shade_top_k``) on the top-K
weights per ray, gated.
Serving renders take their candidate windows from the count pass's packed
window bits (``cand_window_bits``) and build no sample lattice.  NDC rays (forward-facing scenes) sample
linspace(near, far) with per-sample jitter, scale each distance by the
ray's direction norm and shade with the normalized direction.

Every top-k selection here ranks with distinct scores: kept entries
nearest first, then dead entries by ascending index.  That is the order
jax.lax.top_k gives the JAX package's tied scores, so the selected
indices equal the JAX renderer's index for index.

While a profiler runs, ``render_rays`` marks its parts with spans
(``tftorch.render.march``, ``.density``, ``.shade``, ``.composite``) and
counts its rays, the slots the density and the shading run on and the
samples of use in them (utils/tracing.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.alpha_mask import (
    COARSE_STRIDE,
    AlphaGridMask,
    sample_alpha_gate,
    sample_alpha_gate_coarse,
)
from ..models.config import ModelConfig
from ..models.shading import apply_shading
from ..ops.freq_mask import FreeMasks
from ..ops.rays import (
    inbbox_chord,
    lattice_z,
    sample_along_rays,
    sample_along_rays_ndc,
    sample_lattice,
)
from ..ops.render_math import raw2alpha
from ..utils import tracing

# Re-derive z/xyz/dists from the selected lattice indices instead of
# gathering them from the full lattice (bit-identical on the affine
# lattice).  Module-level so a test can pin derived == gathered.
_DERIVED_COMPACTION = True


def normalize_coord(xyz: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """World -> [-1, 1] grid coords."""
    inv = 2.0 / (aabb[1] - aabb[0])
    return (xyz - aabb[0]) * inv - 1.0


def feature2density(cfg: ModelConfig, feat: torch.Tensor) -> torch.Tensor:
    """softplus(x + density_shift) or relu."""
    if cfg.fea2dense_act == "softplus":
        return torch.nn.functional.softplus(feat + cfg.density_shift)
    if cfg.fea2dense_act == "relu":
        return torch.relu(feat)
    raise ValueError(f"unknown fea2dense_act {cfg.fea2dense_act}")


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # (B, 3)
    depth: torch.Tensor  # (B,)
    acc: torch.Tensor  # (B,)
    weights: torch.Tensor  # (B, N)
    sigma: torch.Tensor  # (B, N)
    z_vals: torch.Tensor  # (B, N)
    num_valid_samples: torch.Tensor  # scalar
    # fraction of rays whose candidates a sample budget could not all keep
    # (0 without a budget): nonzero means the render may under-integrate
    budget_overflow_frac: torch.Tensor  # scalar
    mean_alive_samples: torch.Tensor  # scalar: mean live samples per ray
    # the slots the density ran on (host scalar): the admitted ones where the
    # mask gates a whole lattice, else rays x width
    density_rows: torch.Tensor


def _on_rows(keep: torch.Tensor, fn):
    """``fn`` run on the flat indices of the slots ``keep`` (B, N) admits,
    compacted to rows (a read-back of their number), and its rows put back
    into zeros of (B, N, ...): every other slot reads exactly zero and takes
    no gradient.  Returns that and the number of rows."""
    B, N = keep.shape
    rows = torch.nonzero(keep.reshape(-1)).squeeze(-1)
    out = fn(rows)
    dense = torch.zeros((B * N,) + out.shape[1:], dtype=out.dtype, device=out.device)
    return dense.index_put((rows,), out).reshape(B, N, *out.shape[1:]), rows.shape[0]


def _ranked_topk(keep: torch.Tensor, k: int):
    """Top-k of (B, n) keep flags: kept entries nearest first, then dead
    ones by ascending index, as jax.lax.top_k ranks the JAX package's
    keep * (2n - index) scores.  Returns (alive (B, k) bool, idx (B, k)),
    in rank order."""
    n = keep.shape[1]
    order = torch.arange(n, dtype=torch.int32, device=keep.device)
    score = torch.where(keep, 2 * n - order, -order)
    vals, idx = torch.topk(score, k, dim=-1)
    return vals > 0, idx


def _compact(xyz, z_vals, dists, keep, K: int):
    """Keep the nearest K ``keep`` samples per ray, in depth order."""
    _, sel = _ranked_topk(keep, K)
    sel = torch.sort(sel, dim=-1).values
    return (
        torch.take_along_dim(xyz, sel[..., None], dim=1),
        torch.take_along_dim(z_vals, sel, dim=1),
        torch.take_along_dim(dists, sel, dim=1),
        torch.take_along_dim(keep, sel, dim=1),
    )


def _window_keep(keep: torch.Tensor) -> torch.Tensor:
    """(B, n) per-sample flags -> (B, G) per COARSE_STRIDE window (any),
    windows starting at index 0 (models/alpha_mask.py::group_padded_count)."""
    B, n = keep.shape
    S = COARSE_STRIDE
    G = -(-n // S)
    return F.pad(keep, (0, G * S - n)).reshape(B, G, S).any(dim=-1)


def _select_windows_g(gkeep: torch.Tensor, K: int):
    """Window-granular top-k from a window keep mask (B, G): the K // S
    nearest kept windows.  Returns (sel (B, K) lattice indices in depth
    order, win_alive (B, K) bool, padded_count (B,)); K is a
    COARSE_STRIDE multiple."""
    B = gkeep.shape[0]
    S = COARSE_STRIDE
    padded_count = S * torch.sum(gkeep.to(torch.int32), dim=-1, dtype=torch.int32)
    alive, gsel = _ranked_topk(gkeep, K // S)
    code = torch.sort(gsel * 2 + alive.to(gsel.dtype), dim=-1).values  # depth order
    gsel, galive = code >> 1, (code & 1) > 0
    offs = torch.arange(S, dtype=gsel.dtype, device=gsel.device)
    sel = (gsel[..., None] * S + offs).reshape(B, K)
    win_alive = galive[..., None].expand(B, K // S, S).reshape(B, K)
    return sel, win_alive, padded_count


def pack_window_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., G) bool -> (..., ceil(G/8)) uint8, little-endian bit order
    (jnp.packbits(..., bitorder="little")): window g is bit g % 8 of
    byte g // 8, the tail byte zero-padded."""
    G = bits.shape[-1]
    b = F.pad(bits.to(torch.int32), (0, (-G) % 8)).reshape(*bits.shape[:-1], -1, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return torch.sum(b << shifts, dim=-1).to(torch.uint8)


def unpack_window_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., Gb) uint8 -> (..., Gb * 8) bool, the inverse of
    pack_window_bits (jnp.unpackbits(..., bitorder="little") > 0)."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1) > 0


def _select_windows(keep: torch.Tensor, K: int):
    """Window selection over per-sample keep flags (B, n): see
    _select_windows_g."""
    return _select_windows_g(_window_keep(keep), K)


def _compact_grouped(xyz, z_vals, dists, keep, K: int):
    """_compact at window granularity, by gathering from the full lattice:
    (xyz, z_vals, dists, kept, padded_count).  Lattice-tail padding rows
    carry keep = 0, so a selected straddling window adds no live sample."""
    B, n = keep.shape
    S = COARSE_STRIDE
    tail = -(-n // S) * S - n
    sel, _, padded_count = _select_windows(keep, K)
    xyz, z_vals, dists = (F.pad(a, (0, 0, 0, tail)) if a.dim() == 3 else F.pad(a, (0, tail))
                          for a in (xyz, z_vals, dists))
    keep = F.pad(keep, (0, tail))
    return (
        torch.take_along_dim(xyz, sel[..., None], dim=1),
        torch.take_along_dim(z_vals, sel, dim=1),
        torch.take_along_dim(dists, sel, dim=1),
        torch.take_along_dim(keep, sel, dim=1),
        padded_count,
    )


def _derive_at(rays_o, viewdirs, aabb, near, far, u, step_size, n_samples, sel, win_alive):
    """(xyz, z_vals, dists, kept) at selected lattice indices, computed by
    the same expressions as sample_along_rays, so bit-identical to
    gathering them.  Indices at or past ``n_samples`` (the straddling last
    window's tail) stay masked."""
    t_min = sample_lattice(rays_o, viewdirs, aabb, near, far)
    idxf = sel.to(rays_o.dtype)
    z_sel = lattice_z(t_min, u, idxf, step_size)
    z_next = lattice_z(t_min, u, idxf + 1.0, step_size)
    d_sel = torch.where(sel < n_samples - 1, z_next - z_sel, torch.zeros_like(z_sel))
    xyz_sel = rays_o[:, None, :] + viewdirs[:, None, :] * z_sel[..., None]
    inb = ~torch.any((xyz_sel < aabb[0]) | (xyz_sel > aabb[1]), dim=-1)
    kept = win_alive & inb & (sel < n_samples)
    return xyz_sel, z_sel, d_sel, kept


def _over(keep: torch.Tensor, K: int) -> torch.Tensor:
    """(B,) bool: rays with more than K set flags."""
    return torch.sum(keep.to(torch.int32), dim=-1) > K


def render_rays(
    field,
    rays: torch.Tensor,
    masks: FreeMasks,
    *,
    aabb: torch.Tensor,
    step_size: float,
    n_samples: int,
    is_train: bool,
    white_bg: bool,
    ndc_ray: bool = False,
    shade_top_k: Optional[int] = None,
    fused: bool = True,
    sample_budget: Optional[int] = None,
    budget_mode: str = "alive",
    use_coarse_gate: bool = True,
    alive_budget: Optional[int] = None,
    alpha_mask: Optional[AlphaGridMask] = None,
    cand_window_bits=None,
    u: Optional[torch.Tensor] = None,
    flip: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Volume-render a batch of rays (B, 6) -> RenderOutput.

    ``field`` is a field of models/tensorf.py; ``masks`` the per-step
    FreeNeRF bundle; ``alpha_mask`` (or None) gates samples by occupancy.
    Where the JAX version takes a key, this takes the noise itself: ``u``
    (B, 1) is the per-ray lattice jitter, ``jitter`` (B, n_samples) the
    per-sample jitter of NDC rays (``ndc_ray``), and ``flip`` (scalar 0/1)
    the train-time random white-background flip for datasets whose
    background is not white.  All None give the deterministic eval render.

    A ``sample_budget`` K < ``n_samples`` compacts each ray before the
    field runs, by the first rule that applies:
    - a mask whose coarse gate is invalid (``use_coarse_gate`` False): the
      K nearest exact-alive samples;
    - ``budget_mode="cand"`` with a mask: the K nearest coarse candidates
      (whole stride windows when K is a COARSE_STRIDE multiple), exact-gated
      after; ``alive_budget`` below K compacts those once more;
    - ``"alive"`` with a mask: K1 = min(n_samples, K + 224) coarse
      candidates, exact-gated, then the K nearest alive ones;
    - no mask (the prefilter budget): the K nearest in-bbox samples.
    The stride-window selections re-derive the kept samples from the affine
    lattice; NDC rays gather them instead (whole windows in "cand" mode,
    single samples without a mask), as the JAX renderer does.
    ``cand_window_bits`` (B, Gb) uint8, the packed per-window probe hits of
    render/culling.py::count_ray_candidates_chord_bits, replaces the
    lattice and its coarse gate: the K // COARSE_STRIDE nearest hit windows
    within each ray's chord, exact-gated after.  It needs a mask, the
    "cand" mode and a COARSE_STRIDE-multiple budget K <= ``n_samples``.
    """
    if cand_window_bits is not None and (
        ndc_ray or alpha_mask is None or sample_budget is None or sample_budget > n_samples
        or sample_budget % COARSE_STRIDE != 0 or budget_mode != "cand"
    ):
        raise ValueError(
            "cand_window_bits requires non-NDC cand-mode budget rendering with an alpha "
            "mask and a COARSE_STRIDE-multiple budget <= n_samples"
        )
    cfg = field.cfg
    B = rays.shape[0]
    rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
    near, far = cfg.near_far
    zero = torch.zeros((), device=rays.device)

    with tracing.span("tftorch.render.march"):
        n_eff = n_samples
        overflow = zero
        exact_gated = False
        if cand_window_bits is not None:
            # Serving window bits: the count pass probed every stride window, so
            # the candidates are the unpacked hits within the closed-form chord
            # (a superset of the per-sample validity: extra boundary windows are
            # exact-gated off below, and the tier covers them).  No (B, N, 3)
            # lattice is built.
            S = COARSE_STRIDE
            K = sample_budget
            _, hit, chord = inbbox_chord(rays_o, viewdirs, aabb, near, far, step_size, n_samples)
            ghits = unpack_window_bits(cand_window_bits)  # (B, Gb * 8)
            starts = torch.arange(ghits.shape[1], dtype=torch.int32, device=rays.device) * S
            gkeep = ghits & hit[:, None] & (starts < chord[:, None]) & (starts < n_samples)
            sel, win_alive, pc = _select_windows_g(gkeep, K)
            xyz, z_vals, dists, kept = _derive_at(rays_o, viewdirs, aabb, near, far, u, step_size,
                                                  n_samples, sel, win_alive)
            ray_valid = kept & (sample_alpha_gate(alpha_mask, xyz) > 0)
            overflow = torch.mean((pc > K).to(torch.float32))
            exact_gated = True
            n_eff = K
            use_budget = False
        else:
            if ndc_ray:
                xyz, z_vals, ray_valid = sample_along_rays_ndc(
                    rays_o, viewdirs, aabb, near, far, n_samples, jitter
                )
            else:
                xyz, z_vals, ray_valid = sample_along_rays(
                    rays_o, viewdirs, aabb, near, far, step_size, n_samples, u
                )
            dists = torch.cat(
                [z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], dim=-1
            )
            if ndc_ray:
                rays_norm = torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
                dists = dists * rays_norm
                viewdirs = viewdirs / rays_norm
            use_budget = sample_budget is not None and sample_budget < n_samples

        def compact_windows(keep, K):
            if _DERIVED_COMPACTION and not ndc_ray:
                sel, win_alive, pc = _select_windows(keep, K)
                return (*_derive_at(rays_o, viewdirs, aabb, near, far, u, step_size,
                                    n_samples, sel, win_alive), pc)
            return _compact_grouped(xyz, z_vals, dists, keep, K)

        if use_budget:
            K = sample_budget
            if alpha_mask is not None and not use_coarse_gate:
                alive = ray_valid & (sample_alpha_gate(alpha_mask, xyz) > 0)
                overflow = torch.mean(_over(alive, K).to(torch.float32))
                xyz, z_vals, dists, ray_valid = _compact(xyz, z_vals, dists, alive, K)
                exact_gated = True
            elif alpha_mask is not None and budget_mode == "cand":
                cand = ray_valid & sample_alpha_gate_coarse(alpha_mask, xyz)
                if K % COARSE_STRIDE == 0:
                    xyz, z_vals, dists, kept, pc = compact_windows(cand, K)
                    over1 = pc > K
                else:
                    over1 = _over(cand, K)
                    xyz, z_vals, dists, kept = _compact(xyz, z_vals, dists, cand, K)
                ray_valid = kept & (sample_alpha_gate(alpha_mask, xyz) > 0)
                if alive_budget is not None and alive_budget < K:
                    over1 = over1 | _over(ray_valid, alive_budget)
                    xyz, z_vals, dists, ray_valid = _compact(xyz, z_vals, dists, ray_valid,
                                                             alive_budget)
                    K = alive_budget
                overflow = torch.mean(over1.to(torch.float32))
                exact_gated = True
            elif alpha_mask is not None:
                # candidates exceed the alive set by about the dilated shell's
                # thickness per surface crossing: an additive margin
                K1 = min(n_samples, K + 224)
                cand = ray_valid & sample_alpha_gate_coarse(alpha_mask, xyz)
                over1 = _over(cand, K1)
                xyz, z_vals, dists, cand1 = _compact(xyz, z_vals, dists, cand, K1)
                alive = cand1 & (sample_alpha_gate(alpha_mask, xyz) > 0)
                overflow = torch.mean((over1 | _over(alive, K)).to(torch.float32))
                xyz, z_vals, dists, ray_valid = _compact(xyz, z_vals, dists, alive, K)
                exact_gated = True
            elif K % COARSE_STRIDE == 0 and not ndc_ray:
                # mask-free: the candidates are the contiguous in-bbox run
                xyz, z_vals, dists, ray_valid, pc = compact_windows(ray_valid, K)
                overflow = torch.mean((pc > K).to(torch.float32))
            else:
                overflow = torch.mean(_over(ray_valid, K).to(torch.float32))
                xyz, z_vals, dists, ray_valid = _compact(xyz, z_vals, dists, ray_valid, K)
            n_eff = K

        # the occupancy gate over the whole lattice (reference tensorBase.py:349-354)
        lattice_gated = alpha_mask is not None and not exact_gated
        if lattice_gated:
            ray_valid = ray_valid & (sample_alpha_gate(alpha_mask, xyz) > 0)
        mean_alive = torch.mean(torch.sum(ray_valid.to(torch.float32), dim=-1))
    N = n_eff

    def shade(pts, app_feat, K):
        view = viewdirs[:, None, :].expand(B, K, 3).reshape(-1, 3)
        return apply_shading(cfg, field.render, pts, view, app_feat, masks).reshape(B, K, 3)

    top_k = shade_top_k is not None and shade_top_k < N
    density_feature = field.density_feature_fused if fused else field.density_feature
    app_feature = field.app_feature_fused if fused else field.app_feature

    with tracing.span("tftorch.render.density"):
        xyz_n = normalize_coord(xyz, aabb)  # (B, n_eff, 3)
        if lattice_gated:
            # The gate admits few of the lattice's slots (flower's last
            # segment about one in eight), so the density runs on the admitted
            # rows alone, their number read back after the march and gate are
            # queued, and sigma goes back into a zero (B, N): the gated dense
            # formula's sigma, weights and gradients.  A budget has already
            # packed the alive slots, and without a mask the lattice is the
            # box test, mostly true: those stay dense.
            sigma, n_density = _on_rows(ray_valid, lambda rows: feature2density(
                cfg, density_feature(xyz_n.reshape(-1, 3).index_select(0, rows), masks.den)))
        else:
            n_density = B * N
            sigma = torch.where(ray_valid, feature2density(
                cfg, density_feature(xyz_n.reshape(-1, 3), masks.den).reshape(B, N)), zero)
        _, weight, _ = raw2alpha(sigma, dists * cfg.distance_scale)
        app_gate = weight > cfg.ray_march_weight_thres
        num_valid = torch.sum(app_gate.to(torch.int32))

    with tracing.span("tftorch.render.shade"):
        if top_k:
            # Appearance only for the top-K weights per ray: exact whenever K
            # covers every above-threshold sample.  torch.topk may order tied
            # weights differently from jax.lax.top_k; the render is the same.
            K = shade_top_k
            n_shade = B * K
            w_sel, idx = torch.topk(weight, K, dim=-1)
            xyz_sel = torch.take_along_dim(xyz_n, idx[..., None], dim=1).reshape(-1, 3)
            gate_sel = w_sel > cfg.ray_march_weight_thres
            app_feat_sel = app_feature(xyz_sel, masks.app)
            rgb_s = shade(xyz_sel, app_feat_sel.reshape(B * K, -1), K)
            rgb_s = torch.where(gate_sel[..., None], rgb_s, zero)
            rgb_map = torch.sum(w_sel[..., None] * rgb_s, dim=-2)
        else:
            # Appearance and the head only on the samples whose weight passes
            # the threshold (the reference's app_mask), compacted to rows; the
            # read-back of their number is what the rows' shapes need.  Every
            # other slot's radiance is exactly zero, as the gate made it.  With
            # no row passing, the zero rows still give the appearance factors
            # and the head zero gradients, so Adam steps every leaf.  The rows
            # gather their taps directly: at so few rows that beats building
            # and scattering whole footprint tables (``chip_dev.py
            # shade_route`` times both), and it is the fused path's
            # arithmetic where that runs in float32.
            float32 = field.grid_dtype == torch.float32 and field.line_a_dtype is None
            rows_app_feature = field.app_feature if float32 else app_feature

            def shade_rows(rows):
                pts = xyz_n.reshape(-1, 3).index_select(0, rows)
                return apply_shading(cfg, field.render, pts, viewdirs.index_select(0, rows // N),
                                     rows_app_feature(pts, masks.app), masks)

            rgb_s, n_shade = _on_rows(app_gate, shade_rows)
            rgb_map = torch.sum(weight[..., None] * rgb_s, dim=-2)

    if tracing.enabled():
        # the slots each part of the field ran on, and how many of them were of use
        tracing.count("render.rays", B)
        tracing.count("render.density_rows", n_density)
        tracing.count("render.alive", mean_alive, B)
        tracing.count("render.shade_rows", n_shade)
        tracing.count("render.shaded", num_valid)
    with tracing.span("tftorch.render.composite"):
        return _composite(
            rgb_map, weight, sigma, z_vals, rays, flip, num_valid,
            is_train=is_train, white_bg=white_bg, budget_overflow_frac=overflow,
            mean_alive_samples=mean_alive, density_rows=torch.tensor(n_density),
        )


def _composite(
    rgb_map, weight, sigma, z_vals, rays, flip, num_valid, *,
    is_train: bool, white_bg: bool, budget_overflow_frac, mean_alive_samples, density_rows,
) -> RenderOutput:
    acc = torch.sum(weight, dim=-1)
    # White background; at train time a random 50% flip when the dataset
    # background is not white.
    if white_bg:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    elif is_train and flip is not None:
        rgb_map = rgb_map + flip * (1.0 - acc[..., None])
    rgb_map = torch.clamp(rgb_map, 0.0, 1.0)
    with torch.no_grad():
        depth = torch.sum(weight * z_vals, dim=-1) + (1.0 - acc) * rays[:, -1]
    return RenderOutput(
        rgb=rgb_map,
        depth=depth,
        acc=acc,
        weights=weight,
        sigma=sigma,
        z_vals=z_vals,
        num_valid_samples=num_valid,
        budget_overflow_frac=budget_overflow_frac,
        mean_alive_samples=mean_alive_samples,
        density_rows=density_rows,
    )
