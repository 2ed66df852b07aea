"""Dense-alpha extraction, alpha-mask updates, ray-set filtering, the
per-ray sample counts that stratify the ray store and the serving
window-bits count pass (counterpart of tensorf_tpu/render/culling.py).

The dense sweeps and the count passes run chunk by chunk on the device
under no_grad; the shape-changing decisions (the new aabb, which rays
stay, the strata) are made at the schedule events, as in the reference
(models/tensorBase.py:214-288).  The strata plan below the count passes
is numpy, copied from the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.alpha_mask import (
    COARSE_STRIDE,
    AlphaGridMask,
    coarse_probe_hits,
    coarse_probe_indices,
    group_padded_count,
    max_pool_3d_same,
    sample_alpha_gate,
    sample_alpha_gate_coarse,
    with_dilation,
)
from ..ops.rays import aabb_entry_exit, inbbox_chord, linspace, sample_along_rays
from .volume import feature2density, normalize_coord, pack_window_bits


def _bbox_hit(rays: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    t_min, t_max = aabb_entry_exit(rays[:, :3], rays[:, 3:6], aabb)
    return t_max > t_min


def _chunked_mask(fn, rays: torch.Tensor, chunk: int) -> torch.Tensor:
    return torch.cat([fn(rays[s : s + chunk]) for s in range(0, rays.shape[0], chunk)])


def filter_rays_bbox(
    all_rays, all_rgbs, aabb, device, chunk: int = 51200
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep rays whose line intersects the scene bbox (reference
    filtering_rays bbox_only=True).  Returns the kept rays and colors as
    tensors on ``device`` — the device-resident ray store."""
    rays = torch.as_tensor(np.asarray(all_rays, np.float32), device=device)
    rgbs = torch.as_tensor(np.asarray(all_rgbs, np.float32), device=device)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=device)
    mask = _chunked_mask(lambda r: _bbox_hit(r, aabb_t), rays, chunk)
    kept = int(mask.sum())
    print(
        f"========> bbox ray filtering: kept {kept}/{mask.numel()} "
        f"({kept / max(mask.numel(), 1):.3f})"
    )
    return rays[mask], rgbs[mask]


def _alpha_at(field, alpha_mask, xyz, aabb, den_mask, length: float) -> torch.Tensor:
    """alpha = 1 - exp(-sigma * length) at world points (M, 3), with the
    alpha-mask gate (reference compute_alpha, tensorBase.py:298-318)."""
    xyz_n = normalize_coord(xyz, aabb)
    sigma = feature2density(field.cfg, field.density_feature(xyz_n, den_mask))
    if alpha_mask is not None:
        gate = sample_alpha_gate(alpha_mask, xyz) > 0
        sigma = torch.where(gate, sigma, torch.zeros((), device=xyz.device))
    return 1.0 - torch.exp(-sigma * length)


@torch.no_grad()
def compute_alpha_grid(
    field,
    alpha_mask: Optional[AlphaGridMask],
    aabb,
    grid_size: Tuple[int, int, int],
    step_size: float,
    den_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (gx, gy, gz) alpha grid and its (gx, gy, gz, 3) world-space
    lattice, on the field's device (reference getDenseAlpha,
    tensorBase.py:214-230): a 0..1 lattice lerped into the aabb, evaluated
    one x-slice at a time."""
    dev = field.basis.device
    gx, gy, gz = (int(g) for g in grid_size)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=dev)
    samples = torch.stack(
        torch.meshgrid(linspace(0.0, 1.0, gx, dev), linspace(0.0, 1.0, gy, dev),
                       linspace(0.0, 1.0, gz, dev), indexing="ij"),
        dim=-1,
    )
    dense_xyz = aabb_t[0] * (1 - samples) + aabb_t[1] * samples
    alpha = torch.empty((gx, gy, gz), device=dev)
    for i in range(gx):
        alpha[i] = _alpha_at(
            field, alpha_mask, dense_xyz[i].reshape(-1, 3), aabb_t, den_mask, float(step_size)
        ).reshape(gy, gz)
    return alpha, dense_xyz


@torch.no_grad()
def update_alpha_mask(
    field,
    alpha_mask: Optional[AlphaGridMask],
    aabb,
    grid_size: Tuple[int, int, int],
    step_size: float,
    den_mask=None,
) -> Tuple[AlphaGridMask, np.ndarray, float]:
    """Rebuild the occupancy mask and find the tight new aabb (reference
    updateAlphaMask, tensorBase.py:232-256): clamp, transpose to (z, y, x),
    3x3x3 max-pool, threshold at the model's ``alpha_mask_thres``.  The mask
    keeps ``aabb``; the new aabb spans its occupied lattice points.
    Returns (mask, new_aabb (2, 3) float32, occupancy ratio)."""
    alpha, dense_xyz = compute_alpha_grid(field, alpha_mask, aabb, grid_size, step_size, den_mask)
    vol = torch.clamp(alpha, 0, 1).permute(2, 1, 0).contiguous()  # (z, y, x)
    vol = max_pool_3d_same(vol, ks=3)
    vol = (vol >= field.cfg.alpha_mask_thres).to(torch.float32)
    del alpha

    occupied = vol > 0.5
    count = int(occupied.sum())
    if count == 0:
        new_aabb = np.asarray(aabb, np.float32).reshape(2, 3)
    else:
        xyz_zyx = dense_xyz.permute(2, 1, 0, 3)
        inf = torch.tensor(float("inf"), device=vol.device)
        lo = torch.where(occupied[..., None], xyz_zyx, inf).reshape(-1, 3).amin(dim=0)
        hi = torch.where(occupied[..., None], xyz_zyx, -inf).reshape(-1, 3).amax(dim=0)
        new_aabb = torch.stack([lo, hi]).cpu().numpy()
    ratio = float(np.float32(count) / vol.numel())
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=vol.device)
    return with_dilation(AlphaGridMask(aabb=aabb_t, volume=vol)), new_aabb, ratio


@torch.no_grad()
def _alpha_hit(rays, alpha_mask, aabb, *, n_samples, step_size, near, far) -> torch.Tensor:
    xyz, _, valid = sample_along_rays(
        rays[:, :3], rays[:, 3:6], aabb, near, far, step_size, n_samples, None
    )
    alive = valid & (sample_alpha_gate(alpha_mask, xyz) > 0)
    return torch.any(alive, dim=-1)


@torch.no_grad()
def filter_rays_alpha(
    rays: torch.Tensor,
    rgbs: torch.Tensor,
    alpha_mask: AlphaGridMask,
    aabb,
    step_size: float,
    near_far=(2.0, 6.0),
    n_samples: int = 256,
    chunk: int = 51200,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the rays of the store with any alive sample under the alpha
    mask (reference filtering_rays bbox_only=False, tensorBase.py:279-281).
    ``n_samples`` is 256 as in the reference call, not the step's lattice.
    An empty result keeps the store unfiltered, with a notice."""
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=rays.device)
    mask = _chunked_mask(
        lambda r: _alpha_hit(
            r, alpha_mask, aabb_t, n_samples=n_samples, step_size=float(step_size),
            near=float(near_far[0]), far=float(near_far[1]),
        ),
        rays,
        chunk,
    )
    kept = int(mask.sum())
    print(
        f"========> alpha ray filtering: kept {kept}/{mask.numel()} "
        f"({kept / max(mask.numel(), 1):.3f})"
    )
    if kept == 0:
        print("========> alpha ray filtering kept nothing; skipping filter")
        return rays, rgbs
    return rays[mask], rgbs[mask]


# ---- per-ray counts over the ray store ---------------------------------------


def _chunked_counts(fn, all_rays, device, chunk: int) -> Tuple[np.ndarray, ...]:
    """Run ``fn`` (rays (m, 6) -> tuple of (m,) int tensors) over the rays
    in chunks on ``device``; returns the concatenated counts as int32
    numpy arrays."""
    rays = torch.as_tensor(all_rays, dtype=torch.float32, device=device)
    parts = [fn(rays[s : s + chunk]) for s in range(0, rays.shape[0], chunk)]
    return tuple(
        torch.cat([p[i] for p in parts]).to(torch.int32).cpu().numpy()
        for i in range(len(parts[0]))
    )


def _lattice(rays, aabb, n_samples, step_size, near, far):
    return sample_along_rays(rays[:, :3], rays[:, 3:6], aabb, near, far, step_size, n_samples, None)


def _count(flags: torch.Tensor) -> torch.Tensor:
    return torch.sum(flags.to(torch.int32), dim=-1, dtype=torch.int32)


@torch.no_grad()
def _candidate_counts(rays, alpha_mask, aabb, *, n_samples, step_size, near, far, coarse):
    xyz, _, valid = _lattice(rays, aabb, n_samples, step_size, near, far)
    if coarse:
        # group-padded: the renderer selects whole stride windows
        return (group_padded_count(valid & sample_alpha_gate_coarse(alpha_mask, xyz)),)
    return (_count(valid & (sample_alpha_gate(alpha_mask, xyz) > 0)),)


@torch.no_grad()
def _candidate_counts_both(rays, alpha_mask, aabb, *, n_samples, step_size, near, far):
    """(coarse candidate, exact alive, in-bbox chord) counts per ray."""
    xyz, _, valid = _lattice(rays, aabb, n_samples, step_size, near, far)
    cand = valid & sample_alpha_gate_coarse(alpha_mask, xyz)
    alive = valid & (sample_alpha_gate(alpha_mask, xyz) > 0)
    return group_padded_count(cand), _count(alive), _count(valid)


@torch.no_grad()
def _probe_counts(rays, alpha_mask, aabb, *, n_samples, step_size, near, far):
    """(group-padded coarse candidate count, in-bbox chord, raw window
    hits (B, G)) per ray, from the probes alone: one mask lookup per
    COARSE_STRIDE samples at the positions sample_along_rays gives those
    indices, and no (B, N, 3) lattice.  Both counts are reported
    conservatively (+1 chord sample, +1 candidate window on hitting rays),
    so a render sized from them never pays more than promised; rays that
    miss the box report exact zeros."""
    o, d = rays[:, :3], rays[:, 3:6]
    t0, hit, chord = inbbox_chord(o, d, aabb, near, far, step_size, n_samples)
    pidx = coarse_probe_indices(n_samples, o.device).to(o.dtype)
    z = t0[:, None] + pidx[None, :] * step_size
    probe = o[:, None, :] + d[:, None, :] * z[..., None]
    hits = coarse_probe_hits(alpha_mask, probe)  # (B, n_probe)
    starts = torch.arange(pidx.shape[0], dtype=torch.int32, device=o.device) * COARSE_STRIDE
    wvalid = hit[:, None] & (starts[None, :] < chord[:, None])
    cand = COARSE_STRIDE * _count(hits & wvalid)
    # +1-window slack on nonzero counts only
    cand = torch.where(cand > 0, torch.clamp(cand + COARSE_STRIDE, max=n_samples), cand)
    return cand, chord, hits


@torch.no_grad()
def _inbbox_counts(rays, aabb, *, n_samples, step_size, near, far):
    _, _, valid = _lattice(rays, aabb, n_samples, step_size, near, far)
    # group-padded: the mask-free compaction also selects whole windows
    return (group_padded_count(valid),)


def _count_kw(aabb, device, step_size, near_far, n_samples):
    return dict(
        aabb=torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=device),
        n_samples=int(n_samples), step_size=float(step_size),
        near=float(near_far[0]), far=float(near_far[1]),
    )


def count_ray_candidates(
    all_rays, alpha_mask: AlphaGridMask, aabb, step_size: float, near_far=(2.0, 6.0),
    n_samples: int = 256, chunk: int = 51200, use_coarse: bool = True,
) -> np.ndarray:
    """Per-ray candidate-sample counts over a ray set, on the mask's
    device: group-padded coarse candidates, or (``use_coarse`` False)
    exact-gate alive samples."""
    dev = alpha_mask.volume.device
    kw = _count_kw(aabb, dev, step_size, near_far, n_samples)
    return _chunked_counts(
        lambda r: _candidate_counts(r, alpha_mask, coarse=bool(use_coarse), **kw),
        all_rays, dev, chunk,
    )[0]


def count_ray_candidates_and_chord(
    all_rays, alpha_mask: AlphaGridMask, aabb, step_size: float, near_far=(2.0, 6.0),
    n_samples: int = 256, chunk: int = 51200,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-ray (candidate, in-bbox chord) counts from the probe-only pass:
    candidates pick a stratum's budget, chords cap its lattice."""
    dev = alpha_mask.volume.device
    kw = _count_kw(aabb, dev, step_size, near_far, n_samples)
    return _chunked_counts(
        lambda r: _probe_counts(r, alpha_mask, **kw)[:2], all_rays, dev, chunk
    )


@torch.no_grad()
def count_ray_candidates_chord_bits(
    all_rays, alpha_mask: AlphaGridMask, aabb, step_size: float, near_far=(2.0, 6.0),
    n_samples: int = 256, tile: int = 32768,
) -> Tuple[np.ndarray, np.ndarray, torch.Tensor, torch.Tensor]:
    """The serving count pass over a frame's rays, on the mask's device.

    Returns (counts (M,) int32 numpy, chords (M,) int32 numpy, window-hit
    bits (M_pad, Gb) uint8 and rays (M_pad, 6) float32, both left on the
    device): the bucket renders gather their rows from these two stores
    (render/chunked.py).  The bits are the raw probe hits, packed
    little-endian; the consumer re-applies the chord.  ``all_rays`` may
    already be a device tensor (rays_from_pose).  The rays are padded to a
    multiple of ``tile`` by repeating the last one and counted tile by tile;
    counts and chords reach the host in one copy."""
    dev = alpha_mask.volume.device
    if isinstance(all_rays, torch.Tensor):
        rays = all_rays.to(dev, torch.float32)
    else:
        rays = torch.as_tensor(np.asarray(all_rays, np.float32), device=dev)
    M = rays.shape[0]
    pad = (-M) % tile
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, 6)])
    kw = _count_kw(aabb, dev, step_size, near_far, n_samples)
    tile = min(tile, rays.shape[0])
    counts, bits = [], []
    for s in range(0, rays.shape[0], tile):
        cand, chord, hits = _probe_counts(rays[s : s + tile], alpha_mask, **kw)
        counts.append(torch.stack([cand, chord]))
        bits.append(pack_window_bits(hits))
    host = torch.cat(counts, dim=1)[:, :M].cpu().numpy()
    return host[0], host[1], torch.cat(bits), rays


def count_ray_inbbox(
    all_rays, aabb, step_size: float, near_far=(2.0, 6.0), n_samples: int = 256,
    chunk: int = 51200,
) -> np.ndarray:
    """Per-ray group-padded in-bbox lattice sample counts, on the rays'
    device (the CPU for numpy rays).  Before the first alpha mask every
    in-bbox sample is alive, so this is the candidate count of the
    prefilter phase."""
    dev = all_rays.device if isinstance(all_rays, torch.Tensor) else torch.device("cpu")
    kw = _count_kw(aabb, dev, step_size, near_far, n_samples)
    return _chunked_counts(lambda r: _inbbox_counts(r, **kw), all_rays, dev, chunk)[0]


def count_ray_candidates_and_alive(
    all_rays, alpha_mask: AlphaGridMask, aabb, step_size: float, near_far=(2.0, 6.0),
    n_samples: int = 256, chunk: int = 51200,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-ray (coarse candidate, exact alive, in-bbox chord) counts in one
    pass over the full lattice: the counts of alive-primary strata."""
    dev = alpha_mask.volume.device
    kw = _count_kw(aabb, dev, step_size, near_far, n_samples)
    return _chunked_counts(
        lambda r: _candidate_counts_both(r, alpha_mask, **kw), all_rays, dev, chunk
    )


# ---- the strata plan (numpy, a copy of tensorf_tpu's) -------------------------


def _budget_hint(max_count: int) -> int:
    """Candidate budget for a stratum: its max count + jitter slack, padded
    to a 32-multiple (train-time stratified jitter moves samples within
    their lattice bin, so live counts can exceed the deterministic count by
    a few per surface crossing; overflow monitoring + auto-raise remain the
    backstop)."""
    return int(max(32, -(-(int(max_count) + 8) // 32) * 32))


def count_histogram(counts: np.ndarray, length: Optional[int] = None
                    ) -> np.ndarray:
    """int64 histogram ``hist[v] = #rays with count v``.  ``length`` fixes
    the array length (``length + 1`` bins) so per-host histograms can be
    summed element-wise across processes (multi-host stratification sync).
    """
    counts = np.asarray(counts, np.int64)
    if length is not None:
        # ``length`` must be an exact length, not bincount's lower bound:
        # group-PADDED count sources can exceed n_samples (padding rounds
        # up to the coarse stride), and a single such ray on one host
        # would desynchronize the element-wise host_allsum.  Clipping is
        # conservative — the ray lands in the top budget class.
        counts = np.clip(counts, 0, length)
    minlength = (length + 1) if length is not None else 0
    return np.bincount(counts, minlength=minlength).astype(np.int64)


def _hist_quantile(hist: np.ndarray, q: float) -> float:
    """``np.quantile`` (linear interpolation) of the integer population a
    histogram describes, without materializing it."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"Quantiles must be in the range [0, 1], got {q}")
    cum = np.cumsum(hist)
    n = int(cum[-1])
    pos = q * (n - 1)
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    v_lo = int(np.searchsorted(cum, lo + 1))  # sorted element at index lo
    v_hi = int(np.searchsorted(cum, hi + 1))
    return v_lo + (pos - lo) * (v_hi - v_lo)


def _optimal_edges(hist: np.ndarray, max_strata: int = 6,
                   stratum_penalty: float = 0.01):
    """Budget-class partition minimizing the expected per-ray budget.

    Every ray in a stratum pays the stratum's (padded) max budget, so the
    per-step sample cost is E[stratum budget]; quantile edges are
    arbitrary — the optimal contiguous partition over the ~n_samples/32
    padded-budget classes is exact via a tiny DP.  ``stratum_penalty``
    charges each extra stratum 1% of total cost (a sub-batch render has
    some fixed per-call cost), which also picks the stratum COUNT.

    Operates on a count histogram (see count_histogram) so multi-host runs
    can feed the globally summed histogram and derive identical edges on
    every process.  Returns upper-inclusive count edges (ascending, last ==
    max observed count).
    """
    hist = np.asarray(hist, np.int64)
    values = np.nonzero(hist)[0].astype(np.int64)
    vfreq = hist[values]
    vclasses = np.maximum(32, -((values + 8) // -32) * 32)  # _budget_hint
    uniq = np.unique(vclasses)
    freq = np.asarray(
        [int(vfreq[vclasses == c].sum()) for c in uniq], np.int64
    )
    m = uniq.size
    if m == 1:
        return [int(values.max())]
    pref = np.concatenate([[0], np.cumsum(freq)])
    S_max = min(max_strata, m)
    INF = float("inf")
    # dp[s][j]: min cost of covering classes [0, j) with s strata
    dp = [[INF] * (m + 1) for _ in range(S_max + 1)]
    choice = [[0] * (m + 1) for _ in range(S_max + 1)]
    dp[0][0] = 0.0
    for s in range(1, S_max + 1):
        for j in range(1, m + 1):
            for i in range(j):
                if dp[s - 1][i] == INF:
                    continue
                c = dp[s - 1][i] + (pref[j] - pref[i]) * float(uniq[j - 1])
                if c < dp[s][j]:
                    dp[s][j] = c
                    choice[s][j] = i
    total = float(vfreq.sum())
    best_s = min(
        range(1, S_max + 1),
        key=lambda s: dp[s][m] / total * (1.0 + stratum_penalty * s),
    )
    # recover class boundaries -> count edges
    cuts = []
    j = m
    for s in range(best_s, 0, -1):
        cuts.append(j)
        j = choice[s][j]
    cuts = sorted(set(cuts))
    edges = []
    for j in cuts:
        b = uniq[j - 1]  # stratum budget class
        # the largest actual count in this class
        edges.append(int(values[vclasses <= b].max()))
    edges[-1] = int(values.max())
    return sorted(set(edges))


def stratify_edges(hist: np.ndarray, quantiles=None,
                   min_frac: float = 0.01):
    """Stratum plan from a count histogram: (lo, hi] count intervals,
    per-stratum population sizes, and padded budget hints.

    A pure function of the histogram — processes that share a (summed)
    histogram derive IDENTICAL strata structure, budgets, and quotas, which
    multi-host SPMD requires (every process must compile the same step
    program; the host-local ray stores differ).  Single-host
    ``stratify_rays`` is a thin wrapper.

    ``quantiles=None`` (default) uses the cost-optimal DP partition
    (_optimal_edges); a quantile tuple forces explicit edges.  Strata
    smaller than ``min_frac`` of the population merge into their higher
    neighbor, and adjacent strata with equal budgets merge (a sub-batch
    render has fixed per-call cost; slivers aren't worth one).
    """
    hist = np.asarray(hist, np.int64)
    values = np.nonzero(hist)[0]
    assert values.size, "empty count histogram"
    vmax = int(values.max())
    if quantiles is None:
        bnds = _optimal_edges(hist)
    else:
        edges = sorted({int(_hist_quantile(hist, q)) for q in quantiles})
        bnds = edges + [vmax]
    cum = np.cumsum(hist)

    def size_of(lo: int, hi: int) -> int:  # population with count in (lo, hi]
        top = int(cum[min(hi, cum.size - 1)])
        bot = int(cum[lo]) if lo >= 0 else 0
        return top - bot

    raw = []
    lo = -1
    for e in bnds:
        if size_of(lo, e):
            raw.append([lo, e])
        lo = e
    # merge slivers upward (the last stratum merges downward)
    min_n = max(1, int(min_frac * int(cum[-1])))
    bounds = []
    for b in raw:
        bounds.append(b)
        if len(bounds) >= 2 and size_of(*bounds[-2]) < min_n:
            prev = bounds.pop(-2)
            bounds[-1][0] = prev[0]
    if len(bounds) >= 2 and size_of(*bounds[-1]) < min_n:
        last = bounds.pop(-1)
        bounds[-1][1] = last[1]

    def max_in(lo: int, hi: int) -> int:
        return int(values[(values > lo) & (values <= hi)].max())

    budgets = [_budget_hint(max_in(*b)) for b in bounds]
    # adjacent strata that rounded to the SAME budget gain nothing from
    # separate sub-batches — merge
    i = 0
    while i + 1 < len(bounds):
        if budgets[i] == budgets[i + 1]:
            bounds[i][1] = bounds[i + 1][1]
            bounds.pop(i + 1)
            budgets.pop(i)
        else:
            i += 1
    sizes = [size_of(*b) for b in bounds]
    return [tuple(b) for b in bounds], sizes, budgets


def strata_from_bounds(counts: np.ndarray, bounds) -> List[np.ndarray]:
    """Index arrays of the rays whose count falls in each (lo, hi] bound."""
    counts = np.asarray(counts)
    return [
        np.nonzero((counts > lo) & (counts <= hi))[0] for lo, hi in bounds
    ]


def stratify_rays(counts: np.ndarray, quantiles=None,
                  min_frac: float = 0.01):
    """Partition ray indices into strata by candidate count (single-host
    wrapper over stratify_edges).  Returns (list of index arrays
    low->high, list of per-stratum candidate budget hints)."""
    counts = np.asarray(counts)
    bounds, _, budgets = stratify_edges(
        count_histogram(counts), quantiles=quantiles, min_frac=min_frac
    )
    return strata_from_bounds(counts, bounds), budgets


def stratify_rays_joint(cand_counts: np.ndarray, alive_counts: np.ndarray,
                        quantiles=None, min_frac: float = 0.01):
    """Alive-primary stratification: strata partitioned by EXACT-ALIVE
    count, with per-stratum two-stage budgets.

    The wide per-sample rows (density footprint gather + its backward
    scatter, the step's dominant traffic) run at the stage-2 alive budget
    K2, while the stage-1 candidate compaction moves only cheap rows — so
    the DP partition should minimize E[K2], not E[K1].  Partitioning by
    alive count does exactly that; each stratum's K1 is then the measured
    candidate maximum *within* the stratum, so BOTH compaction stages are
    exact by construction (no overflow at the measuring mask state).

    Returns (strata, cand_budgets K1, alive_budgets K2); alive budget is
    None where it does not undercut the stratum's candidate budget (single
    stage).  Reference economy matched: tensorBase.py:360-375 pays each
    ray's own alive count on every per-sample op.
    """
    alive_counts = np.asarray(alive_counts)
    cand_counts = np.asarray(cand_counts)
    strata, alive_budgets = stratify_rays(
        alive_counts, quantiles=quantiles, min_frac=min_frac
    )
    cand_budgets = [_budget_hint(cand_counts[sel].max()) for sel in strata]
    out_alive = [
        a if a < c else None for a, c in zip(alive_budgets, cand_budgets)
    ]
    return strata, cand_budgets, out_alive
