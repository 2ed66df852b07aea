"""Chunked eval-time rendering and stratified serving (counterpart of
tensorf_tpu/render/chunked.py).

``render_chunked`` renders rays in chunks under no_grad, with no jitter, at
one uniform sample budget if one is given.

``render_chunked_stratified`` is the serving path.  It counts each ray's
candidate samples, sorts the rays by count on the host, composites the
zero-candidate rays to background there, renders each budget-tier bucket at
its own budget on a lattice capped at the bucket's longest chord, and puts
the results back in pixel order.  That is exact by construction: a tier
covers the count of every member, and the eval render draws no jitter.  The
device-resident path renders from the count pass's window bits and never
builds a sample lattice; the legacy path renders each bucket on the full
lattice from the training side's count passes: the exact-gate one without
the coarse gate, the candidate-and-alive one for its exact-alive second
stage (``alive_stage``).  Both enqueue every bucket chunk before reading
anything back: the counts reach the host in one copy before the bucket
loop, the pixels in one copy after it.

``render_frame`` renders a whole frame in fixed-size tiles, the last one
padded, so every tile launches the same shapes.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..models.alpha_mask import COARSE_STRIDE
from ..ops.freq_mask import FreeMasks
from .volume import render_rays

# Chunk-size ladder of the serving paths: the per-chunk cost scales with
# the chunk, so a small bucket must not pad to the full chunk; few shapes
# keep the set of distinct launches small.
_CHUNK_LADDER = (2048, 4096, 8192, 16384, 32768)

# Budget ladder of stratified serving: a bucket's candidate budget is its
# count tier, snapped up to one of these (32-multiples, spaced to bound the
# padding within a tier at about 1.25x below 512).
BUDGET_TIERS = (32, 64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512,
                640, 768, 1024)


def _next_chunk(rem: int, cap: int) -> int:
    """Smallest ladder size >= rem (<= cap) — unless that would pad by
    >1.3x, in which case the largest ladder size <= rem (the bucket then
    spans multiple chunks)."""
    sizes = [c for c in _CHUNK_LADDER if c <= cap] or [cap]
    c = next((x for x in sizes if x >= rem), sizes[-1])
    if c > rem * 1.3 and c > sizes[0]:
        c = max(x for x in sizes if x <= max(rem, sizes[0]))
    return c


def _render_chunks(field, alpha_mask, rays, aabb, chunk: int, masks, **render_kw):
    """render_rays over device rays (M, 6), ``chunk`` at a time: (rgb, depth,
    shaded samples, largest overflow fraction of a chunk), all on the device."""
    rgbs, depths, n_valid, overflow = [], [], [], []
    for s in range(0, rays.shape[0], chunk):
        out = render_rays(field, rays[s : s + chunk], masks, aabb=aabb, is_train=False,
                          alpha_mask=alpha_mask, u=None, **render_kw)
        rgbs.append(out.rgb)
        depths.append(out.depth)
        n_valid.append(out.num_valid_samples)
        overflow.append(out.budget_overflow_frac)
    return (torch.cat(rgbs), torch.cat(depths), torch.stack(n_valid).sum(),
            torch.stack(overflow).amax())


@torch.no_grad()
def render_chunked(
    field,
    alpha_mask,
    rays,
    aabb: torch.Tensor,
    *,
    chunk: int = 8192,
    masks: FreeMasks = FreeMasks(),
    **render_kw,
) -> Tuple[torch.Tensor, torch.Tensor, int, float]:
    """Render (M, 6) rays (numpy or a tensor) in chunks on the field's
    device; returns (rgb (M, 3), depth (M,)) tensors there, the number of
    shaded samples and the largest budget overflow fraction of a chunk.
    ``render_kw`` are render_rays' keywords (step_size, n_samples,
    white_bg, ndc_ray, shade_top_k, fused, sample_budget, budget_mode,
    use_coarse_gate)."""
    rays = torch.as_tensor(rays, dtype=torch.float32, device=aabb.device)
    rgb, depth, n_valid, overflow = _render_chunks(field, alpha_mask, rays, aabb, chunk, masks,
                                                   **render_kw)
    return rgb, depth, int(n_valid), float(overflow)


@torch.no_grad()
def render_frame(
    field,
    alpha_mask,
    rays,
    aabb: torch.Tensor,
    *,
    tile: int = 16384,
    masks: FreeMasks = FreeMasks(),
    **render_kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (M, 6) rays (numpy or a tensor) in ``tile``-ray tiles, the
    last padded by repeating the last ray; numpy (rgb (M, 3), depth (M,)).
    ``render_kw`` as render_chunked's."""
    rays = torch.as_tensor(rays, dtype=torch.float32, device=aabb.device)
    M = rays.shape[0]
    pad = (-M) % tile
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, 6)])
    rgb, depth, _, _ = _render_chunks(field, alpha_mask, rays, aabb, tile, masks, **render_kw)
    return rgb[:M].cpu().numpy(), depth[:M].cpu().numpy()


def rays_from_pose(directions: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """get_rays on the device: camera-space directions (M, 3) and a pose
    (3|4, 4) -> the (M, 6) ray store, on the directions' device.  With the
    directions resident, a new view costs a pose upload, not a ray upload.
    A float32 matmul: the entry points keep TF32 off."""
    rays_d = directions @ c2w[:3, :3].T
    return torch.cat([c2w[:3, 3].expand_as(rays_d), rays_d], dim=-1)


def _render_eval_windows(field, alpha_mask, rays_store, bits_store, idx, aabb, masks, *,
                         n_samples: int, sample_budget: int, **common):
    """One bucket chunk of the resident path: its rays and window bits
    gathered from the frame-resident stores by ``idx``, the bits cut to the
    bytes of the ``n_samples`` lattice, rendered from the bits."""
    gb = -(-(-(-n_samples // COARSE_STRIDE)) // 8)
    rays = rays_store.index_select(0, idx)
    bits = bits_store.index_select(0, idx)[:, :gb]
    out = render_rays(field, rays, masks, aabb=aabb, n_samples=n_samples, is_train=False,
                      sample_budget=sample_budget, budget_mode="cand", alpha_mask=alpha_mask,
                      cand_window_bits=bits, u=None, **common)
    return out.rgb, out.depth, out.num_valid_samples, out.budget_overflow_frac


class _SortedFrame:
    """A frame's rendered rays in count order on the device: each bucket
    chunk's rgb and depth land in one (M - start, 4) buffer, and the shaded
    samples and the largest overflow accumulate beside it, so nothing is
    read back until every chunk is enqueued.  ``start`` rays (the
    zero-candidate ones, first in count order) are background."""

    def __init__(self, order: np.ndarray, start: int, dev):
        self.order, self.start = order, start
        self.out = torch.empty((order.shape[0] - start, 4), device=dev)
        self.n_valid = torch.zeros((), dtype=torch.int64, device=dev)
        self.overflow = torch.zeros((), device=dev)
        # the rendered rays' rows, uploaded once
        self.idx = torch.as_tensor(order[start:]).to(dev)

    def rows(self, lo: int, n: int, pad_to: int = 0) -> torch.Tensor:
        """Store rows of sorted rays [lo, lo + n), the last repeated up to
        ``pad_to``."""
        idx = self.idx[lo - self.start : lo - self.start + n]
        return torch.cat([idx, idx[-1:].expand(pad_to - n)]) if pad_to > n else idx

    def put(self, lo: int, n: int, rgb, depth, n_valid, overflow) -> None:
        rows = self.out[lo - self.start : lo - self.start + n]
        rows[:, :3] = rgb[:n]
        rows[:, 3] = depth[:n]
        self.n_valid += n_valid
        self.overflow = torch.maximum(self.overflow, overflow)

    def fetch(self, dirz: np.ndarray, white_bg: bool):
        """Pixel-order numpy rgb and depth, the shaded samples and the
        largest overflow: one copy of the buffer, then the background rays
        filled on the host (acc = 0: the background color, and depth
        (1 - acc) * rays[:, -1] as the composite computes it)."""
        host = self.out.cpu().numpy()
        M = self.order.shape[0]
        rgb, depth = np.empty((M, 3), np.float32), np.empty((M,), np.float32)
        bg, hit = self.order[: self.start], self.order[self.start :]
        rgb[bg] = 1.0 if white_bg else 0.0
        depth[bg] = dirz[bg]
        rgb[hit], depth[hit] = host[:, :3], host[:, 3]
        return rgb, depth, int(self.n_valid), float(self.overflow)


def _sort_by_count(counts: np.ndarray, n_samples: int):
    """(order, sorted counts, zero-candidate rays, the tiers below the
    lattice)."""
    order = np.argsort(counts, kind="stable")
    sorted_counts = counts[order]
    start = int(np.searchsorted(sorted_counts, 0, side="right"))
    return order, sorted_counts, start, [t for t in BUDGET_TIERS if t < n_samples]


def _buckets(sorted_counts: np.ndarray, start: int, tiers: List[int]):
    """(tier, lo, hi) of each non-empty bucket in count order; tier None is
    the tail above the last tier, rendered on the full lattice."""
    M = sorted_counts.shape[0]
    for tier in tiers + [None]:
        if start >= M:
            return
        end = M if tier is None else int(np.searchsorted(sorted_counts, tier, side="right"))
        if end > start:
            yield tier, start, end
            start = end


@torch.no_grad()
def render_chunked_stratified(
    field,
    alpha_mask,
    rays,
    aabb: torch.Tensor,
    *,
    step_size: float,
    n_samples: int,
    white_bg: bool,
    ndc_ray: bool = False,
    shade_top_k: Optional[int] = None,
    fused: bool = True,
    chunk: int = 8192,
    masks: FreeMasks = FreeMasks(),
    use_coarse_gate: bool = True,
    alive_stage: bool = False,
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[np.ndarray, np.ndarray, int, float]:
    """Candidate-count-stratified serving of (M, 6) rays (numpy or a device
    tensor, e.g. from rays_from_pose) on the field's device; returns numpy
    (rgb (M, 3), depth (M,)), the shaded samples and the largest overflow
    fraction of a chunk (0.0: every tier covers its bucket).

    With the coarse gate it runs the device-resident window-bits path
    unless ``alive_stage`` asks for the legacy path's exact-alive second
    stage.  The legacy path renders each bucket on the full lattice: without
    the coarse gate it counts with the exact-gate pass; with ``alive_stage``
    it counts candidates and alive samples, and a bucket whose largest alive
    count snaps to a tier below its candidate tier compacts to that tier
    once more.  ``log`` receives the count pass's line and one line per
    bucket, on the resident path per bucket chunk (tier, budget K, rays,
    chunk, lattice).

    NDC rays render uniform and unbudgeted, without the coarse gate: the
    count passes march the non-NDC slab and would miscount them.  A lattice
    above 512 samples caps the chunk at 8192 rays."""
    common = dict(step_size=step_size, white_bg=white_bg, shade_top_k=shade_top_k, fused=fused)
    if ndc_ray:
        rgb, depth, n_valid, overflow = render_chunked(
            field, alpha_mask, rays, aabb, chunk=min(chunk, 8192) if n_samples > 512 else chunk,
            masks=masks, n_samples=n_samples, ndc_ray=True, use_coarse_gate=False, **common)
        return rgb.cpu().numpy(), depth.cpu().numpy(), n_valid, overflow
    from .culling import count_ray_candidates, count_ray_candidates_and_alive

    near_far = tuple(float(v) for v in field.cfg.near_far)
    if use_coarse_gate and not alive_stage:
        return _render_stratified_resident(field, alpha_mask, rays, aabb, n_samples=n_samples,
                                           chunk=chunk, masks=masks, near_far=near_far, log=log,
                                           **common)
    dev = aabb.device
    rays = torch.as_tensor(rays, dtype=torch.float32, device=dev)
    count_args = (rays, alpha_mask, aabb.cpu().numpy(), step_size, near_far)
    alive_counts = None
    if use_coarse_gate:
        counts, alive_counts, _ = count_ray_candidates_and_alive(
            *count_args, n_samples=n_samples, chunk=max(chunk, 32768))
    else:
        counts = count_ray_candidates(*count_args, n_samples=n_samples, chunk=max(chunk, 32768),
                                      use_coarse=False)
    dirz = rays[:, 5].cpu().numpy()
    order, sorted_counts, start, tiers = _sort_by_count(counts, n_samples)
    if log is not None:
        log(f"count pass: {rays.shape[0]} rays, {start} with no candidate composited on the host")
    frame = _SortedFrame(order, start, dev)
    for tier, lo, hi in _buckets(sorted_counts, start, tiers):
        # the exact-alive second stage: eval counts draw no jitter, so the
        # bucket's largest alive count, snapped up the tier ladder, is an
        # exact budget; used only where it undercuts the candidate tier
        alive_tier = None
        if tier is not None and alive_counts is not None:
            amax = int(alive_counts[order[lo:hi]].max())
            snapped = next((t for t in BUDGET_TIERS if t >= amax), None)
            if snapped is not None and snapped < tier:
                alive_tier = snapped
        n_b = hi - lo
        chunk_b = chunk
        for c in _CHUNK_LADDER[:-1]:
            if c >= chunk:
                break
            if n_b <= c:
                chunk_b = c
                break
        # memory guard: an unbudgeted deep lattice caps the chunk
        if tier is None and n_samples > 512:
            chunk_b = min(chunk_b, 8192)
        frame.put(lo, n_b, *_render_chunks(
            field, alpha_mask, rays.index_select(0, frame.rows(lo, n_b)), aabb, chunk_b, masks,
            n_samples=n_samples, sample_budget=tier, budget_mode="cand",
            use_coarse_gate=use_coarse_gate, alive_budget=alive_tier, **common))
        if log is not None:
            log(f"bucket tier={tier} K={tier} alive={alive_tier} rays={n_b} chunk={chunk_b} "
                f"lattice={n_samples}")
    return frame.fetch(dirz, white_bg)


def _render_stratified_resident(field, alpha_mask, rays, aabb, *, n_samples: int, chunk: int,
                                masks, near_far, log, **common):
    """The device-resident path: the count pass leaves the padded rays and
    their window bits on the device; each bucket chunk gathers its rows from
    them (render_rays' window-bits path, no lattice) on a lattice capped at
    the bucket's longest chord, snapped up to a multiple of 128, at the
    bucket's tier budget (the capped lattice itself where it is tighter).
    A bucket whose budget is no COARSE_STRIDE multiple (the lattice with
    n_samples % 4 != 0) renders on that lattice instead."""
    from .culling import count_ray_candidates_chord_bits

    M = rays.shape[0]
    counts, chords, bits_dev, rays_dev = count_ray_candidates_chord_bits(
        rays, alpha_mask, aabb.cpu().numpy(), common["step_size"], near_far,
        n_samples=n_samples, tile=max(chunk, 32768))
    if isinstance(rays, torch.Tensor):
        dirz = rays_dev[:M, 5].cpu().numpy()
    else:
        dirz = np.asarray(rays, np.float32)[:, 5]
    order, sorted_counts, start, tiers = _sort_by_count(counts, n_samples)
    if log is not None:
        log(f"count pass: {M} rays, {start} with no candidate composited on the host")
    frame = _SortedFrame(order, start, rays_dev.device)
    for tier, lo, hi in _buckets(sorted_counts, start, tiers):
        cmax = int(chords[order[lo:hi]].max())
        n_eff = min(n_samples, max(128, -(-cmax // 128) * 128))
        tier_b = tier if (tier is not None and tier < n_eff) else None
        # the window-bits render needs a COARSE_STRIDE-multiple budget: with
        # no tier below the capped lattice, the lattice is the budget
        K_b = tier_b if tier_b is not None else n_eff
        if K_b % COARSE_STRIDE != 0:
            cb = chunk if (tier_b is not None or n_eff <= 512) else min(chunk, 8192)
            frame.put(lo, hi - lo, *_render_chunks(
                field, alpha_mask, rays_dev.index_select(0, frame.rows(lo, hi - lo)), aabb, cb,
                masks, n_samples=n_eff, sample_budget=tier_b, budget_mode="cand", **common))
            if log is not None:
                log(f"bucket tier={tier} K={tier_b} rays={hi - lo} chunk={cb} lattice={n_eff} "
                    f"(lattice render)")
            continue
        # memory guard: (chunk x K_b) feature rows
        cap = chunk if K_b <= 512 else min(chunk, 8192)
        while lo < hi:
            c = _next_chunk(hi - lo, cap)
            n = min(c, hi - lo)
            frame.put(lo, n, *_render_eval_windows(
                field, alpha_mask, rays_dev, bits_dev, frame.rows(lo, n, c), aabb, masks,
                n_samples=n_eff, sample_budget=K_b, **common))
            if log is not None:
                log(f"bucket tier={tier} K={K_b} rays={n} chunk={c} lattice={n_eff}")
            lo += n
    return frame.fetch(dirz, common["white_bg"])
