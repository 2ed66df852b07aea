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

With ``group`` on several ranks (parallel/mesh.py) every rank holds the
whole frame's rays and renders a disjoint share of its chunks: chunk j of
the uniform path, or bucket chunk j of the stratified one, on rank
j mod W.  The rendered rows are gathered to every rank (``gather_rows``),
the shaded samples summed and the overflow max-reduced, so every rank
returns the whole frame, the single-rank render's: each ray is rendered
on its own.

The stratified path marks its phases for a profiler (utils/tracing.py):
``tftorch.serve.count`` (the count pass, its read-back, the host sort and
the sorted rows' upload), one ``tftorch.serve.bucket`` a bucket chunk, and
``tftorch.serve.fetch``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..models.alpha_mask import COARSE_STRIDE
from ..ops.freq_mask import FreeMasks
from ..parallel.mesh import RankGroup, gather_rows, host_allmax, host_allsum
from ..utils import tracing
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


def _reduce_counts(n_valid: torch.Tensor, overflow: torch.Tensor,
                   group: Optional[RankGroup]):
    """The shaded samples summed and the overflow max-reduced over the
    ranks, on the device."""
    if group is None:
        return n_valid, overflow
    dev = n_valid.device
    return (torch.as_tensor(host_allsum(np.asarray([int(n_valid)]), group)[0], device=dev),
            torch.as_tensor(host_allmax(np.asarray([float(overflow)], np.float32), group)[0],
                            device=dev))


def _render_chunks(field, alpha_mask, rays, aabb, chunk: int, masks,
                   group: Optional[RankGroup] = None, **render_kw):
    """render_rays over device rays (M, 6), ``chunk`` at a time: (rgb, depth,
    shaded samples, largest overflow fraction of a chunk), all on the
    device.  With ``group`` on W ranks, chunk j is rendered on rank j mod W
    and the rows gathered to every rank."""
    starts = list(range(0, rays.shape[0], chunk))
    multi = group is not None
    mine = starts[group.rank::group.world] if multi else starts
    rgbs, depths, n_valid, overflow = [], [], [], []
    for s in mine:
        out = render_rays(field, rays[s : s + chunk], masks, aabb=aabb, is_train=False,
                          alpha_mask=alpha_mask, u=None, **render_kw)
        rgbs.append(out.rgb)
        depths.append(out.depth)
        n_valid.append(out.num_valid_samples)
        overflow.append(out.budget_overflow_frac)
    dev = rays.device
    n_valid = torch.stack(n_valid).sum() if n_valid else torch.zeros((), dtype=torch.int64,
                                                                      device=dev)
    overflow = torch.stack(overflow).amax() if overflow else torch.zeros((), device=dev)
    if not multi:
        return torch.cat(rgbs), torch.cat(depths), n_valid, overflow
    # every rank's rows padded to the most chunks a rank renders, gathered,
    # and put back in chunk order
    W = group.world
    per_rank = len(starts[0::W]) * chunk
    local = torch.cat([torch.cat(rgbs), torch.cat(depths)[:, None]], 1) if rgbs else \
        torch.zeros((0, 4), device=dev)
    local = torch.cat([local, local.new_zeros((per_rank - local.shape[0], 4))])
    rows = gather_rows(local, group).view(W, per_rank, 4)
    out = torch.cat([rows[j % W, (j // W) * chunk:(j // W) * chunk + min(chunk, rays.shape[0] - s)]
                     for j, s in enumerate(starts)])
    return (out[:, :3], out[:, 3]) + _reduce_counts(n_valid, overflow, group)


@torch.no_grad()
def render_chunked(
    field,
    alpha_mask,
    rays,
    aabb: torch.Tensor,
    *,
    chunk: int = 8192,
    masks: FreeMasks = FreeMasks(),
    group: Optional[RankGroup] = None,
    **render_kw,
) -> Tuple[torch.Tensor, torch.Tensor, int, float]:
    """Render (M, 6) rays (numpy or a tensor) in chunks on the field's
    device; returns (rgb (M, 3), depth (M,)) tensors there, the number of
    shaded samples and the largest budget overflow fraction of a chunk.
    ``render_kw`` are render_rays' keywords (step_size, n_samples,
    white_bg, ndc_ray, shade_top_k, fused, sample_budget, budget_mode,
    use_coarse_gate).  ``group``: the chunks split over its ranks."""
    rays = torch.as_tensor(rays, dtype=torch.float32, device=aabb.device)
    rgb, depth, n_valid, overflow = _render_chunks(field, alpha_mask, rays, aabb, chunk, masks,
                                                   group, **render_kw)
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
    zero-candidate ones, first in count order) are background.  With
    ``group`` on W ranks, ``take`` hands bucket chunk j to rank j mod W and
    ``fetch`` gathers the ranks' rows."""

    def __init__(self, order: np.ndarray, start: int, dev, group: Optional[RankGroup] = None):
        self.order, self.start = order, start
        self.out = torch.empty((order.shape[0] - start, 4), device=dev)
        self.n_valid = torch.zeros((), dtype=torch.int64, device=dev)
        self.overflow = torch.zeros((), device=dev)
        # the rendered rays' rows, uploaded once
        self.idx = torch.as_tensor(order[start:]).to(dev)
        self.group = group
        self.tasks: List[Tuple[int, int]] = []  # (lo, n) of each chunk handed out

    def take(self, lo: int, n: int) -> bool:
        """Hand out the chunk of sorted rays [lo, lo + n): whether this rank
        renders it."""
        self.tasks.append((lo, n))
        g = self.group
        return g is None or (len(self.tasks) - 1) % g.world == g.rank

    def _gather(self) -> None:
        """Every rank's chunks' rows into every rank's buffer."""
        g, dev = self.group, self.out.device

        def rows(q):
            spans = [torch.arange(lo - self.start, lo - self.start + n, device=dev)
                     for j, (lo, n) in enumerate(self.tasks) if j % g.world == q]
            return torch.cat(spans) if spans else torch.zeros(0, dtype=torch.int64, device=dev)

        owned = [rows(q) for q in range(g.world)]
        width = max(r.numel() for r in owned)
        local = self.out[owned[g.rank]]
        local = torch.cat([local, local.new_zeros((width - local.shape[0], 4))])
        every = gather_rows(local, g).view(g.world, width, 4)
        for q, r in enumerate(owned):
            if q != g.rank:
                self.out[r] = every[q, :r.numel()]
        self.n_valid, self.overflow = _reduce_counts(self.n_valid, self.overflow, g)

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
        with tracing.span("tftorch.serve.fetch"):
            if self.group is not None:
                self._gather()
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
    group: Optional[RankGroup] = None,
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
    above 512 samples caps the chunk at 8192 rays.  ``group``: every rank
    counts the whole frame and renders its share of the bucket chunks (the
    legacy path: of each bucket's chunks); every rank returns the frame."""
    common = dict(step_size=step_size, white_bg=white_bg, shade_top_k=shade_top_k, fused=fused)
    if ndc_ray:
        rgb, depth, n_valid, overflow = render_chunked(
            field, alpha_mask, rays, aabb, chunk=min(chunk, 8192) if n_samples > 512 else chunk,
            masks=masks, group=group, n_samples=n_samples, ndc_ray=True, use_coarse_gate=False,
            **common)
        return rgb.cpu().numpy(), depth.cpu().numpy(), n_valid, overflow
    from .culling import count_ray_candidates, count_ray_candidates_and_alive

    near_far = tuple(float(v) for v in field.cfg.near_far)
    if use_coarse_gate and not alive_stage:
        return _render_stratified_resident(field, alpha_mask, rays, aabb, n_samples=n_samples,
                                           chunk=chunk, masks=masks, near_far=near_far, log=log,
                                           group=group, **common)
    dev = aabb.device
    with tracing.span("tftorch.serve.count"):
        rays = torch.as_tensor(rays, dtype=torch.float32, device=dev)
        count_args = (rays, alpha_mask, aabb.cpu().numpy(), step_size, near_far)
        alive_counts = None
        if use_coarse_gate:
            counts, alive_counts, _ = count_ray_candidates_and_alive(
                *count_args, n_samples=n_samples, chunk=max(chunk, 32768))
        else:
            counts = count_ray_candidates(*count_args, n_samples=n_samples,
                                          chunk=max(chunk, 32768), use_coarse=False)
        dirz = rays[:, 5].cpu().numpy()
        order, sorted_counts, start, tiers = _sort_by_count(counts, n_samples)
        frame = _SortedFrame(order, start, dev)
    if log is not None:
        log(f"count pass: {rays.shape[0]} rays, {start} with no candidate composited on the host")
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
        # the bucket's chunks split over the ranks, gathered to each
        with tracing.span("tftorch.serve.bucket"):
            frame.put(lo, n_b, *_render_chunks(
                field, alpha_mask, rays.index_select(0, frame.rows(lo, n_b)), aabb, chunk_b,
                masks, group, n_samples=n_samples, sample_budget=tier, budget_mode="cand",
                use_coarse_gate=use_coarse_gate, alive_budget=alive_tier, **common))
        if log is not None:
            log(f"bucket tier={tier} K={tier} alive={alive_tier} rays={n_b} chunk={chunk_b} "
                f"lattice={n_samples}")
    return frame.fetch(dirz, white_bg)


def _render_stratified_resident(field, alpha_mask, rays, aabb, *, n_samples: int, chunk: int,
                                masks, near_far, log, group=None, **common):
    """The device-resident path: the count pass leaves the padded rays and
    their window bits on the device; each bucket chunk gathers its rows from
    them (render_rays' window-bits path, no lattice) on a lattice capped at
    the bucket's longest chord, snapped up to a multiple of 128, at the
    bucket's tier budget (the capped lattice itself where it is tighter).
    A bucket whose budget is no COARSE_STRIDE multiple (the lattice with
    n_samples % 4 != 0) renders on that lattice instead."""
    from .culling import count_ray_candidates_chord_bits

    M = rays.shape[0]
    with tracing.span("tftorch.serve.count"):
        counts, chords, bits_dev, rays_dev = count_ray_candidates_chord_bits(
            rays, alpha_mask, aabb.cpu().numpy(), common["step_size"], near_far,
            n_samples=n_samples, tile=max(chunk, 32768))
        if isinstance(rays, torch.Tensor):
            dirz = rays_dev[:M, 5].cpu().numpy()
        else:
            dirz = np.asarray(rays, np.float32)[:, 5]
        order, sorted_counts, start, tiers = _sort_by_count(counts, n_samples)
        frame = _SortedFrame(order, start, rays_dev.device, group)
    if log is not None:
        log(f"count pass: {M} rays, {start} with no candidate composited on the host")
    for tier, lo, hi in _buckets(sorted_counts, start, tiers):
        cmax = int(chords[order[lo:hi]].max())
        n_eff = min(n_samples, max(128, -(-cmax // 128) * 128))
        tier_b = tier if (tier is not None and tier < n_eff) else None
        # the window-bits render needs a COARSE_STRIDE-multiple budget: with
        # no tier below the capped lattice, the lattice is the budget
        K_b = tier_b if tier_b is not None else n_eff
        if K_b % COARSE_STRIDE != 0:
            cb = chunk if (tier_b is not None or n_eff <= 512) else min(chunk, 8192)
            if frame.take(lo, hi - lo):
                with tracing.span("tftorch.serve.bucket"):
                    frame.put(lo, hi - lo, *_render_chunks(
                        field, alpha_mask, rays_dev.index_select(0, frame.rows(lo, hi - lo)),
                        aabb, cb, masks, n_samples=n_eff, sample_budget=tier_b,
                        budget_mode="cand", **common))
            if log is not None:
                log(f"bucket tier={tier} K={tier_b} rays={hi - lo} chunk={cb} lattice={n_eff} "
                    f"(lattice render)")
            continue
        # memory guard: (chunk x K_b) feature rows
        cap = chunk if K_b <= 512 else min(chunk, 8192)
        while lo < hi:
            c = _next_chunk(hi - lo, cap)
            n = min(c, hi - lo)
            if frame.take(lo, n):
                with tracing.span("tftorch.serve.bucket"):
                    frame.put(lo, n, *_render_eval_windows(
                        field, alpha_mask, rays_dev, bits_dev, frame.rows(lo, n, c), aabb,
                        masks, n_samples=n_eff, sample_budget=K_b, **common))
            if log is not None:
                log(f"bucket tier={tier} K={K_b} rays={n} chunk={c} lattice={n_eff}")
            lo += n
    return frame.fetch(dirz, common["white_bg"])
