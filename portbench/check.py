"""The comparisons that decide ``correct``: the port's output against the
plain reference's on the same made inputs.

Training (three steps of the timed step function, from the made state,
each with the benchmark's noise and, where the step is stratified, every
row's loss weighted alike):
* ``store_gap``: each checked batch row of the port's ray store (the
  loader's rays and colours) against the benchmark's own ray and photo
  pixel, the widest gap; the reference renders the port's rays, held to
  the benchmark's by this number, against the benchmark's own targets;
* ``loss_gap``: the widest relative gap of the three steps' losses;
* ``grad_gap``: the first gradient, as Adam holds it after step one, by
  the worst leaf: the gap between the two leaf norms over the larger of
  the reference's leaf norm and its median leaf norm;
* ``grad_gap_median``: the same gap of the median leaf, steady where one
  leaf's gap swings from seed to seed (a cell's limits say which numbers
  it compares; the others are reported);
* ``change_gap``: the parameters' change over the three steps, by the
  worst leaf, measured alike, and ``change_gap_median``, that of the
  median leaf.
``grad_gap`` takes every leaf.  Leaves whose reference gradient is under a
thousandth of the median leaf's move under Adam by round-off alone (its
first steps move an element by about its learning rate whatever the
gradient's size, so a gradient that cancels to round-off takes either
sign); they are left out of ``change_gap``.

Serving: ``rgb_mean_gap``, the mean per-channel rgb gap over sampled
served views (the widest gaps ``rgb_gap`` and ``depth_gap`` are reported
beside it: a top-K or threshold decision within round-off of flipping
moves a pixel by up to that sample's weight, so the widest gap swings from
seed to seed above what the control reads).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import reference as ref
from .scene import BLENDER2OPENCV, Scene, forward_rays, forward_train_views


def composite_rows(scene: Scene, rays: torch.Tensor, rgbs: torch.Tensor):
    """(widest gap, own targets (M, 3)) of store rows (rays (M, 6), rgbs
    (M, 3)) against the pixel each names: the view is the camera nearest
    the row's origin, the pixel the one its direction passes closest to;
    the gap takes the origin, the direction and the colour."""
    dev = rays.device
    W, H = scene.wh
    f = scene.focal
    poses = torch.as_tensor(scene.c2w @ BLENDER2OPENCV, device=dev)  # (V, 4, 4)
    centres = poses[:, :3, 3]
    dist = torch.linalg.norm(rays[:, None, :3] - centres[None], dim=-1)
    o_gap, view = dist.min(dim=1)
    R = poses[view, :3, :3]  # (M, 3, 3)
    d_cam = torch.einsum("mji,mj->mi", R, rays[:, 3:6])
    i = torch.round(d_cam[:, 0] / d_cam[:, 2] * f + W / 2 - 0.5).long().clamp(0, W - 1)
    j = torch.round(d_cam[:, 1] / d_cam[:, 2] * f + H / 2 - 0.5).long().clamp(0, H - 1)
    own = torch.stack([(i.float() + 0.5 - W / 2) / f, (j.float() + 0.5 - H / 2) / f,
                       torch.ones_like(d_cam[:, 0])], -1)
    own = own / torch.linalg.norm(own, dim=-1, keepdim=True)
    own_d = torch.einsum("mij,mj->mi", R, own)
    px = scene.images[view, j, i].float() / 255.0
    own_rgb = px[:, :3] * px[:, 3:] + (1.0 - px[:, 3:])
    return max(float(o_gap.max()), float((own_d - rays[:, 3:6]).abs().max()),
               float((own_rgb - rgbs).abs().max())), own_rgb


def forward_rows(scene: Scene, ids: torch.Tensor, rays: torch.Tensor, rgbs: torch.Tensor):
    """(widest gap, own targets (M, 3)) of store rows against the
    benchmark's own: the forward store is every train view's every pixel
    in order, so an id names its view and pixel."""
    W, H = scene.wh
    views = forward_train_views(len(scene.c2w))
    slot, pix = ids // (W * H), ids % (W * H)
    gap = 0.0
    own_rgb = torch.empty_like(rgbs)
    for s in torch.unique(slot).tolist():
        sel = slot == s
        own = forward_rays(scene, [views[s]], rays.device)[pix[sel]]
        own_rgb[sel] = scene.images[views[s]].reshape(-1, 3)[pix[sel]].float() / 255.0
        gap = max(gap, float((own - rays[sel]).abs().max()),
                  float((own_rgb[sel] - rgbs[sel]).abs().max()))
    return gap, own_rgb


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float], keep: List[str]
              ) -> Dict[str, float]:
    """Per leaf: |prog - ref| / max(ref, median ref) over ``keep``."""
    med = float(np.median([refn[k] for k in keep]))
    return {k: abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30) for k in keep}


def reference_readings(model: ref.Model, geom: ref.Geometry, lw: ref.Loss,
                       p0: Dict[str, torch.Tensor], steps: List[dict], lrs: Dict[str, float],
                       prec: ref.Precision, block: int, device) -> dict:
    """The reference over the checked steps from ``p0``: each step's loss,
    the first gradient's leaf norms, the change's leaf norms after the
    last.  ``steps``: per step {iteration, strata}."""
    P = {k: v.to(device).clone().requires_grad_(True) for k, v in p0.items()}
    adam = ref.Adam(P, lrs, lw.lr_factor)
    losses, g1 = [], None
    for n, st in enumerate(steps):
        losses.append(ref.step_loss(model, P, geom, lw, st["iteration"], st["strata"], prec,
                                    block))
        if n == 0:
            g1 = {k: float(torch.linalg.norm(p.grad)) if p.grad is not None else 0.0
                  for k, p in P.items()}
        adam.step()
    change = {k: float(torch.linalg.norm(P[k].detach() - p0[k].to(device))) for k in P}
    return dict(losses=losses, grad1=g1, change=change)


def train_numbers(prog: dict, refr: dict) -> Dict[str, float]:
    """The port's (or a control's) readings against the reference's."""
    g1 = refr["grad1"]
    med = float(np.median(list(g1.values())))
    keep = [k for k in g1 if g1[k] >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], refr["losses"]))
    grad = leaf_gaps(prog["grad1"], g1, list(g1))
    change = leaf_gaps(prog["change"], refr["change"], keep)
    return dict(loss_gap=loss_gap, grad_gap=max(grad.values()),
                grad_gap_median=float(np.median(list(grad.values()))),
                change_gap=max(change.values()),
                change_gap_median=float(np.median(list(change.values()))),
                grad_leaf=max(grad, key=grad.get),
                change_leaf=max(change, key=change.get),
                left_out=[k for k in g1 if k not in keep])


def serve_numbers(model: ref.Model, P, geom: ref.Geometry, views: List[tuple],
                  prec: ref.Precision, block: int) -> Dict[str, float]:
    """``views``: (rays (M, 6) on the device, rgb (M, 3), depth (M,)) of the
    port's served views, host arrays; the reference renders the rays in
    ``prec``."""
    rgb_gap = depth_gap = total = 0.0
    count = 0
    with torch.no_grad():
        for rays, rgb, depth in views:
            for a in range(0, rays.shape[0], block):
                out = ref.render(model, P, geom, rays[a:a + block], ref.Masks(), prec)
                r = torch.as_tensor(rgb[a:a + block], device=rays.device)
                d = torch.as_tensor(depth[a:a + block], device=rays.device)
                gap = (out.rgb - r).abs()
                rgb_gap = max(rgb_gap, float(gap.max()))
                total += float(gap.double().sum())
                count += gap.numel()
                depth_gap = max(depth_gap, float((out.depth - d).abs().max()))
    return dict(rgb_mean_gap=total / count, rgb_gap=rgb_gap, depth_gap=depth_gap)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every number within its limit; a
    number that is not finite fails."""
    rows = {k: {"value": float(numbers[k]), "limit": limits.get(k)} for k in limits}
    ok = all(v["limit"] is not None and math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in rows.values())
    return ok, rows
