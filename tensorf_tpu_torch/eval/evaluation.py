"""Evaluation entry points: test-set metrics, trajectory rendering and the
mid-training PSNR sweep (counterpart of tensorf_tpu/eval/evaluation.py).

``evaluation`` renders each (stacked) view and computes its PSNR, SSIM and
LPIPS (None -> NaN); ``evaluation_path`` renders a camera trajectory.  Only
when ``savePath`` is given do they write PNGs, the two videos and (for
``evaluation``) mean.txt; imageio is imported there and nowhere else.  A
stratified handle with a mask serves each view through
render_chunked_stratified, exact by construction; otherwise the view is
rendered in uniform chunks at the handle's budget.  A render whose sample
budget dropped candidates prints a warning.  A handle with a ``group``
splits every frame's chunks over the ranks (render/chunked.py), which must
all call it in step: every rank then returns the same images and metrics,
and only rank 0 writes files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.alpha_mask import AlphaGridMask
from ..ops.rays import get_rays, ndc_rays_blender
from ..parallel.mesh import RankGroup, is_writer
from ..render.chunked import render_chunked, render_chunked_stratified
from ..utils import tracing
from ..utils.misc import visualize_depth_numpy
from .metrics import psnr as psnr_fn
from .metrics import rgb_lpips, rgb_ssim


@dataclasses.dataclass
class RendererHandle:
    """Everything needed to render rays with the current model state."""

    field: torch.nn.Module
    alpha_mask: Optional[AlphaGridMask]
    aabb: torch.Tensor  # (2, 3) on the field's device
    step_size: float
    n_samples: int
    white_bg: bool
    ndc_ray: bool = False
    shade_top_k: Optional[int] = None
    fused: bool = True
    # the uniform render's budget ("alive" mode); None = every sample
    sample_budget: Optional[int] = None
    use_coarse_gate: bool = True
    # candidate-count-stratified serving with per-bucket budgets whenever
    # there is a mask (the uniform path without one, and for NDC rays)
    stratified: bool = False
    # the largest budget overflow fraction of a chunk over this handle's
    # renders so far (0.0: nothing under-integrated)
    max_overflow: float = 0.0
    # the ranks that split every frame's chunks (None: this process alone),
    # as the JAX handle carries its mesh
    group: Optional[RankGroup] = None

    def render(self, rays, chunk: int = 8192, log: Optional[Callable[[str], None]] = None):
        """(M, 6) rays (numpy or a tensor) -> (rgb (M, 3), depth (M,))
        numpy, shaded samples.  ``log`` receives the stratified path's count
        and bucket lines (render_chunked_stratified)."""
        with tracing.span("tftorch.serve.view"):
            kw = dict(step_size=float(self.step_size), n_samples=int(self.n_samples),
                      white_bg=self.white_bg, ndc_ray=self.ndc_ray, shade_top_k=self.shade_top_k,
                      fused=self.fused, use_coarse_gate=self.use_coarse_gate)
            if self.stratified and self.alpha_mask is not None:
                rgb, depth, n_valid, overflow = render_chunked_stratified(
                    self.field, self.alpha_mask, rays, self.aabb, chunk=chunk, log=log,
                    group=self.group, **kw)
            else:
                rgb, depth, n_valid, overflow = render_chunked(
                    self.field, self.alpha_mask, rays, self.aabb, chunk=chunk,
                    sample_budget=self.sample_budget, group=self.group, **kw)
                rgb, depth = rgb.cpu().numpy(), depth.cpu().numpy()
            self.max_overflow = max(self.max_overflow, overflow)
            if overflow > 0.0:
                # a too-small budget would silently under-integrate the images
                print(f"[eval] WARNING: sample-budget overflow on up to {overflow:.1%} of rays "
                      f"in a chunk — rendered images may under-integrate; raise sample_budget",
                      flush=True)
            return rgb, depth, n_valid


def _depth_rgb(depth: np.ndarray, near_far) -> np.ndarray:
    """(H, W) depth -> uint8 RGB JET image over [near, far], as the JAX
    evaluation colours it (utils/misc.py's BGR map, flipped to RGB)."""
    return visualize_depth_numpy(depth, near_far)[0][..., ::-1]


def _write_video(imageio, path: str, frames: List[np.ndarray], fps: int = 30) -> None:
    try:
        imageio.mimwrite(path, np.stack(frames), fps=fps, quality=10)
    except Exception as e:  # no mp4 backend: write a GIF beside it
        gif = os.path.splitext(path)[0] + ".gif"
        imageio.mimwrite(gif, np.stack(frames), format="GIF", duration=1000.0 / fps, loop=0)
        print(f"[eval] no mp4 backend ({type(e).__name__}); wrote {gif}")


def evaluation(
    test_dataset,
    handle: RendererHandle,
    savePath: Optional[str] = None,
    chunk: int = 8192,
    heartbeat: Optional[Callable[[], None]] = None,
) -> List[float]:
    """Render the stacked dataset's views and return their PSNRs
    (reference renderer.py:148-225); ``heartbeat`` runs once per view (the
    training run's watchdog)."""
    PSNRs, ssims, l_alex, l_vgg = [], [], [], []
    rgb_frames, depth_frames = [], []
    W, H = test_dataset.img_wh
    imageio = None
    if not is_writer(handle.group):  # rank 0 writes (tensorf_tpu evaluation.py:151)
        savePath = None
    if savePath is not None:
        import imageio.v2 as imageio

        for sub in ("prediction", "ground_truth", "rgbd"):
            os.makedirs(f"{savePath}/{sub}", exist_ok=True)

    for idx in range(test_dataset.all_rays.shape[0]):
        if heartbeat is not None:
            heartbeat()
        rays = np.asarray(test_dataset.all_rays[idx]).reshape(-1, 6)
        rgb_map, depth_map, _ = handle.render(rays, chunk=chunk)
        rgb_map = np.clip(rgb_map, 0, 1).reshape(H, W, 3)
        has_gt = len(test_dataset.all_rgbs) > 0
        if has_gt:
            gt_rgb = np.asarray(test_dataset.all_rgbs[idx]).reshape(H, W, 3)
            PSNRs.append(psnr_fn(rgb_map, gt_rgb))
            ssims.append(rgb_ssim(rgb_map, gt_rgb, 1))
            # on the renderer's device
            la = rgb_lpips(gt_rgb, rgb_map, "alex", handle.aabb.device)
            lv = rgb_lpips(gt_rgb, rgb_map, "vgg", handle.aabb.device)
            if (la is None or lv is None) and not l_alex:
                print("[eval] LPIPS weights unavailable — mean.txt LPIPS lines will be NaN "
                      "(put lpips_{alex,vgg}.npz in tensorf_tpu_torch/eval/weights/ or set "
                      "TENSORF_LPIPS_DIR)")
            l_alex.append(float("nan") if la is None else la)
            l_vgg.append(float("nan") if lv is None else lv)
        if imageio is None:
            continue
        rgb8 = (rgb_map * 255).astype(np.uint8)
        depth_vis = _depth_rgb(depth_map.reshape(H, W), test_dataset.near_far)
        rgb_frames.append(rgb8)
        depth_frames.append(depth_vis)
        imageio.imwrite(f"{savePath}/prediction/{idx:03d}.png", rgb8)
        if has_gt:
            imageio.imwrite(f"{savePath}/ground_truth/{idx:03d}.png",
                            (np.clip(gt_rgb, 0, 1) * 255).astype(np.uint8))
        imageio.imwrite(f"{savePath}/rgbd/{idx:03d}.png",
                        np.concatenate([rgb8, depth_vis], axis=1))

    if imageio is not None:
        _write_video(imageio, f"{savePath}/video.mp4", rgb_frames)
        _write_video(imageio, f"{savePath}/depthvideo.mp4", depth_frames)
        if PSNRs:
            # the reference's 4-line mean.txt: psnr, ssim, lpips-alex, lpips-vgg
            lines = [np.mean(PSNRs), np.mean(ssims), np.mean(l_alex), np.mean(l_vgg)]
            np.savetxt(f"{savePath}/mean.txt", np.asarray(lines, np.float64))
    return PSNRs


def evaluation_path(
    test_dataset,
    handle: RendererHandle,
    c2ws,
    savePath: Optional[str] = None,
    chunk: int = 8192,
    heartbeat: Optional[Callable[[], None]] = None,
) -> List[float]:
    """Render a camera trajectory (reference renderer.py:227-282): the rays
    of each pose from the dataset's directions (projected to NDC for an
    NDC handle, with the dataset's focal); with ``savePath`` each
    frame's prediction PNG and the rgb and depth videos.  ``heartbeat``
    runs once per frame.  Returns []."""
    W, H = test_dataset.img_wh
    imageio = None
    if not is_writer(handle.group):  # rank 0 writes (tensorf_tpu evaluation.py:249)
        savePath = None
    if savePath is not None:
        import imageio.v2 as imageio

        os.makedirs(f"{savePath}/prediction", exist_ok=True)
        os.makedirs(f"{savePath}/rgbd", exist_ok=True)
    rgb_frames, depth_frames = [], []
    for idx, c2w in enumerate(np.asarray(c2ws)):
        if heartbeat is not None:
            heartbeat()
        rays_o, rays_d = get_rays(test_dataset.directions, c2w[:3, :4])
        if handle.ndc_ray:
            rays_o, rays_d = ndc_rays_blender(H, W, test_dataset.focal[0], 1.0, rays_o, rays_d)
        rays = np.concatenate([rays_o, rays_d], axis=1).astype(np.float32)
        rgb_map, depth_map, _ = handle.render(rays, chunk=chunk)
        rgb8 = (np.clip(rgb_map, 0, 1).reshape(H, W, 3) * 255).astype(np.uint8)
        rgb_frames.append(rgb8)
        depth_frames.append(_depth_rgb(depth_map.reshape(H, W), test_dataset.near_far))
        if imageio is not None:
            imageio.imwrite(f"{savePath}/prediction/{idx:03d}.png", rgb8)
    if imageio is not None:
        _write_video(imageio, f"{savePath}/video.mp4", rgb_frames)
        _write_video(imageio, f"{savePath}/depthvideo.mp4", depth_frames)
    return []


def psnrs_calculate(handle: RendererHandle, dataset, chunk: int = 4096,
                    heartbeat: Optional[Callable[[], None]] = None) -> List[float]:
    """Mid-training test-set PSNR sweep (reference loss.py:10-57);
    ``heartbeat`` runs once per view."""
    PSNRs = []
    for idx in range(dataset.all_rays.shape[0]):
        if heartbeat is not None:
            heartbeat()
        rgb_map, _, _ = handle.render(np.asarray(dataset.all_rays[idx]).reshape(-1, 6), chunk=chunk)
        if len(dataset.all_rgbs):
            gt = np.asarray(dataset.all_rgbs[idx]).reshape(-1, 3)
            PSNRs.append(psnr_fn(np.clip(rgb_map, 0, 1), gt))
    return PSNRs
