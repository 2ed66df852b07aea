"""LLFF forward-facing loader (a copy of tensorf_tpu/data/llff.py).

COLMAP ``poses_bounds.npy`` + ``images_4/``: poses recentred on their
average, depths rescaled so the nearest bound sits at 1/0.75,
blender-convention directions, NDC rays built at load time, a spiral
render path, every ``hold_every``-th frame held out for test,
near_far=[0, 1], bbox ±[1.5, 1.67, 1.0].  Besides the files it takes the
same layout in memory — ``meta`` = {"poses_bounds": (N, 17), "images":
uint8 (N, H, W, 3|4)} (data/synthetic.py::make_forward_facing_scene builds
one) — so a run needs neither files nor PIL.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ..ops.rays import get_ray_directions_blender, get_rays, ndc_rays_blender
from .base import RayDataset, image_to_rows, load_image_rgba, stack_or_cat


def _normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average c2w pose (3, 4): mean centre, mean z, y from x = z x mean y."""
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(z, y_))
    y = np.cross(x, z)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, transform=None):
    """Re-express every pose in the average pose's frame; returns (poses
    (N, 3, 4), the average pose as a (4, 4) matrix)."""
    if transform is not None:
        poses = poses @ transform
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (np.linalg.inv(pose_avg_homo) @ poses_homo)[:, :3]
    return poses_centered, pose_avg_homo


def viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([-vec0, vec1, vec2, pos], 1)
    return m


def render_path_spiral(c2w, up, rads, focal, zrate=0.5, N_rots=2, N=120):
    """N poses on a spiral around the average pose, looking at depth focal."""
    out = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * N_rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads
        )
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(viewmatrix(z, up, c))
    return out


def get_spiral(c2ws_all, near_fars, rads_scale=1.0, N_views=120):
    """The spiral render path (N_views, 4, 4) of a forward-facing capture."""
    c2w = average_poses(c2ws_all)
    up = _normalize(c2ws_all[:, :3, 1].sum(0))
    dt = 0.75
    close_depth, inf_depth = near_fars.min() * 0.9, near_fars.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = c2ws_all[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0) * rads_scale
    return np.stack(render_path_spiral(c2w, up, rads, focal, zrate=0.5, N=N_views))


class LLFFDataset(RayDataset):
    def __init__(
        self,
        datadir: str,
        split: str = "train",
        downsample: float = 4.0,
        is_stack: bool = False,
        hold_every: int = 8,
        meta: Optional[dict] = None,
        **_,
    ):
        self.root_dir = datadir
        self.split = split
        self.hold_every = hold_every
        self.is_stack = is_stack
        self.downsample = downsample

        self._read_meta(meta)
        self.white_bg = False
        self.near_far = [0.0, 1.0]
        self.scene_bbox = np.array([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], dtype=np.float32)
        self.center = self.scene_bbox.mean(axis=0).reshape(1, 1, 3)
        self.invradius = 1.0 / (self.scene_bbox[1] - self.center).reshape(1, 1, 3)

    def _read_meta(self, meta: Optional[dict]):
        if meta is None:
            poses_bounds = np.load(os.path.join(self.root_dir, "poses_bounds.npy"))  # (N, 17)
            self.image_paths = sorted(glob.glob(os.path.join(self.root_dir, "images_4/*")))
            n_images = len(self.image_paths)
        else:
            poses_bounds = np.array(meta["poses_bounds"], np.float64)
            n_images = len(meta["images"])
        if self.split in ("train", "test") and len(poses_bounds) != n_images:
            raise ValueError(
                "Mismatch between number of images and number of poses! Please rerun COLMAP!"
            )

        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.near_fars = poses_bounds[:, -2:]

        H, W, focal = poses[0, :, -1]
        self.img_wh = (int(W / self.downsample), int(H / self.downsample))
        self.focal = [focal * self.img_wh[0] / W, focal * self.img_wh[1] / H]

        # "down right back" -> "right up back", then recentre
        poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.poses, self.pose_avg = center_poses(poses)

        # rescale so the nearest depth sits a bit beyond 1.0
        near_original = self.near_fars.min()
        scale_factor = near_original * 0.75
        self.near_fars /= scale_factor
        self.poses[..., 3] /= scale_factor

        self.render_path = get_spiral(self.poses, self.near_fars, N_views=120)

        W, H = self.img_wh
        self.directions = get_ray_directions_blender(H, W, self.focal)

        i_test = np.arange(0, self.poses.shape[0], self.hold_every)
        img_list = (
            i_test
            if self.split != "train"
            else sorted(set(range(len(self.poses))) - set(i_test.tolist()))
        )

        rays, rgbs = [], []
        for i in img_list:
            if meta is None:
                img = load_image_rgba(self.image_paths[i], self.img_wh, self.downsample)
            else:
                img = image_to_rows(meta["images"][i], self.img_wh, self.downsample)
            rgbs.append(img[:, :3])
            rays_o, rays_d = get_rays(self.directions, self.poses[i])
            rays_o, rays_d = ndc_rays_blender(H, W, self.focal[0], 1.0, rays_o, rays_d)
            rays.append(np.concatenate([rays_o, rays_d], 1).astype(np.float32))

        self.all_masks = []
        self.all_rays = stack_or_cat(rays, self.is_stack)
        self.all_rgbs = stack_or_cat(
            rgbs, self.is_stack, self.img_wh if self.is_stack else None, 3
        )
