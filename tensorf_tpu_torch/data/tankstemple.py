"""Tanks&Temples loader (NSVF layout at 1920x1080); a copy of
tensorf_tpu/data/tankstemple.py.

bbox.txt x1.2, intrinsics.txt matrix, 0_/1_/2_ filename split, circular
look-at render path, white_bg=True, near_far=[0.01, 6].
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.rays import get_ray_directions, get_rays
from .base import RayDataset, load_image_rgba, stack_or_cat


def circle(radius=3.5, h=0.0, axis="z", t0=0, r=1):
    """Parametric circle position generator about ``axis``."""
    if axis == "z":
        return lambda t: [
            radius * np.cos(r * t + t0),
            radius * np.sin(r * t + t0),
            h,
        ]
    if axis == "y":
        return lambda t: [
            radius * np.cos(r * t + t0),
            h,
            radius * np.sin(r * t + t0),
        ]
    return lambda t: [
        h,
        radius * np.cos(r * t + t0),
        radius * np.sin(r * t + t0),
    ]


def _normalize(x):
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    n[n == 0] = 1
    return x / n


def look_at_rotation(camera_position, at=(0, 0, 0), up=(0, -1, 0)):
    """Camera rotation (3, 3) looking from ``camera_position`` at ``at``."""
    cam = np.asarray(camera_position, np.float64)
    at = np.asarray(at, np.float64)
    up = np.asarray(up, np.float64)
    z_axis = _normalize(at - cam)
    x_axis = _normalize(np.cross(up, z_axis))
    y_axis = _normalize(np.cross(z_axis, x_axis))
    return np.stack([x_axis, y_axis, z_axis], axis=1)


def gen_path(pos_gen, at=(0, 0, 0), up=(0, -1, 0), frames=180) -> np.ndarray:
    """Circular camera trajectory (frames, 4, 4) looking at ``at``."""
    c2ws = []
    for t in range(frames):
        c2w = np.eye(4, dtype=np.float32)
        cam_pos = np.asarray(pos_gen(t * (360.0 / frames) / 180 * np.pi))
        c2w[:3, 3] = cam_pos
        c2w[:3, :3] = look_at_rotation(cam_pos, at=at, up=up)
        c2ws.append(c2w)
    return np.stack(c2ws)


class TanksTempleDataset(RayDataset):
    """NSVF-layout Tanks&Temples dataset."""

    def __init__(
        self,
        datadir: str,
        split: str = "train",
        downsample: float = 1.0,
        wh=(1920, 1080),
        is_stack: bool = False,
        **_,
    ):
        self.root_dir = datadir
        self.split = split
        self.is_stack = is_stack
        self.downsample = downsample
        self.img_wh = (int(wh[0] / downsample), int(wh[1] / downsample))

        self.white_bg = True
        self.near_far = [0.01, 6.0]
        self.scene_bbox = (
            np.loadtxt(os.path.join(datadir, "bbox.txt"))
            .reshape(-1)[:6]
            .reshape(2, 3)
            .astype(np.float32)
            * 1.2
        )
        self._read_meta()

        self.center = self.scene_bbox.mean(axis=0).reshape(1, 1, 3)
        self.radius = (self.scene_bbox[1] - self.center).reshape(1, 1, 3)

    def _split_files(self, files):
        if self.split == "train":
            return [x for x in files if x.startswith("0_")]
        if self.split == "val":
            return [x for x in files if x.startswith("1_")]
        test = [x for x in files if x.startswith("2_")]
        return test if test else [x for x in files if x.startswith("1_")]

    def _read_meta(self):
        self.intrinsics = np.loadtxt(
            os.path.join(self.root_dir, "intrinsics.txt")
        )
        self.intrinsics[:2] *= (
            np.array(self.img_wh) / np.array([1920, 1080])
        ).reshape(2, 1)

        pose_files = self._split_files(
            sorted(os.listdir(os.path.join(self.root_dir, "pose")))
        )
        img_files = self._split_files(
            sorted(os.listdir(os.path.join(self.root_dir, "rgb")))
        )
        if len(img_files) != len(pose_files):
            raise ValueError(f"{len(img_files)} images but {len(pose_files)} poses")

        directions = get_ray_directions(
            self.img_wh[1],
            self.img_wh[0],
            [self.intrinsics[0, 0], self.intrinsics[1, 1]],
            center=self.intrinsics[:2, 2],
        )
        self.directions = directions / np.linalg.norm(
            directions, axis=-1, keepdims=True
        )

        poses, rays, rgbs = [], [], []
        for img_fname, pose_fname in zip(img_files, pose_files):
            img = load_image_rgba(
                os.path.join(self.root_dir, "rgb", img_fname),
                self.img_wh,
                self.downsample,
            )
            if img.shape[-1] == 4:
                img = img[:, :3] * img[:, -1:] + (1 - img[:, -1:])
            rgbs.append(img[:, :3])

            c2w = np.loadtxt(
                os.path.join(self.root_dir, "pose", pose_fname)
            ).astype(np.float32)
            poses.append(c2w)
            rays_o, rays_d = get_rays(self.directions, c2w)
            rays.append(np.concatenate([rays_o, rays_d], 1).astype(np.float32))

        self.poses = np.stack(poses)

        center = self.scene_bbox.mean(axis=0)
        radius = float(np.linalg.norm(self.scene_bbox[1] - center)) * 1.2
        up = self.poses[:, :3, 1].mean(axis=0).tolist()
        pos_gen = circle(radius=radius, h=-0.2 * up[1], axis="y")
        self.render_path = gen_path(pos_gen, up=up, frames=200)
        self.render_path[:, :3, 3] += center

        self.all_masks = []
        stack = self.is_stack or self.split != "train"
        self.all_rays = stack_or_cat(rays, stack)
        self.all_rgbs = stack_or_cat(
            rgbs, stack, self.img_wh if stack else None, 3
        )
