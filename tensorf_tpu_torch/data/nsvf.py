"""NSVF-layout loader (bbox.txt, intrinsics.txt, pose/, rgb/); a copy of
tensorf_tpu/data/nsvf.py.

bbox from file, split by filename prefix 0_/1_/2_ (test falls back to
1_), spherical render path, white_bg=True, near_far=[0.5, 6].
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.rays import get_ray_directions, get_rays
from .base import RayDataset, load_image_rgba, stack_or_cat


def _trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = np.cos(phi), -np.sin(phi)
    m[2, 1], m[2, 2] = np.sin(phi), np.cos(phi)
    return m


def _rot_theta(th):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = np.cos(th), -np.sin(th)
    m[2, 0], m[2, 2] = np.sin(th), np.cos(th)
    return m


def pose_spherical(theta, phi, radius) -> np.ndarray:
    """Spherical camera pose: radius out along z, tilted by phi, turned by
    theta (degrees)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    return flip @ c2w


class NSVF(RayDataset):
    """NSVF generic dataset."""

    def __init__(
        self,
        datadir: str,
        split: str = "train",
        downsample: float = 1.0,
        wh=(800, 800),
        is_stack: bool = False,
        **_,
    ):
        self.root_dir = datadir
        self.split = split
        self.is_stack = is_stack
        self.downsample = downsample
        self.img_wh = (int(wh[0] / downsample), int(wh[1] / downsample))

        self.white_bg = True
        self.near_far = [0.5, 6.0]
        self.scene_bbox = (
            np.loadtxt(os.path.join(datadir, "bbox.txt"))
            .reshape(-1)[:6]
            .reshape(2, 3)
            .astype(np.float32)
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
        with open(os.path.join(self.root_dir, "intrinsics.txt")) as f:
            focal = float(f.readline().split()[0])
        self.intrinsics = np.array(
            [[focal, 0, 400.0], [0, focal, 400.0], [0, 0, 1]]
        )
        self.intrinsics[:2] *= (
            np.array(self.img_wh) / np.array([800, 800])
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

        self.render_path = np.stack(
            [
                pose_spherical(angle, -30.0, 4.0)
                for angle in np.linspace(-180, 180, 41)[:-1]
            ]
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
        self.all_masks = []
        stack = self.is_stack or self.split != "train"
        self.all_rays = stack_or_cat(rays, stack)
        self.all_rgbs = stack_or_cat(
            rgbs, stack, self.img_wh if stack else None, 3
        )
