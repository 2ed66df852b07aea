"""Loader for self-captured scenes (a colmap2nerf-style transforms.json);
a copy of tensorf_tpu/data/your_own_data.py.

A blender-style loader that also honours per-file intrinsics —
``camera_angle_y``, ``fl_x``/``fl_y``, ``w``/``h``, the principal point —
which is what data/colmap2nerf.py writes.
"""

from __future__ import annotations

import json
import os
from typing import List, Union

import numpy as np

from ..ops.rays import get_ray_directions, get_rays
from .base import RayDataset, load_image_rgba, select_frame_indices, stack_or_cat
from .blender import BLENDER2OPENCV


class YourOwnDataset(RayDataset):
    def __init__(
        self,
        datadir: str,
        split: str = "train",
        downsample: float = 1.0,
        is_stack: bool = False,
        N_vis: int = -1,
        num_images: Union[int, List[int], None] = -1,
        **_,
    ):
        self.root_dir = datadir
        self.split = split
        self.is_stack = is_stack
        self.N_vis = N_vis
        self.downsample = downsample
        self.num_images = num_images

        self.scene_bbox = np.array(
            [[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], dtype=np.float32
        )
        self.white_bg = True
        self.near_far = [0.1, 10.0]

        self._read_meta()
        self.center = self.scene_bbox.mean(axis=0).reshape(1, 1, 3)
        self.radius = (self.scene_bbox[1] - self.center).reshape(1, 1, 3)

    def _read_meta(self):
        meta_path = os.path.join(
            self.root_dir, f"transforms_{self.split}.json"
        )
        if not os.path.exists(meta_path):
            meta_path = os.path.join(self.root_dir, "transforms.json")
        with open(meta_path) as f:
            self.meta = json.load(f)

        src_w = int(self.meta.get("w", 800))
        src_h = int(self.meta.get("h", 800))
        w = int(src_w / self.downsample)
        h = int(src_h / self.downsample)
        self.img_wh = (w, h)

        if "fl_x" in self.meta:
            fx = float(self.meta["fl_x"])
            fy = float(self.meta.get("fl_y", self.meta["fl_x"]))
        else:
            fx = 0.5 * src_w / np.tan(0.5 * self.meta["camera_angle_x"])
            if "camera_angle_y" in self.meta:
                fy = 0.5 * src_h / np.tan(0.5 * self.meta["camera_angle_y"])
            else:
                fy = fx
        scale = w / src_w
        self.focal = [fx * scale, fy * scale]
        cx = float(self.meta.get("cx", src_w / 2)) * scale
        cy = float(self.meta.get("cy", src_h / 2)) * scale

        directions = get_ray_directions(h, w, self.focal, center=[cx, cy])
        self.directions = directions / np.linalg.norm(
            directions, axis=-1, keepdims=True
        )
        self.intrinsics = np.array(
            [[self.focal[0], 0, cx], [0, self.focal[1], cy], [0, 0, 1]],
            dtype=np.float32,
        )

        frames = self.meta["frames"]
        idxs = select_frame_indices(len(frames), self.num_images, self.N_vis)

        self.image_paths, poses = [], []
        rays, rgbs, masks = [], [], []
        for i in idxs:
            frame = frames[i]
            pose = (
                np.asarray(frame["transform_matrix"], np.float32)
                @ BLENDER2OPENCV
            )
            poses.append(pose)

            rel = frame["file_path"]
            image_path = os.path.join(self.root_dir, rel)
            if not os.path.splitext(image_path)[1]:
                image_path += ".png"
            self.image_paths.append(image_path)

            img = load_image_rgba(image_path, self.img_wh, self.downsample)
            if img.shape[-1] == 4:
                alpha = img[:, -1:]
                rgb = img[:, :3] * alpha + (1.0 - alpha)
            else:
                alpha = np.ones_like(img[:, :1])
                rgb = img[:, :3]
            rgbs.append(rgb)
            masks.append(alpha)

            rays_o, rays_d = get_rays(self.directions, pose)
            rays.append(
                np.concatenate([rays_o, rays_d], axis=1).astype(np.float32)
            )

        self.poses = np.stack(poses)
        self.all_rays = stack_or_cat(rays, self.is_stack)
        self.all_rgbs = stack_or_cat(
            rgbs, self.is_stack, self.img_wh if self.is_stack else None, 3
        )
        self.all_masks = stack_or_cat(
            masks, self.is_stack, self.img_wh if self.is_stack else None, 1
        )
        if self.is_stack and len(masks):
            self.all_masks = self.all_masks[..., 0]
