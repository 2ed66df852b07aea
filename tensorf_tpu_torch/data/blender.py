"""NeRF-synthetic (blender) loader (a copy of tensorf_tpu/data/blender.py).

Focal from camera_angle_x, normalized camera-space directions, RGBA
white-composite, few-shot selection, white_bg=True, near_far=[2,6],
scene bbox ±1.5.  Besides the on-disk ``transforms_{split}.json`` + PNG
layout it takes an in-memory ``meta`` of the same shape whose frames carry
their ``image`` (uint8 RGBA) — data/synthetic.py::make_synthetic_scene_arrays
builds one — so a run needs neither files nor PIL.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Union

import numpy as np

from ..ops.rays import get_ray_directions, get_rays
from .base import RayDataset, image_to_rows, load_image_rgba, select_frame_indices, stack_or_cat

BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
    dtype=np.float32,
)


class BlenderDataset(RayDataset):
    def __init__(
        self,
        datadir: str,
        split: str = "train",
        downsample: float = 1.0,
        is_stack: bool = False,
        N_vis: int = -1,
        num_images: Union[int, List[int], None] = -1,
        wh=(800, 800),
        meta: Optional[dict] = None,
        **_,
    ):
        self.root_dir = datadir
        self.split = split
        self.is_stack = is_stack
        self.N_vis = N_vis
        self.downsample = downsample
        self.src_wh = (int(wh[0]), int(wh[1]))
        self.img_wh = (int(wh[0] / downsample), int(wh[1] / downsample))
        self.num_images = num_images
        self.scene_bbox = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], dtype=np.float32)
        self.white_bg = True
        self.near_far = [2.0, 6.0]
        self._read_meta(meta)

    def _frame_image_path(self, frame) -> str:
        # keep everything after the leading '.' of the relative path
        return self.root_dir + frame["file_path"].split(".")[-1] + ".png"

    def _read_meta(self, meta: Optional[dict]):
        if meta is None:
            with open(os.path.join(self.root_dir, f"transforms_{self.split}.json")) as f:
                meta = json.load(f)
        self.meta = meta

        w, h = self.img_wh
        focal = 0.5 * self.src_wh[0] / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal = focal * w / self.src_wh[0]
        directions = get_ray_directions(h, w, [self.focal, self.focal])
        self.directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

        idxs = select_frame_indices(len(self.meta["frames"]), self.num_images, self.N_vis)
        poses, rays, rgbs, masks = [], [], [], []
        for i in idxs:
            frame = self.meta["frames"][i]
            pose = np.asarray(frame["transform_matrix"], np.float32) @ BLENDER2OPENCV
            poses.append(pose)
            if "image" in frame:
                img = image_to_rows(frame["image"], self.img_wh, self.downsample)
            else:
                img = load_image_rgba(self._frame_image_path(frame), self.img_wh, self.downsample)
            if img.shape[-1] == 4:
                alpha = img[:, -1:]
                rgb = img[:, :3] * alpha + (1.0 - alpha)
            else:
                alpha = np.ones_like(img[:, :1])
                rgb = img[:, :3]
            rgbs.append(rgb)
            masks.append(alpha)
            rays_o, rays_d = get_rays(self.directions, pose)
            rays.append(np.concatenate([rays_o, rays_d], axis=1).astype(np.float32))

        self.poses = np.stack(poses)
        self.all_rays = stack_or_cat(rays, self.is_stack)
        self.all_rgbs = stack_or_cat(rgbs, self.is_stack, self.img_wh if self.is_stack else None, 3)
        self.all_masks = stack_or_cat(masks, self.is_stack, self.img_wh if self.is_stack else None, 1)
        if self.is_stack and len(masks):
            self.all_masks = self.all_masks[..., 0]
