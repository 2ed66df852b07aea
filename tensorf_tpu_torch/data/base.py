"""Common dataset plumbing: eager in-memory ray stores (numpy) — a copy of
tensorf_tpu/data/base.py with PIL imported only where a file is read."""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np


class RayDataset:
    """Base: exposes all_rays, all_rgbs, all_masks, poses, img_wh, near_far,
    scene_bbox, white_bg, directions, is_stack."""

    white_bg: bool = False
    near_far = [2.0, 6.0]

    def __len__(self):
        return len(self.all_rgbs)


def select_frame_indices(
    n_frames: int,
    num_images: Union[int, Sequence[int], None],
    n_vis: int = -1,
    seed: int = 20211202,
) -> List[int]:
    """Few-shot frame selection: an explicit index list, a random subset of
    ``num_images`` frames, or every ``n_frames // n_vis``-th frame."""
    interval = 1 if n_vis < 0 else max(n_frames // n_vis, 1)
    idxs = list(range(0, n_frames, interval))
    if isinstance(num_images, (list, tuple)):
        return [int(i) for i in num_images]
    if isinstance(num_images, (int, np.integer)) and 0 < num_images < len(idxs):
        rng = np.random.default_rng(seed)
        return sorted(rng.choice(idxs, int(num_images), replace=False).tolist())
    return idxs


def image_to_rows(img, img_wh, downsample: float) -> np.ndarray:
    """A PIL image or a uint8 (H, W, C) array -> float32 (H*W, C) in [0, 1],
    LANCZOS-resized to ``img_wh`` on downsample."""
    if downsample != 1.0:
        from PIL import Image

        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.resize(img_wh, Image.LANCZOS)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr.reshape(-1, arr.shape[-1]) if arr.ndim == 3 else arr.reshape(-1, 1)


def load_image_rgba(path: str, img_wh, downsample: float) -> np.ndarray:
    """Load an image file as float32 (H*W, C); needs PIL."""
    from PIL import Image

    with Image.open(path) as img:
        return image_to_rows(img, img_wh, downsample)


def stack_or_cat(parts: List[np.ndarray], is_stack: bool, img_wh=None, ch=None):
    if not parts:
        return np.zeros((0,), np.float32)
    if not is_stack:
        return np.concatenate(parts, axis=0)
    out = np.stack(parts, axis=0)
    if img_wh is not None and ch is not None:
        out = out.reshape(-1, img_wh[1], img_wh[0], ch)
    return out
