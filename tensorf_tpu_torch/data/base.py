"""Common dataset plumbing: eager in-memory ray stores (numpy) — a copy of
tensorf_tpu/data/base.py with PIL imported only where a file is read; an
in-memory image is downsampled by a numpy copy of PIL's LANCZOS."""

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


_PRECISION_BITS = 22  # Pillow's fixed-point coefficients for 8-bit images


def _lanczos_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One separable Lanczos-3 pass of an int64 image along ``axis``, with
    Pillow's coefficients (Resample.c precompute_coeffs, rounded to 22-bit
    fixed point) and its clip to [0, 255]."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    img = np.moveaxis(img, axis, 0)
    out = np.full((out_size,) + img.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        x = (np.arange(n) + xmin - center + 0.5) / filterscale
        w = np.where((x >= -3.0) & (x < 3.0), np.sinc(x) * np.sinc(x / 3), 0.0)
        if w.sum() != 0.0:
            w = w / w.sum()
        w = w * (1 << _PRECISION_BITS)
        k = np.trunc(np.where(w < 0, w - 0.5, w + 0.5)).astype(np.int64)
        out[xx] += np.tensordot(k, img[xmin : xmin + n], axes=(0, 0))
    return np.moveaxis(np.clip(out >> _PRECISION_BITS, 0, 255), 0, axis)


def resize_lanczos(img: np.ndarray, img_wh) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (h, w, C), (w, h) = ``img_wh``: the pixels
    of PIL's ``Image.resize(img_wh, LANCZOS)``, which premultiplies RGBA by
    its alpha around the two passes, in numpy."""
    out = img.astype(np.int64)
    rgba = out.shape[-1] == 4
    if rgba:
        alpha = out[..., 3:]
        t = out[..., :3] * alpha + 128
        out = np.concatenate([((t >> 8) + t) >> 8, alpha], axis=-1)
    out = _lanczos_pass(_lanczos_pass(out, 1, int(img_wh[0])), 0, int(img_wh[1]))
    if rgba:
        alpha = out[..., 3:]
        unmul = np.clip(255 * out[..., :3] // np.maximum(alpha, 1), 0, 255)
        rgb = np.where((alpha == 0) | (alpha == 255), out[..., :3], unmul)
        out = np.concatenate([rgb, alpha], axis=-1)
    return out.astype(np.uint8)


def image_to_rows(img, img_wh, downsample: float) -> np.ndarray:
    """A PIL image or a uint8 (H, W, C) array -> float32 (H*W, C) in [0, 1],
    LANCZOS-resized to ``img_wh`` on downsample (an array without PIL)."""
    if downsample != 1.0:
        if isinstance(img, np.ndarray):
            # PIL returns a copy when the size already matches
            if img.shape[1::-1] != tuple(img_wh):
                img = resize_lanczos(img, img_wh)
        else:
            from PIL import Image

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
