"""Procedural synthetic scenes in the blender layout (the scenes of
tensorf_tpu/data/synthetic.py, built in memory).

``make_synthetic_scene_arrays`` ray-traces the scene analytically and
returns, per split, the ``transforms_{split}.json`` dict with each frame's
uint8 RGBA image inlined — the pixels the JAX package's on-disk writer
stores as PNGs — so BlenderDataset loads it with no files and no PIL.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _look_at_c2w_opengl(cam_pos: np.ndarray, target=None) -> np.ndarray:
    """OpenGL/blender-convention c2w (x right, y up, -z forward)."""
    target = np.zeros(3) if target is None else np.asarray(target)
    forward = target - cam_pos
    forward = forward / np.linalg.norm(forward)
    world_up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, world_up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = cam_pos
    return c2w


def _camera_rays(c2w: np.ndarray, wh: Tuple[int, int], camera_angle_x: float):
    W, H = wh
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float64) + 0.5,
        np.arange(H, dtype=np.float64) + 0.5,
        indexing="xy",
    )
    dirs = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    rd = dirs @ c2w[:3, :3].T
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    return c2w[:3, 3], rd


def _trace_sphere(c2w, wh, camera_angle_x, radius: float = 0.8) -> np.ndarray:
    """Analytic render of a lambertian-shaded sphere; returns (H, W, 4)."""
    W, H = wh
    ro, rd = _camera_rays(c2w, wh, camera_angle_x)
    b = np.sum(rd * ro, axis=-1)
    c = np.sum(ro * ro) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0
    p = ro + rd * t[..., None]
    n = p / radius
    light = np.array([0.577, 0.577, 0.577])
    lambert = np.clip(n @ light, 0, 1)
    # position-dependent albedo so views constrain appearance
    albedo = 0.5 + 0.5 * np.stack([n[..., 0], n[..., 1], n[..., 2]], -1)
    rgb = np.clip(albedo * (0.3 + 0.7 * lambert[..., None]), 0, 1)
    out = np.zeros((H, W, 4))
    out[..., :3] = np.where(hit[..., None], rgb, 1.0)
    out[..., 3] = hit.astype(np.float64)
    return out


# A multi-object checker-textured arrangement: high-frequency appearance and
# real occlusion, inside the blender loader's ±1.5 bbox.
COMPOSITE_SPHERES = (
    # (center, radius, base_rgb_a, base_rgb_b, checker_freq)
    ((0.0, 0.0, 0.0), 0.55, (0.9, 0.25, 0.2), (0.95, 0.9, 0.85), 12),
    ((0.85, 0.0, -0.1), 0.26, (0.2, 0.5, 0.9), (0.9, 0.9, 0.3), 8),
    ((-0.85, 0.0, -0.1), 0.26, (0.2, 0.8, 0.4), (0.2, 0.2, 0.6), 10),
    ((0.0, 0.85, -0.1), 0.26, (0.9, 0.6, 0.2), (0.3, 0.1, 0.4), 14),
    ((0.0, -0.85, -0.1), 0.26, (0.7, 0.2, 0.7), (0.9, 0.95, 0.9), 6),
    ((0.45, 0.45, 0.62), 0.16, (0.95, 0.85, 0.2), (0.1, 0.1, 0.1), 16),
    ((-0.45, -0.45, 0.62), 0.16, (0.3, 0.9, 0.9), (0.9, 0.3, 0.2), 20),
    ((0.0, 0.0, -0.78), 0.22, (0.55, 0.55, 0.6), (0.95, 0.45, 0.1), 24),
)


def _trace_composite(c2w, wh, camera_angle_x) -> np.ndarray:
    """Nearest-hit analytic render of the composite checker-sphere scene."""
    W, H = wh
    ro, rd = _camera_rays(c2w, wh, camera_angle_x)
    t_best = np.full((H, W), np.inf)
    rgb = np.ones((H, W, 3))
    light = np.array([0.577, 0.577, 0.577])
    for center, radius, col_a, col_b, freq in COMPOSITE_SPHERES:
        oc = ro - np.asarray(center)
        b = np.sum(rd * oc, axis=-1)
        c = np.sum(oc * oc) - radius**2
        disc = b * b - c
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (t > 1e-6) & (t < t_best)
        p = ro + rd * t[..., None]
        n = (p - np.asarray(center)) / radius
        theta = np.arccos(np.clip(n[..., 2], -1, 1))
        phi = np.arctan2(n[..., 1], n[..., 0])
        checker = (
            np.floor(theta / np.pi * freq) + np.floor((phi + np.pi) / (2 * np.pi) * freq)
        ) % 2.0
        albedo = np.where(checker[..., None] > 0.5, np.asarray(col_a), np.asarray(col_b))
        lambert = np.clip(n @ light, 0, 1)
        shaded = np.clip(albedo * (0.25 + 0.75 * lambert[..., None]), 0, 1)
        rgb = np.where(hit[..., None], shaded, rgb)
        t_best = np.where(hit, t, t_best)
    out = np.zeros((H, W, 4))
    hit_any = np.isfinite(t_best)
    out[..., :3] = np.where(hit_any[..., None], rgb, 1.0)
    out[..., 3] = hit_any.astype(np.float64)
    return out


def make_synthetic_scene_arrays(
    n_train: int = 12,
    n_test: int = 4,
    wh: Tuple[int, int] = (64, 64),
    camera_angle_x: float = 0.6911,
    cam_radius: float = 4.0,
    seed: int = 0,
    scene: str = "sphere",
) -> Dict[str, dict]:
    """{split: transforms dict} with each frame's uint8 RGBA ``image``.

    ``scene``: "sphere" (one lambertian sphere) or "composite" (the
    checker-textured multi-sphere arrangement of configs/synth_full.txt).
    Same cameras and pixels as the JAX package's on-disk writer for the
    same arguments.
    """
    if scene not in ("sphere", "composite"):
        raise ValueError(f"unknown synthetic scene {scene!r}")
    trace = _trace_composite if scene == "composite" else _trace_sphere
    rng = np.random.default_rng(seed)
    out = {}
    for split, n in (("train", n_train), ("test", n_test)):
        frames = []
        for k in range(n):
            theta = 2 * np.pi * (k / n) + (0.1 if split == "test" else 0.0)
            phi = np.pi / 5 + 0.25 * rng.standard_normal()
            pos = cam_radius * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
            )
            c2w = _look_at_c2w_opengl(pos)
            img = trace(c2w, wh, camera_angle_x)
            frames.append(
                {
                    "file_path": f"./{split}/r_{k}",
                    "transform_matrix": c2w.tolist(),
                    "image": (img * 255).astype(np.uint8),
                }
            )
        out[split] = {"camera_angle_x": camera_angle_x, "frames": frames}
    return out

