"""Procedural synthetic scenes, built in memory or written to disk.

``make_synthetic_scene_arrays`` ray-traces the blender-layout scenes of
tensorf_tpu/data/synthetic.py analytically and returns, per split, the
``transforms_{split}.json`` dict with each frame's uint8 RGBA image
inlined, so BlenderDataset loads it with no files and no PIL;
``make_synthetic_blender_scene`` writes the same scene as a blender
directory (``transforms_{split}.json`` and RGBA PNGs), as the JAX
package's writer does.
``make_forward_facing_scene`` traces a forward-facing capture in LLFF's
layout (``poses_bounds`` and images_4-sized images) for LLFFDataset;
``write_forward_facing_scene`` writes it as an LLFF directory for a reader
of files, such as the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

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
    views: Optional[Dict[str, Iterable[int]]] = None,
) -> Dict[str, dict]:
    """{split: transforms dict} with each frame's uint8 RGBA ``image``.

    ``scene``: "sphere" (one lambertian sphere) or "composite" (the
    checker-textured multi-sphere arrangement of configs/synth_full.txt).
    Same cameras and pixels as the JAX package's on-disk writer for the
    same arguments.  ``views`` ({split: frame indices}) traces only those
    frames of a split it names; the split's other frames keep their cameras
    and carry an all-zero image, for a reader that selects the named ones.
    """
    if scene not in ("sphere", "composite"):
        raise ValueError(f"unknown synthetic scene {scene!r}")
    trace = _trace_composite if scene == "composite" else _trace_sphere
    rng = np.random.default_rng(seed)
    views = None if views is None else {k: set(v) for k, v in views.items()}
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
            if views is not None and split in views and k not in views[split]:
                img = np.zeros((wh[1], wh[0], 4))
            else:
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


def make_synthetic_blender_scene(
    root: str,
    n_train: int = 12,
    n_test: int = 4,
    wh: Tuple[int, int] = (64, 64),
    camera_angle_x: float = 0.6911,
    cam_radius: float = 4.0,
    seed: int = 0,
    scene: str = "sphere",
) -> str:
    """Write ``transforms_{train,test}.json`` and RGBA PNGs of
    ``make_synthetic_scene_arrays``'s scene under ``root`` (needs PIL):
    the files the JAX package's writer makes for the same arguments.
    Returns ``root``."""
    import json
    import os

    from PIL import Image

    splits = make_synthetic_scene_arrays(n_train, n_test, wh, camera_angle_x, cam_radius, seed,
                                         scene)
    for split, meta in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for frame in meta["frames"]:
            Image.fromarray(frame["image"]).save(os.path.join(root, frame["file_path"] + ".png"))
            frames.append({"file_path": frame["file_path"],
                           "transform_matrix": frame["transform_matrix"]})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    return root


# A forward-facing capture in LLFF's layout: a textured backdrop plane
# behind a few textured spheres, seen from a small rig of cameras that all
# look down -z (world: x right, y up, z back).
FORWARD_SPHERES = (
    # (center, radius, base_rgb_a, base_rgb_b, checker_freq)
    ((0.0, 0.0, -4.0), 0.9, (0.9, 0.3, 0.25), (0.95, 0.85, 0.6), 10),
    ((1.3, 0.6, -5.0), 0.6, (0.2, 0.5, 0.9), (0.9, 0.9, 0.35), 8),
    ((-1.2, -0.5, -3.4), 0.5, (0.25, 0.75, 0.35), (0.2, 0.2, 0.55), 12),
    ((-0.6, 1.0, -5.6), 0.55, (0.85, 0.55, 0.2), (0.35, 0.1, 0.45), 6),
)
FORWARD_PLANE_Z = -8.0


def _trace_forward(c2w: np.ndarray, wh: Tuple[int, int], focal: float) -> np.ndarray:
    """Nearest-hit analytic render (H, W, 3) float32 and the (H, W) hit
    depths along the camera's -z, of the forward-facing scene."""
    W, H = wh
    i, j = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                       np.arange(H, dtype=np.float32) + 0.5, indexing="xy")
    dirs = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    rd = (dirs @ c2w[:3, :3].T.astype(np.float32)).reshape(-1, 3)
    ro = c2w[:3, 3].astype(np.float32)
    light = np.array([0.4, 0.5, 0.77], np.float32)
    light /= np.linalg.norm(light)
    # the backdrop: a plane z = FORWARD_PLANE_Z with a coloured checker
    t_best = (FORWARD_PLANE_Z - ro[2]) / rd[:, 2]
    p = ro + rd * t_best[:, None]
    cell = (np.floor(p[:, 0] * 1.5) + np.floor(p[:, 1] * 1.5)) % 2.0
    stripe = 0.5 + 0.5 * np.sin(p[:, 0] * 0.9)
    rgb = np.where(cell[:, None] > 0.5, np.array([0.3, 0.35, 0.3], np.float32),
                   np.array([0.75, 0.7, 0.55], np.float32)) * (0.7 + 0.3 * stripe[:, None])
    for center, radius, col_a, col_b, freq in FORWARD_SPHERES:
        oc = ro - np.asarray(center, np.float32)
        dd = np.sum(rd * rd, axis=-1)
        b = np.sum(rd * oc, axis=-1) / dd
        disc = b * b - (np.sum(oc * oc) - radius**2) / dd
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit = np.nonzero((disc > 0) & (t > 1e-6) & (t < t_best))[0]
        n = (ro + rd[hit] * t[hit, None] - np.asarray(center, np.float32)) / radius
        theta = np.arccos(np.clip(n[:, 1], -1, 1))
        phi = np.arctan2(n[:, 2], n[:, 0])
        checker = (np.floor(theta / np.pi * freq)
                   + np.floor((phi + np.pi) / (2 * np.pi) * freq)) % 2.0
        albedo = np.where(checker[:, None] > 0.5, np.asarray(col_a, np.float32),
                          np.asarray(col_b, np.float32))
        lambert = np.clip(n @ light, 0, 1)
        rgb[hit] = albedo * (0.3 + 0.7 * lambert[:, None])
        t_best[hit] = t[hit]
    return np.clip(rgb, 0, 1).reshape(H, W, 3), t_best.reshape(H, W)


def make_forward_facing_scene(
    n_views: int = 34,
    wh: Tuple[int, int] = (1008, 756),
    focal: Optional[float] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """An LLFF capture in memory: {"poses_bounds": (N, 17) float64,
    "images": uint8 (N, H, W, 3)}, the layout of ``poses_bounds.npy`` and
    ``images_4/`` (data/llff.py reads either).  Each pose row holds the
    camera's "down right back" axes and position, then (H, W, focal) at 4x
    the images' resolution, as LLFF stores the full-size camera the
    downsampled images_4 come from; the last two columns are the view's
    near and far depth bounds.  The cameras sit on a jittered spiral in the
    z = 0 plane, each looking at a point on the -z axis; ``focal`` (pixels)
    defaults to 820 at a width of 1008 (a 63-degree field of view)."""
    rng = np.random.default_rng(seed)
    W, H = wh
    focal = 820.0 * W / 1008 if focal is None else focal
    rows, images = [], []
    for k in range(n_views):
        a = 2 * np.pi * 2 * k / n_views
        r = 0.35 * (0.4 + 0.6 * k / max(n_views - 1, 1))
        pos = np.array([r * np.cos(a), 0.75 * r * np.sin(a), 0.0]) + 0.02 * rng.standard_normal(3)
        target = np.array([0.0, 0.0, -5.0]) + 0.1 * rng.standard_normal(3)
        back = pos - target
        back /= np.linalg.norm(back)
        right = np.cross(np.array([0.0, 1.0, 0.0]), back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.stack([right, up, back, pos], 1)  # (3, 4) right up back
        rgb, depth = _trace_forward(c2w, wh, focal)
        images.append((rgb * 255).astype(np.uint8))
        # the camera-space directions have z = -1: t is the depth
        near, far = 0.9 * float(depth.min()), 1.1 * float(depth.max())
        m = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:4]], 1)  # down right back
        hwf = np.array([[H * 4.0], [W * 4.0], [focal * 4.0]])
        rows.append(np.concatenate([np.concatenate([m, hwf], 1).reshape(-1), [near, far]]))
    return {"poses_bounds": np.stack(rows), "images": np.stack(images)}


def write_forward_facing_scene(root: str, scene: Dict[str, np.ndarray]) -> str:
    """Write ``scene`` (make_forward_facing_scene) as an LLFF directory:
    ``poses_bounds.npy`` and ``images_4/<k>.png`` (needs PIL).  Returns
    ``root``."""
    import os

    from PIL import Image

    os.makedirs(os.path.join(root, "images_4"), exist_ok=True)
    np.save(os.path.join(root, "poses_bounds.npy"), scene["poses_bounds"])
    for k, img in enumerate(scene["images"]):
        Image.fromarray(img).save(os.path.join(root, "images_4", f"{k:03d}.png"))
    return root
