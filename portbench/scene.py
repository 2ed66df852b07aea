"""The benchmark's scenes, traced analytically on the card.

Two scenes, each a public capture's layout filled with a procedural
object that the benchmark knows exactly:

* ``composite``: eight checker-textured spheres inside Blender's +-1.5 box,
  photographed as NeRF-synthetic's Blender scenes are (cameras on an orbit
  of radius 4 looking at the origin, 800x800 RGBA, white background).
* ``forward``: four spheres before a checkered backdrop at z = -8,
  photographed as LLFF's forward-facing captures are (a spiral of cameras
  in the z = 0 plane, 1008x756 RGB, flower's images_4 size).

The cameras of the training views are fixed by the configuration, so every
seed trains on the same photos; the seed draws the served views.  The
images are handed to the port's loaders in their in-memory layouts
(``loader_scene``); the benchmark keeps its own copy of every photo and
every ray for the comparisons (``Scene``).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

# (center, radius, colour a, colour b, checker frequency)
COMPOSITE_SPHERES = (
    ((0.0, 0.0, 0.0), 0.55, (0.9, 0.25, 0.2), (0.95, 0.9, 0.85), 12),
    ((0.85, 0.0, -0.1), 0.26, (0.2, 0.5, 0.9), (0.9, 0.9, 0.3), 8),
    ((-0.85, 0.0, -0.1), 0.26, (0.2, 0.8, 0.4), (0.2, 0.2, 0.6), 10),
    ((0.0, 0.85, -0.1), 0.26, (0.9, 0.6, 0.2), (0.3, 0.1, 0.4), 14),
    ((0.0, -0.85, -0.1), 0.26, (0.7, 0.2, 0.7), (0.9, 0.95, 0.9), 6),
    ((0.45, 0.45, 0.62), 0.16, (0.95, 0.85, 0.2), (0.1, 0.1, 0.1), 16),
    ((-0.45, -0.45, 0.62), 0.16, (0.3, 0.9, 0.9), (0.9, 0.3, 0.2), 20),
    ((0.0, 0.0, -0.78), 0.22, (0.55, 0.55, 0.6), (0.95, 0.45, 0.1), 24),
)
FORWARD_SPHERES = (
    ((0.0, 0.0, -4.0), 0.9, (0.9, 0.3, 0.25), (0.95, 0.85, 0.6), 10),
    ((1.3, 0.6, -5.0), 0.6, (0.2, 0.5, 0.9), (0.9, 0.9, 0.35), 8),
    ((-1.2, -0.5, -3.4), 0.5, (0.25, 0.75, 0.35), (0.2, 0.2, 0.55), 12),
    ((-0.6, 1.0, -5.6), 0.55, (0.85, 0.55, 0.2), (0.35, 0.1, 0.45), 6),
)
FORWARD_PLANE_Z = -8.0
# the flip from OpenGL camera axes (Blender's) to OpenCV's (the loader's)
BLENDER2OPENCV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


class Scene(NamedTuple):
    kind: str
    wh: tuple
    focal: float
    # the training photos as the loader reads them: (N, H, W, 4|3) uint8
    images: torch.Tensor
    # c2w (N, 4, 4) float32 of the training views, OpenGL axes
    c2w: np.ndarray
    # what the port's loader is handed
    loader_scene: dict
    # forward scenes: the LLFF frame (pose_avg (4, 4), scale), as the
    # loader recentres and rescales the poses
    frame: Optional[tuple] = None


def _checker(n: torch.Tensor, freq: int, up: int, a: int, b: int) -> torch.Tensor:
    theta = torch.arccos(torch.clamp(n[:, up], -1.0, 1.0))
    phi = torch.atan2(n[:, b], n[:, a])
    return torch.remainder(torch.floor(theta / math.pi * freq)
                           + torch.floor((phi + math.pi) / (2 * math.pi) * freq), 2.0)


def trace_spheres(ro: torch.Tensor, rd: torch.Tensor, spheres, t_best: torch.Tensor,
                  rgb: torch.Tensor, light, ambient: float, up: int, a: int, b: int):
    """Nearest-hit shading of ``spheres`` along rays (ro (M|1, 3), rd (M, 3)),
    in place over ``t_best`` (M,) and ``rgb`` (M, 3)."""
    light = torch.as_tensor(light, dtype=rd.dtype, device=rd.device)
    light = light / torch.linalg.norm(light)
    for center, radius, col_a, col_b, freq in spheres:
        c = torch.as_tensor(center, dtype=rd.dtype, device=rd.device)
        oc = ro - c
        dd = torch.sum(rd * rd, dim=-1)
        bq = torch.sum(rd * oc, dim=-1) / dd
        disc = bq * bq - (torch.sum(oc * oc, dim=-1) - radius ** 2) / dd
        t = -bq - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 1e-6) & (t < t_best)
        n = (ro + rd * t[:, None] - c) / radius
        checker = _checker(n, freq, up, a, b)
        albedo = torch.where(checker[:, None] > 0.5,
                             torch.as_tensor(col_a, dtype=rd.dtype, device=rd.device),
                             torch.as_tensor(col_b, dtype=rd.dtype, device=rd.device))
        lambert = torch.clamp(n @ light, 0.0, 1.0)
        shaded = albedo * (ambient + (1.0 - ambient) * lambert[:, None])
        rgb.copy_(torch.where(hit[:, None], shaded, rgb))
        t_best.copy_(torch.where(hit, t, t_best))


def camera_dirs(wh, focal: float, device, opengl: bool) -> torch.Tensor:
    """Camera-space directions (H*W, 3) at pixel centres, not normalised:
    OpenCV axes (+z forward) or OpenGL axes (-z forward)."""
    W, H = wh
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device) + 0.5,
                          torch.arange(W, dtype=torch.float32, device=device) + 0.5,
                          indexing="ij")
    sign = -1.0 if opengl else 1.0
    d = torch.stack([(i - W / 2) / focal, sign * (j - H / 2) / focal,
                     torch.full_like(i, sign)], dim=-1)
    return d.reshape(-1, 3)


def look_at_gl(pos: np.ndarray) -> np.ndarray:
    """OpenGL c2w (x right, y up, -z forward) at ``pos`` looking at the
    origin, world up +z."""
    forward = -pos / np.linalg.norm(pos)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, pos
    return c2w.astype(np.float32)


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    return look_at_gl(radius * np.array([math.cos(theta) * math.cos(phi),
                                         math.sin(theta) * math.cos(phi), math.sin(phi)]))


def trace_composite(c2w: np.ndarray, wh, focal: float, device) -> torch.Tensor:
    """(H, W, 4) uint8 RGBA photo of the composite scene from ``c2w``."""
    W, H = wh
    R = torch.as_tensor(c2w[:3, :3], device=device)
    rd = camera_dirs(wh, focal, device, opengl=True) @ R.T
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    ro = torch.as_tensor(c2w[:3, 3], device=device)[None]
    t_best = torch.full((rd.shape[0],), float("inf"), device=device)
    rgb = torch.ones((rd.shape[0], 3), device=device)
    trace_spheres(ro, rd, COMPOSITE_SPHERES, t_best, rgb, (0.577, 0.577, 0.577), 0.25,
                  up=2, a=0, b=1)
    hit = torch.isfinite(t_best)
    out = torch.cat([torch.clamp(rgb, 0.0, 1.0), hit[:, None].float()], dim=-1)
    return (out * 255).to(torch.uint8).reshape(H, W, 4)


def composite_train_poses(n: int, radius: float) -> List[np.ndarray]:
    """The fixed training cameras: evenly around the orbit, each at an
    elevation of pi/5 moved by a fixed draw."""
    rng = np.random.default_rng(0)
    return [orbit_pose(2 * math.pi * k / n, math.pi / 5 + 0.25 * rng.standard_normal(), radius)
            for k in range(n)]


def served_poses(seed: int, n: int, radius: float) -> List[np.ndarray]:
    """``n`` test-orbit cameras drawn from ``seed``: any azimuth, elevation
    pi/5 moved by a normal draw of sd 0.25, as the test split's."""
    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(n, generator=g, dtype=torch.float64) * 2 * math.pi
    phi = math.pi / 5 + 0.25 * torch.randn(n, generator=g, dtype=torch.float64)
    return [orbit_pose(float(t), float(p), radius) for t, p in zip(theta, phi)]


def view_rays(c2w_gl: np.ndarray, wh, focal: float, device) -> torch.Tensor:
    """(H*W, 6) rays of a view as the Blender loader builds them: normalised
    OpenCV directions rotated by the OpenCV pose."""
    pose = torch.as_tensor(c2w_gl @ BLENDER2OPENCV, device=device)
    d = camera_dirs(wh, focal, device, opengl=False)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rd = d @ pose[:3, :3].T
    return torch.cat([pose[:3, 3].expand_as(rd), rd], dim=-1)


def make_composite(spec: dict, device) -> Scene:
    wh = tuple(spec["wh"])
    focal = 0.5 * wh[0] / math.tan(0.5 * spec["camera_angle_x"])
    poses = composite_train_poses(spec["n_train"], spec["cam_radius"])
    images = torch.stack([trace_composite(p, wh, focal, device) for p in poses])
    host = images.cpu().numpy()

    def split(idx):
        return {"camera_angle_x": spec["camera_angle_x"],
                "frames": [{"file_path": f"./r_{k}", "transform_matrix": poses[k].tolist(),
                            "image": host[k]} for k in idx]}

    # the loader builds a test split too: one view, which nothing serves
    loader_scene = {"train": split(range(len(poses))), "test": split([0])}
    return Scene("composite", wh, focal, images, np.stack(poses), loader_scene)


def forward_poses(n: int):
    """The fixed spiral of a forward-facing capture: (c2w (3, 4) right up
    back, target) per view."""
    rng = np.random.default_rng(0)
    out = []
    for k in range(n):
        a = 2 * np.pi * 2 * k / n
        r = 0.35 * (0.4 + 0.6 * k / max(n - 1, 1))
        pos = np.array([r * np.cos(a), 0.75 * r * np.sin(a), 0.0]) + 0.02 * rng.standard_normal(3)
        target = np.array([0.0, 0.0, -5.0]) + 0.1 * rng.standard_normal(3)
        back = pos - target
        back /= np.linalg.norm(back)
        right = np.cross(np.array([0.0, 1.0, 0.0]), back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        out.append(np.stack([right, up, back, pos], 1))
    return out


def trace_forward(c2w: np.ndarray, wh, focal: float, device):
    """(H, W, 3) uint8 photo and (H*W,) hit depths along the camera's -z."""
    W, H = wh
    R = torch.as_tensor(c2w[:3, :3], dtype=torch.float32, device=device)
    rd = camera_dirs(wh, focal, device, opengl=True) @ R.T
    ro = torch.as_tensor(c2w[:3, 3], dtype=torch.float32, device=device)[None]
    t_best = (FORWARD_PLANE_Z - ro[:, 2]) / rd[:, 2]
    p = ro + rd * t_best[:, None]
    cell = torch.remainder(torch.floor(p[:, 0] * 1.5) + torch.floor(p[:, 1] * 1.5), 2.0)
    stripe = 0.5 + 0.5 * torch.sin(p[:, 0] * 0.9)
    col = torch.where(cell[:, None] > 0.5, torch.tensor([0.3, 0.35, 0.3], device=device),
                      torch.tensor([0.75, 0.7, 0.55], device=device))
    rgb = col * (0.7 + 0.3 * stripe[:, None])
    trace_spheres(ro, rd, FORWARD_SPHERES, t_best, rgb, (0.4, 0.5, 0.77), 0.3, up=1, a=0, b=2)
    img = (torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8).reshape(H, W, 3)
    return img, t_best


def average_pose(poses: np.ndarray) -> np.ndarray:
    """The LLFF average pose (4, 4), as LLFF's loaders take it: mean
    centre, mean back axis z, x = z cross the mean up axis, y = x cross z."""
    def norm(v):
        return v / np.linalg.norm(v)
    center = poses[:, :, 3].mean(0)
    z = norm(poses[:, :, 2].mean(0))
    x = norm(np.cross(z, poses[:, :, 1].mean(0)))
    y = np.cross(x, z)
    out = np.eye(4)
    out[:3] = np.stack([x, y, z, center], 1)
    return out


def make_forward(spec: dict, device) -> Scene:
    wh = tuple(spec["wh"])
    focal = float(spec["focal"])
    W, H = wh
    rows, images = [], []
    poses = forward_poses(spec["n_views"])
    for c2w in poses:
        img, depth = trace_forward(c2w, wh, focal, device)
        images.append(img)
        near, far = 0.9 * float(depth.min()), 1.1 * float(depth.max())
        m = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:4]], 1)  # down right back
        hwf = np.array([[H * 4.0], [W * 4.0], [focal * 4.0]])
        rows.append(np.concatenate([np.concatenate([m, hwf], 1).reshape(-1), [near, far]]))
    images = torch.stack(images)
    poses_bounds = np.stack(rows)
    loader_scene = {"poses_bounds": poses_bounds, "images": images.cpu().numpy()}
    # the loader's frame: recentred on the average pose, scaled so the
    # nearest bound sits at 1 / 0.75
    stacked = np.stack(poses)
    scale = float(poses_bounds[:, -2].min()) * 0.75
    return Scene("forward", wh, focal, images, stacked, loader_scene,
                 frame=(average_pose(stacked), scale))


def make_scene(spec: dict, device) -> Scene:
    return {"composite": make_composite, "forward": make_forward}[spec["kind"]](spec, device)


def forward_rays(scene: Scene, views, device) -> torch.Tensor:
    """(len(views) * H * W, 6) NDC rays of forward views as the LLFF loader
    builds them: poses recentred and rescaled, blender directions, NDC at
    near 1."""
    pose_avg, scale = scene.frame
    W, H = scene.wh
    f = scene.focal
    inv = torch.as_tensor(np.linalg.inv(pose_avg), dtype=torch.float32, device=device)
    d_cam = camera_dirs(scene.wh, f, device, opengl=True)
    out = []
    for k in views:
        c2w = np.eye(4)
        c2w[:3] = scene.c2w[k]
        pose = inv @ torch.as_tensor(c2w, dtype=torch.float32, device=device)
        rd = d_cam @ pose[:3, :3].T
        ro = (pose[:3, 3] / scale).expand_as(rd)
        t = -(1.0 + ro[:, 2]) / rd[:, 2]
        ro = ro + t[:, None] * rd
        o0 = -1.0 / (W / (2.0 * f)) * ro[:, 0] / ro[:, 2]
        o1 = -1.0 / (H / (2.0 * f)) * ro[:, 1] / ro[:, 2]
        o2 = 1.0 + 2.0 * 1.0 / ro[:, 2]
        d0 = -1.0 / (W / (2.0 * f)) * (rd[:, 0] / rd[:, 2] - ro[:, 0] / ro[:, 2])
        d1 = -1.0 / (H / (2.0 * f)) * (rd[:, 1] / rd[:, 2] - ro[:, 1] / ro[:, 2])
        d2 = -2.0 * 1.0 / ro[:, 2]
        out.append(torch.stack([o0, o1, o2, d0, d1, d2], dim=-1))
    return torch.cat(out)


def forward_train_views(n_views: int, hold_every: int = 8) -> List[int]:
    """LLFF's split: every ``hold_every``-th view is held out."""
    return [k for k in range(n_views) if k % hold_every]


def ndc_to_world(scene: Scene, pts: torch.Tensor) -> torch.Tensor:
    """NDC points (..., 3) of a forward scene -> world points, through the
    loader's recentred and rescaled frame (NDC z = 1 + 2 / Z)."""
    pose_avg, scale = scene.frame
    W, H = scene.wh
    f = scene.focal
    Z = 2.0 / (pts[..., 2] - 1.0)
    X = -pts[..., 0] * Z * (W / (2.0 * f))
    Y = -pts[..., 1] * Z * (H / (2.0 * f))
    local = torch.stack([X, Y, Z], dim=-1) * scale
    R = torch.as_tensor(pose_avg[:3, :3], dtype=pts.dtype, device=pts.device)
    t = torch.as_tensor(pose_avg[:3, 3], dtype=pts.dtype, device=pts.device)
    return local @ R.T + t


def occupancy(scene: Scene, pts: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """(...,) bool: which lattice points (..., 3) of the field's frame lie in
    the scene's objects.  ``cell`` (3,) is the lattice spacing: a forward
    scene's backdrop plane occupies the points within one NDC cell of it."""
    if scene.kind == "composite":
        occ = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
        for center, radius, *_ in COMPOSITE_SPHERES:
            c = torch.as_tensor(center, dtype=pts.dtype, device=pts.device)
            occ |= torch.sum(torch.square(pts - c), dim=-1) <= radius ** 2
        return occ
    world = ndc_to_world(scene, pts)
    ahead = pts.clone()
    ahead[..., 2] = ahead[..., 2] + cell[2]
    thick = torch.linalg.norm(ndc_to_world(scene, ahead) - world, dim=-1)
    occ = torch.abs(world[..., 2] - FORWARD_PLANE_Z) <= thick
    for center, radius, *_ in FORWARD_SPHERES:
        c = torch.as_tensor(center, dtype=pts.dtype, device=pts.device)
        occ |= torch.sum(torch.square(world - c), dim=-1) <= radius ** 2
    return occ
