"""COLMAP -> transforms.json conversion tool (a copy of
tensorf_tpu/data/colmap2nerf.py), the host tool behind
configs/your_own_data.txt.

    python -m tensorf_tpu_torch.data.colmap2nerf [--video V] [--run_colmap]
        --images DIR --text DIR --out transforms.json

Parses a COLMAP text model (cameras.txt / images.txt), scores image
sharpness, converts the w2c quaternion poses to blender-convention c2w
matrices, recentres and rescales the scene, and writes the transforms.json
that data/your_own_data.py reads.  ffmpeg and colmap run only when asked
for (``--video``, ``--run_colmap``); the conversion is numpy.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
from typing import Dict

import numpy as np


def run_ffmpeg(video: str, images_dir: str, fps: float = 2.0):
    """Extract frames from a video with ffmpeg."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH")
    os.makedirs(images_dir, exist_ok=True)
    subprocess.run(
        [
            "ffmpeg", "-i", video, "-qscale:v", "1", "-qmin", "1",
            "-vf", f"fps={fps}", os.path.join(images_dir, "%04d.jpg"),
        ],
        check=True,
    )


def run_colmap(images_dir: str, out_dir: str, matcher: str = "sequential"):
    """Run COLMAP feature extraction, matching and mapping; returns the
    text model's directory."""
    if shutil.which("colmap") is None:
        raise RuntimeError("colmap not found on PATH")
    db = os.path.join(out_dir, "colmap.db")
    sparse = os.path.join(out_dir, "sparse")
    text = os.path.join(out_dir, "colmap_text")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(text, exist_ok=True)
    subprocess.run(
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", images_dir,
         "--ImageReader.camera_model", "OPENCV",
         "--ImageReader.single_camera", "1"],
        check=True,
    )
    subprocess.run(
        ["colmap", f"{matcher}_matcher", "--database_path", db], check=True
    )
    subprocess.run(
        ["colmap", "mapper", "--database_path", db,
         "--image_path", images_dir, "--output_path", sparse],
        check=True,
    )
    subprocess.run(
        ["colmap", "model_converter",
         "--input_path", os.path.join(sparse, "0"),
         "--output_path", text, "--output_type", "TXT"],
        check=True,
    )
    return text


def sharpness(image_path: str) -> float:
    """Variance-of-Laplacian focus score (needs PIL)."""
    from PIL import Image

    img = np.asarray(Image.open(image_path).convert("L"), np.float64)
    lap = (
        -4 * img[1:-1, 1:-1]
        + img[:-2, 1:-1]
        + img[2:, 1:-1]
        + img[1:-1, :-2]
        + img[1:-1, 2:]
    )
    return float(lap.var())


def qvec2rotmat(q) -> np.ndarray:
    """COLMAP quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def closest_point_2_lines(oa, da, ob, db):
    """Point minimizing distance to two rays + a confidence weight."""
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    ta, tb = max(ta, 0), max(tb, 0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def parse_colmap_cameras(path: str) -> Dict:
    """cameras.txt -> intrinsics dict (first camera)."""
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            model, w, h = parts[1], int(parts[2]), int(parts[3])
            p = [float(v) for v in parts[4:]]
            out = {"w": w, "h": h, "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0}
            if model == "SIMPLE_PINHOLE":
                out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
            elif model == "PINHOLE":
                out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
            elif model in ("SIMPLE_RADIAL", "RADIAL"):
                out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
                if model == "RADIAL":
                    out["k2"] = p[4]
            elif model == "OPENCV":
                out.update(
                    fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                    k1=p[4], k2=p[5], p1=p[6], p2=p[7],
                )
            else:
                raise ValueError(f"unhandled camera model {model}")
            out["camera_angle_x"] = 2 * math.atan(w / (2 * out["fl_x"]))
            out["camera_angle_y"] = 2 * math.atan(h / (2 * out["fl_y"]))
            return out
    raise ValueError("no camera found")


def colmap2nerf(
    text_dir: str,
    images_dir: str,
    out_path: str = "transforms.json",
    aabb_scale: int = 4,
    keep_colmap_coords: bool = False,
):
    """Convert a COLMAP text model to a transforms.json."""
    cam = parse_colmap_cameras(os.path.join(text_dir, "cameras.txt"))

    frames = []
    with open(os.path.join(text_dir, "images.txt")) as f:
        lines = [
            l.strip() for l in f
            if l.strip() and not l.startswith("#")
        ]
    # images.txt alternates pose lines and 2D-point lines
    flip_mat = np.diag([1, -1, -1, 1.0])
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        qvec = np.array([float(v) for v in parts[1:5]])
        tvec = np.array([float(v) for v in parts[5:8]])
        name = parts[9]
        R = qvec2rotmat(qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = tvec
        c2w = np.linalg.inv(w2c)
        if not keep_colmap_coords:
            # OpenCV -> blender camera convention (flip y, z)
            c2w = c2w @ flip_mat
        img_path = os.path.join(images_dir, name)
        frame = {
            "file_path": os.path.join(
                os.path.basename(images_dir.rstrip("/")), name
            ),
            "transform_matrix": c2w.tolist(),
        }
        if os.path.exists(img_path):
            frame["sharpness"] = sharpness(img_path)
        frames.append(frame)

    if not keep_colmap_coords and len(frames) > 1:
        # recenter on the mutual closest point of all camera rays and
        # rescale to ~unit camera distance
        mats = [np.asarray(fr["transform_matrix"]) for fr in frames]
        totw, totp = 0.0, np.zeros(3)
        for a in mats:
            for b in mats:
                p, w = closest_point_2_lines(
                    a[:3, 3], a[:3, 2], b[:3, 3], b[:3, 2]
                )
                if w > 0.01:
                    totp += p * w
                    totw += w
        if totw > 0:
            center = totp / totw
            for m in mats:
                m[:3, 3] -= center
            avglen = float(np.mean([np.linalg.norm(m[:3, 3]) for m in mats]))
            for m in mats:
                m[:3, 3] *= 4.0 / max(avglen, 1e-9)
            for fr, m in zip(frames, mats):
                fr["transform_matrix"] = m.tolist()

    out = dict(cam)
    out["aabb_scale"] = aabb_scale
    out["frames"] = frames
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {out_path} ({len(frames)} frames)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--video", default=None, help="extract frames first")
    ap.add_argument("--fps", type=float, default=2.0)
    ap.add_argument("--images", default="images")
    ap.add_argument("--run_colmap", action="store_true")
    ap.add_argument("--colmap_matcher", default="sequential")
    ap.add_argument("--text", default="colmap_text",
                    help="COLMAP text-model dir (cameras.txt/images.txt)")
    ap.add_argument("--out", default="transforms.json")
    ap.add_argument("--aabb_scale", type=int, default=4)
    ap.add_argument("--keep_colmap_coords", action="store_true")
    args = ap.parse_args(argv)

    if args.video:
        run_ffmpeg(args.video, args.images, args.fps)
    text = args.text
    if args.run_colmap:
        text = run_colmap(args.images, os.path.dirname(args.out) or ".",
                          args.colmap_matcher)
    colmap2nerf(
        text, args.images, args.out, args.aabb_scale, args.keep_colmap_coords
    )


if __name__ == "__main__":
    main()
