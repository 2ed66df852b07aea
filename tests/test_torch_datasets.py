"""The port's dataset loaders and file tools against tensorf_tpu's.

Each of the five loaders beside blender reads a tiny on-disk scene (the
layouts tests/test_loaders.py and tests/test_own_data.py write) in both
packages, both splits, and every attribute JAX's loader sets must be equal
in the port's (its rays, colours, masks, poses, render path, focal, image
size, near/far and bbox).  The in-memory LLFF layout loads what the
on-disk one does; read_pfm and colmap2nerf's conversion match JAX's; and
every config in configs/ builds a run in the port and takes one step.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tensorf_tpu.data import colmap2nerf as jc2n
from tensorf_tpu.data import dataset_dict as j_datasets
from tensorf_tpu.data.io import read_pfm as j_read_pfm
from tensorf_tpu.data.synthetic import make_synthetic_blender_scene
from tensorf_tpu_torch.config import load_config
from tensorf_tpu_torch.data import colmap2nerf as tc2n
from tensorf_tpu_torch.data import dataset_dict as t_datasets
from tensorf_tpu_torch.data.io import read_pfm as t_read_pfm
from tensorf_tpu_torch.data.synthetic import (
    make_forward_facing_scene,
    make_synthetic_scene_arrays,
    write_forward_facing_scene,
)
from tensorf_tpu_torch.train.loop import TrainState, build_statics
from tensorf_tpu_torch.train.step import make_train_step

# every attribute a loader of either package may set that a run reads, and
# the intrinsics matrix where the port's loader keeps one (its blender and
# human loaders keep none: nothing reads it)
ATTRS = ("all_rays", "all_rgbs", "all_masks", "poses", "render_path", "focal", "img_wh",
         "near_far", "near_fars", "scene_bbox", "white_bg", "directions", "intrinsics")
OPTIONAL = ("intrinsics",)


def _save(path, h, w, rng, ch=4):
    Image.fromarray((rng.uniform(size=(h, w, ch)) * 255).astype(np.uint8)).save(path)


def _same(got, want):
    for name in ATTRS:
        if not hasattr(want, name) or (name in OPTIONAL and not hasattr(got, name)):
            continue
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, (bool, tuple)) or np.isscalar(b):
            assert a == b, name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def llff_scene(root, rng):
    """tests/test_loaders.py's LLFF layout: 10 views, images_4 of 60x40."""
    n, H, W, focal = 10, 40, 60, 50.0
    os.makedirs(root / "images_4")
    poses = []
    for i in range(n):
        theta = 0.2 * (i - n / 2)
        c2w = np.eye(4)[:3]
        c2w[:, 3] = [np.sin(theta), 0.05 * i, 4.0 + 0.1 * np.cos(theta)]
        m = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:4]], axis=1)
        hwf = np.array([[H * 4], [W * 4], [focal * 4]])
        poses.append(np.concatenate([m, hwf], axis=1).reshape(-1))
        _save(root / "images_4" / f"im_{i:03d}.png", H, W, rng)
    bounds = np.stack([np.full(n, 2.0), np.full(n, 8.0)], -1)
    np.save(root / "poses_bounds.npy", np.concatenate([np.stack(poses), bounds], axis=1))
    return dict(downsample=4)


def nsvf_scene(root, rng):
    os.makedirs(root / "pose")
    os.makedirs(root / "rgb")
    np.savetxt(root / "bbox.txt", np.array([[-1, -1, -1, 1, 1, 1, 0.1]]))
    (root / "intrinsics.txt").write_text("555.0 400.0 400.0 0.\n0 0 0\n")
    for prefix, n in (("0_", 3), ("2_", 2)):
        for i in range(n):
            c2w = np.eye(4)
            c2w[2, 3] = 3.0 + i
            np.savetxt(root / "pose" / f"{prefix}{i:02d}.txt", c2w)
            _save(root / "rgb" / f"{prefix}{i:02d}.png", 32, 32, rng)
    return dict(downsample=25.0, wh=(800, 800))


def tankstemple_scene(root, rng):
    os.makedirs(root / "pose")
    os.makedirs(root / "rgb")
    np.savetxt(root / "bbox.txt", np.array([[-1, -1, -1, 1, 1, 1, 0.1]]))
    intr = np.eye(3)
    intr[0, 0] = intr[1, 1] = 1111.0
    intr[0, 2], intr[1, 2] = 960, 540
    np.savetxt(root / "intrinsics.txt", intr)
    for prefix, n in (("0_", 3), ("1_", 2)):
        for i in range(n):
            c2w = np.eye(4)
            c2w[2, 3] = 3.0 + i
            np.savetxt(root / "pose" / f"{prefix}{i:02d}.txt", c2w)
            _save(root / "rgb" / f"{prefix}{i:02d}.png", 27, 48, rng)
    return dict(downsample=40.0)


def human_scene(root, rng, n_train=4):
    """A blender-layout scene whose frames name their images by Windows
    paths, under <root>/<split>/, as the THuman renders do."""
    make_synthetic_blender_scene(str(root), n_train=n_train, n_test=2, wh=(16, 16),
                                 scene="sphere")
    for split in ("train", "test"):
        path = root / f"transforms_{split}.json"
        meta = json.loads(path.read_text())
        for frame in meta["frames"]:
            frame["file_path"] = "C:\\renders\\" + frame["file_path"].split("/")[-1] + ".png"
        path.write_text(json.dumps(meta))
    return dict(wh=(16, 16), N_imgs=3)


def own_data_scene(root, rng):
    """tests/test_own_data.py's colmap2nerf-style transforms."""
    os.makedirs(root / "images")
    frames = []
    for i in range(3):
        _save(root / "images" / f"f_{i}.png", 20, 30, rng)
        c2w = np.eye(4)
        c2w[:3, 3] = [0, 0, 2 + i]
        frames.append({"file_path": f"images/f_{i}.png", "transform_matrix": c2w.tolist()})
    meta = {"w": 30, "h": 20, "fl_x": 40.0, "fl_y": 42.0, "cx": 14.0, "cy": 11.0,
            "camera_angle_x": 0.7, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return dict(num_images=[0, 2])


SCENES = {"llff": llff_scene, "nsvf": nsvf_scene, "tankstemple": tankstemple_scene,
          "human": human_scene, "own_data": own_data_scene}


def test_dataset_dict_names_every_loader():
    assert set(t_datasets) == set(j_datasets)


@pytest.mark.parametrize("name", list(SCENES))
def test_loader_matches_jax(tmp_path, rng, name):
    kw = SCENES[name](tmp_path, rng)
    for split, stack in (("train", False), ("test", True)):
        want = j_datasets[name](str(tmp_path), split=split, is_stack=stack, **kw)
        got = t_datasets[name](str(tmp_path), split=split, is_stack=stack, **kw)
        assert len(np.asarray(got.all_rays)) > 0
        _same(got, want)


def test_llff_in_memory_layout_equals_the_one_on_disk(tmp_path):
    """make_forward_facing_scene written by write_forward_facing_scene loads
    the same in both packages from disk, and in the port from memory."""
    scene = make_forward_facing_scene(n_views=10, wh=(40, 30))
    write_forward_facing_scene(str(tmp_path), scene)
    assert len(os.listdir(tmp_path / "images_4")) == 10
    for split, stack in (("train", False), ("test", True)):
        want = j_datasets["llff"](str(tmp_path), split=split, is_stack=stack)
        from_disk = t_datasets["llff"](str(tmp_path), split=split, is_stack=stack)
        in_memory = t_datasets["llff"]("unused", split=split, is_stack=stack, meta=scene)
        for got in (from_disk, in_memory):
            _same(got, want)
        assert want.img_wh == (40, 30) and len(want.poses) == 10
    # hold_every 8: views 0 and 8 are the test split
    assert want.all_rays.shape == (2, 40 * 30, 6)
    # the capture's content lies inside LLFF's NDC box
    assert np.abs(want.all_rays[..., 2]).max() <= 1.0 + 1e-5


@pytest.mark.parametrize("color", [True, False], ids=["PF", "Pf"])
def test_read_pfm_matches_jax(tmp_path, rng, color):
    data = rng.normal(size=(5, 7, 3) if color else (5, 7)).astype("<f4")
    path = tmp_path / "d.pfm"
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"7 5\n-1.0\n")
        f.write(np.flipud(data).tobytes())
    got, scale = t_read_pfm(str(path))
    want, j_scale = j_read_pfm(str(path))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
    assert scale == j_scale == 1.0
    (tmp_path / "bad.pfm").write_bytes(b"P6\n")
    with pytest.raises(ValueError):
        t_read_pfm(str(tmp_path / "bad.pfm"))


CAMERAS = {
    "SIMPLE_PINHOLE": "100.0 20 15",
    "PINHOLE": "100.0 110.0 20 15",
    "SIMPLE_RADIAL": "100.0 20 15 0.01",
    "RADIAL": "100.0 20 15 0.01 0.002",
    "OPENCV": "100.0 110.0 20 15 0.01 0.002 0.001 0.003",
}


@pytest.mark.parametrize("model", list(CAMERAS))
def test_colmap2nerf_converts_a_text_model_as_jax_does(tmp_path, rng, model):
    """cameras.txt + images.txt of three views -> transforms.json: the same
    dict in both packages (sharpness from the images on disk included), and
    the pure helpers agree."""
    text, images = tmp_path / "text", tmp_path / "images"
    text.mkdir()
    images.mkdir()
    (text / "cameras.txt").write_text(f"# camera\n1 {model} 40 30 {CAMERAS[model]}\n")
    lines = ["# images"]
    for k in range(3):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        tvec = rng.normal(size=3) + [0, 0, 4]
        lines += [f"{k + 1} {' '.join(map(str, q))} {' '.join(map(str, tvec))} 1 v{k}.png",
                  "10.0 12.0 -1"]
        _save(images / f"v{k}.png", 30, 40, rng, ch=3)
    (text / "images.txt").write_text("\n".join(lines) + "\n")
    got = tc2n.colmap2nerf(str(text), str(images), str(tmp_path / "port.json"))
    want = jc2n.colmap2nerf(str(text), str(images), str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    assert got == want and len(got["frames"]) == 3
    q = rng.normal(size=4)
    np.testing.assert_array_equal(tc2n.qvec2rotmat(q), jc2n.qvec2rotmat(q))
    lines = rng.normal(size=(4, 3))
    p_got, w_got = tc2n.closest_point_2_lines(*lines)
    p_want, w_want = jc2n.closest_point_2_lines(*lines)
    np.testing.assert_array_equal(p_got, p_want)
    assert w_got == w_want
    assert tc2n.sharpness(str(images / "v0.png")) == jc2n.sharpness(str(images / "v0.png"))


# each config reduced to a tiny run on a scene of its dataset's kind
TINY = dict(N_voxel_init=8**3, N_voxel_final=10**3, batch_size=64, nSamples=32,
            n_lamb_sigma=[2, 2, 2], n_lamb_sh=[2, 2, 2], data_dim_color=6, featureC=8,
            downsample_train=1.0)


@pytest.mark.parametrize("config", sorted(os.listdir("configs")))
def test_every_config_builds_a_run(tmp_path, rng, config):
    """Every config of configs/ parses, loads its dataset (in memory, or a
    tiny scene of its kind on disk), builds its field, statics and step in
    the port, and takes one finite step on the CPU."""
    path = f"configs/{config}"
    written = load_config(path)
    name = written.dataset_name
    over = dict(TINY, basedir=str(tmp_path / "log"))
    if written.model_name == "TensorCP":
        over.update(n_lamb_sigma=[2], n_lamb_sh=[2])
    scene = None
    if name == "blender":
        # Blender's split sizes, tracing only the views the config selects
        idxs = {"train": written.train_idxs, "test": written.test_idxs}
        scene = make_synthetic_scene_arrays(n_train=44, n_test=194, wh=(8, 8),
                                            views={k: v for k, v in idxs.items() if v} or None)
    elif name == "llff":
        # images_4 at a quarter of the camera's size, as the config reads them
        scene = make_forward_facing_scene(n_views=9, wh=(16, 12))
        over["downsample_train"] = 4.0
    else:
        over["datadir"] = str(tmp_path / "scene")
        if name == "human":
            # 16x16 images of an 800x800 camera
            human_scene(tmp_path / "scene", rng, n_train=44)
            over["downsample_train"] = 50.0
        else:
            os.makedirs(over["datadir"])
            SCENES[name](tmp_path / "scene", rng)
    cfg = load_config(path, over)
    state = TrainState(cfg, torch.device("cpu"), scene)
    assert state.ndc_ray == (name == "llff")
    step = make_train_step(state.field, build_statics(state), state.optimizer)
    gen = torch.Generator().manual_seed(0)
    metrics = step(state.aabb, state.rays, state.rgbs, 0, gen, state.alpha_mask,
                   ids=torch.randint(0, state.rays.shape[0], (cfg.batch_size,), generator=gen))
    assert np.isfinite(float(metrics["total_loss"]))
