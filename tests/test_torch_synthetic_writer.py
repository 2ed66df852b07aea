"""The port's on-disk scene writer (tensorf_tpu_torch/data/synthetic.py::
make_synthetic_blender_scene) against the JAX package's
(tensorf_tpu/data/synthetic.py::make_synthetic_blender_scene) at 16x16:
the same file tree, equal ``transforms_{train,test}.json`` (the poses to
float32 tolerance, every other field exactly) and equal decoded PNG pixels.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from tensorf_tpu.data.synthetic import make_synthetic_blender_scene as jax_writer
from tensorf_tpu_torch.data.synthetic import make_synthetic_blender_scene as port_writer


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("scene", ["sphere", "composite"])
def test_writer_matches_jax(tmp_path, scene):
    kw = dict(n_train=3, n_test=2, wh=(16, 16), seed=5, scene=scene)
    want_root = jax_writer(str(tmp_path / "jax"), **kw)
    got_root = port_writer(str(tmp_path / "port"), **kw)
    assert got_root == str(tmp_path / "port")
    assert _tree(got_root) == _tree(want_root)
    for split in ("train", "test"):
        with open(os.path.join(want_root, f"transforms_{split}.json")) as f:
            want = json.load(f)
        with open(os.path.join(got_root, f"transforms_{split}.json")) as f:
            got = json.load(f)
        assert got["camera_angle_x"] == want["camera_angle_x"]
        assert len(got["frames"]) == len(want["frames"]) == kw[f"n_{split}"]
        for g, w in zip(got["frames"], want["frames"]):
            assert set(g) == set(w) == {"file_path", "transform_matrix"}
            assert g["file_path"] == w["file_path"]
            np.testing.assert_allclose(np.asarray(g["transform_matrix"], np.float32),
                                       np.asarray(w["transform_matrix"], np.float32),
                                       rtol=1e-6, atol=1e-6)
            png = w["file_path"] + ".png"
            want_px = np.asarray(Image.open(os.path.join(want_root, png)))
            got_px = np.asarray(Image.open(os.path.join(got_root, png)))
            assert got_px.shape == want_px.shape == (16, 16, 4)
            np.testing.assert_array_equal(got_px, want_px)
