"""Mesh export in the port against tensorf_tpu's.

The same seeded numpy alpha grid goes through both packages' iso-surface
extraction, on the native library and on the numpy version: the vertices
and triangles must be equal exactly, and the .ply files byte for byte.  On
a tiny TensorVMSplit checkpoint (a Gaussian density blob and an alpha
mask), ``export_mesh`` of both packages must give alpha grids within 1e-5
(rtol and atol), the same vertex and face counts, and vertices within
1e-4.  The CLI's mesh export writes the .ply and trains nothing.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorf_tpu.config.schema import TrainConfig as JConfig
from tensorf_tpu.eval import mesh as jmesh
from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models import alpha_mask as jam
from tensorf_tpu.models.config import GridGeometry
from tensorf_tpu.render import culling as jcull
from tensorf_tpu.train import loop as jloop
from tensorf_tpu.utils import ckpt as jckpt
from tensorf_tpu_torch.config import TrainConfig
from tensorf_tpu_torch.eval import mesh as tmesh
from tensorf_tpu_torch.render import culling as tcull
from tensorf_tpu_torch.train import loop as tloop
from tensorf_tpu_torch.utils import ckpt as tckpt
from tensorf_tpu_torch.utils.cuda_build import BUILD_DIR

ROOT = Path(__file__).resolve().parents[1]
JM = FIELD_MODELS["TensorVMSplit"]
CFG = ModelConfig(
    model_name="TensorVMSplit", density_n_comp=(2, 3, 4), app_n_comp=(4, 3, 2), app_dim=6,
    shading_mode="MLP_Fea", pos_pe=2, view_pe=2, fea_pe=2, feature_c=16, density_shift=-10.0,
)
GRID = (18, 16, 17)
AABB = np.asarray([[-1.5, -1.4, -1.3], [1.4, 1.5, 1.6]], np.float32)


def blob_grid(rng, shape=(17, 19, 21)):
    """A noisy sphere of alpha: a closed surface at level 0.005 with many
    cells of every crossing kind."""
    axes = [np.linspace(-1, 1, n) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(x**2 + y**2 + z**2) + 0.05 * rng.normal(size=shape)
    return (0.01 * np.exp(-3.0 * (r - 0.3))).astype(np.float32)


def read_ply(path):
    """(verts (V, 3) float32, tris (T, 3) int32) of a binary .ply of
    write_ply's layout."""
    data = Path(path).read_bytes()
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    nv = int(next(s for s in lines if s.startswith("element vertex")).split()[-1])
    nt = int(next(s for s in lines if s.startswith("element face")).split()[-1])
    verts = np.frombuffer(body[: nv * 12], "<f4").reshape(nv, 3)
    faces = np.frombuffer(body[nv * 12:], np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
    assert len(faces) == nt and np.all(faces["n"] == 3)
    return verts, faces["idx"]


@pytest.mark.parametrize("level", [0.005, 0.008])
def test_marching_matches_jax_on_both_paths(rng, level):
    grid = blob_grid(rng)
    assert tmesh.native_available() and jmesh._load_native() is not None
    # the port's library is its own build of csrc/marching.cpp, never the
    # JAX package's tensorf_tpu/native/libmarching.so
    assert os.path.dirname(tmesh._load_native()._name) == str(BUILD_DIR)
    got, want = tmesh.marching_iso_surface(grid, level), jmesh.marching_iso_surface(grid, level)
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = tmesh._marching_tetrahedra_numpy(grid, level)
    want = jmesh._marching_tetrahedra_numpy(grid, level)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the two paths number the vertices differently but build one surface
    native = tmesh.marching_iso_surface(grid, level)
    assert len(native[0]) == len(got[0]) and len(native[1]) == len(got[1])
    np.testing.assert_array_equal(np.unique(np.round(native[0], 9), axis=0),
                                  np.unique(np.round(got[0], 9), axis=0))


def test_marching_of_an_uncrossed_grid_is_empty():
    grid = np.zeros((4, 5, 6), np.float32)
    for fn in (tmesh.marching_iso_surface, tmesh._marching_tetrahedra_numpy):
        verts, tris = fn(grid, 0.005)
        assert verts.shape == (0, 3) and tris.shape == (0, 3)


def test_ply_bytes_match_jax(rng, tmp_path):
    grid = blob_grid(rng, (13, 11, 12))
    bbox = np.asarray([[-1.2, -1.0, -0.9], [1.1, 1.3, 1.0]], np.float32)
    mesh = tmesh.convert_alpha_samples_to_ply(grid, str(tmp_path / "port.ply"), bbox, level=0.005)
    jmesh.convert_alpha_samples_to_ply(grid, str(tmp_path / "jax.ply"), bbox, level=0.005)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    verts, tris = read_ply(tmp_path / "port.ply")
    np.testing.assert_array_equal(verts, mesh.verts.astype(np.float32))
    np.testing.assert_array_equal(tris, mesh.tris)


def tiny_checkpoint(tmp_path):
    """A JAX-written TensorVMSplit checkpoint whose density is a Gaussian
    blob, with an alpha mask that cuts a corner off it."""
    params = JM.init(jax.random.PRNGKey(0), CFG, GRID)
    axes = [np.linspace(AABB[0, i], AABB[1, i], g) for i, g in enumerate(GRID)]

    def bump(axis, c):
        return np.exp(-((axes[axis] - c) ** 2) / (2 * 0.45**2))

    planes, lines = [], []
    for i, ((m0, m1), v) in enumerate(zip(((0, 1), (0, 2), (1, 2)), (2, 1, 0))):
        r = CFG.density_n_comp[i]
        plane = 3.0 * bump(m1, 0.1)[:, None] * bump(m0, -0.1)[None, :]
        planes.append(jnp.asarray(np.repeat(plane[..., None], r, -1), jnp.float32))
        lines.append(jnp.asarray(np.repeat(bump(v, 0.05)[:, None], r, -1), jnp.float32))
    params = {**params, "density_plane": tuple(planes), "density_line": tuple(lines)}
    vol = np.ones((9, 8, 7), np.float32)
    vol[:3, :3, :3] = 0.0
    mask = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(AABB), volume=jnp.asarray(vol)))
    path = str(tmp_path / "jax" / "tiny.npz")
    os.makedirs(os.path.dirname(path))
    jckpt.save_checkpoint(path, CFG, params, AABB, GRID, mask)
    return path, params, mask


def test_export_mesh_matches_jax(tmp_path):
    path, params, mask = tiny_checkpoint(tmp_path)
    port_path = str(tmp_path / "port" / "tiny.npz")
    os.makedirs(os.path.dirname(port_path))
    shutil.copy(path, port_path)

    geometry = GridGeometry.create(AABB, GRID, CFG.step_ratio)
    want_alpha, _ = jcull.compute_alpha_grid(JM, CFG, params, mask, geometry.aabb_np,
                                             geometry.grid_size, geometry.step_size)
    _, field, aabb, grid, tmask, _ = tckpt.load_checkpoint(port_path, "cpu")
    got_alpha, _ = tcull.compute_alpha_grid(field, tmask, aabb, grid, geometry.step_size)
    np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha), rtol=1e-5, atol=1e-5)

    want_ply = jloop.export_mesh(JConfig(), path)
    got = tloop.export_mesh(TrainConfig(), port_path, device="cpu", log=lambda m: None)
    assert got.ply == port_path[:-4] + ".ply" and want_ply == path[:-4] + ".ply"
    assert got.native
    want_v, want_t = read_ply(want_ply)
    got_v, got_t = read_ply(got.ply)
    assert len(got_v) == len(want_v) > 100 and len(got_t) == len(want_t)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-4)


def test_cli_exports_a_checkpoint_and_trains_nothing(tmp_path):
    path, _, _ = tiny_checkpoint(tmp_path)
    folder = os.path.dirname(path)
    before = set(os.listdir(folder))
    proc = subprocess.run(
        [sys.executable, "-m", "tensorf_tpu_torch", "--config", "configs/synth_sphere.txt",
         "--export_mesh", "1", "--ckpt", path, "--device", "cpu",
         "--basedir", str(tmp_path / "log")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ply"] == path[:-4] + ".ply" and out["native"] is True
    verts, tris = read_ply(out["ply"])
    assert out["verts"] == len(verts) > 100 and out["faces"] == len(tris)
    assert set(os.listdir(folder)) - before == {"tiny.ply"}  # no new checkpoint
    assert not (tmp_path / "log").exists()  # no run, no logfolder
    assert "Iteration" not in proc.stdout and "stratified" not in proc.stdout
