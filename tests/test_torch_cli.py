"""The port's CLI dispatches as train.py does, and render-only renders the
views JAX's render-only renders.

Each dispatch branch of train.py:82-95 (the auto_resume supervisor, mesh
export from a checkpoint, render-only with and without a render flag,
training with and without a mesh export after it) runs through both
CLIs with the entry points replaced by recorders: the calls must be the
same.  On a 3-view test split and a config that selects test_idxs [0, 2],
render-only renders the whole split in both packages, with the same mean
PSNR (within 1e-4 dB), while training evaluates the selected views.
"""

import dataclasses
import re
from functools import partial
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import train as train_cli
from tensorf_tpu.config.frontends import load_config as j_load_config
from tensorf_tpu.data import dataset_dict as j_datasets
from tensorf_tpu.data.synthetic import make_synthetic_blender_scene
from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.train import loop as jloop
from tensorf_tpu.utils import ckpt as jckpt
from tensorf_tpu_torch import __main__ as cli
from tensorf_tpu_torch.config import load_config
from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
from tensorf_tpu_torch.train import loop as tloop

CONFIG = "configs/synth_sphere.txt"
BRANCHES = {
    "auto_resume": ["--auto_resume", "2"],
    "export_from_ckpt": ["--export_mesh", "1", "--ckpt", "x.npz"],
    "export_from_ckpt_path": ["--export_mesh", "1", "--ckpt_path", "x.npz"],
    "render_only": ["--render_only", "1", "--render_test", "1", "--ckpt", "x.npz"],
    "render_only_train_split": ["--render_only", "1", "--render_test", "0", "--render_train", "1",
                                "--ckpt", "x.npz"],
    "render_only_without_render_flag": ["--render_only", "1", "--render_test", "0"],
    "train_then_export": ["--export_mesh", "1"],
    "train": [],
}


def record_jax(monkeypatch, calls):
    monkeypatch.setattr(train_cli, "_supervise",
                        lambda argv, retries: calls.append(("supervise", retries)) or 0)
    monkeypatch.setattr(train_cli, "export_mesh", lambda cfg, ckpt_path=None: calls.append(
        ("export", ckpt_path or cfg.ckpt or cfg.ckpt_path)))
    monkeypatch.setattr(train_cli, "render_test", lambda cfg: calls.append(("render",)))
    monkeypatch.setattr(train_cli, "reconstruction",
                        lambda cfg: calls.append(("train",)) or "final.npz")


def record_port(monkeypatch, calls):
    monkeypatch.setattr(cli, "_supervise",
                        lambda argv, retries: calls.append(("supervise", retries)) or 0)

    def export(cfg, ckpt_path=None, device=None):
        calls.append(("export", ckpt_path or cfg.ckpt or cfg.ckpt_path))
        return SimpleNamespace(ply="x.ply", mesh=SimpleNamespace(verts=[], tris=[]), native=True,
                               alpha_ms=0.0, march_ms=0.0)

    monkeypatch.setattr(cli, "export_mesh", export)
    monkeypatch.setattr(cli, "render_test",
                        lambda cfg, scene, device, save_images: calls.append(("render",)) or [])
    monkeypatch.setattr(cli, "reconstruction", lambda cfg, scene, device, save_images: (
        calls.append(("train",)) or SimpleNamespace(final_path="final.npz", test_psnrs={},
                                                    final_psnrs=[], segments=[])))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_cli_dispatches_as_train_py(monkeypatch, capsys, branch):
    argv = ["--config", CONFIG, *BRANCHES[branch]]
    want, got = [], []
    record_jax(monkeypatch, want)
    try:
        train_cli.main(argv)
    except SystemExit as e:  # train.py exits with the supervisor's code
        assert e.code == 0 and branch == "auto_resume"
    record_port(monkeypatch, got)
    assert cli.main(argv) == 0
    assert got == want and want
    if branch == "train_then_export":
        assert want == [("train",), ("export", "final.npz")]
    if branch == "render_only_without_render_flag":
        assert want == [("train",)]


def test_render_only_renders_the_whole_test_split_as_jax(tmp_path, capsys):
    """F2: the port's render-only loaded the test split with the config's
    few-shot selection; JAX's renders all of it."""
    datadir = str(tmp_path / "scene")
    make_synthetic_blender_scene(datadir, n_train=2, n_test=3, wh=(16, 16), scene="sphere")
    scene = make_synthetic_scene_arrays(n_train=2, n_test=3, wh=(16, 16), scene="sphere")
    cfg_model = ModelConfig(model_name="TensorVMSplit", density_n_comp=(2, 2, 2),
                            app_n_comp=(2, 2, 2), app_dim=6, shading_mode="MLP_Fea", pos_pe=2,
                            view_pe=2, fea_pe=2, feature_c=16, density_shift=-3.0)
    params = FIELD_MODELS["TensorVMSplit"].init(jax.random.PRNGKey(0), cfg_model, (12, 12, 12))
    ckpt = str(tmp_path / "ck" / "tiny.npz")
    (tmp_path / "ck").mkdir()
    jckpt.save_checkpoint(ckpt, cfg_model, params, np.asarray([[-1.5] * 3, [1.5] * 3]),
                          (12, 12, 12))
    over = dict(datadir=datadir, test_idxs=[0, 2], ckpt=ckpt, render_only=1, render_test=1,
                downsample_train=1, basedir=str(tmp_path / "log"), N_voxel_init=12**3,
                n_lamb_sigma=[2, 2, 2], n_lamb_sh=[2, 2, 2], data_dim_color=6, featureC=16)
    port_cfg = load_config(CONFIG, over)
    assert port_cfg.resolved_test_images() == [0, 2]

    psnrs = tloop.render_test(port_cfg, scene, "cpu", save_images=False, log=lambda m: None)
    orig = j_datasets["blender"]
    j_datasets["blender"] = partial(orig, wh=(16, 16))
    try:
        capsys.readouterr()
        # op by op: the port's reference rounding (XLA's fused render moves
        # shading-threshold samples by float32 rounding)
        with jax.disable_jit():
            jloop.render_test(j_load_config(CONFIG, over))
    finally:
        j_datasets["blender"] = orig
    out = capsys.readouterr().out
    n_jax = len(list((tmp_path / "ck" / "imgs_test_all" / "prediction").iterdir()))
    assert len(psnrs) == n_jax == 3
    jax_psnr = float(re.search(r"test all psnr: ([0-9.eE+-]+)", out).group(1))
    assert abs(float(np.mean(psnrs)) - jax_psnr) <= 1e-4

    # training evaluates the selected views, in both packages
    state = tloop.TrainState(dataclasses.replace(port_cfg, ckpt=None, render_only=0),
                             torch.device("cpu"), scene)
    assert state.test_ds.all_rays.shape[0] == 2
