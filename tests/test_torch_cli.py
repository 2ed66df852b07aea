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
import json
import re
import shutil
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
from tensorf_tpu_torch.utils import ckpt as tckpt

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


# configs/lego.txt cut to a tiny run: every event within 10 steps, small
# widths, a 16x16 scene with the views its train_idxs and test_idxs reach
LEGO_TINY = dict(n_iters=10, N_voxel_init=10**3, N_voxel_final=16**3, upsamp_list=[3, 6],
                 update_AlphaMask_list=[4, 7], batch_size=256, downsample_train=1,
                 n_lamb_sigma=[3], n_lamb_sh=[4], featureC=16, vis_every=5,
                 save_ckpt_every=[5], progress_refresh_rate=5, seed=3, render_test=1)
LEGO_VIEWS = dict(n_train=43, n_test=193, wh=(16, 16), scene="composite")


def _flags(over):
    return [a for k, v in over.items()
            for a in (f"--{k}", str(v).replace(" ", "") if isinstance(v, list) else str(v))]


def _selected_test_split(src, dst, idxs):
    """A copy of the scene directory whose test split holds only the views
    ``idxs`` selects, in order: what a training run's evaluation renders,
    and render-only renders the whole split."""
    shutil.copytree(src, dst)
    meta = json.loads((dst / "transforms_test.json").read_text())
    meta["frames"] = [meta["frames"][i] for i in idxs]
    (dst / "transforms_test.json").write_text(json.dumps(meta))


def test_lego_txt_runs_through_both_clis(tmp_path, capsys, monkeypatch):
    """configs/lego.txt (TensorCP, MLP shading) trains through both CLIs on
    the same scene; the port's run evaluates, checkpoints and exports a
    mesh, and its final checkpoint re-renders the final PSNR of the
    selected test views (1e-4); JAX, op by op, renders it as the port does
    (1e-4, on the first 3 of those views)."""
    datadir = tmp_path / "scene"
    make_synthetic_blender_scene(str(datadir), **LEGO_VIEWS)
    flags = _flags(LEGO_TINY)
    for datasets in (j_datasets, tloop.dataset_dict):  # both loaders default to 800x800
        monkeypatch.setitem(datasets, "blender", partial(datasets["blender"], wh=(16, 16)))
    capsys.readouterr()
    train_cli.main(["--config", "configs/lego.txt", *flags, "--datadir", str(datadir),
                    "--basedir", str(tmp_path / "jax")])
    out = capsys.readouterr().out
    assert re.search(r"test all psnr: [0-9.]+", out), out[-2000:]
    (jax_ckpt,) = (tmp_path / "jax").glob("*/free_lego_882_27/final_free_lego_882_27.npz")
    assert jckpt.load_checkpoint(str(jax_ckpt))[0].model_name == "TensorCP"

    assert cli.main(["--config", "configs/lego.txt", *flags, "--basedir", str(tmp_path / "port"),
                     "--synthetic", "--synthetic_wh", "16", "--synthetic_views", "43,193",
                     "--device", "cpu", "--save_images", "0", "--export_mesh", "1"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    trained, mesh = lines[-2], lines[-1]
    ckpt = trained["final_ckpt"]
    assert ckpt.endswith("final_free_lego_882_27.npz") and mesh["ply"].endswith(".ply")
    assert sorted(int(k) for k in trained["test_psnrs"]) == [5]
    cfg, field, *_ = tckpt.load_checkpoint(ckpt, device="cpu")
    assert (cfg.model_name, cfg.shading_mode, field.grid_size) == (
        "TensorCP", "MLP", tuple(jckpt.load_checkpoint(ckpt)[3]))

    test_idxs = load_config("configs/lego.txt").test_idxs

    def render_only(name, idxs, *extra):
        _selected_test_split(datadir, tmp_path / name, idxs)
        return ["--config", "configs/lego.txt", *flags, "--datadir", str(tmp_path / name),
                "--render_only", "1", "--render_test", "1", "--ckpt", ckpt, *extra]

    port_only = ["--device", "cpu", "--save_images", "0"]
    assert cli.main(render_only("selected", test_idxs, *port_only)) == 0
    reloaded = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["test_psnr"]
    assert abs(reloaded - trained["final_test_psnr"]) <= 1e-4
    # JAX, op by op, on the first 3 of those views, against the port's render
    assert cli.main(render_only("first3", test_idxs[:3], *port_only)) == 0
    port_psnr = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["test_psnr"]
    with jax.disable_jit():
        train_cli.main(render_only("first3_jax", test_idxs[:3], "--basedir",
                                   str(tmp_path / "jax")))
    jax_psnr = float(re.search(r"test all psnr: ([0-9.eE+-]+)", capsys.readouterr().out).group(1))
    assert abs(jax_psnr - port_psnr) <= 1e-4


def test_a_config_without_shading_mode_runs_mlp_pe(tmp_path, capsys):
    """The schema's default head, MLP_PE, in both packages: a txt config
    that names no shadingMode trains in the port."""
    text = "".join(line for line in open("configs/lego.txt") if not line.startswith("shadingMode"))
    config = tmp_path / "no_mode.txt"
    config.write_text(text)
    modes = (load_config(str(config)).shadingMode, j_load_config(str(config)).shadingMode)
    assert modes == ("MLP_PE", "MLP_PE")
    argv = ["--config", str(config), *_flags(LEGO_TINY), "--basedir", str(tmp_path),
            "--synthetic", "--synthetic_wh", "16", "--synthetic_views", "43,193", "--device",
            "cpu", "--save_images", "0", "--n_steps", "3"]
    assert cli.main(argv) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len([row["first_loss"], row["last_loss"]]) == 2 and np.isfinite(row["test_psnr"])
