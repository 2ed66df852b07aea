"""Checkpoints cross between the port and tensorf_tpu both ways, and the
port's whole schedule runs end to end on the CPU.

A JAX ``save_checkpoint`` loads in the port's ``load_checkpoint`` and
renders what JAX renders from it; a port checkpoint loads in JAX's and
renders what the port renders (rtol/atol 1e-5).  The tiny reconstruction
fires every event within 10 steps on a 40x40 sphere scene; JAX loads its
final checkpoint, render-only re-renders its test PSNR, and a new run with
``ckpt_path`` starts from it.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.eval import metrics as jmetrics
from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models import alpha_mask as jam
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.utils import ckpt as jckpt
from tensorf_tpu_torch import __main__ as cli
from tensorf_tpu_torch.config import load_config
from tensorf_tpu_torch.convert import params_from_jax, params_to_jax
from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
from tensorf_tpu_torch.eval import metrics as tmetrics
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import TensorVMSplit
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.render import render_chunked
from tensorf_tpu_torch.train.loop import TrainState, reconstruction, render_test
from tensorf_tpu_torch.utils import ckpt as tckpt

FWD = dict(rtol=1e-5, atol=1e-5)
JM = FIELD_MODELS["TensorVMSplit"]
CFG = ModelConfig(
    model_name="TensorVMSplit", density_n_comp=(2, 3, 4), app_n_comp=(4, 3, 2), app_dim=6,
    shading_mode="MLP_Fea", pos_pe=2, view_pe=2, fea_pe=2, feature_c=16, density_shift=-3.0,
)
GRID = (10, 12, 14)
AABB = np.asarray([[-1.2, -1.3, -1.1], [1.3, 1.2, 1.25]], np.float32)
RENDER = dict(step_size=0.06, n_samples=70, white_bg=True, shade_top_k=16, fused=True)


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return np.concatenate([o, d], -1).astype(np.float32)


def _flat(params):
    out = {}
    jckpt._flatten("", params, out)
    return out


def _jax_render(cfg, params, mask, aabb, rays, **kw):
    out = j_render(JM, cfg, params, mask, jnp.asarray(rays), None, JMasks(),
                   aabb=jnp.asarray(aabb), is_train=False, ndc_ray=False, **kw)
    return np.asarray(out.rgb), np.asarray(out.depth)


def _port_render(field, mask, aabb, rays, **kw):
    rgb, depth, _, _ = render_chunked(field, mask, rays, torch.as_tensor(aabb), chunk=16, **kw)
    return rgb.numpy(), depth.numpy()


def _jax_state(rng):
    params = JM.init(jax.random.PRNGKey(5), CFG, GRID)
    vol = (rng.uniform(size=(9, 8, 7)) < 0.3).astype(np.float32)
    mask = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(AABB), volume=jnp.asarray(vol)))
    return params, mask


def _port_field(params):
    field = TensorVMSplit(TConfig(**dataclasses.asdict(CFG)), GRID, device="cpu")
    field.load_state_dict(params_from_jax(_flat(params)))
    return field


def test_params_to_jax_inverts_params_from_jax():
    params = JM.init(jax.random.PRNGKey(0), CFG, GRID)
    flat = _flat(params)
    back = params_to_jax(_port_field(params))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)


def test_jax_checkpoint_loads_and_renders_in_the_port(rng, tmp_path):
    params, mask = _jax_state(rng)
    path = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(path, CFG, params, AABB, GRID, mask, extra={"iteration": 3})
    cfg, field, aabb, grid, pmask, extra = tckpt.load_checkpoint(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(CFG)
    assert grid == GRID and field.grid_size == GRID and extra == {"iteration": 3}
    np.testing.assert_array_equal(aabb, AABB)
    np.testing.assert_array_equal(pmask.volume.numpy(), np.asarray(mask.volume))
    np.testing.assert_array_equal(pmask.dilated.numpy(), np.asarray(mask.dilated))
    rays = _rays(rng, 40)
    for got, want in zip(_port_render(field, pmask, aabb, rays, **RENDER),
                         _jax_render(CFG, params, mask, AABB, rays, **RENDER)):
        np.testing.assert_allclose(got, want, **FWD)


def test_port_checkpoint_loads_and_renders_in_jax(rng, tmp_path):
    params, mask = _jax_state(rng)
    field = _port_field(params)
    pmask = tam.unpack_mask(jam.pack_mask(mask))
    path = tckpt.save_checkpoint(str(tmp_path / "port"), field, AABB, pmask, extra={"n_samples": 70})
    assert path.endswith("port.npz") and not (tmp_path / "port.tmp.npz").exists()
    data = np.load(path)
    assert not [k for k in data.files if k.startswith(("opt/", "aux/"))]
    assert json.loads(bytes(data["kwargs"]).decode())["gridSize"] == list(GRID)
    cfg, jparams, aabb, grid, jmask, extra = jckpt.load_checkpoint(path)
    assert cfg == CFG and grid == GRID and extra == {"n_samples": 70}
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(np.asarray(v), _flat(params)[k])
    np.testing.assert_array_equal(np.asarray(jmask.volume), np.asarray(mask.volume))
    np.testing.assert_array_equal(np.asarray(jmask.aabb), np.asarray(mask.aabb))
    rays = _rays(rng, 40)
    for got, want in zip(_jax_render(cfg, jparams, jmask, aabb, rays, **RENDER),
                         _port_render(field, pmask, AABB, rays, **RENDER)):
        np.testing.assert_allclose(got, want, **FWD)


# every model with an MLP head, SH (27 = 3 x 9 features) and RGB (3)
CROSS_MODES = {"MLP": 6, "SH": 27, "RGB": 3}


@pytest.mark.parametrize("mode", list(CROSS_MODES))
@pytest.mark.parametrize("model", ["TensorVMSplit", "TensorCP", "TensorVM"])
def test_every_model_and_mode_crosses_both_ways(rng, tmp_path, model, mode):
    """A JAX checkpoint of each model and head loads in the port and renders
    what JAX renders; the port's checkpoint of that field loads in JAX with
    the same config and arrays (none under render/ for SH and RGB)."""
    ranks = (2, 3, 4) if model == "TensorVMSplit" else (3,)
    cfg = dataclasses.replace(CFG, model_name=model, shading_mode=mode,
                              app_dim=CROSS_MODES[mode], density_n_comp=ranks,
                              app_n_comp=ranks[::-1])
    params = FIELD_MODELS[model].init(jax.random.PRNGKey(6), cfg, GRID)
    vol = (rng.uniform(size=(9, 8, 7)) < 0.3).astype(np.float32)
    mask = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(AABB), volume=jnp.asarray(vol)))
    jpath = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(jpath, cfg, params, AABB, GRID, mask)
    tcfg, field, aabb, grid, pmask, _ = tckpt.load_checkpoint(jpath, device="cpu")
    assert type(field).__name__ == model and dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert grid == GRID == field.grid_size
    rays = _rays(rng, 24)
    out = j_render(FIELD_MODELS[model], cfg, params, mask, jnp.asarray(rays), None, JMasks(),
                   aabb=jnp.asarray(AABB), is_train=False, ndc_ray=False, **RENDER)
    for got, want in zip(_port_render(field, pmask, aabb, rays, **RENDER),
                         (np.asarray(out.rgb), np.asarray(out.depth))):
        np.testing.assert_allclose(got, want, **FWD)

    ppath = tckpt.save_checkpoint(str(tmp_path / "port"), field, aabb, pmask)
    assert bool([k for k in np.load(ppath).files if k.startswith("params/render/")]) == (mode == "MLP")
    cfg2, jparams, aabb2, grid2, jmask, _ = jckpt.load_checkpoint(ppath)
    assert cfg2 == cfg and grid2 == GRID
    np.testing.assert_array_equal(aabb2, AABB)
    np.testing.assert_array_equal(np.asarray(jmask.volume), vol)
    want = _flat(params)
    got = _flat(jparams)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_metrics_match_jax(rng):
    a = rng.uniform(size=(20, 24, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    assert tmetrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert tmetrics.rgb_ssim(a, b, 1) == jmetrics.rgb_ssim(a, b, 1)
    assert tmetrics.rgb_lpips(a, b) is None


TINY = dict(
    stratify=0, n_iters=10, N_voxel_init=10**3, N_voxel_final=16**3,
    upsamp_list=[3, 6], update_AlphaMask_list=[4, 7], batch_size=256, downsample_train=1,
    vis_every=5, save_ckpt_every=[5], progress_refresh_rate=5, seed=3,
)


def test_tiny_reconstruction_end_to_end(tmp_path):
    """Every event within 10 steps on a 40x40 sphere; the final checkpoint
    loads in JAX and renders what the port renders, and the render-only
    entry (here through the CLI) re-renders the final test PSNR."""
    cfg = load_config("configs/synth_sphere.txt", dict(TINY, basedir=str(tmp_path)))
    scene = make_synthetic_scene_arrays(n_train=4, n_test=1, wh=(40, 40), scene="sphere")
    logs = []
    res = reconstruction(cfg, scene, "cpu", save_images=True, log=logs.append)
    assert len(res.total_loss) == 10 and np.all(np.isfinite(res.total_loss))
    assert [e["event"] for e in res.events] == ["upsample", "alpha_mask", "upsample", "alpha_mask"]
    assert res.events[1].get("shrink_grid") and res.events[3].get("refiltered")
    assert res.events[-2]["grid"] == res.state.geometry.grid_size
    assert [s["start"] for s in res.segments] == [1, 4, 5, 7, 8]
    assert sorted(res.test_psnrs) == [5] and len(res.final_psnrs) == 1
    assert res.state.l1_weight == cfg.L1_weight_rest
    (folder,) = tmp_path.glob("*/synth_sphere")  # basedir/<date>/expname
    assert (folder / "0k_synth_sphere.npz").exists()  # save_ckpt_every [5]
    assert (folder / "imgs_test_all" / "prediction" / "000.png").exists()
    assert np.loadtxt(folder / "imgs_test_all" / "mean.txt").shape == (4,)

    # JAX loads the final checkpoint and renders what the port renders
    mcfg, jparams, aabb, grid, jmask, extra = jckpt.load_checkpoint(res.final_path)
    assert grid == res.state.geometry.grid_size and extra["iteration"] == 9
    np.testing.assert_array_equal(aabb, res.state.geometry.aabb_np)
    rays = res.state.test_ds.all_rays[0][::7]
    kw = dict(step_size=res.state.geometry.step_size, n_samples=res.state.n_samples,
              white_bg=True, shade_top_k=None, fused=True)
    for got, want in zip(_port_render(res.state.field, res.state.alpha_mask, aabb, rays, **kw),
                         _jax_render(mcfg, jparams, jmask, aabb, rays, **kw)):
        np.testing.assert_allclose(got, want, **FWD)

    psnrs = render_test(dataclasses.replace(cfg, ckpt=res.final_path), scene, "cpu",
                        save_images=False, log=logs.append)
    assert abs(np.mean(psnrs) - np.mean(res.final_psnrs)) <= 1e-4
    argv = ["--config", "configs/synth_sphere.txt", "--render_only", "1", "--render_test", "1",
            "--stratify", "0", "--downsample_train", "1", "--device",
            "cpu", "--synthetic", "--synthetic_scene", "sphere", "--synthetic_views", "4,1",
            "--synthetic_wh", "40", "--save_images", "0", "--ckpt", res.final_path]
    assert cli.main(argv) == 0

    # a run with ckpt_path starts from the checkpoint's field, grid, aabb and mask
    start = TrainState(dataclasses.replace(cfg, ckpt_path=res.final_path), torch.device("cpu"), scene)
    assert start.geometry.grid_size == res.state.geometry.grid_size
    np.testing.assert_array_equal(start.geometry.aabb_np, res.state.geometry.aabb_np)
    np.testing.assert_array_equal(start.alpha_mask.volume.numpy(), res.state.alpha_mask.volume.numpy())
    for k, v in params_to_jax(start.field).items():
        np.testing.assert_array_equal(v, params_to_jax(res.state.field)[k])


def test_schedule_refuses_what_is_not_ported(tmp_path):
    """Nothing of the schedule is refused any more: the bf16 dtypes, the
    last refusal, run their whole schedule (tests/test_torch_bf16.py pins
    them against JAX); a dtype the port does not know is refused."""
    cfg = load_config("configs/synth_sphere.txt", dict(TINY, basedir=str(tmp_path)))
    scene = make_synthetic_scene_arrays(n_train=2, n_test=1, wh=(16, 16), scene="sphere")
    for knob in ("compute_dtype", "grid_dtype", "line_dtype"):
        res = reconstruction(dataclasses.replace(cfg, **{knob: "bfloat16"}), scene, "cpu",
                             save_images=False)
        assert np.all(np.isfinite(res.total_loss)) and np.all(np.isfinite(res.final_psnrs))
        with pytest.raises(ValueError, match="unknown dtype"):
            reconstruction(dataclasses.replace(cfg, **{knob: "float16"}), scene, "cpu")
