"""Reference ``.th`` checkpoints in the port (tensorf_tpu_torch/utils/
import_torch.py) against tensorf_tpu/utils/import_torch.py.

The reference's own models are not needed: each test builds a state dict
in the reference's layout in memory (planes (1, R, H, W), lines (1, R, L, 1),
``basis_mat.weight`` (out, in), ``renderModule.mlp.{0,2,4}``, the legacy
TensorVM's stacked ``plane_coef``/``line_coef``), the reference's
``get_kwargs`` dict and its bit-packed alpha mask, from a numpy seed, and
writes them with ``torch.save`` as the reference's TensorBase.save does
(models/tensorBase.py:160-168).  Both packages load the file: the configs,
the arrays and the mask are equal, a CPU render of the same rays agrees
within rtol/atol 1e-5 (depth 1e-4), and render-only through the port's CLI
reads the same PSNR from the ``.th`` as from its converted ``.npz``.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.models import FIELD_MODELS
from tensorf_tpu.models.shading import mlp_in_dim
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu.utils.ckpt import load_checkpoint as j_load_checkpoint
from tensorf_tpu.utils.import_torch import load_reference_checkpoint as j_load_th
from tensorf_tpu_torch import __main__ as cli
from tensorf_tpu_torch.convert import params_to_jax
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.render import render_rays as t_render
from tensorf_tpu_torch.utils.ckpt import load_aux, load_checkpoint, load_opt_leaves
from tensorf_tpu_torch.utils.import_torch import _near_far, convert, infer_model_name

FWD = dict(rtol=1e-5, atol=1e-5)
GRID = [8, 10, 12]  # non-cubic: an axis-order mistake cannot hide
AABB = [[-1.5, -1.2, -1.0], [1.5, 1.2, 1.0]]
MAT_MODE = [[0, 1], [0, 2], [1, 2]]
VEC_MODE = [2, 1, 0]
KWARGS = dict(density_shift=-3.0, alphaMask_thres=1e-4, distance_scale=25.0,
              rayMarch_weight_thres=1e-4, fea2denseAct="softplus", step_ratio=0.5, pos_pe=2,
              view_pe=2, fea_pe=2, featureC=16)
# (model, shading mode, alpha mask): every model, every head with
# parameters, with and without a mask
CASES = [
    ("TensorVMSplit", "MLP_Fea", True),
    ("TensorVMSplit", "MLP_PE", False),
    ("TensorVMSplit", "MLP", True),
    ("TensorCP", "MLP", True),
    ("TensorCP", "SH", False),
    ("TensorVM", "MLP_Fea", False),
    ("TensorVM", "RGB", True),
]


def _reference_th(path, model, mode, with_mask, seed=0):
    """A reference checkpoint of ``model`` with ``mode`` shading, drawn
    from ``seed``: torch.save({kwargs, state_dict, alphaMask.*})."""
    rng = np.random.default_rng(seed)

    def tensor(*shape, scale=0.3):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    app_dim = {"SH": 27, "RGB": 3}.get(mode, 6)
    sd = {}
    if model == "TensorVMSplit":
        den, app, grid = [2, 3, 4], [4, 3, 2], list(GRID)
        for name, ranks in (("density", den), ("app", app)):
            for i in range(3):
                m0, m1 = MAT_MODE[i]
                sd[f"{name}_plane.{i}"] = tensor(1, ranks[i], grid[m1], grid[m0])
                sd[f"{name}_line.{i}"] = tensor(1, ranks[i], grid[VEC_MODE[i]], 1)
        sd["basis_mat.weight"] = tensor(app_dim, sum(app))
    elif model == "TensorCP":
        den, app, grid = [5, 5, 5], [7, 7, 7], list(GRID)
        for name, r in (("density", den[0]), ("app", app[0])):
            for i in range(3):
                sd[f"{name}_line.{i}"] = tensor(1, r, grid[VEC_MODE[i]], 1)
        sd["basis_mat.weight"] = tensor(app_dim, app[0])
    else:  # the legacy TensorVM: int ranks, one cubic resolution
        den, app, grid = 3, 4, [8, 8, 8]
        sd["plane_coef"] = tensor(3, app + den, 8, 8)
        sd["line_coef"] = tensor(3, app + den, 8, 1)
        sd["basis_mat.weight"] = tensor(app_dim, 3 * app)
    kwargs = dict(KWARGS, aabb=torch.tensor(AABB), gridSize=grid, density_n_comp=den,
                  appearance_n_comp=app, app_dim=app_dim, shadingMode=mode,
                  # the reference's TensorCP writes its device into near_far
                  near_far="cpu" if model == "TensorCP" else [2.0, 6.0])
    if mode.startswith("MLP"):
        from tensorf_tpu.models import ModelConfig

        c = 16
        d_in = mlp_in_dim(ModelConfig(shading_mode=mode, app_dim=app_dim, pos_pe=2, view_pe=2,
                                      fea_pe=2))
        for slot, (o, i) in zip((0, 2, 4), ((c, d_in), (c, c), (3, c))):
            sd[f"renderModule.mlp.{slot}.weight"] = tensor(o, i)
            sd[f"renderModule.mlp.{slot}.bias"] = tensor(o, scale=0.1)
    ckpt = {"kwargs": kwargs, "state_dict": sd}
    vol = None
    if with_mask:
        vol = rng.uniform(size=(5, 6, 7)) > 0.4
        ckpt["alphaMask.shape"] = (1, 1, 5, 6, 7)
        ckpt["alphaMask.mask"] = np.packbits(vol.reshape(-1))
        ckpt["alphaMask.aabb"] = torch.tensor(AABB)
    torch.save(ckpt, path)
    return vol


def _flat(tree):
    out = {}
    _flatten("", tree, out)
    return out


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return np.concatenate([o, d], -1).astype(np.float32)


@pytest.mark.parametrize("model,mode,with_mask", CASES,
                         ids=[f"{m}-{s}-{'mask' if k else 'nomask'}" for m, s, k in CASES])
def test_th_loads_as_in_jax_and_renders_alike(tmp_path, rng, model, mode, with_mask):
    path = str(tmp_path / f"{model}.th")
    vol = _reference_th(path, model, mode, with_mask)
    j_cfg, j_params, j_aabb, j_grid, j_mask, j_extra = j_load_th(path)
    cfg, field, aabb, grid, mask, extra = load_checkpoint(path, "cpu")
    assert cfg.model_name == model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert tuple(grid) == tuple(j_grid) == tuple(field.grid_size)
    assert extra is None and j_extra is None
    np.testing.assert_array_equal(aabb, j_aabb)
    want = _flat(j_params)
    got = params_to_jax(field)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    assert (mask is None) == (j_mask is None) == (not with_mask)
    if with_mask:
        np.testing.assert_array_equal(mask.volume.numpy(), np.asarray(j_mask.volume))
        np.testing.assert_array_equal(mask.volume.numpy(), vol.astype(np.float32))
        np.testing.assert_array_equal(mask.aabb.numpy(), np.asarray(j_mask.aabb))
    assert load_opt_leaves(path) is None and load_aux(path) == {}

    rays = _rays(rng, 32)
    kw = dict(step_size=0.06, n_samples=64, is_train=False, white_bg=True, ndc_ray=False)
    want_r = j_render(FIELD_MODELS[model], j_cfg, j_params, j_mask, jnp.asarray(rays), None,
                      JMasks(), aabb=jnp.asarray(j_aabb), **kw)
    with torch.no_grad():
        got_r = t_render(field, torch.from_numpy(rays), TMasks(), aabb=torch.from_numpy(aabb),
                         alpha_mask=mask, **kw)
    np.testing.assert_allclose(got_r.rgb.numpy(), np.asarray(want_r.rgb), **FWD)
    np.testing.assert_allclose(got_r.depth.numpy(), np.asarray(want_r.depth), rtol=1e-4,
                               atol=1e-4)

    # the converted .npz: the same field, and JAX reads it as it reads the .th
    npz = convert(path, str(tmp_path / "converted"))
    assert npz.endswith(".npz")
    _, again, _, _, mask2, _ = load_checkpoint(npz, "cpu")
    for k, v in params_to_jax(again).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    j_again = _flat(j_load_checkpoint(npz)[1])
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(j_again[k]), v, err_msg=k)
    if with_mask:
        np.testing.assert_array_equal(mask2.volume.numpy(), mask.volume.numpy())


def test_near_far_fallback():
    """A non-numeric near_far (the reference TensorCP's device in its slot)
    falls back to (2, 6), as in JAX; numbers round-trip."""
    assert _near_far({"near_far": "cpu"}) == (2.0, 6.0)
    assert _near_far({"near_far": "cuda"}) == (2.0, 6.0)
    assert _near_far({"near_far": [0.5, 7.5]}) == (0.5, 7.5)
    assert _near_far({"near_far": torch.tensor([1.0, 3.0])}) == (1.0, 3.0)
    with pytest.raises(ValueError, match="unrecognized"):
        infer_model_name(["basis_mat.weight"])


def test_cli_render_only_reads_th_as_its_npz(tmp_path, capsys):
    """--ckpt x.th through the port's CLI: render-only gives the PSNR of the
    converted .npz's render-only; mesh export reads it too."""
    path = str(tmp_path / "ref.th")
    _reference_th(path, "TensorVMSplit", "MLP_Fea", True, seed=3)
    npz = convert(path, str(tmp_path / "ref.npz"))
    base = ["--config", "configs/synth_sphere.txt", "--device", "cpu", "--synthetic",
            "--synthetic_scene", "sphere", "--synthetic_wh", "24", "--synthetic_views", "2,2", "--downsample_train", "1",
            "--save_images", "0", "--basedir", str(tmp_path)]
    psnrs = []
    for ckpt in (path, npz):
        assert cli.main(base + ["--render_only", "1", "--render_test", "1", "--ckpt", ckpt]) == 0
        psnrs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1])["test_psnr"])
    assert np.isfinite(psnrs[0]) and psnrs[0] == psnrs[1]
    assert cli.main(base + ["--export_mesh", "1", "--ckpt", path]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["ply"].endswith(".ply")
