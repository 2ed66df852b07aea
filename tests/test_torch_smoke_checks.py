"""chip_smoke.py's render comparison (``same_render``), run on the CPU.

A budgeted or stratified render keeps the unbudgeted render's samples but
sums their weights in another float32 order, so a shading decision on its
edge can fall either way.  ``same_render`` holds depth to 1e-4 on every ray
and rgb to 1e-5 on every ray but those with a shading decision within
FLIP_MARGIN of flipping, which may move by up to that decision's weight.
Here a small field's unbudgeted render is compared with copies of itself
moved on purpose; the weight threshold is set onto one ray's top-K weight
to make a decision that sits exactly on its edge.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from tensorf_tpu_torch.eval.evaluation import RendererHandle
from tensorf_tpu_torch.models import ModelConfig, TensorVMSplit
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.ops.freq_mask import FreeMasks
from tensorf_tpu_torch.render.volume import render_rays

AABB = torch.tensor([[-1.5] * 3, [1.5] * 3])
TOP_K = 16
# the ray whose (TOP_K // 2 + 1)-th largest weight becomes the threshold
EDGE_RAY = 7


def _ball_mask():
    """An alpha mask over AABB occupied inside a ball of radius 0.9."""
    g = (np.arange(10) + 0.5) * 0.3 - 1.5
    ball = np.linalg.norm(np.stack(np.meshgrid(g, g, g, indexing="ij")), axis=0) < 0.9
    return tam.with_dilation(tam.AlphaGridMask(aabb=AABB, volume=torch.from_numpy(
        ball.astype(np.float32))))


@pytest.fixture(scope="module")
def scene():
    """(handle whose threshold sits on a top-K weight of ray EDGE_RAY,
    rays, unbudgeted rgb, depth)."""
    torch.manual_seed(0)
    cfg = ModelConfig(model_name="TensorVMSplit", density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6),
                      app_dim=9, shading_mode="MLP_Fea", pos_pe=2, view_pe=2, fea_pe=2,
                      feature_c=32, density_shift=-3.0)
    field = TensorVMSplit(cfg, (12, 12, 12), device="cpu")
    mask = _ball_mask()
    rng = np.random.default_rng(0)
    o = rng.normal(size=(300, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(300, 3))
    rays = torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))
    with torch.no_grad():
        w = render_rays(field, rays, FreeMasks(), aabb=AABB, step_size=0.05, n_samples=128,
                        is_train=False, white_bg=True, shade_top_k=TOP_K, alpha_mask=mask,
                        u=None).weights
    field.cfg = dataclasses.replace(cfg, ray_march_weight_thres=float(
        torch.sort(w[EDGE_RAY], descending=True).values[TOP_K // 2]))
    handle = RendererHandle(field=field, alpha_mask=mask, aabb=AABB, step_size=0.05,
                            n_samples=128, white_bg=True, shade_top_k=TOP_K)
    rgb, depth, _ = handle.render(rays, chunk=64)
    return handle, rays, rgb, depth


def _moved(scene):
    handle, rays, _, _ = scene
    return chip_smoke.shading_decisions(torch, np, handle, rays)


# (ray, rgb move as a multiple of the ray's flippable weight, absolute rgb
# move, depth move, passes)
CASES = {
    "identical": (None, 0.0, 0.0, 0.0, True),
    "rgb_within_1e-5": (3, 0.0, 5e-6, 0.0, True),
    "rgb_no_decision_near": ("far", 0.0, 1e-3, 0.0, False),
    "depth": (3, 0.0, 0.0, 1e-2, False),
    "flip_within_its_weight": (EDGE_RAY, 0.9, 0.0, 0.0, True),
    "flip_beyond_its_weight": (EDGE_RAY, 1.5, 2e-5, 0.0, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_same_render_tells_shading_flips_from_differences(scene, case):
    handle, rays, rgb, depth = scene
    moved = _moved(scene)
    assert moved[EDGE_RAY] >= handle.field.cfg.ray_march_weight_thres > 1e-3
    ray, times, plus, plus_depth, passes = CASES[case]
    if ray == "far":
        ray = int(np.nonzero(moved == 0.0)[0][0])
    got_rgb, got_depth = rgb.copy(), depth.copy()
    if ray is not None:
        got_rgb[ray] = np.clip(got_rgb[ray] - times * moved[ray] - plus, 0.0, None)
        got_depth[ray] += plus_depth
    e_rgb, e_depth, flips, msg = chip_smoke.same_render(
        torch, np, handle, rays, (got_rgb, got_depth), (rgb, depth))
    assert (msg is None) == passes, msg
    assert e_rgb == pytest.approx(float(np.abs(got_rgb - rgb).max()))
    assert e_depth == pytest.approx(float(np.abs(got_depth - depth).max()))
    assert flips == int((np.abs(got_rgb - rgb) > 1e-5 + 1e-5 * np.abs(rgb)).any(-1).sum())
    assert flips == (1 if times or plus > 1e-5 else 0)


@pytest.mark.parametrize("one_hot_bytes", [None, 30_000], ids=["one_hot", "footprint_lines"])
@pytest.mark.parametrize("model", ["TensorVMSplit", "TensorCP", "TensorVM"])
@pytest.mark.parametrize("fused,top_k", [(True, 16), (True, None), (False, 16)],
                         ids=["fused_topk", "fused_all", "unfused"])
def test_scatter_launches_per_step_counts_each_models_gathers(model, fused, top_k,
                                                              one_hot_bytes, monkeypatch):
    """chip_smoke.py's expected launch count of a step equals the plane and
    line row gathers the step's backward scatters, counted on the CPU, for
    every model: with strata (one render each, one width under top-K and
    one above it) and without, and with a mask gating the whole lattice (the
    density on the admitted slots alone); with every fused line on the
    one-hot matmul,
    and with a byte bound that sends the wide passes' lines to the
    footprint gather and keeps some top-K passes' on the matmul."""
    from unittest import mock

    from tensorf_tpu_torch.models import FIELD_MODELS
    from tensorf_tpu_torch.models import tensorf
    from tensorf_tpu_torch.ops import grid_sample
    from tensorf_tpu_torch.ops.scatter_add import scatter_add_reference
    from tensorf_tpu_torch.parallel import parity
    from tensorf_tpu_torch.train import LossWeights, TrainStatics, loss_fn

    ranks = (3, 3, 3) if model == "TensorVMSplit" else (3,)
    cfg = ModelConfig(model_name=model, density_n_comp=ranks, app_n_comp=ranks, app_dim=6,
                      shading_mode="MLP_Fea", feature_c=8, density_shift=-3.0)
    field = FIELD_MODELS[model](cfg, (10, 11, 12), "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    o = rng.normal(size=(48, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(48, 3))
    rays = torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))
    rgbs = torch.rand((48, 3), generator=torch.Generator().manual_seed(2))
    u = torch.rand((48, 1), generator=torch.Generator().manual_seed(3))
    common = dict(n_samples=64, step_size=0.06, white_bg=True, ndc_ray=False, total_steps=10,
                  lr_factor=1.0, weights=LossWeights(), shade_top_k=top_k, fused=fused)
    cases = [
        (TrainStatics(**common), rays, rgbs, u, torch.tensor(0.0), None),
        (TrainStatics(**common, strata_budgets=(16, None), strata_n_samples=(64, 64),
                      strata_loss_weights=(0.5, 0.5)),
         (rays[:24], rays[24:]), (rgbs[:24], rgbs[24:]), (u[:24], u[24:]),
         (torch.tensor(0.0), torch.tensor(0.0)), None),
        # the mask gates the whole lattice: the density runs on the admitted slots
        (TrainStatics(**common), rays, rgbs, u, torch.tensor(0.0), _ball_mask()),
    ]
    if one_hot_bytes is not None:
        monkeypatch.setattr(tensorf, "_ONE_HOT_MAX_BYTES", one_hot_bytes)
    for statics, rays_, rgbs_, u_, flip, mask in cases:
        calls = []

        def counting(idx, g, n_rows):
            if idx.shape[0]:  # the card launches nothing for no rows
                calls.append(g.shape[1])
            return scatter_add_reference(idx, g, n_rows)

        field.zero_grad(set_to_none=True)
        with mock.patch.object(grid_sample, "scatter_add", counting), \
                parity.recording_renders() as renders:
            total, _ = loss_fn(field, statics, AABB, rays_, rgbs_, 3, u_, flip, mask)
            total.backward()
        batches = [r.shape[0] for r in rays_] if isinstance(rays_, tuple) else [48]
        # a render's recorded density rows are its rays x width but where the
        # mask gates its lattice
        assert ((chip_smoke.density_rows(statics, batches, renders)
                 != chip_smoke.density_rows(statics, batches)) == (mask is not None))
        assert len(calls) == chip_smoke.scatter_launches_per_step(statics, model, batches,
                                                                  (10, 11, 12), renders=renders)


@pytest.mark.parametrize("one_hot_bytes", [None, 30_000], ids=["one_hot", "footprint_lines"])
@pytest.mark.parametrize("model", ["TensorVMSplit", "TensorCP", "TensorVM"])
@pytest.mark.parametrize("fused,top_k", [(True, 16), (True, None), (False, 16)],
                         ids=["fused_topk", "fused_all", "unfused"])
def test_line_lerp_launches_per_step_count_each_models_float32_one_hot_reads(
        model, fused, top_k, one_hot_bytes, monkeypatch):
    """chip_smoke.py's expected line-lerp launches of a step equal twice the
    float32 line reads that the CPU's step takes by the one-hot matmul with
    a graph (the reads the card's kernel takes, a forward and a backward
    each), and each such read gets its backward: every model, strata or
    not, a mask gating the whole lattice or not, every line on the one-hot
    and the wide passes' lines on the footprint gather."""
    from unittest import mock

    from tensorf_tpu_torch.models import FIELD_MODELS
    from tensorf_tpu_torch.models import tensorf
    from tensorf_tpu_torch.parallel import parity
    from tensorf_tpu_torch.train import LossWeights, TrainStatics, loss_fn

    ranks = (3, 3, 3) if model == "TensorVMSplit" else (3,)
    cfg = ModelConfig(model_name=model, density_n_comp=ranks, app_n_comp=ranks, app_dim=6,
                      shading_mode="MLP_Fea", feature_c=8, density_shift=-3.0)
    field = FIELD_MODELS[model](cfg, (10, 11, 12), "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    o = rng.normal(size=(48, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(48, 3))
    rays = torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))
    rgbs = torch.rand((48, 3), generator=torch.Generator().manual_seed(2))
    u = torch.rand((48, 1), generator=torch.Generator().manual_seed(3))
    common = dict(n_samples=64, step_size=0.06, white_bg=True, ndc_ray=False, total_steps=10,
                  lr_factor=1.0, weights=LossWeights(), shade_top_k=top_k, fused=fused)
    cases = [
        (TrainStatics(**common), rays, rgbs, u, torch.tensor(0.0), None),
        (TrainStatics(**common, strata_budgets=(16, None), strata_n_samples=(64, 64),
                      strata_loss_weights=(0.5, 0.5)),
         (rays[:24], rays[24:]), (rgbs[:24], rgbs[24:]), (u[:24], u[24:]),
         (torch.tensor(0.0), torch.tensor(0.0)), None),
        # the mask gates the whole lattice: the density runs on the admitted slots
        (TrainStatics(**common), rays, rgbs, u, torch.tensor(0.0), _ball_mask()),
    ]
    if one_hot_bytes is not None:
        monkeypatch.setattr(tensorf, "_ONE_HOT_MAX_BYTES", one_hot_bytes)
    matmul = tensorf.line_sample_matmul
    for statics, rays_, rgbs_, u_, flip, mask in cases:
        forwards, backwards = [], []

        def counting(line, coord, a_dtype=None):
            out = matmul(line, coord, a_dtype)
            if a_dtype is None and torch.is_grad_enabled() and line.requires_grad:
                forwards.append(line.shape)
                out.register_hook(lambda g: backwards.append(g.shape))
            return out

        field.zero_grad(set_to_none=True)
        with mock.patch.object(tensorf, "line_sample_matmul", counting), \
                parity.recording_renders() as renders:
            total, _ = loss_fn(field, statics, AABB, rays_, rgbs_, 3, u_, flip, mask)
            total.backward()
        batches = [r.shape[0] for r in rays_] if isinstance(rays_, tuple) else [48]
        # a render's recorded density rows are its rays x width but where the
        # mask gates its lattice
        assert ((chip_smoke.density_rows(statics, batches, renders)
                 != chip_smoke.density_rows(statics, batches)) == (mask is not None))
        want = chip_smoke.line_lerp_launches_per_step(statics, model, batches, (10, 11, 12),
                                                      renders=renders)
        assert len(backwards) == len(forwards)
        assert 2 * len(forwards) == want
        if one_hot_bytes is None:
            assert (want > 0) == fused


def test_graphless_line_reads_count_the_reads_with_no_graph():
    """chip_smoke.py's count of the line reads that launch the line lerp
    once: those under no_grad or of a line that needs no gradient, not
    those a backward follows; the port's read is restored after."""
    from tensorf_tpu_torch.models import tensorf

    line = torch.randn((30, 4), generator=torch.Generator().manual_seed(0))
    coord = torch.linspace(-1, 1, 7)
    real = tensorf.line_lerp
    with chip_smoke.graphless_line_reads(torch) as n:
        tensorf.line_lerp(line.clone().requires_grad_(), coord).sum().backward()
        with torch.no_grad():
            tensorf.line_lerp(line.clone().requires_grad_(), coord)
        tensorf.line_lerp(line, coord)
    assert n == [2] and tensorf.line_lerp is real


@pytest.mark.parametrize("model", ["TensorVMSplit", "TensorCP", "TensorVM"])
@pytest.mark.parametrize("fused,top_k", [(True, 16), (True, None), (False, 16)],
                         ids=["fused_topk", "fused_all", "unfused"])
def test_bf16_launches_per_step_count_the_bf16_gathers(model, fused, top_k):
    """With grid_dtype and line_dtype bfloat16, chip_smoke.py's counts of a
    step's launches equal what the step's backward scatters, counted on the
    CPU: in all (scatter_launches_per_step with the bf16 one-hot) and in
    bf16 rows (bf16_launches_per_step: TensorVMSplit's fused plane tables,
    strata or not, a mask gating the whole lattice or not)."""
    from unittest import mock

    from tensorf_tpu_torch.models import FIELD_MODELS
    from tensorf_tpu_torch.ops import grid_sample
    from tensorf_tpu_torch.ops.scatter_add import scatter_add_reference
    from tensorf_tpu_torch.parallel import parity
    from tensorf_tpu_torch.train import LossWeights, TrainStatics, loss_fn

    ranks = (3, 3, 3) if model == "TensorVMSplit" else (3,)
    cfg = ModelConfig(model_name=model, density_n_comp=ranks, app_n_comp=ranks, app_dim=6,
                      shading_mode="MLP_Fea", feature_c=8, density_shift=-3.0,
                      grid_dtype="bfloat16", line_dtype="bfloat16")
    field = FIELD_MODELS[model](cfg, (10, 11, 12), "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    o = rng.normal(size=(48, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(48, 3))
    rays = torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))
    rgbs = torch.rand((48, 3), generator=torch.Generator().manual_seed(2))
    u = torch.rand((48, 1), generator=torch.Generator().manual_seed(3))
    common = dict(n_samples=64, step_size=0.06, white_bg=True, ndc_ray=False, total_steps=10,
                  lr_factor=1.0, weights=LossWeights(), shade_top_k=top_k, fused=fused)
    cases = [
        (TrainStatics(**common), rays, rgbs, u, torch.tensor(0.0), None),
        (TrainStatics(**common, strata_budgets=(16, None), strata_n_samples=(64, 64),
                      strata_loss_weights=(0.5, 0.5)),
         (rays[:24], rays[24:]), (rgbs[:24], rgbs[24:]), (u[:24], u[24:]),
         (torch.tensor(0.0), torch.tensor(0.0)), None),
        # the mask gates the whole lattice: the density runs on the admitted slots
        (TrainStatics(**common), rays, rgbs, u, torch.tensor(0.0), _ball_mask()),
    ]
    for statics, rays_, rgbs_, u_, flip, mask in cases:
        calls = []

        def counting(idx, g, n_rows):
            if idx.shape[0]:  # the card launches nothing for no rows
                calls.append(g.dtype)
            return scatter_add_reference(idx, g, n_rows)

        field.zero_grad(set_to_none=True)
        with mock.patch.object(grid_sample, "scatter_add", counting), \
                parity.recording_renders() as renders:
            total, _ = loss_fn(field, statics, AABB, rays_, rgbs_, 3, u_, flip, mask)
            total.backward()
        batches = [r.shape[0] for r in rays_] if isinstance(rays_, tuple) else [48]
        # a render's recorded density rows are its rays x width but where the
        # mask gates its lattice
        assert ((chip_smoke.density_rows(statics, batches, renders)
                 != chip_smoke.density_rows(statics, batches)) == (mask is not None))
        assert len(calls) == chip_smoke.scatter_launches_per_step(
            statics, model, batches, (10, 11, 12), field.line_a_dtype, renders, field.grid_dtype)
        assert calls.count(torch.bfloat16) == chip_smoke.bf16_launches_per_step(
            statics, model, batches, field.grid_dtype, renders)
        assert (calls.count(torch.bfloat16) > 0) == (model == "TensorVMSplit" and fused)


@pytest.mark.parametrize("model,mode,with_mask", [
    ("TensorVMSplit", "MLP_Fea", True), ("TensorCP", "MLP", False), ("TensorVM", "SH", True)])
def test_reference_th_writer_round_trips_through_the_importer(tmp_path, model, mode, with_mask):
    """chip_smoke.py's th_import writes a field in the reference's .th
    layout; utils/import_torch.py reads back the same config, grid, params,
    aabb and mask."""
    from tensorf_tpu_torch.convert import params_to_jax
    from tensorf_tpu_torch.models import FIELD_MODELS
    from tensorf_tpu_torch.utils.import_torch import load_reference_checkpoint

    ranks = (2, 3, 4) if model == "TensorVMSplit" else (3,)
    grid = (8, 8, 8) if model == "TensorVM" else (8, 10, 12)
    cfg = ModelConfig(model_name=model, density_n_comp=ranks, app_n_comp=ranks,
                      app_dim=27 if mode == "SH" else 6, shading_mode=mode, pos_pe=2, view_pe=2,
                      fea_pe=2, feature_c=8, density_shift=-3.0, near_far=(1.5, 5.5))
    field = FIELD_MODELS[model](cfg, grid, "cpu", torch.Generator().manual_seed(0))
    aabb = np.asarray([[-1.5, -1.2, -1.0], [1.5, 1.2, 1.0]], np.float32)
    mask = None
    if with_mask:
        vol = torch.from_numpy((np.random.default_rng(0).uniform(size=(5, 6, 7)) > 0.5)
                               .astype(np.float32))
        mask = tam.with_dilation(tam.AlphaGridMask(aabb=torch.from_numpy(aabb), volume=vol))
    path = str(tmp_path / "field.th")
    chip_smoke.write_reference_th(torch, np, path, field, aabb, mask)
    got_cfg, got, got_aabb, got_grid, got_mask, extra = load_reference_checkpoint(path, "cpu")
    # the legacy TensorVM's reference kwargs carry one int rank, read as three
    full_ranks = ranks * 3 if model == "TensorVM" else ranks
    assert got_cfg == dataclasses.replace(cfg, density_n_comp=full_ranks, app_n_comp=full_ranks)
    assert got_grid == grid and extra is None
    np.testing.assert_array_equal(got_aabb, aabb)
    want = params_to_jax(field)
    assert params_to_jax(got).keys() == want.keys()
    for k, v in params_to_jax(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert (got_mask is None) == (mask is None)
    if mask is not None:
        np.testing.assert_array_equal(got_mask.volume.numpy(), mask.volume.numpy())
        np.testing.assert_array_equal(got_mask.aabb.numpy(), aabb)


def test_sphere_seed_mean_holds_the_mean_to_30_db(capsys):
    """The sphere check holds the five seeds' mean to 30 dB: a run under
    the bar passes inside a mean above it, a mean under it fails."""
    psnrs = {20211202: 30.2, 1: 29.6, 2: 31.0, 3: 30.1, 4: 29.9}
    assert chip_smoke.sphere_seed_mean(np, psnrs) == pytest.approx(30.16)
    assert "mean 30.1600 dB over 5 seeds" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.sphere_seed_mean(np, {**psnrs, 2: 29.0})
    assert "under 30.0" in capsys.readouterr().err
