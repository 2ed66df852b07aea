"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without a GPU (a CUDA kernel has no CPU mode).
Mesh export and resume on the card are held against the CPU and the
checkpoint.  This file imports neither jax nor tensorf_tpu, so it also
runs on a GPU machine without them; tests/conftest.py imports jax, so run
it there as

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerance rtol 1e-5, atol 1e-4: the same sums in another (atomic) order.
"""

import os

import numpy as np
import pytest
import torch

from tensorf_tpu_torch.ops.grid_sample import gather_rows
from tensorf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_bf16, scatter_add_reference

TOL = dict(rtol=1e-5, atol=1e-4)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,R,C",
    [(2048, 256, 128), (100_003, 16_384, 64), (65_536, 16_384, 192), (4099, 7, 5)],
    ids=["test_grid_sample_shape", "density_ragged", "appearance", "odd_C"],
)
def test_scatter_add_kernel_matches_add_at_and_reference(M, R, C):
    _need_gpu()
    rng = np.random.default_rng(1)
    idx = rng.integers(0, R, size=M).astype(np.int32)
    g = rng.normal(size=(M, C)).astype(np.float32)
    want = np.zeros((R, C), np.float32)
    np.add.at(want, idx, g)
    idx_d, g_d = torch.from_numpy(idx).cuda(), torch.from_numpy(g).cuda()
    before = scatter_add.launches
    got = scatter_add(idx_d, g_d, R)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.cpu().numpy(), scatter_add_reference(idx_d, g_d, R).cpu().numpy(), **TOL
    )


def _stream(kind, M, R, rng):
    """uniform rows; sorted runs of random length 1-40; runs of 200-1000
    rows (each crosses segment and block edges); runs of 1-8 shuffled
    within each 64-row window (duplicates that only a sort brings
    together); each 512-row stretch drawn from 32 rows (duplicates spread
    over a whole window); every index on one row."""
    if kind == "uniform":
        return rng.integers(0, R, size=M).astype(np.int32)
    if kind == "window_dups":
        base = rng.integers(0, R - 32, size=M // 512 + 1)
        return (np.repeat(base, 512)[:M] + rng.integers(0, 32, size=M)).astype(np.int32)
    if kind in ("runs", "long_runs", "shuffled"):
        lo, hi = {"runs": (1, 41), "long_runs": (200, 1001), "shuffled": (1, 9)}[kind]
        lengths = rng.integers(lo, hi, size=M)
        n_runs = int(np.searchsorted(np.cumsum(lengths), M)) + 1
        rows = np.sort(rng.integers(0, R, size=n_runs))
        idx = np.repeat(rows, lengths[:n_runs])[:M].astype(np.int32)
        if kind == "shuffled":
            for start in range(0, M, 64):
                rng.shuffle(idx[start : start + 64])
        return idx
    assert kind == "hot_row", kind
    return np.full(M, R // 2, np.int32)


def _values(kind, M, C, rng):
    """Normal rows; for a hot row, multiples of 1/8, whose float32 sums are
    exact in any order (the plain version's own rounding over 10^5 adds
    into one element would exceed the tolerance)."""
    if kind == "hot_row":
        return (rng.integers(-8, 9, size=(M, C)) / 8).astype(np.float32)
    return rng.normal(size=(M, C)).astype(np.float32)


def _check_kernel(idx, g, R, g_d=None):
    """The kernel on (idx, g) against np.add.at (float64) and the plain
    version; ``g_d`` is g already on the card, in any layout the wrapper
    takes."""
    want = np.zeros((R, g.shape[1]), np.float64)
    np.add.at(want, idx, g.astype(np.float64))
    idx_d = torch.from_numpy(idx).cuda()
    g_d = torch.from_numpy(g).cuda() if g_d is None else g_d
    before = scatter_add.launches
    got = scatter_add(idx_d, g_d, R)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.cpu().numpy(), scatter_add_reference(idx_d, g_d, R).cpu().numpy(), **TOL
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,M,R,C",
    [
        ("runs", 200_003, 4096, 64),
        ("runs", 65_536, 4096, 192),
        ("long_runs", 300_001, 2000, 64),
        ("hot_row", 200_000, 1000, 64),
        ("hot_row", 4096, 1000, 5),
        ("runs", 4099, 7, 5),
        ("runs", 10_007, 300, 6),
        ("runs", 20_003, 300, 130),
        ("uniform", 3001, 100, 1028),
        ("uniform", 3001, 100, 1030),
        ("uniform", 1, 10, 64),
        ("uniform", 1, 10, 5),
        ("uniform", 100_003, 16_384, 192),
        ("shuffled", 200_003, 100_000, 192),
        ("uniform", 500_003, 16_384, 5),
    ],
    ids=["runs_C64", "runs_C192", "long_runs_C64", "hot_row_C64", "hot_row_C5",
         "runs_C5", "runs_C6", "runs_C130", "wide_C1028", "wide_C1030", "M1_C64",
         "M1_C5", "ragged_M_C192", "shuffled_C192", "uniform_C5"],
)
def test_scatter_add_kernel_branches(kind, M, R, C):
    """Every branch of the kernels: float4 and scalar columns, rows wider
    than a block, run flushes at segment edges, sorted and unsorted tiles,
    hot rows, ragged and single-row M, and launches small enough for
    segments shorter than the unrolled loop."""
    _need_gpu()
    rng = np.random.default_rng(2)
    _check_kernel(_stream(kind, M, R, rng), _values(kind, M, C, rng), R)


@pytest.mark.cuda
def test_scatter_add_kernel_on_unaligned_rows():
    """g 4 bytes off a 16-byte boundary: the scalar path, at C = 64."""
    _need_gpu()
    rng = np.random.default_rng(3)
    M, R, C = 40_001, 512, 64
    idx = _stream("runs", M, R, rng)
    g = rng.normal(size=(M, C)).astype(np.float32)
    flat = torch.empty(M * C + 1, device="cuda")
    flat[1:] = torch.from_numpy(g.reshape(-1)).cuda()
    g_d = flat[1:].view(M, C)
    assert g_d.is_contiguous() and g_d.data_ptr() % 16 != 0
    _check_kernel(idx, g, R, g_d)


def _check_bf16_kernel(idx, g, R, g_d=None):
    """The bf16 entry point on (idx, g as bf16) against np.add.at of the
    bf16 values (float64) and the plain version (index_add_ of g.float());
    it counts as a launch of both entry points' counter and of its own."""
    g_bf = torch.from_numpy(g).to(torch.bfloat16)
    want = np.zeros((R, g.shape[1]), np.float64)
    np.add.at(want, idx, g_bf.double().numpy())
    idx_d = torch.from_numpy(idx).cuda()
    g_d = g_bf.cuda() if g_d is None else g_d
    before = (scatter_add.launches, scatter_add_bf16.launches)
    got = scatter_add_bf16(idx_d, g_d, R)
    torch.cuda.synchronize()
    assert (scatter_add.launches, scatter_add_bf16.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.cpu().numpy(), scatter_add_reference(idx_d, g_d, R).cpu().numpy(), **TOL
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,M,R,C",
    [
        ("runs", 200_003, 4096, 64),
        ("shuffled", 200_003, 100_000, 192),
        ("long_runs", 300_001, 2000, 256),
        ("hot_row", 200_000, 1000, 64),
        ("runs", 4099, 7, 5),
        ("runs", 10_007, 300, 12),
        ("uniform", 3001, 100, 2056),
        ("uniform", 1, 10, 64),
        ("uniform", 500_003, 16_384, 5),
        ("window_dups", 300_001, 16_384, 64),
        ("window_dups", 83_456, 16_384, 192),
        ("uniform", 83_456, 16_384, 192),
        ("hot_row", 262_144, 16_384, 192),
        ("hot_row", 65_537, 1000, 12),
        ("runs", 1_000_003, 16_384, 64),
        ("shuffled", 65_537, 1000, 6),
    ],
    ids=["runs_C64", "shuffled_C192", "long_runs_C256", "hot_row_C64", "runs_C5", "runs_C12",
         "wide_C2056", "M1_C64", "uniform_C5", "window_dups_C64", "window_dups_C192",
         "stratum_C192", "hot_row_C192", "hot_row_C12", "ragged_M_C64", "shuffled_C6"],
)
def test_scatter_add_bf16_kernel_branches(kind, M, R, C):
    """The bf16 entry point's branches: four-channel columns (8-byte loads
    widened to a float4) where C % 4 == 0 (C 12 among them), one channel a
    thread otherwise (C 5, 6), rows wider than a block, tiles sorted
    (short runs, duplicates spread over a stretch) and in stream order, hot
    rows and long runs, ragged and single-row M."""
    _need_gpu()
    rng = np.random.default_rng(4)
    _check_bf16_kernel(_stream(kind, M, R, rng), _values(kind, M, C, rng), R)


@pytest.mark.cuda
def test_scatter_add_bf16_kernel_on_unaligned_rows():
    """bf16 g 2 bytes off a 16-byte boundary: the one-channel path at C = 64."""
    _need_gpu()
    rng = np.random.default_rng(5)
    M, R, C = 40_001, 512, 64
    idx = _stream("runs", M, R, rng)
    g = rng.normal(size=(M, C)).astype(np.float32)
    flat = torch.empty(M * C + 1, device="cuda", dtype=torch.bfloat16)
    flat[1:] = torch.from_numpy(g.reshape(-1)).to(torch.bfloat16).cuda()
    g_d = flat[1:].view(M, C)
    assert g_d.is_contiguous() and g_d.data_ptr() % 16 != 0
    _check_bf16_kernel(idx, g, R, g_d)


@pytest.mark.cuda
def test_scatter_add_bf16_kernel_on_rows_8_bytes_off():
    """bf16 g 8 bytes off a 16-byte boundary: still the four-channel path
    (8-byte loads), at C = 64 and C = 12."""
    _need_gpu()
    rng = np.random.default_rng(6)
    for M, R, C in ((40_001, 512, 64), (40_001, 512, 12)):
        idx = _stream("shuffled", M, R, rng)
        g = rng.normal(size=(M, C)).astype(np.float32)
        flat = torch.empty(M * C + 4, device="cuda", dtype=torch.bfloat16)
        flat[4:] = torch.from_numpy(g.reshape(-1)).to(torch.bfloat16).cuda()
        g_d = flat[4:].view(M, C)
        assert g_d.is_contiguous() and g_d.data_ptr() % 16 == 8
        _check_bf16_kernel(idx, g, R, g_d)


@pytest.mark.cuda
def test_bf16_gather_backward_launches_the_bf16_kernel():
    """A bf16 table's gather: its backward launches the bf16 entry point
    and hands autograd the float32 sum rounded to bf16, as on the CPU."""
    _need_gpu()
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((300, 16), generator=gen).to(torch.bfloat16)
    idx = torch.randint(0, 300, (5000,), generator=gen, dtype=torch.int32)
    cot = torch.randn((5000, 16), generator=gen).to(torch.bfloat16)
    grads = {}
    for dev in ("cpu", "cuda"):
        t = table.to(dev, copy=True).requires_grad_()
        before = scatter_add_bf16.launches
        gather_rows(t, idx.to(dev)).backward(cot.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert scatter_add_bf16.launches == before + 1
        assert t.grad.dtype == torch.bfloat16
        grads[dev] = t.grad.float().cpu().numpy()
    # the same float32 sums in another order, each rounded to bf16 once:
    # at most one bf16 step (2^-8 relative) apart
    np.testing.assert_allclose(grads["cuda"], grads["cpu"], rtol=2 ** -7, atol=1e-3)


@pytest.mark.cuda
def test_gather_backward_launches_the_kernel():
    _need_gpu()
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((300, 12), generator=gen).cuda().requires_grad_()
    idx = torch.randint(0, 300, (5000,), generator=gen, dtype=torch.int32).cuda()
    cot = torch.randn((5000, 12), generator=gen).cuda()
    before = scatter_add.launches
    gather_rows(table, idx).backward(cot)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    np.testing.assert_allclose(
        table.grad.cpu().numpy(), scatter_add_reference(idx, cot, 300).cpu().numpy(), **TOL
    )


@pytest.mark.cuda
@pytest.mark.parametrize("L,C", [(786, 64), (471, 16), (1100, 8)],
                         ids=["flower_axis0", "flower_axis2", "over_1024"])
def test_line_footprint_backward_kernel_matches_plain(L, C):
    """The 1-D footprint gather of a long line (flower's 640^3-era lines,
    and one past the one-hot's 1024 rows): forward equal to the CPU's, its
    backward one kernel launch into the (L, 2C) table, held to the plain
    scatter and to the CPU's gradient.  The points march along rays, so the
    index stream comes in long sorted runs, as NDC samples give it."""
    from tensorf_tpu_torch.ops.grid_sample import footprint_sample_1d, make_footprint_1d

    _need_gpu()
    gen = torch.Generator().manual_seed(0)
    n_rays, n_samples = 512, 400
    start = torch.rand((n_rays, 1), generator=gen) * 2 - 1
    slope = (torch.rand((n_rays, 1), generator=gen) - 0.5) * 0.4
    coord = (start + slope * torch.linspace(0, 1, n_samples)).clamp(-1, 1).reshape(-1)
    line = torch.randn((L, C), generator=gen)
    cot = torch.randn((coord.numel(), C), generator=gen)
    grads = {}
    for dev in ("cpu", "cuda"):
        table = line.to(dev, copy=True).requires_grad_()
        out = footprint_sample_1d(make_footprint_1d(table), L, coord.to(dev))
        before = scatter_add.launches
        out.backward(cot.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert scatter_add.launches == before + 1
        grads[dev] = (out.detach().cpu().numpy(), table.grad.cpu().numpy())
    np.testing.assert_allclose(grads["cuda"][0], grads["cpu"][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grads["cuda"][1], grads["cpu"][1], **TOL)


def _small_field(seed, grid=(20, 22, 24), density_shift=-3.0, density_scale=1.0):
    from tensorf_tpu_torch.models import ModelConfig, TensorVMSplit

    cfg = ModelConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=9, pos_pe=2,
                      view_pe=2, fea_pe=2, feature_c=32, density_shift=density_shift)
    field = TensorVMSplit(cfg, grid, "cpu", torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in [*field.density_plane, *field.density_line]:
            p.mul_(density_scale)
    return field


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("model,mode,app_dim,scatters",
                         [("TensorCP", "MLP", 9, 0), ("TensorVM", "SH", 27, 6)],
                         ids=["TensorCP_MLP", "TensorVM_SH"])
def test_cp_and_vm_steps_on_the_card_match_the_cpu(model, mode, app_dim, scatters):
    """One top-K train step of TensorCP (no plane: no scatter-add) and of
    TensorVM (its density and appearance plane tables: 6), card against
    CPU: the same loss and every gradient."""
    import copy

    from tensorf_tpu_torch.models import FIELD_MODELS, ModelConfig
    from tensorf_tpu_torch.train import LossWeights, TrainStatics, loss_fn

    _need_gpu()
    cfg = ModelConfig(model_name=model, density_n_comp=(4,), app_n_comp=(6,), app_dim=app_dim,
                      shading_mode=mode, pos_pe=2, view_pe=2, fea_pe=2, feature_c=32,
                      density_shift=-3.0)
    field = FIELD_MODELS[model](cfg, (20, 22, 24), "cpu", torch.Generator().manual_seed(3))
    statics = TrainStatics(n_samples=96, step_size=0.05, white_bg=True, ndc_ray=False,
                           total_steps=100, lr_factor=0.99, shade_top_k=16, fused=True,
                           weights=LossWeights(ortho=0.01, l1=8e-5, tv_density=0.01,
                                               tv_app=0.01))
    rng = np.random.default_rng(4)
    rays, rgbs = _rays(rng, 256), torch.from_numpy(rng.uniform(size=(256, 3)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(256, 1)).astype(np.float32))
    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3])
    out = {}
    for dev in ("cpu", "cuda"):
        f = copy.deepcopy(field).to(dev)
        before = scatter_add.launches
        total, _ = loss_fn(f, statics, aabb.to(dev), rays.to(dev), rgbs.to(dev), 3, u.to(dev),
                           torch.tensor(0.0, device=dev))
        total.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert scatter_add.launches - before == scatters
        out[dev] = (float(total.detach()),
                    {n: p.grad.cpu().numpy() for n, p in f.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for name, g in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][name], g, err_msg=name, **TOL)


@pytest.mark.cuda
def test_masked_render_on_the_card_matches_the_cpu():
    """The masked render and its gradients, card (kernel backward) against
    CPU (plain backward): same field, mask, rays and jitter."""
    import copy

    from tensorf_tpu_torch.models.alpha_mask import AlphaGridMask, with_dilation
    from tensorf_tpu_torch.ops.freq_mask import FreeMasks
    from tensorf_tpu_torch.render import render_rays

    _need_gpu()
    rng = np.random.default_rng(4)
    field = _small_field(1)
    vol = torch.from_numpy((rng.uniform(size=(12, 11, 10)) < 0.3).astype(np.float32))
    mask = with_dilation(AlphaGridMask(torch.tensor([[-1.2, -1.3, -1.1], [1.3, 1.2, 1.25]]), vol))
    rays = _rays(rng, 512)
    u = torch.from_numpy(rng.uniform(size=(512, 1)).astype(np.float32))
    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3])
    kw = dict(step_size=0.04, n_samples=130, is_train=True, white_bg=True, shade_top_k=32,
              fused=True)
    outs = {}
    for dev in ("cpu", "cuda"):
        f = copy.deepcopy(field).to(dev)
        out = render_rays(f, rays.to(dev), FreeMasks(), aabb=aabb.to(dev), alpha_mask=mask.to(dev),
                          u=u.to(dev), **kw)
        out.rgb.sum().backward()
        outs[dev] = (out, {n: p.grad.cpu() for n, p in f.named_parameters()})
    (cpu, g_cpu), (card, g_card) = outs["cpu"], outs["cuda"]
    assert float(card.mean_alive_samples) == float(cpu.mean_alive_samples)
    for name in ("rgb", "depth", "weights"):
        np.testing.assert_allclose(getattr(card, name).detach().cpu().numpy(),
                                   getattr(cpu, name).detach().numpy(), **TOL)
    for name, g in g_cpu.items():
        np.testing.assert_allclose(g_card[name].numpy(), g.numpy(), err_msg=name, **TOL)


@pytest.mark.cuda
def test_update_alpha_mask_on_the_card_matches_the_cpu():
    """The dense alpha sweep, dilation, threshold and tight bbox on the
    card against the CPU; bits may differ only within 1e-5 of the
    threshold."""
    import copy

    from tensorf_tpu_torch.models.alpha_mask import max_pool_3d_same
    from tensorf_tpu_torch.render.culling import compute_alpha_grid, update_alpha_mask

    _need_gpu()
    field = _small_field(2, density_shift=-10.0, density_scale=8.0)  # ~6% occupied
    aabb = np.asarray([[-1.5] * 3, [1.5] * 3], np.float32)
    grid, step = (20, 22, 24), 0.035
    res = {}
    for dev in ("cpu", "cuda"):
        f = copy.deepcopy(field).to(dev)
        alpha, _ = compute_alpha_grid(f, None, aabb, grid, step)
        res[dev] = update_alpha_mask(f, None, aabb, grid, step) + (alpha.cpu(),)
    (m_cpu, aabb_cpu, occ_cpu, a_cpu), (m_card, aabb_card, occ_card, a_card) = res["cpu"], res["cuda"]
    np.testing.assert_allclose(a_card.numpy(), a_cpu.numpy(), rtol=1e-5, atol=1e-6)
    assert 0.0 < occ_cpu < 1.0
    pooled = max_pool_3d_same(torch.clamp(a_cpu, 0, 1).permute(2, 1, 0).contiguous(), 3).numpy()
    differ = m_card.volume.cpu().numpy() != m_cpu.volume.numpy()
    assert not np.any(differ & (np.abs(pooled - field.cfg.alpha_mask_thres) > 1e-5))
    if not differ.any():
        assert occ_card == occ_cpu
        np.testing.assert_array_equal(aabb_card, aabb_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [dict(sample_budget=48, budget_mode="cand"),
                                    dict(sample_budget=96, budget_mode="cand", alive_budget=32),
                                    dict(sample_budget=32, budget_mode="alive"),
                                    dict(sample_budget=40, use_coarse_gate=False)],
                         ids=["cand", "cand_alive", "alive", "exact_gate"])
def test_budgeted_render_and_counts_on_the_card_match_the_cpu(budget):
    """Every masked budget mode, card against CPU: the same samples kept
    (depths equal), the same overflow, outputs and gradients within TOL;
    and the count passes equal."""
    import copy

    from tensorf_tpu_torch.models.alpha_mask import AlphaGridMask, with_dilation
    from tensorf_tpu_torch.ops.freq_mask import FreeMasks
    from tensorf_tpu_torch.render import culling, render_rays

    _need_gpu()
    rng = np.random.default_rng(5)
    field = _small_field(1)
    vol = torch.from_numpy((rng.uniform(size=(12, 11, 10)) < 0.3).astype(np.float32))
    mask = with_dilation(AlphaGridMask(torch.tensor([[-1.2, -1.3, -1.1], [1.3, 1.2, 1.25]]), vol))
    rays = _rays(rng, 512)
    u = torch.from_numpy(rng.uniform(size=(512, 1)).astype(np.float32))
    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3])
    kw = dict(step_size=0.04, n_samples=130, is_train=True, white_bg=True, shade_top_k=16,
              fused=True, **budget)
    outs = {}
    for dev in ("cpu", "cuda"):
        f = copy.deepcopy(field).to(dev)
        out = render_rays(f, rays.to(dev), FreeMasks(), aabb=aabb.to(dev), alpha_mask=mask.to(dev),
                          u=u.to(dev), **kw)
        out.rgb.sum().backward()
        counts = culling.count_ray_candidates_and_alive(rays.to(dev), mask.to(dev), aabb.numpy(),
                                                        0.04, n_samples=130, chunk=200)
        outs[dev] = (out, {n: p.grad.cpu() for n, p in f.named_parameters()}, counts)
    (cpu, g_cpu, c_cpu), (card, g_card, c_card) = outs["cpu"], outs["cuda"]
    assert float(card.budget_overflow_frac) == float(cpu.budget_overflow_frac)
    np.testing.assert_allclose(card.z_vals.cpu().numpy(), cpu.z_vals.numpy(), rtol=1e-6, atol=1e-6)
    for name in ("rgb", "depth", "weights"):
        np.testing.assert_allclose(getattr(card, name).detach().cpu().numpy(),
                                   getattr(cpu, name).detach().numpy(), **TOL)
    for name, g in g_cpu.items():
        np.testing.assert_allclose(g_card[name].numpy(), g.numpy(), err_msg=name, **TOL)
    for a, b in zip(c_card, c_cpu):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_compacted_flower_step_on_the_card_matches_the_dense_formula():
    """One train step of a small flower-like field (NDC rays, TensorVMSplit
    16/4/4 + 48/12/12, MLP_Fea with PE 0, no top-K), whose shading runs
    only on the ~1% of slots over the weight threshold, against the dense
    formula on the card: every slot's features and head, ``where`` on the
    gate, the weighted sum.  The same loss and every gradient (the shaded
    rows' appearance gradients sum the same terms by the direct taps'
    scatters instead of the footprint tables', in another order)."""
    import dataclasses

    from tensorf_tpu_torch.models import ModelConfig, TensorVMSplit
    from tensorf_tpu_torch.models.shading import apply_shading
    from tensorf_tpu_torch.ops.freq_mask import FreeMasks
    from tensorf_tpu_torch.ops.rays import sample_along_rays_ndc
    from tensorf_tpu_torch.ops.render_math import raw2alpha
    from tensorf_tpu_torch.render.volume import feature2density, normalize_coord
    from tensorf_tpu_torch.train import LossWeights, TrainStatics, loss_fn

    _need_gpu()
    B, N = 2048, 128
    cfg = ModelConfig(density_n_comp=(16, 4, 4), app_n_comp=(48, 12, 12), app_dim=27,
                      shading_mode="MLP_Fea", pos_pe=0, view_pe=0, fea_pe=0, feature_c=128,
                      fea2dense_act="relu", near_far=(0.0, 1.0))
    field = TensorVMSplit(cfg, (96, 104, 64), "cuda", torch.Generator().manual_seed(6))
    aabb = torch.tensor([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], device="cuda")
    rng = np.random.default_rng(8)
    o = np.concatenate([rng.uniform(-1.2, 1.2, size=(B, 2)), -np.ones((B, 1))], -1)
    d = np.concatenate([rng.uniform(-0.8, 0.8, size=(B, 2)), 2.0 * np.ones((B, 1))], -1)
    rays = torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32)).cuda()
    rgbs = torch.from_numpy(rng.uniform(size=(B, 3)).astype(np.float32)).cuda()
    jitter = torch.from_numpy(rng.uniform(size=(B, N)).astype(np.float32)).cuda()
    flip = torch.tensor(1.0, device="cuda")

    def dense_loss():
        near, far = cfg.near_far
        xyz, z, valid = sample_along_rays_ndc(rays[:, :3], rays[:, 3:6], aabb, near, far, N,
                                              jitter)
        norm = torch.linalg.norm(rays[:, 3:6], dim=-1, keepdim=True)
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], dim=-1) * norm
        pts = normalize_coord(xyz, aabb).reshape(-1, 3)
        sigma = torch.where(valid, feature2density(
            field.cfg, field.density_feature_fused(pts, None).reshape(B, N)), 0.0)
        _, weight, _ = raw2alpha(sigma, dists * field.cfg.distance_scale)
        gate = weight > field.cfg.ray_march_weight_thres
        view = (rays[:, None, 3:6] / norm[:, None]).expand(B, N, 3).reshape(-1, 3)
        rgb_s = apply_shading(field.cfg, field.render, pts, view,
                              field.app_feature_fused(pts, None), FreeMasks()).reshape(B, N, 3)
        rgb = torch.sum(weight[..., None] * torch.where(gate[..., None], rgb_s, 0.0), dim=-2)
        rgb = torch.clamp(rgb + flip * (1.0 - torch.sum(weight, dim=-1)[..., None]), 0.0, 1.0)
        return torch.mean(torch.square(rgb - rgbs)), weight, torch.sum(gate)

    with torch.no_grad():
        thres = float(torch.quantile(dense_loss()[1].flatten(), 0.99))
    field.cfg = dataclasses.replace(cfg, ray_march_weight_thres=thres)
    statics = TrainStatics(n_samples=N, step_size=0.0, white_bg=False, ndc_ray=True,
                           total_steps=100, lr_factor=1.0, weights=LossWeights(),
                           shade_top_k=None, fused=True)
    grads = {}
    for name in ("compacted", "dense"):
        field.zero_grad(set_to_none=True)
        before = scatter_add.launches
        if name == "compacted":
            total, metrics = loss_fn(field, statics, aabb, rays, rgbs, 3, jitter, flip)
            shaded = int(metrics["num_valid_samples"])
        else:
            total, _, gate_sum = dense_loss()
            assert int(gate_sum) == shaded
        total.backward()
        torch.cuda.synchronize()
        # the density's three plane tables; the appearance's three plane tables
        # over every slot, or the shaded rows' direct taps of three planes and
        # three lines
        assert scatter_add.launches - before == {"compacted": 9, "dense": 6}[name]
        grads[name] = (float(total.detach()),
                       {n: p.grad.cpu().numpy() for n, p in field.named_parameters()})
    assert 0 < shaded < B * N // 50
    assert grads["compacted"][0] == pytest.approx(grads["dense"][0], rel=1e-6)
    for name, g in grads["dense"][1].items():
        np.testing.assert_allclose(grads["compacted"][1][name], g, err_msg=name, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("path", [dict(), dict(use_coarse_gate=False), dict(alive_stage=True)],
                         ids=["resident", "legacy", "legacy_alive_stage"])
def test_stratified_serving_on_the_card_matches_uniform_and_cpu(path):
    """Stratified serving on the card (window-bits or legacy path, with or
    without its exact-alive stage, rays
    built on the device by rays_from_pose) equals the card's unbudgeted
    uniform render and the CPU's stratified render of the same field and
    rays, with no overflow; host rays render as the device rays do."""
    import copy

    from tensorf_tpu_torch.models.alpha_mask import AlphaGridMask, with_dilation
    from tensorf_tpu_torch.render.chunked import (
        rays_from_pose,
        render_chunked,
        render_chunked_stratified,
    )

    _need_gpu()
    rng = np.random.default_rng(6)
    field = _small_field(3)
    vol = torch.from_numpy((rng.uniform(size=(12, 11, 10)) < 0.3).astype(np.float32))
    mask = with_dilation(AlphaGridMask(torch.tensor([[-1.2, -1.3, -1.1], [1.3, 1.2, 1.25]]), vol))
    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3])
    i, j = np.meshgrid(np.arange(48) + 0.5, np.arange(48) + 0.5)
    dirs = np.stack([(i - 24) / 40.0, (j - 24) / 40.0, np.ones_like(i)], -1).reshape(-1, 3)
    dirs = torch.from_numpy((dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32))
    c2w = torch.tensor([[1.0, 0, 0, 0.1], [0, 0, 1, -4.0], [0, -1, 0, 0.2]])  # looks along +y
    kw = dict(step_size=0.04, n_samples=130, white_bg=True, shade_top_k=16, chunk=512, **path)
    out = {}
    for dev in ("cpu", "cuda"):
        f, m, a = copy.deepcopy(field).to(dev), mask.to(dev), aabb.to(dev)
        rays = rays_from_pose(dirs.to(dev), c2w.to(dev))
        out[dev] = render_chunked_stratified(f, m, rays, a, **kw)
        if dev == "cuda":
            host = render_chunked_stratified(f, m, rays.cpu().numpy(), a, **kw)
            for x, y in zip(host, out[dev]):
                np.testing.assert_array_equal(x, y)
            rgb, depth, _, _ = render_chunked(f, m, rays, a, chunk=512, step_size=0.04,
                                              n_samples=130, white_bg=True, shade_top_k=16)
            uniform = (rgb.cpu().numpy(), depth.cpu().numpy())
    cpu, card = out["cpu"], out["cuda"]
    assert cpu[3] == card[3] == 0.0
    assert 0 < card[2] and (card[0] < 1.0).any()  # something was shaded
    np.testing.assert_allclose(card[0], uniform[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card[1], uniform[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card[0], cpu[0], **TOL)
    np.testing.assert_allclose(card[1], cpu[1], **TOL)


@pytest.mark.cuda
def test_export_mesh_on_the_card_matches_the_cpu(tmp_path):
    """A checkpoint's mesh exported on the card and on the CPU: the alpha
    grids within TOL, the native marching on both, and the same mesh
    (vertices within 1e-4) unless an alpha value lies within 1e-5 of the
    level, where the two devices' rounding may pick different sides."""
    from tensorf_tpu_torch.config import TrainConfig
    from tensorf_tpu_torch.models.config import GridGeometry
    from tensorf_tpu_torch.render.culling import compute_alpha_grid
    from tensorf_tpu_torch.train.loop import export_mesh
    from tensorf_tpu_torch.utils.ckpt import save_checkpoint

    _need_gpu()
    field = _small_field(2, density_shift=-10.0, density_scale=8.0)
    aabb = np.asarray([[-1.5] * 3, [1.5] * 3], np.float32)
    paths = {}
    for dev in ("cpu", "cuda"):
        (tmp_path / dev).mkdir()
        paths[dev] = save_checkpoint(str(tmp_path / dev / "tiny.npz"), field, aabb)
    geometry = GridGeometry.create(aabb, field.grid_size, field.cfg.step_ratio)
    alpha = {dev: compute_alpha_grid(field.to(dev), None, aabb, field.grid_size,
                                     geometry.step_size)[0].cpu().numpy()
             for dev in ("cpu", "cuda")}
    np.testing.assert_allclose(alpha["cuda"], alpha["cpu"], **TOL)
    out = {dev: export_mesh(TrainConfig(), paths[dev], device=dev, log=lambda m: None)
           for dev in ("cpu", "cuda")}
    assert out["cuda"].native and out["cpu"].native and len(out["cuda"].mesh.tris) > 0
    assert os.path.exists(out["cuda"].ply)
    if not np.any(np.abs(alpha["cpu"] - 0.005) <= 1e-5):
        np.testing.assert_array_equal(out["cuda"].mesh.tris, out["cpu"].mesh.tris)
        np.testing.assert_allclose(out["cuda"].mesh.verts, out["cpu"].mesh.verts, rtol=0,
                                   atol=1e-4)


@pytest.mark.cuda
def test_resume_on_the_card(tmp_path):
    """A tiny schedule on the card killed after step 31 and resumed from its
    checkpoint at 30: the resume restores the checkpoint's parameters and
    Adam state exactly, logs the optimizer and sampling state restored, and
    carries the history rows written before the kill."""
    import dataclasses

    from tensorf_tpu_torch.config import TrainConfig
    from tensorf_tpu_torch.convert import optimizer_to_jax, params_to_jax
    from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
    from tensorf_tpu_torch.train.loop import TrainState, reconstruction
    from tensorf_tpu_torch.utils.ckpt import load_opt_leaves

    _need_gpu()
    cfg = TrainConfig(
        basedir=str(tmp_path), dataset_name="blender", model_name="TensorVMSplit",
        shadingMode="MLP_Fea", batch_size=256, n_iters=45, N_voxel_init=16**3,
        N_voxel_final=20**3, upsamp_list=[20], update_AlphaMask_list=[22, 28],
        save_ckpt_every=[30], n_lamb_sigma=[2, 2, 2], n_lamb_sh=[2, 2, 2], data_dim_color=6,
        featureC=16, pos_pe=2, view_pe=2, fea_pe=2, density_shift=-3.0, vis_every=1000,
        train_vis_every=10, render_test=1, progress_refresh_rate=100)
    scene = make_synthetic_scene_arrays(n_train=4, n_test=1, wh=(24, 24), scene="composite")

    class Killed(Exception):
        pass

    def kill(it, state):
        if it == 31:
            raise Killed()

    with pytest.raises(Killed):
        reconstruction(cfg, scene, "cuda", save_images=False, on_step=kill, log=lambda m: None)
    (ckpt,) = tmp_path.glob("*/exp/0k_exp.npz")
    state = TrainState(dataclasses.replace(cfg, resume=1, ckpt_path=str(ckpt)),
                       torch.device("cuda"), scene)
    leaves = load_opt_leaves(str(ckpt))
    assert state.start_iter == 31 and state.restore_optimizer(leaves, lambda m: None)
    data = np.load(ckpt)
    for k, v in params_to_jax(state.field).items():
        np.testing.assert_array_equal(v, data[f"params/{k}"])
    for a, b in zip(optimizer_to_jax(state.optimizer, state.field), leaves):
        np.testing.assert_array_equal(a, b)
    logs = []
    res = reconstruction(dataclasses.replace(cfg, resume=1), scene, "cuda", save_images=False,
                         log=logs.append)
    for want in ("continuing at iteration 31", "optimizer state restored",
                 "sampling state restored"):
        assert any(want in line for line in logs), want
    assert len(res.total_loss) == 14 and np.all(np.isfinite(res.total_loss))
    assert np.isfinite(np.mean(res.final_psnrs))
    hist = np.load(os.path.join(os.path.dirname(res.final_path), "history.npz"))
    assert list(hist["iteration"]) == [10, 20, 30, 40]


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_one_rank():
    """One stratified TensorVMSplit step on two gloo ranks sharing the card
    (each launching the kernel on its half of every scatter's rows) against
    the same step on one rank, from an Adam state in progress (second
    moments 1e-6: the update is smooth in the gradient)."""
    _need_gpu()
    from tensorf_tpu_torch.models import ModelConfig, TensorVMSplit
    from tensorf_tpu_torch.parallel import parity, spawn
    from tensorf_tpu_torch.train.losses import LossWeights
    from tensorf_tpu_torch.train.step import TrainStatics

    cfg = ModelConfig(model_name="TensorVMSplit", density_n_comp=(4, 4, 4),
                      app_n_comp=(6, 6, 6), app_dim=9, shading_mode="MLP_Fea", pos_pe=2,
                      view_pe=2, fea_pe=2, feature_c=32, density_shift=-3.0)
    field = TensorVMSplit(cfg, (32, 32, 32), "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    o = rng.normal(size=(4096, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(4096, 3))
    aabb = np.asarray([[-1.5] * 3, [1.5] * 3], np.float32)
    case = dict(
        model_cfg=cfg, grid=(32, 32, 32),
        params={k: v.numpy() for k, v in field.state_dict().items()}, aabb=aabb,
        mask=(aabb, (rng.uniform(size=(32, 32, 32)) < 0.35).astype(np.float32)),
        statics=TrainStatics(
            n_samples=256, step_size=0.02, white_bg=True, ndc_ray=False, total_steps=100,
            lr_factor=0.999, free_reg=True, free_decomp=True, freq_reg_ratio=0.8,
            shade_top_k=32, strata_budgets=(64, 160, None), strata_n_samples=(128, 256, 256),
            strata_loss_weights=(0.5, 0.3, 0.2), strata_noise_match=True,
            weights=LossWeights(ortho=0.01, l1=8e-5, tv_density=0.01, tv_app=0.01, occ=0.1,
                                occ_range=5, occ_wb_range=12, occ_wb_prior=True)),
        lr=(0.02, 1e-3, 1.0), opt_leaves=parity.adam_in_progress(field),
        rays=np.concatenate([o, d], -1).astype(np.float32),
        rgbs=rng.uniform(size=(4096, 3)).astype(np.float32),
        ids=tuple(rng.choice(4096, size=n, replace=False).astype(np.int32)
                  for n in (1024, 512, 256)),
        step=3, seed=11)
    want = parity.one_step(None, "cuda:0", case)
    got = spawn(parity.one_step, (case,), ["cuda:0", "cuda:0"], timeout_s=600.0,
                collective_timeout_s=300.0)
    assert want["launches"] > 0
    for res in got:
        assert res["launches"] == want["launches"]
        assert sum(res["rows"]) * 2 == sum(want["rows"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(res["params"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    assert got[0]["checksum"] == got[1]["checksum"]
