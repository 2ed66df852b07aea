"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without a GPU (a CUDA kernel has no CPU mode).
This file imports neither jax nor tensorf_tpu, so it also runs on a GPU
machine without them; tests/conftest.py imports jax, so run it there as

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerance rtol 1e-5, atol 1e-4: the same sums in another (atomic) order.
"""

import numpy as np
import pytest
import torch

from tensorf_tpu_torch.ops.grid_sample import gather_rows
from tensorf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_reference

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
    together); every index on one row."""
    if kind == "uniform":
        return rng.integers(0, R, size=M).astype(np.int32)
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
