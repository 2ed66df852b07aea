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
