"""The port's row scatter-add (tensorf_tpu_torch/ops/scatter_add.py) against
the TPU kernel it replaces (scatter_add_banked, run in interpret mode as
tests/test_grid_sample.py runs it) and against np.add.at.

Tolerance rtol 1e-5, atol 1e-4, as the JAX package's own kernel test: the
sums are the same but taken in another order.  The CUDA kernel itself runs
only on the card: tests/test_torch_cuda.py holds it against this plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.ops.pallas.scatter_add2 import scatter_add_banked
from tensorf_tpu_torch.ops import grid_sample as tgs
from tensorf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_reference

TOL = dict(rtol=1e-5, atol=1e-4)


def _stream(kind, M, R, rng):
    """Index streams of the shapes the CUDA kernel's branches take: uniform
    rows; sorted runs of random length 1-40 (the density lattice's shape,
    where the kernel sums runs in registers); every index on one row."""
    if kind == "uniform":
        return rng.integers(0, R, size=M).astype(np.int32)
    if kind == "runs":
        lengths = rng.integers(1, 41, size=M)
        n_runs = int(np.searchsorted(np.cumsum(lengths), M)) + 1
        rows = np.sort(rng.integers(0, R, size=n_runs))
        return np.repeat(rows, lengths[:n_runs])[:M].astype(np.int32)
    assert kind == "hot_row", kind
    return np.full(M, R // 2, np.int32)


def _case(seed, M, R, C, kind="uniform"):
    rng = np.random.default_rng(seed)
    idx = _stream(kind, M, R, rng)
    g = rng.normal(size=(M, C)).astype(np.float32)
    want = np.zeros((R, C), np.float64)
    np.add.at(want, idx, g.astype(np.float64))
    return idx, g, want


@pytest.mark.parametrize(
    "kind,M,R,C",
    [
        ("uniform", 2048, 256, 128),
        ("uniform", 2048, 256, 64),
        ("uniform", 2048, 256, 192),
        ("runs", 4099, 256, 64),
        ("runs", 2048, 256, 192),
        ("hot_row", 2048, 256, 64),
        ("runs", 4099, 7, 5),
        ("hot_row", 2048, 7, 5),
        ("runs", 2048, 300, 6),
    ],
    ids=["test_grid_sample_shape", "density_C64", "appearance_C192", "runs_C64",
         "runs_C192", "hot_row_C64", "runs_C5", "hot_row_C5", "runs_C6"],
)
def test_reference_matches_banked_kernel_and_add_at(kind, M, R, C):
    idx, g, want = _case(0, M, R, C, kind)
    got = scatter_add_reference(torch.from_numpy(idx), torch.from_numpy(g), R).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    banked = np.asarray(scatter_add_banked(jnp.asarray(idx), jnp.asarray(g), R))
    np.testing.assert_allclose(got, banked, **TOL)
    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = scatter_add.launches
    np.testing.assert_array_equal(
        scatter_add(torch.from_numpy(idx), torch.from_numpy(g), R).numpy(), got
    )
    assert scatter_add.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    idx = torch.zeros(4, dtype=torch.int32)
    g = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="int32"):
        scatter_add(idx.long(), g, 5)
    with pytest.raises(ValueError, match="float32"):
        scatter_add(idx, g.double(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        scatter_add(idx, torch.zeros(3, 4).T, 5)
    with pytest.raises(ValueError, match="rows"):
        scatter_add(idx[:3], g, 5)
    with pytest.raises(ValueError, match="n_rows"):
        scatter_add(idx, g, 0)


def test_gather_rows_backward_is_the_scatter(rng):
    table = torch.from_numpy(rng.normal(size=(37, 8)).astype(np.float32)).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 37, size=300).astype(np.int32))
    cot = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    rows = tgs.gather_rows(table, idx)
    np.testing.assert_array_equal(rows.detach().numpy(), table.detach().numpy()[idx.numpy()])
    rows.backward(cot)
    np.testing.assert_allclose(
        table.grad.numpy(), scatter_add_reference(idx, cot, 37).numpy(), **TOL
    )

