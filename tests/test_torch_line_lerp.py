"""The line-lerp kernels (tensorf_tpu_torch/csrc/line_lerp.cu) run on the
CPU, compiled with g++ against tests/cuda_cpu_emulation.h (a block's
threads as std::threads), against the port's one-hot read
(ops/grid_sample.py::line_sample_matmul) and the plain gather-lerp
(ops/line_lerp.py::line_lerp_reference); the CPU route of the port's line
reads; the readers of ``line_lerp_roofline_pct``.

This is not the card: it checks the kernels' arithmetic, tap edges, plans
and launch sizes, never their speed or the hardware's memory model;
tests/test_torch_cuda.py runs the same source on the card.  Tolerances:
forward rtol/atol 1e-6 (the kernel's lerp is one FMA after a product, the
plain versions round both products, so the two may differ by an ulp);
gradient rtol 1e-5, atol 1e-5 plus 1e-6 of the largest sum of |terms|
landing on one element (the same float32 sums in another, atomic, order).
"""

import ctypes
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensorf_tpu_torch.models import tensorf
from tensorf_tpu_torch.ops.grid_sample import line_sample_matmul
from tensorf_tpu_torch.ops.line_lerp import (KERNEL_SOURCE, MAX_LEN, line_lerp,
                                             line_lerp_reference)
from tensorf_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
SM_COUNT = 8  # what the emulated device reports: few SMs, few blocks
FWD = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    src = (ROOT / KERNEL_SOURCE).read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    src = re.sub(r"extern __shared__ float (\w+)\[\];", r"float* \1 = cuda_cpu::dynamic_smem();",
                 src)
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"cuda_cpu::launch(\1, \2)(", src)
    work = tmp_path_factory.mktemp("line_lerp_emulated")
    (work / "line_lerp.cpp").write_text(src)
    out = work / "libline_lerp_emulated.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         "-include", str(ROOT / "tests" / "cuda_cpu_emulation.h"),
         "-o", str(out), str(work / "line_lerp.cpp")],
        check=True, capture_output=True, text=True,
    )
    handle = ctypes.CDLL(str(out))
    handle.cuda_cpu_set_sm_count(SM_COUNT)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    handle.tftorch_line_lerp_f32.argtypes = [p, p, ll, p, ll, i, i, p]
    handle.tftorch_line_lerp_f32.restype = ctypes.c_int
    handle.tftorch_line_lerp_grad_f32.argtypes = [p, p, ll, p, ll, i, i, p]
    handle.tftorch_line_lerp_grad_f32.restype = ctypes.c_int
    return handle


def _coords(M, rng):
    """M coordinates: the edges (-1, 1, -0, beyond +-1, a few on texels
    of any line whose L - 1 is even), then samples along rays, in order
    (each ray walks the line by a fraction of a texel a step, some beyond
    [-1, 1])."""
    n = M // 64 + 1
    start = rng.uniform(-1.2, 1.2, size=(n, 1))
    slope = rng.uniform(-0.6, 0.6, size=(n, 1))
    rays = (start + slope * np.linspace(0.0, 1.0, 64)).reshape(-1)
    edges = np.array([-1.0, 1.0, -0.0, 1.5, -1.5, 1e30, -1e30, 0.5, -0.5, 0.0], np.float64)
    return np.concatenate([edges, rays])[:M].astype(np.float32)


def _on_texels(L):
    """A coordinate on each of a few texels, as float32 rounds it."""
    return (2.0 * np.arange(0, L, max(1, L // 7)) / (L - 1) - 1.0).astype(np.float32)


def _strided(coord, k=1):
    """coord as column k of an (M, 3) float32 array: (array, byte pointer,
    stride in floats)."""
    xyz = np.random.default_rng(0).normal(size=(coord.shape[0], 3)).astype(np.float32)
    xyz[:, k] = coord
    return xyz, xyz.ctypes.data + 4 * k, 3


def _forward(lib, line, coord, strided=False):
    M, (L, C) = coord.shape[0], line.shape
    keep, ptr, stride = _strided(coord) if strided else (coord, coord.ctypes.data, 1)
    out = np.full((M, C), np.nan, np.float32)
    assert lib.tftorch_line_lerp_f32(line.ctypes.data, ptr, stride, out.ctypes.data, M, L, C,
                                     None) == 0
    del keep
    return out


def _backward(lib, g, coord, L, strided=False):
    M, C = g.shape
    keep, ptr, stride = _strided(coord) if strided else (coord, coord.ctypes.data, 1)
    d_line = np.full((L, C), np.nan, np.float32)  # the entry point zero-fills it
    assert lib.tftorch_line_lerp_grad_f32(g.ctypes.data, ptr, stride, d_line.ctypes.data, M, L,
                                          C, None) == 0
    del keep
    return d_line


def _plain_grad(read, line, coord, g):
    t = torch.from_numpy(line).clone().requires_grad_()
    read(t, torch.from_numpy(coord)).backward(torch.from_numpy(g))
    return t.grad.numpy()


def _grad_tol(line, coord, g):
    """1e-5 plus 1e-6 of the largest sum of |terms| on one element."""
    abs_sum = _plain_grad(line_lerp_reference, line, coord, np.abs(g))
    return 1e-5 + 1e-6 * float(abs_sum.max())


CASES = [
    # L, C, M: cp384's three lines (C = 96, L 430 and 538), synth_full's
    # density (16) and top-32 appearance (48) lines near 300, a line longer
    # than one slice of shared memory holds whole (1024 x 96), two texels,
    # an odd width (one channel a thread), CP's appearance width (288)
    (538, 96, 6_000), (430, 96, 6_000), (300, 16, 20_000), (300, 48, 5_000),
    (1024, 96, 9_000), (2, 4, 1_000), (37, 5, 3_000), (40, 288, 700),
]
CASE_IDS = ["cp384_538x96", "cp384_430x96", "vm_density_300x16", "vm_app_300x48",
            "long_1024x96", "two_texels", "odd_C5", "wide_C288"]


@pytest.mark.parametrize("L,C,M", CASES, ids=CASE_IDS)
def test_emulated_forward_matches_the_one_hot_and_the_gather(lib, L, C, M):
    """Rows along rays and at the edges: equal to the plain gather-lerp and
    to the one-hot matmul; coordinates on texels read their texel."""
    rng = np.random.default_rng(L * 1000 + C)
    line = rng.normal(size=(L, C)).astype(np.float32)
    coord = np.concatenate([_coords(M, rng), _on_texels(L)])
    got = _forward(lib, line, coord)
    lt, ct = torch.from_numpy(line), torch.from_numpy(coord)
    np.testing.assert_allclose(got, line_lerp_reference(lt, ct).numpy(), **FWD)
    np.testing.assert_allclose(got, line_sample_matmul(lt, ct).numpy(), **FWD)
    # a coordinate whose float32 position lands on a texel (-1 and 1 among
    # them) reads that texel exactly
    one, half = np.float32(1), np.float32(0.5)
    pos = (np.clip(coord, -one, one) + one) * half * np.float32(L - 1)
    on = pos == np.floor(pos)
    assert on[coord == -1.0].all() and on[coord == 1.0].all()
    np.testing.assert_array_equal(got[on], line[pos[on].astype(int)])


@pytest.mark.parametrize("L,C,M", CASES, ids=CASE_IDS)
def test_emulated_backward_matches_the_one_hot_and_the_gather(lib, L, C, M):
    """The line's gradient, summed in shared memory and over blocks: equal
    to autograd's through the gather-lerp and through the one-hot."""
    rng = np.random.default_rng(L * 1000 + C + 1)
    line = rng.normal(size=(L, C)).astype(np.float32)
    coord = np.concatenate([_coords(M, rng), _on_texels(L)])
    g = rng.normal(size=(coord.shape[0], C)).astype(np.float32)
    got = _backward(lib, g, coord, L)
    tol = _grad_tol(line, coord, g)
    np.testing.assert_allclose(got, _plain_grad(line_lerp_reference, line, coord, g),
                               rtol=1e-5, atol=tol)
    np.testing.assert_allclose(got, _plain_grad(line_sample_matmul, line, coord, g),
                               rtol=1e-5, atol=tol)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_coordinates_read_zero_and_give_no_gradient(lib, bad):
    """A row whose coordinate is NaN or +-inf: a zero row, and its g (large
    here) reaches no texel; the finite rows around it are unchanged."""
    rng = np.random.default_rng(3)
    L, C, M = 300, 16, 4_000
    line = rng.normal(size=(L, C)).astype(np.float32)
    coord = _coords(M, rng)
    bad_rows = np.arange(5, M, 37)
    coord[bad_rows] = bad
    out = _forward(lib, line, coord)
    assert not out[bad_rows].any()
    good = np.setdiff1d(np.arange(M), bad_rows)
    np.testing.assert_allclose(out[good], line_lerp_reference(
        torch.from_numpy(line), torch.from_numpy(coord[good])).numpy(), **FWD)
    g = rng.normal(size=(M, C)).astype(np.float32)
    g[bad_rows] = 1e6
    got = _backward(lib, g, coord, L)
    want = _plain_grad(line_lerp_reference, line, coord[good], g[good])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=_grad_tol(line, coord[good], g[good]))
    every = np.full(64, bad, np.float32)
    assert not _forward(lib, line, every).any()
    assert not _backward(lib, np.ones((64, C), np.float32), every, L).any()


@pytest.mark.parametrize("end", [-1, 1], ids=["minus_inf", "plus_inf"])
def test_an_infinite_coordinate_reads_zero_where_the_one_hot_reads_the_end_texel(lib, end):
    """The one place where the two routes of a line read differ: the
    one-hot (the CPU's route, and the JAX package's) clamps +-inf to the
    end texel, the kernel and its plain version read a zero row and give
    no gradient.  NaN reads a zero row in both."""
    rng = np.random.default_rng(9)
    L, C = 300, 16
    line = rng.normal(size=(L, C)).astype(np.float32)
    coord = np.array([end * np.inf, np.nan, 0.25], np.float32)
    one_hot = line_sample_matmul(torch.from_numpy(line), torch.from_numpy(coord)).numpy()
    np.testing.assert_array_equal(one_hot[0], line[0 if end < 0 else -1])
    assert not one_hot[1].any()
    plain = line_lerp_reference(torch.from_numpy(line), torch.from_numpy(coord)).numpy()
    kernel = _forward(lib, line, coord)
    for got in (plain, kernel):
        assert not got[:2].any()
        np.testing.assert_allclose(got[2], one_hot[2], **FWD)
    g = np.ones((3, C), np.float32)
    d_line = _backward(lib, g, coord, L)
    np.testing.assert_allclose(d_line, _plain_grad(line_lerp_reference, line, coord[2:], g[2:]),
                               rtol=1e-5, atol=_grad_tol(line, coord[2:], g[2:]))


def test_a_strided_coordinate_view_reads_in_place(lib):
    """The coordinate as one column of an (M, 3) xyz, read with stride 3:
    the same rows and gradient as the contiguous copy."""
    rng = np.random.default_rng(4)
    L, C, M = 430, 96, 5_000
    line = rng.normal(size=(L, C)).astype(np.float32)
    coord = _coords(M, rng)
    g = rng.normal(size=(M, C)).astype(np.float32)
    np.testing.assert_array_equal(_forward(lib, line, coord, strided=True),
                                  _forward(lib, line, coord))
    np.testing.assert_allclose(_backward(lib, g, coord, L, strided=True),
                               _backward(lib, g, coord, L), rtol=1e-5,
                               atol=_grad_tol(line, coord, g))


def test_the_entry_points_refuse_what_they_cannot_run(lib):
    """No rows, and a line longer than the backward's shared-memory slice
    holds (one channel of MAX_LEN texels is the most): a CUDA error code,
    nothing written."""
    g = np.ones((10, 4), np.float32)
    coord = np.zeros(10, np.float32)
    for M, L, C in [(0, 300, 16), (10, MAX_LEN + 1, 4), (10, 300, 0)]:
        d_line = np.full((max(L, 1), max(C, 1)), 7.0, np.float32)
        assert lib.tftorch_line_lerp_grad_f32(g.ctypes.data, coord.ctypes.data, 1,
                                              d_line.ctypes.data, M, L, C, None) != 0
        assert (d_line == 7.0).all()
    line = np.zeros((3, 4), np.float32)
    assert lib.tftorch_line_lerp_f32(line.ctypes.data, line.ctypes.data, 1, line.ctypes.data, 0,
                                     3, 4, None) != 0
    d_line = _backward(lib, np.ones((10, 1), np.float32), np.zeros(10, np.float32), MAX_LEN)
    # coordinate 0 lies halfway between texels (MAX_LEN - 2) / 2 and MAX_LEN / 2
    half = MAX_LEN // 2
    assert d_line[half - 1, 0] == d_line[half, 0] == 5.0 and d_line.sum() == 10.0


def test_the_backward_sums_many_blocks(lib):
    """Enough rows for many blocks (two rows a texel a block at the least):
    their reductions into the zeroed gradient sum to the plain gradient."""
    rng = np.random.default_rng(5)
    L, C, M = 300, 16, 40_000
    line = rng.normal(size=(L, C)).astype(np.float32)
    coord = _coords(M, rng)
    g = rng.normal(size=(M, C)).astype(np.float32)
    got = _backward(lib, g, coord, L)
    np.testing.assert_allclose(got, _plain_grad(line_lerp_reference, line, coord, g), rtol=1e-5,
                               atol=_grad_tol(line, coord, g))


def test_on_the_cpu_line_lerp_is_the_plain_gather_and_agrees_with_the_one_hot():
    rng = np.random.default_rng(6)
    line = torch.from_numpy(rng.normal(size=(538, 96)).astype(np.float32))
    coord = torch.from_numpy(_coords(3_000, rng)).reshape(30, 100)
    g = torch.from_numpy(rng.normal(size=(30, 100, 96)).astype(np.float32))
    before = line_lerp.launches
    outs, grads = [], []
    for read in (line_lerp, line_lerp_reference, line_sample_matmul):
        t = line.clone().requires_grad_()
        out = read(t, coord)
        out.backward(g)
        outs.append(out.detach().numpy())
        grads.append(t.grad.numpy())
    assert outs[0].shape == (30, 100, 96) and line_lerp.launches == before
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_allclose(outs[0], outs[2], **FWD)
    np.testing.assert_allclose(grads[0], grads[2], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("line,coord", [
    (torch.zeros((8, 4), dtype=torch.bfloat16), torch.zeros(3)),
    (torch.zeros((8, 4)), torch.zeros(3, dtype=torch.float64)),
    (torch.zeros(8), torch.zeros(3)),
    (torch.zeros((0, 4)), torch.zeros(3)),
], ids=["bf16_line", "f64_coord", "1d_line", "empty_line"])
def test_line_lerp_refuses_what_the_kernel_does_not_take(line, coord):
    with pytest.raises(ValueError):
        line_lerp(line, coord)


def test_cpu_reads_keep_the_one_hot_and_record_route_1():
    """On the CPU a float32 read under the one-hot's bounds is the one-hot
    matmul (route 1), the JAX package's arithmetic; no kernel launches."""
    line = torch.randn((300, 16), generator=torch.Generator().manual_seed(7))
    xyz = torch.rand((500, 3), generator=torch.Generator().manual_seed(8)) * 2 - 1
    before = line_lerp.launches
    tracing.take_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tensorf._sample_line_packed(line, xyz[..., 2])
    assert tracing.take_counts()["line"] == [(500, 300, 16, 1)]
    assert line_lerp.launches == before
    torch.testing.assert_close(got, line_sample_matmul(line, xyz[..., 2]), rtol=0, atol=0)


def _metric(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KERNEL_TIMES = {
    "void (anonymous namespace)::line_lerp_fwd_kernel<4>(float const*, float const*)": (10.0, 18),
    "void (anonymous namespace)::line_lerp_bwd_kernel<4>(float const*, float const*)": (25.0, 18),
    "void (anonymous namespace)::line_lerp_fill_kernel(float*, long)": (5.0, 18),
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn": (100.0, 4),
    "void (anonymous namespace)::scatter_add_runs_kernel<float4, float4>": (50.0, 3),
}
READS = [(300_000, 538, 96, 2), (200_000, 430, 96, 2), (20_000, 500, 288, 0),
         (5_000, 300, 16, 1)]


@pytest.mark.parametrize("kind,backward", [("train", True), ("serve", False)])
def test_the_line_lerp_roofline_readers(kind, backward):
    """Route-2 reads' bytes over 3.35 TB/s (forward M*4 + L*C*4 + M*C*4;
    in training the backward's M*4 + M*C*4 + L*C*4 too) over the time of
    the kernels named line_lerp; the taps' (route 0) and the one-hot's
    (route 1) reads and other kernels add nothing."""
    read = _metric(f"line_lerp_roofline_pct.{kind}").read
    ctx = dict(kind=kind, trace=SimpleNamespace(kernels=KERNEL_TIMES),
               port_counts={"line": READS})
    nbytes = 0
    for m, L, c, route in READS:
        if route == 2:
            nbytes += 4 * (m + L * c + m * c) + (4 * (m + m * c + L * c) if backward else 0)
    want = 100.0 * nbytes / 3.35e12 / 40e-6
    assert read(ctx) == pytest.approx(want)
    other = "serve" if kind == "train" else "train"
    assert read(dict(ctx, kind=other)) is None
    assert read(dict(ctx, port_counts={"line": [r for r in READS if r[3] != 2]})) is None
    assert read(dict(ctx, port_counts=None)) is None  # a port without the counters
    no_time = {k: v for k, v in KERNEL_TIMES.items() if "line_lerp" not in k}
    assert read(dict(ctx, trace=SimpleNamespace(kernels=no_time))) is None
