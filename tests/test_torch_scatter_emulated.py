"""The CUDA source of the row scatter-add (tensorf_tpu_torch/csrc/scatter_add.cu)
run on the CPU: its two entry points, as written, compiled with g++ against
tests/cuda_cpu_emulation.h (a block's threads as std::threads, atomics
counted), against np.add.at, the port's plain version and the TPU kernel it
replaces (scatter_add_banked, in interpret mode).

This is not the card: it checks the kernel's index arithmetic, segments,
tile sorts, run sums and launch sizes for both source types, never their
speed or the hardware's memory model;
tests/test_torch_cuda.py runs the same source on the card.  Tolerance
rtol 1e-5, atol 1e-4: the same sums in another order.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.ops.pallas.scatter_add2 import scatter_add_banked
from tensorf_tpu_torch.ops.scatter_add import KERNEL_SOURCE, scatter_add_reference

TOL = dict(rtol=1e-5, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
# SMs the emulated device reports: few, so small streams still take long
# segments (the launch sizes a card gives streams 16x larger)
SM_COUNT = 8


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    src = (ROOT / KERNEL_SOURCE).read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    src = re.sub(r"asm volatile\(.*?\);", ";", src)
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"cuda_cpu::launch(\1, \2)(", src)
    work = tmp_path_factory.mktemp("scatter_emulated")
    (work / "scatter_add.cpp").write_text(src)
    out = work / "libscatter_emulated.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         "-include", str(ROOT / "tests" / "cuda_cpu_emulation.h"),
         "-o", str(out), str(work / "scatter_add.cpp")],
        check=True, capture_output=True, text=True,
    )
    handle = ctypes.CDLL(str(out))
    handle.cuda_cpu_set_sm_count(SM_COUNT)
    handle.cuda_cpu_reductions.restype = ctypes.c_longlong
    for name in ("tftorch_scatter_add_f32", "tftorch_scatter_add_bf16"):
        fn = getattr(handle, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return handle


def _stream(kind, M, R, rng):
    """uniform rows; sorted runs of 1-40 rows; runs of 1-8 shuffled within
    each 64-row stretch; each 512-row stretch drawn from 32 rows; every
    index on one row."""
    if kind == "uniform":
        return rng.integers(0, R, size=M).astype(np.int32)
    if kind in ("runs", "shuffled"):
        lengths = rng.integers(1, 41 if kind == "runs" else 9, size=M)
        n_runs = int(np.searchsorted(np.cumsum(lengths), M)) + 1
        idx = np.repeat(np.sort(rng.integers(0, R, size=n_runs)), lengths[:n_runs])[:M]
        if kind == "shuffled":
            for start in range(0, M, 64):
                rng.shuffle(idx[start:start + 64])
        return idx.astype(np.int32)
    if kind == "window_dups":
        base = rng.integers(0, R - 32, size=M // 512 + 1)
        return (np.repeat(base, 512)[:M] + rng.integers(0, 32, size=M)).astype(np.int32)
    assert kind == "hot_row", kind
    return np.full(M, R // 2, np.int32)


def _run(lib, entry, idx, g_bits, R, C, offset=0):
    """One call of an entry point on (idx, g) with g's rows starting
    ``offset`` elements past a 16-byte boundary; returns (out, reductions)."""
    M = idx.shape[0]
    item = g_bits.dtype.itemsize
    buf = np.zeros(M * C + 16 // item + offset, g_bits.dtype)
    start = (-buf.ctypes.data // item) % (16 // item) + offset
    buf[start:start + M * C] = g_bits.reshape(-1)
    out = np.full((R, C), np.nan, np.float32)  # the entry point zero-fills it
    lib.cuda_cpu_reductions()
    err = getattr(lib, entry)(idx.ctypes.data, buf.ctypes.data + start * item, out.ctypes.data,
                              M, R, C, None)
    assert err == 0
    return out, lib.cuda_cpu_reductions()


def _bf16_bits(g):
    """g (float32) rounded to bf16: (the bits as uint16, the values as float32)."""
    t = torch.from_numpy(g).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16), t.float().numpy()


def _want(idx, values, R):
    want = np.zeros((R, values.shape[1]), np.float64)
    np.add.at(want, idx, values.astype(np.float64))
    return want


BF16_CASES = [
    # kind, M, R, C, offset (bf16 values past a 16-byte boundary)
    ("runs", 20_003, 512, 64, 0),
    ("shuffled", 20_003, 2000, 192, 0),
    ("window_dups", 30_001, 4096, 64, 0),
    ("uniform", 8_345, 1024, 192, 0),
    ("hot_row", 20_000, 100, 64, 0),
    ("hot_row", 3_001, 100, 5, 0),
    ("runs", 10_007, 300, 12, 0),
    ("runs", 4_099, 7, 5, 0),
    ("shuffled", 7_001, 200, 6, 0),
    ("uniform", 301, 10, 1030, 0),
    ("uniform", 1, 10, 64, 0),
    ("runs", 20_003, 512, 64, 4),
    ("runs", 20_003, 512, 64, 1),
]


@pytest.mark.parametrize(
    "kind,M,R,C,offset", BF16_CASES,
    ids=["runs_C64", "shuffled_C192", "window_dups_C64", "stratum_C192", "hot_row_C64",
         "hot_row_C5", "runs_C12", "runs_C5", "shuffled_C6", "wide_C1030", "M1_C64",
         "8_bytes_off_C64", "2_bytes_off_C64"],
)
def test_bf16_entry_point_matches_add_at_and_plain(lib, kind, M, R, C, offset):
    """Every branch of tftorch_scatter_add_bf16: four-channel columns
    (C % 4 == 0 and g 8-byte aligned, C = 12 among them) and one channel a
    thread (C 5, 6, or g 2 bytes off), tiles sorted and in stream order,
    blocks of one index, rows wider than a block, a single row."""
    rng = np.random.default_rng(11)
    idx = _stream(kind, M, R, rng)
    g = rng.normal(size=(M, C)).astype(np.float32)
    if kind == "hot_row":
        g = np.round(g * 8) / 8  # sums exact in any order
    bits, values = _bf16_bits(g)
    got, _ = _run(lib, "tftorch_scatter_add_bf16", idx, bits, R, C, offset)
    np.testing.assert_allclose(got, _want(idx, values, R), **TOL)
    plain = scatter_add_reference(torch.from_numpy(idx),
                                  torch.from_numpy(g).to(torch.bfloat16), R)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


@pytest.mark.parametrize(
    "kind,M,R,C",
    [("runs", 20_003, 512, 64), ("shuffled", 20_003, 2000, 192), ("hot_row", 20_000, 100, 64),
     ("runs", 4_099, 7, 5)],
    ids=["runs_C64", "shuffled_C192", "hot_row_C64", "runs_C5"],
)
def test_f32_entry_point_matches_add_at(lib, kind, M, R, C):
    """tftorch_scatter_add_f32's float4 and scalar columns, sorted and
    unsorted tiles, a hot row."""
    rng = np.random.default_rng(12)
    idx = _stream(kind, M, R, rng)
    g = rng.normal(size=(M, C)).astype(np.float32)
    if kind == "hot_row":
        g = np.round(g * 8) / 8
    got, _ = _run(lib, "tftorch_scatter_add_f32", idx, g, R, C)
    np.testing.assert_allclose(got, _want(idx, g, R), **TOL)


@pytest.mark.parametrize("C", [64, 192])
def test_bf16_entry_point_matches_scatter_add_banked(lib, C):
    """The TPU kernel on the same bf16 rows (it widens them to float32
    inside): equal sums."""
    rng = np.random.default_rng(13)
    M, R = 6_000, 300
    idx = _stream("shuffled", M, R, rng)
    bits, values = _bf16_bits(rng.normal(size=(M, C)).astype(np.float32))
    got, _ = _run(lib, "tftorch_scatter_add_bf16", idx, bits, R, C)
    banked = scatter_add_banked(jnp.asarray(idx), jnp.asarray(values).astype(jnp.bfloat16), R)
    np.testing.assert_allclose(got, np.asarray(banked), **TOL)


@pytest.mark.parametrize("entry", ["tftorch_scatter_add_f32", "tftorch_scatter_add_bf16"])
def test_hot_row_sends_one_reduction_per_column_per_segment(lib, entry):
    """A hot row: every segment is one run, so each four-channel column
    sends one reduction a segment, in either source type."""
    # at SM_COUNT's launch size: 128-row segments of 16 columns
    M, R, C, seg_rows = 3 * 2048 * 16, 100, 64, 128
    idx = np.full(M, 7, np.int32)
    ones = np.ones((M, C), np.float32)
    g = ones if entry.endswith("f32") else _bf16_bits(ones)[0]
    got, reductions = _run(lib, entry, idx, g, R, C)
    assert got[7, 0] == M and np.count_nonzero(got) == C
    assert reductions == (M // seg_rows) * (C // 4)


@pytest.mark.parametrize("kind", ["uniform", "shuffled", "runs", "hot_row"])
def test_bf16_entry_point_takes_the_float32_segments_and_tiles(lib, kind):
    """Four bf16 channels a thread on the float32 kernel: the float32 entry
    point's columns, segments and tiles, so the same reductions on every
    stream."""
    rng = np.random.default_rng(14)
    M, R, C = 40_000, 1_000_000, 64
    idx = _stream(kind, M, R, rng)
    g = rng.normal(size=(M, C)).astype(np.float32)
    if kind == "hot_row":
        g = np.round(g * 8) / 8
    bits, values = _bf16_bits(g)
    got, bf16_reductions = _run(lib, "tftorch_scatter_add_bf16", idx, bits, R, C)
    _, f32_reductions = _run(lib, "tftorch_scatter_add_f32", idx, values, R, C)
    np.testing.assert_allclose(got, _want(idx, values, R), **TOL)
    assert bf16_reductions == f32_reductions
