// Row scatter-add: out[idx[m], :] += g[m, :], fp32 accumulation.
//
// This is the backward of the footprint plane gather
// (tensorf_tpu_torch/ops/grid_sample.py::footprint_sample_2d): every train
// step launches it six times, once per density plane over the full sample
// lattice and once per appearance plane over the top-K shading samples.
//
// Replaces the TPU kernel tensorf_tpu/ops/pallas/scatter_add2.py::
// scatter_add_banked (pallas_call at :156).  That kernel keeps NB
// accumulator banks of the whole output in on-chip memory across a grid
// that runs in order.  Nothing of that carries over: blocks here run in
// parallel and in no order, and no on-chip memory lives across blocks, so
// each block adds its rows straight into the output with atomics and the
// L2 cache plays the part of the accumulator.
//
// Design (simple first; faster variants are later work): each block takes
// a run of kRowsPerBlock source rows and reads its own indices; the x
// threads of a row stride over the channels, so the loads of g and the
// atomics into out are coalesced (32 neighbouring floats per warp).  The
// atomics are fp32 atomicAdd with unused results (reductions in L2).
// Offsets are 64-bit.  A row whose index lies outside [0, n_rows) is
// dropped, never written: callers pass clipped indices, and the guard only
// keeps a bad index from corrupting memory.
//
// What bounds it on an H100: the bytes the function must move, M*C*4 (g)
// + M*4 (idx) + n_rows*C*4 (the output, written once), against 3.35 TB/s,
// and the L2's atomic throughput on the output rows.  This design moves
// n_rows*C*4 more: the wrapper zero-fills the output before the launch.  At a 128^3
// grid the output tables are 4 MB (density, C = 64) and 12 MB (appearance,
// C = 192) and sit in the 50 MB L2; at 300^3 they are 23 MB and 69 MB and
// only partly fit, so atomics there also go out to device memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kThreadsPerBlock = 256;

__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ g,
                                        float* __restrict__ out,
                                        int64_t n_src, int64_t n_rows,
                                        int n_chan) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t end = first + kRowsPerBlock < n_src ? first + kRowsPerBlock : n_src;
  for (int64_t m = first + threadIdx.y; m < end; m += blockDim.y) {
    const int64_t row = static_cast<int64_t>(idx[m]);
    if (row < 0 || row >= n_rows) continue;
    const float* src = g + m * n_chan;
    float* dst = out + row * n_chan;
    for (int c = threadIdx.x; c < n_chan; c += blockDim.x) {
      atomicAdd(dst + c, __ldg(src + c));
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  idx: (n_src,) int32; g: (n_src, n_chan)
// fp32 row-major; out: (n_rows, n_chan) fp32, zeroed by the caller; stream:
// the caller's cudaStream_t.  Returns cudaGetLastError() after the launch
// (0 = launched).  n_src and n_chan must be positive.
extern "C" int tftorch_scatter_add_f32(const void* idx, const void* g,
                                       void* out, long long n_src,
                                       long long n_rows, int n_chan,
                                       void* stream) {
  if (n_src <= 0 || n_chan <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // x covers the channels in whole warps (at most a full block), y takes
  // several rows at once when the rows are narrow.
  int tx = ((n_chan + 31) / 32) * 32;
  if (tx > kThreadsPerBlock) tx = kThreadsPerBlock;
  int ty = kThreadsPerBlock / tx;
  if (ty < 1) ty = 1;
  const long long blocks = (n_src + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  scatter_add_rows_kernel<<<static_cast<unsigned int>(blocks), dim3(tx, ty), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(g),
      static_cast<float*>(out), static_cast<int64_t>(n_src),
      static_cast<int64_t>(n_rows), n_chan);
  return static_cast<int>(cudaGetLastError());
}
