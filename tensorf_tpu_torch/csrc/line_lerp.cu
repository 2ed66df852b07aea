// Line lerp: out[m, :] = (1 - w) * line[i0, :] + w * line[i0 + 1, :], and
// its backward into the line, d_line[l, :] += each row's weight on texel l
// times g[m, :], both in float32.
//
// This is the float32 line read of the port's fields on the card
// (tensorf_tpu_torch/models/tensorf.py::_sample_line_packed, through
// ops/line_lerp.py), where the plain version builds an (M, L) one-hot
// matrix with two nonzeros a row and multiplies it by the (L, C) line
// (ops/grid_sample.py::line_sample_matmul; its backward is the transposed
// product).  It replaces no Pallas kernel: the JAX package's one-hot
// (tensorf_tpu/ops/grid_sample.py::line_sample_matmul) is an XLA einsum
// that feeds the TPU's matrix unit.  On an H100 that matrix is a bytes
// problem: its build (compares, selects, an add) and both products each
// pass over M x L float32 values where the read needs two texels a row.
//
// The coordinate: pos = (clamp(c, -1, 1) + 1) * 0.5 * (L - 1), i0 =
// floor(pos), w = pos - i0, each step rounded to float32 as the plain
// version's tensor ops round it, so the two weights are the one-hot's.
// The coordinate is read with its stride (the k-th column of an (M, 3)
// xyz needs no copy).  The upper tap of pos = L - 1 (i0 + 1 = L, weight 0)
// is never read or written, as the one-hot has no column L.  A coordinate
// that is not finite gives a zero row and no gradient.
//
// What bounds it on an H100: bytes.  The forward writes M*C*4 bytes and
// reads the coordinates (M*4) and the line (L*C*4, at most ~1 MB, which
// stays in L2 and L1); its 3*M*C operations are a fraction of a FLOP a
// byte.  The backward reads g (M*C*4) and the coordinates and writes the
// (L, C) gradient; its 4*M*C operations the same.  Design:
//  * Forward: one thread a row's float4 of channels (C % 4 == 0 and the
//    pointers 16-byte aligned; else one channel a thread), consecutive
//    threads on consecutive columns and rows, so the output is written in
//    whole lines; the two taps are read through the read-only cache.
//  * Backward, one block a stretch of rows and a slice of channels: the
//    block keeps its (L, slice) part of the gradient in shared memory
//    (slice chosen from L and C so it fits kSmemBudget), so no sum goes to
//    device memory before the block ends.  Each thread walks a contiguous
//    run of rows (the samples of a ray in order, which walk the line by a
//    fraction of a texel a step) and sums in registers while its tap pair
//    stays put or moves by one texel, sending a sum to shared memory only
//    when a texel is left behind.  Then the block adds its slice into the
//    gradient, which a fill kernel zeroed first: one float4 reduction
//    (red.global.add.v4.f32) for each four channels of a texel it touched.
//    Enough blocks to fill every SM kBlocksPerSm deep, each with at least
//    kRowsPerTexel rows a texel, so the reductions stay under half of g's
//    loads.  The design this replaced wrote each block's slice to a plane
//    of its own and summed the planes in a second kernel, with 8 rows a
//    texel a block (device time, NVIDIA H100 80GB HBM3 at 700 W, against
//    the bytes bound): 97.2 + 4.0 us against 68.6 + 1.4 (fill) at cp384's
//    300,000 x 538 x 96 (bound 34.8), 29.8 + 3.8 against 16.6 + 1.1 at
//    262,144 x 300 x 16 (5.3), 51.1 + 3.0 against 20.5 + 1.1 at 131,072 x
//    300 x 48 (7.7).  Sixteen rows in flight a thread read slower still
//    (110-112 us at cp384's shape: more registers, fewer threads).
//  * Loads of g are streamed (evict-first), kUnroll rows ahead.
// Sums are atomic, in no fixed order: the gradient varies in the last bits
// from run to run.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;  // bytes of one block's (L, slice) gradient
constexpr int kMaxSlice = 256;          // channels a backward block takes
constexpr int kBlocksPerSm = 3;         // backward blocks wanted on each SM
constexpr int kRowsPerTexel = 2;        // rows a backward block takes, per texel at least
constexpr int kUnroll = 8;              // rows whose loads a backward thread keeps in flight
constexpr int kMaxDevices = 64;         // devices whose SM count and opt-in are kept

// The current device in *dev; returns the CUDA error of the query.
int current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *dev >= 0 && *dev < kMaxDevices ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Device dev's SM count in *sms, queried once; returns the CUDA error of
// the query.
int sm_count(int dev, int* sms) {
  static int counts[kMaxDevices] = {};
  if (counts[dev] <= 0) {
    int n = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    counts[dev] = n;
  }
  *sms = counts[dev];
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The two taps of a coordinate: texel i0 with weight w0, texel i0 + 1 with
// w1; `ok` is false for a coordinate that is not finite.
struct Taps {
  int i0;
  float w0, w1;
  bool ok;
};

__device__ __forceinline__ Taps taps_of(float c, int L) {
  Taps t;
  t.ok = fabsf(c) <= FLT_MAX;
  const float x = fminf(fmaxf(c, -1.0f), 1.0f);
  const float pos = __fmul_rn(__fmul_rn(__fadd_rn(x, 1.0f), 0.5f), static_cast<float>(L - 1));
  const float f = floorf(pos);
  t.i0 = static_cast<int>(f);
  t.w1 = __fsub_rn(pos, f);
  t.w0 = __fsub_rn(1.0f, t.w1);
  return t;
}

// V channels of a row: one float4 load, or one float.
__device__ __forceinline__ void load_ro(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_ro(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
__device__ __forceinline__ void load_stream(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_stream(const float* p, float (&v)[1]) { v[0] = __ldcs(p); }
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
// One reduction into device memory: V channels (a float4 is one
// red.global.add.v4.f32).
__device__ __forceinline__ void reduce(float* p, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void reduce(float* p, const float (&v)[1]) { atomicAdd(p, v[0]); }

// One thread a row's V channels: blockDim.x / cols_per_block rows a block,
// columns (of V channels) over gridDim.y.
template <int V>
__global__ void __launch_bounds__(kThreads)
line_lerp_fwd_kernel(const float* __restrict__ line, const float* __restrict__ coord,
                     int64_t coord_stride, float* __restrict__ out, int64_t n_pts, int L, int C,
                     int cols_per_block) {
  const int t = static_cast<int>(threadIdx.x);
  const int rows = static_cast<int>(blockDim.x) / cols_per_block;
  const int col = static_cast<int>(blockIdx.y) * cols_per_block + t % cols_per_block;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * rows + t / cols_per_block;
  if (col * V >= C || m >= n_pts) return;
  const Taps tp = taps_of(__ldg(coord + m * coord_stride), L);
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = 0.0f;
  if (tp.ok) {
    float a[V];
    load_ro(line + static_cast<int64_t>(tp.i0) * C + col * V, a);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __fmul_rn(tp.w0, a[k]);
    if (tp.i0 + 1 < L) {
      load_ro(line + static_cast<int64_t>(tp.i0 + 1) * C + col * V, a);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = fmaf(tp.w1, a[k], v[k]);
    }
  }
  store(out + m * C + col * V, v);
}

// A backward thread's sums for the tap pair (cur, cur + 1) over its run of
// rows; a sum goes to the block's shared (L, slice) gradient when its
// texel is left behind.  Shared layout: texel-major, then channel 4j + k
// of the slice at k * (slice / V) + j, so the V atomics of a flush each
// fall on consecutive banks across the lanes of a row.
template <int V>
struct PairRun {
  float* s;
  int L, slice, j;
  int cur;
  float a0[V], a1[V];

  __device__ __forceinline__ void put(int texel, const float (&a)[V]) {
    if (texel < 0 || texel >= L) return;
    float* p = s + texel * slice + j;
#pragma unroll
    for (int k = 0; k < V; ++k) atomicAdd(p + k * (slice / V), a[k]);
  }
  __device__ __forceinline__ void take(const Taps& tp, const float (&g)[V]) {
    if (!tp.ok) return;
    if (tp.i0 == cur) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a0[k] = fmaf(tp.w0, g[k], a0[k]);
        a1[k] = fmaf(tp.w1, g[k], a1[k]);
      }
      return;
    }
    if (tp.i0 == cur + 1) {  // one texel up: cur is done, cur + 1 carries on
      put(cur, a0);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a0[k] = fmaf(tp.w0, g[k], a1[k]);
        a1[k] = __fmul_rn(tp.w1, g[k]);
      }
    } else if (tp.i0 == cur - 1) {  // one texel down: cur + 1 is done
      put(cur + 1, a1);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a1[k] = fmaf(tp.w1, g[k], a0[k]);
        a0[k] = __fmul_rn(tp.w0, g[k]);
      }
    } else {
      put(cur, a0);
      put(cur + 1, a1);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a0[k] = __fmul_rn(tp.w0, g[k]);
        a1[k] = __fmul_rn(tp.w1, g[k]);
      }
    }
    cur = tp.i0;
  }
  __device__ __forceinline__ void finish() {
    put(cur, a0);
    put(cur + 1, a1);
  }
};

// Block (x, y) takes rows [x * rows_per_block, (x + 1) * rows_per_block)
// and channels [y * slice, (y + 1) * slice) and adds them into d_line;
// thread (r, j) walks the r-th contiguous run of the block's rows on
// channels V*j .. V*j + V - 1 of the slice.
template <int V>
__global__ void __launch_bounds__(kThreads)
line_lerp_bwd_kernel(const float* __restrict__ g, const float* __restrict__ coord,
                     int64_t coord_stride, float* __restrict__ d_line, int64_t n_pts, int L,
                     int C, int slice, int64_t rows_per_block) {
  extern __shared__ float s_grad[];  // (L, slice)
  const int t = static_cast<int>(threadIdx.x);
  const int lanes = slice / V;  // threads a row
  const int n_s = L * slice;
  for (int i = t; i < n_s; i += blockDim.x) s_grad[i] = 0.0f;
  __syncthreads();

  const int c0 = static_cast<int>(blockIdx.y) * slice;
  const int j = t % lanes;
  const int r = t / lanes;
  const int runs = static_cast<int>(blockDim.x) / lanes;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t b1 = b0 + rows_per_block < n_pts ? b0 + rows_per_block : n_pts;
  const int64_t per_run = (rows_per_block + runs - 1) / runs;
  int64_t m = b0 + r * per_run;
  const int64_t end = m + per_run < b1 ? m + per_run : b1;
  if (c0 + V * j < C) {
    PairRun<V> run{s_grad, L, slice, j, -2};
#pragma unroll
    for (int k = 0; k < V; ++k) run.a0[k] = run.a1[k] = 0.0f;
    const float* src = g + c0 + V * j;
    for (; m + kUnroll <= end; m += kUnroll) {
      float c[kUnroll];
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        c[u] = __ldg(coord + (m + u) * coord_stride);
        load_stream(src + (m + u) * C, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) run.take(taps_of(c[u], L), v[u]);
    }
    for (; m < end; ++m) {
      float v[V];
      load_stream(src + m * C, v);
      run.take(taps_of(__ldg(coord + m * coord_stride), L), v);
    }
    run.finish();
  }
  __syncthreads();

  // the slice into d_line: V channels of a texel a reduction, those the
  // block touched (a texel no row reached holds zeros)
  const int width = C - c0 < slice ? C - c0 : slice;
  for (int i = t; i < L * (width / V); i += blockDim.x) {
    const int texel = i / (width / V);
    const int q = i % (width / V);
    const float* src = s_grad + texel * slice + q;
    float v[V];
    bool touched = false;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = src[k * lanes];
      touched |= v[k] != 0.0f;
    }
    if (touched) reduce(d_line + static_cast<int64_t>(texel) * C + c0 + V * q, v);
  }
}

// Zero-fills d_line[0, n) before the backward adds into it.
__global__ void __launch_bounds__(kThreads)
line_lerp_fill_kernel(float* __restrict__ out, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    out[i] = 0.0f;
  }
}

// How the backward cuts its work: channel slices of `slice` (gridDim.y =
// n_y of them) and `blocks_x` stretches of rows.
struct GradPlan {
  int slice, n_y;
  long long blocks_x, rows_per_block;
};

bool grad_plan(long long n_pts, int L, int C, int sms, GradPlan* plan) {
  if (n_pts <= 0 || L <= 0 || C <= 0 || L * 4LL > kSmemBudget || sms <= 0) return false;
  int max_slice = kSmemBudget / (L * 4);
  if (max_slice > kMaxSlice) max_slice = kMaxSlice;
  if (C % 4 == 0 && max_slice >= 4) max_slice -= max_slice % 4;  // whole float4 columns
  plan->n_y = (C + max_slice - 1) / max_slice;
  plan->slice = (C + plan->n_y - 1) / plan->n_y;
  if (C % 4 == 0 && max_slice >= 4) plan->slice += (4 - plan->slice % 4) % 4;
  long long want = (static_cast<long long>(sms) * kBlocksPerSm + plan->n_y - 1) / plan->n_y;
  const long long most = n_pts / (static_cast<long long>(kRowsPerTexel) * L);
  if (want > most) want = most;  // at least kRowsPerTexel rows a texel
  plan->blocks_x = want > 1 ? want : 1;
  plan->rows_per_block = (n_pts + plan->blocks_x - 1) / plan->blocks_x;
  return plan->blocks_x <= 0x7fffffffLL;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <int V>
int launch_grad(const float* g, const float* coord, long long coord_stride, float* d_line,
                long long n_pts, int L, int C, const GradPlan& plan, int dev,
                cudaStream_t stream) {
  const int lanes = plan.slice / V;
  const int runs = kThreads / lanes > 0 ? kThreads / lanes : 1;
  const size_t smem = static_cast<size_t>(L) * plan.slice * sizeof(float);
  auto kernel = line_lerp_bwd_kernel<V>;
  // above 48 KB a block's dynamic shared memory needs the opt-in, once a
  // device
  static bool opted_in[kMaxDevices] = {};
  if (smem > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  const dim3 grid(static_cast<unsigned int>(plan.blocks_x), static_cast<unsigned int>(plan.n_y));
  kernel<<<grid, runs * lanes, smem, stream>>>(g, coord, coord_stride, d_line, n_pts, L, C,
                                               plan.slice, plan.rows_per_block);
  return last_error();
}

}  // namespace

// Plain C entry points for ctypes.  coord: n_pts float32 values, one every
// coord_stride floats; line and d_line: (L, C) row-major float32; out and
// g: (n_pts, C) row-major float32; stream: the caller's cudaStream_t.
// Each returns the first CUDA error of its launches (0 = enqueued).

// out = the lerp of `line` at each coordinate.  n_pts, L and C positive.
extern "C" int tftorch_line_lerp_f32(const void* line, const void* coord, long long coord_stride,
                                     void* out, long long n_pts, int L, int C, void* stream) {
  if (n_pts <= 0 || L <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = C % 4 == 0 && aligned16(line) && aligned16(out);
  const int n_cols = vec ? C / 4 : C;
  const int cols_per_block = n_cols < kThreads ? n_cols : kThreads;
  const int rows = kThreads / cols_per_block;
  const long long blocks_x = (n_pts + rows - 1) / rows;
  const long long blocks_y = (n_cols + cols_per_block - 1) / cols_per_block;
  if (blocks_x > 0x7fffffffLL || blocks_y > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned int>(blocks_x), static_cast<unsigned int>(blocks_y));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ln = static_cast<const float*>(line);
  const float* c = static_cast<const float*>(coord);
  float* o = static_cast<float*>(out);
  if (vec) {
    auto kernel = line_lerp_fwd_kernel<4>;
    kernel<<<grid, rows * cols_per_block, 0, s>>>(ln, c, coord_stride, o, n_pts, L, C,
                                                  cols_per_block);
  } else {
    auto kernel = line_lerp_fwd_kernel<1>;
    kernel<<<grid, rows * cols_per_block, 0, s>>>(ln, c, coord_stride, o, n_pts, L, C,
                                                  cols_per_block);
  }
  return last_error();
}

// d_line = the line's gradient from g, zero-filled here first.  n_pts, L
// and C positive, L * 4 bytes within the shared-memory budget.
extern "C" int tftorch_line_lerp_grad_f32(const void* g, const void* coord,
                                          long long coord_stride, void* d_line, long long n_pts,
                                          int L, int C, void* stream) {
  int dev = 0;
  int sms = 0;
  int err = current_device(&dev);
  if (err == 0) err = sm_count(dev, &sms);
  if (err != 0) return err;
  GradPlan plan;
  if (!grad_plan(n_pts, L, C, sms, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(d_line);
  const long long n = static_cast<long long>(L) * C;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  line_lerp_fill_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      out, static_cast<int64_t>(n));
  err = last_error();
  if (err != 0) return err;
  const float* gf = static_cast<const float*>(g);
  const float* c = static_cast<const float*>(coord);
  const bool vec = C % 4 == 0 && plan.slice % 4 == 0 && aligned16(g) && aligned16(d_line);
  return vec ? launch_grad<4>(gf, c, coord_stride, out, n_pts, L, C, plan, dev, s)
             : launch_grad<1>(gf, c, coord_stride, out, n_pts, L, C, plan, dev, s);
}
