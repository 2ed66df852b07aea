// Row scatter-add: out[idx[m], :] += g[m, :], fp32 accumulation.
//
// This is the backward of the footprint plane gather
// (tensorf_tpu_torch/ops/grid_sample.py::footprint_sample_2d): every train
// step launches it six times, once per density plane over the full sample
// lattice (C = 64) and once per appearance plane over the top-K shading
// samples (C = 192).
//
// Replaces the TPU kernel tensorf_tpu/ops/pallas/scatter_add2.py::
// scatter_add_banked (pallas_call at :156).  That kernel keeps NB
// accumulator banks of the whole output in on-chip memory across a grid
// that runs in order.  Nothing of that carries over: blocks here run in
// parallel and in no order, and no on-chip memory lives across blocks, so
// partial sums go into the output with atomics and the L2 cache plays the
// part of the accumulator.
//
// What bounds it on an H100: bytes.  The function must read g (M*C*4) and
// idx (M*4) once and write the output (n_rows*C*4) once, against 3.35 TB/s;
// its M*C adds are far below the fp32 rate.  At the main path's shapes g
// is 16-116x the output, so the kernel is a stream over g whose cost beside
// the stream is the read-modify-writes it sends to L2.
//
// Design, and what each part does about that:
//  * Runs summed in registers.  A group of threads owns a contiguous
//    segment of seg_rows source rows; each thread of the group owns one
//    column (a float4 of channels, or one channel).  It walks the segment
//    and adds rows into a register accumulator while idx stays the same,
//    and sends one reduction to L2 per run.  The density stream comes in
//    sample order along each ray, whose consecutive samples share a plane
//    row (mean run ~3.1), so this cuts its reductions ~3x; a hot row costs
//    one reduction per segment, not one per sample.  A segment that ends
//    inside a run flushes what it holds, so no state crosses threads.
//  * Tiles sorted where runs are short.  The group walks its segment one
//    tile (up to 64 rows) at a time.  The block stages the tile's indices
//    in shared memory; where they hold fewer than two rows per run on
//    average, a stable rank sort makes equal indices adjacent before the
//    walk.  The appearance stream comes in top-K weight order, with runs of
//    ~1.1 but ~32 distinct rows per 64, so the sort cuts its reductions
//    ~1.8x; the density stream keeps its order and skips the sort's cost.
//  * Vector reductions.  Where C % 4 == 0 and g and out are 16-byte
//    aligned, each reduction is one float4 atomicAdd (red.global.add.v4.f32,
//    compute capability 9.x): one 16-byte L2 operation where the scalar
//    version issues four.  Otherwise a scalar path does the same with one
//    channel per thread.
//  * Streamed loads, several in flight.  g is read with 16-byte (or 4-byte)
//    streaming loads (__ldcs, evict-first), so the output table (4 MB at
//    128^3 for density) stays in the 50 MB L2 while the much larger g
//    streams past it.  Each thread issues kUnroll rows' loads before it
//    compares and flushes any of them.
//  * No idle lanes.  Consecutive threads take consecutive columns and a
//    block packs as many segments as fit in kThreadsPerBlock threads, so a
//    narrow row (C = 5: five threads) leaves no warp lanes idle; a row wider
//    than kMaxColsPerBlock columns is split over gridDim.y.
//  * Segment length from the launch size: the longest power of two in
//    [kMinSegRows, kMaxSegRows] that still gives about kThreadsPerSm
//    threads for every SM; longer segments mean fewer flushes (a hot row
//    costs one per segment), shorter ones more threads in flight, which a
//    small launch (odd_C: 65,537 x 5) needs to fill the card at all.
//  * The zero fill overlaps the launch.  The entry point zero-fills out
//    with its own kernel (n_rows*C*4 bytes, the output write the bound
//    counts), launched plainly, so it starts once the kernels before it
//    have finished.  It lets the scatter after it start at once (a
//    programmatic dependent launch): the scatter loads and sorts, and waits
//    for the fill only before its first reduction.
// Offsets are 64-bit.  A row whose index lies outside [0, n_rows) is
// dropped, never written: callers pass clipped indices, and the guard only
// keeps a bad index from corrupting memory.  Atomics sum in no fixed
// order, so results vary in the last bits from run to run.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kUnroll = 8;  // rows whose loads a thread keeps in flight
constexpr int kThreadsPerBlock = 256;
constexpr int kMaxColsPerBlock = 256;
constexpr int kMaxSegRows = 256;
constexpr int kMinSegRows = 4;
constexpr int kThreadsPerSm = 1024;
constexpr int kMaxTile = 64;     // rows sorted together (an order index fits a byte)
constexpr int kSortRows = 2048;  // a block's keys in shared memory: groups * tile

// Waits until the kernel before this one on the stream has finished and
// its writes are visible (Hopper's programmatic dependent launch); at once
// where this one was not launched early.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Lets the kernel launched after this one on the stream start before this
// one ends; that kernel still waits for this one's writes in
// grid_dependency_wait.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ float4 load_stream(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_stream(const float* p) { return __ldcs(p); }

__device__ __forceinline__ void accumulate(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}
__device__ __forceinline__ void accumulate(float& acc, float v) { acc += v; }

// One thread's run of equal indices: rows are added into `acc` while the
// index stays `cur`, and the sum goes to out[cur, col] as one reduction
// when it changes (or at the end).  Indices outside [0, n_rows) are
// dropped.
template <typename T>
struct RunSum {
  T* out;
  int64_t stride;  // columns per output row
  int64_t n_rows;
  int col;
  int32_t cur = -1;     // -1 (dropped) before the first row
  T acc{};
  bool filled = false;  // the zero fill has been waited for

  __device__ __forceinline__ void flush() {
    if (cur < 0 || cur >= n_rows) return;
    if (!filled) {
      grid_dependency_wait();
      filled = true;
    }
    atomicAdd(out + cur * stride + col, acc);
  }
  // Flushes the last run, and waits for the zero fill even where nothing
  // was flushed: thread 0 of the first block always gets here, so the grid
  // never ends before the fill that it follows.
  __device__ __forceinline__ void finish() {
    flush();
    if (!filled) grid_dependency_wait();
  }
  __device__ __forceinline__ void take(int32_t k, const T& v) {
    if (k == cur) {
      accumulate(acc, v);
      return;
    }
    flush();
    cur = k;
    acc = v;
  }
};

// T is float4 (four channels per column) or float (one).  A block holds
// `groups` = blockDim.x / cols_per_block groups; group j owns source rows
// [s * seg_rows, (s + 1) * seg_rows) of segment s = blockIdx.x * groups + j
// and walks them one tile of `tile` rows at a time.
template <typename T>
__global__ void __launch_bounds__(kThreadsPerBlock)
scatter_add_runs_kernel(const int32_t* __restrict__ idx, const T* __restrict__ g,
                        T* __restrict__ out, int64_t n_src, int64_t n_rows, int n_cols,
                        int cols_per_block, int seg_rows, int tile) {
  __shared__ int32_t s_key[kSortRows];
  __shared__ uint8_t s_ord[kSortRows];
  __shared__ int s_bounds;  // run starts among the block's keys of this tile
  const int t = static_cast<int>(threadIdx.x);
  const int groups = static_cast<int>(blockDim.x) / cols_per_block;
  const int grp = t / cols_per_block;
  const int col = static_cast<int>(blockIdx.y) * cols_per_block + t % cols_per_block;
  const int64_t seg0 = static_cast<int64_t>(blockIdx.x) * groups;
  const int64_t m0 = (seg0 + grp) * seg_rows;
  const bool active = col < n_cols && m0 < n_src;
  const int64_t stride = n_cols;
  const int32_t* key = s_key + grp * tile;
  const uint8_t* ord = s_ord + grp * tile;
  RunSum<T> run{out, stride, n_rows, col};

  if (t == 0) s_bounds = 0;
  __syncthreads();
  const int n_keys = groups * tile;
  for (int tile0 = 0; tile0 < seg_rows; tile0 += tile) {
    // the tile's indices of every group (rows past the end sort last), and
    // how many runs they hold in stream order
    int bounds = 0;
    for (int i = t; i < n_keys; i += blockDim.x) {
      const int64_t m = (seg0 + i / tile) * seg_rows + tile0 + i % tile;
      const int32_t k = m < n_src ? __ldg(idx + m) : INT32_MAX;
      s_key[i] = k;
      bounds += m < n_src && (i % tile == 0 || k != __ldg(idx + m - 1));
    }
    if (bounds) atomicAdd(&s_bounds, bounds);
    __syncthreads();
    // a stable rank sort of each group's tile makes equal indices adjacent;
    // it pays where runs are short (mean under 2 rows), as in the
    // appearance stream, whose rows come in top-K weight order
    const bool sort = 2 * s_bounds > n_keys;
    for (int i = t; i < n_keys; i += blockDim.x) {
      const int r = i % tile;
      int rank = r;
      if (sort) {
        const int32_t* k = s_key + (i - r);
        const int32_t mine = k[r];
        rank = 0;
        for (int q = 0; q < tile; ++q) rank += (k[q] < mine) | ((k[q] == mine) & (q < r));
      }
      s_ord[i - r + rank] = static_cast<uint8_t>(r);
    }
    __syncthreads();
    if (t == 0) s_bounds = 0;  // every thread has read it
    if (active) {
      const int64_t base = m0 + tile0;
      const int n = n_src - base < tile ? static_cast<int>(n_src - base) : tile;
      const T* src = g + base * stride + col;
      int i = 0;
      for (; i + kUnroll <= n; i += kUnroll) {
        int32_t k[kUnroll];
        T v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = ord[i + u];
          k[u] = key[r];
          v[u] = load_stream(src + r * stride);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) run.take(k[u], v[u]);
      }
      for (; i < n; ++i) {
        const int r = ord[i];
        run.take(key[r], load_stream(src + r * stride));
      }
    }
    __syncthreads();  // the next tile overwrites the keys
  }
  if (active) run.finish();
}

// Zero-fills out[0, n).  It lets the scatter kernel launched after it on
// the stream start at once (programmatic dependent launch): that kernel
// loads and sorts while the fill runs and waits for it only before its
// first reduction.  The fill itself is launched plainly, so the kernels
// that wrote the scatter's inputs have finished before either starts.
__global__ void __launch_bounds__(kThreadsPerBlock)
zero_fill_kernel(float* __restrict__ out, int64_t n) {
  allow_dependent_launch();
  const int64_t misalign = static_cast<int64_t>(reinterpret_cast<uintptr_t>(out) & 15);
  const int64_t head = ((16 - misalign) & 15) / 4 < n ? ((16 - misalign) & 15) / 4 : n;
  const int64_t n4 = (n - head) / 4;
  float4* body = reinterpret_cast<float4*>(out + head);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = first; i < n4; i += step) body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t done = head + 4 * n4;
  if (first < head) out[first] = 0.f;
  if (first < n - done) out[done + first] = 0.f;
}

int sm_count() {
  static int count = 0;
  if (count <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        count <= 0) {
      count = 132;  // an H100 SXM
    }
  }
  return count;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launches `kernel` on `stream` as a programmatic dependent launch: it may
// start while the kernel enqueued just before it still runs, and waits for
// that kernel's writes in grid_dependency_wait.  Returns the launch's CUDA
// error.
template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), dim3 grid, int threads, cudaStream_t stream,
               Args... args) {
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = overlap;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch(const int32_t* idx, const void* g, void* out, long long n_src, long long n_rows,
           int n_cols, cudaStream_t stream) {
  const int cols_per_block = n_cols < kMaxColsPerBlock ? n_cols : kMaxColsPerBlock;
  const int groups = kThreadsPerBlock / cols_per_block > 0 ? kThreadsPerBlock / cols_per_block : 1;
  const long long want = static_cast<long long>(sm_count()) * kThreadsPerSm;
  auto threads_at = [&](long long seg) { return (n_src + seg - 1) / seg * n_cols; };
  int seg_rows = kMaxSegRows;
  while (seg_rows > kMinSegRows && threads_at(seg_rows) < want) seg_rows /= 2;
  int tile = kMaxTile < seg_rows ? kMaxTile : seg_rows;
  while (tile > 1 && groups * tile > kSortRows) tile /= 2;
  const long long n_seg = (n_src + seg_rows - 1) / seg_rows;
  const long long blocks_x = (n_seg + groups - 1) / groups;
  const long long blocks_y = (n_cols + cols_per_block - 1) / cols_per_block;
  if (blocks_x > 0x7fffffffLL || blocks_y > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned int>(blocks_x), static_cast<unsigned int>(blocks_y));
  const int threads = groups * cols_per_block;
  const T* src = static_cast<const T*>(g);
  T* dst = static_cast<T*>(out);
  return launch_pdl(scatter_add_runs_kernel<T>, grid, threads, stream, idx, src, dst,
                    static_cast<int64_t>(n_src), static_cast<int64_t>(n_rows), n_cols,
                    cols_per_block, seg_rows, tile);
}

}  // namespace

// Plain C entry point for ctypes.  idx: (n_src,) int32; g: (n_src, n_chan)
// fp32 row-major; out: (n_rows, n_chan) fp32, zero-filled here; stream: the
// caller's cudaStream_t.  Returns the first CUDA error of the fill or the
// scatter's launch (0 = both enqueued).  n_src, n_rows and n_chan must be
// positive.
extern "C" int tftorch_scatter_add_f32(const void* idx, const void* g, void* out,
                                       long long n_src, long long n_rows, int n_chan,
                                       void* stream) {
  if (n_src <= 0 || n_chan <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_out = n_rows * n_chan;
  long long fill_blocks = (n_out / 4 + kThreadsPerBlock - 1) / kThreadsPerBlock;
  if (fill_blocks > 8LL * sm_count()) fill_blocks = 8LL * sm_count();
  if (fill_blocks < 1) fill_blocks = 1;
  zero_fill_kernel<<<static_cast<unsigned int>(fill_blocks), kThreadsPerBlock, 0, s>>>(
      static_cast<float*>(out), static_cast<int64_t>(n_out));
  const int fill = static_cast<int>(cudaGetLastError());
  if (fill != 0) return fill;
  const int32_t* index = static_cast<const int32_t*>(idx);
  if (n_chan % 4 == 0 && aligned16(g) && aligned16(out)) {
    return launch<float4>(index, g, out, n_src, n_rows, n_chan / 4, s);
  }
  return launch<float>(index, g, out, n_src, n_rows, n_chan, s);
}
