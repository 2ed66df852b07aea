// Row scatter-add: out[idx[m], :] += g[m, :], fp32 accumulation, for an
// fp32 g (tftorch_scatter_add_f32) or a bf16 g (tftorch_scatter_add_bf16).
//
// This is the backward of the footprint plane gather
// (tensorf_tpu_torch/ops/grid_sample.py::footprint_sample_2d): every train
// step launches it six times, once per density plane over the full sample
// lattice (C = 64) and once per appearance plane over the top-K shading
// samples (C = 192).
//
// Replaces the TPU kernel tensorf_tpu/ops/pallas/scatter_add2.py::
// scatter_add_banked (pallas_call at :156), which takes g of any float
// type, casts it to fp32 inside (g.astype(jnp.float32), :164) and returns
// fp32: so do both entry points here.  That kernel keeps NB
// accumulator banks of the whole output in on-chip memory across a grid
// that runs in order.  Nothing of that carries over: blocks here run in
// parallel and in no order, and no on-chip memory lives across blocks, so
// partial sums go into the output with atomics and the L2 cache plays the
// part of the accumulator.
//
// What bounds it on an H100: bytes.  The function must read g (M*C*4, or
// M*C*2 in bf16) and idx (M*4) once and write the output (n_rows*C*4) once,
// against 3.35 TB/s; its M*C adds are far below the fp32 rate.  The bf16
// entry point is the backward of a model whose grid_dtype is bfloat16: its
// tap gradients arrive in bf16, and reading them as they are halves the
// bytes of g.  At the main path's shapes g
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
//  * bf16 widened on load.  The bf16 entry point runs the same kernel on
//    another source type; see "The bf16 entry point" below.
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
//
// The bf16 entry point.  Each choice below is a reading of `python3
// chip_dev.py scatter` on an NVIDIA H100 80GB HBM3 at its 700 W power
// limit, which times this entry point in turns beside the float32 one on
// the same values widened (ms a call, back to back; streams as
// chip_smoke.py's kernel cases; the designs that were dropped were built
// as extra entry points of this file and timed the same way).
//  * Four channels a thread.  A column is four bf16, read as one 8-byte
//    streamed load (__ldcs of a uint2) and widened to a float4 (a bf16 is
//    the upper half of the fp32 of the same value, so widening is a
//    shift), summed in fp32 and sent as one float4 reduction: the float32
//    entry point's threads, segments and reductions at half its load
//    bytes.  The count of L2 reductions does not depend on g's type (one
//    per four channels per run), and where every row is its own run, as in
//    the appearance streams, they and not the bytes bound the kernel.  The
//    design this replaced, eight channels a thread (one 16-byte load, two
//    float4 reductions a flush, half the threads), read 0.1624 ms on
//    density_128 (1,814,528 x 64) and 0.1538 on appearance_128 (262,144 x
//    192) against 0.1181 and 0.1006 at four channels; 0.3991 against 0.0894
//    on one_row, where its two reductions a flush hit one address.
//  * The float32 kernel itself (launch<float4, Bf16x4>): segments counted
//    in the same four-channel columns, so the launch picks the segment
//    length the float32 one would, and 64-row tiles rank-sorted where their
//    runs average under two rows.  Two additions were tried and dropped.
//    A block-wide bitonic sort of windows of up to 2048 rows finds
//    duplicates across a whole window (on the bf16 path's largest
//    appearance stream, 83,456 x 192, it cut the reductions from 2.66 M to
//    2.10 M) and won on no stream but the hot row in both calls that
//    timed it (0.0315 ms against 0.0307 on that stream, 0.1504 against
//    0.1262 on 1,000,003 uniform rows at C = 64): its barrier stages cost
//    more than the reductions it saves.  A merge of the groups' last runs
//    in shared memory (each hot-row block then sends one reduction a
//    column, not one a segment) read 0.0290 against 0.0894 on one_row, but
//    on the streams of the main path and of the bf16 path it differed from
//    this kernel by 6% at most and in no steady direction over two calls
//    (density_128 0.1216 against 0.1181, the appearance stratum 0.0290
//    against 0.0307, then 0.0267 against 0.0263), and those streams show
//    no hot rows (mean run 2.26 and 1.09 on the bf16 path's strata).
//  * One channel a thread (2-byte loads) where C % 4 != 0 or g is not
//    8-byte aligned.
//  * The fill is kept as it is: on a 83,456 x 192 call the fill grid takes
//    4.2 us and the scatter grid ~23 us of device time (torch.profiler),
//    while the host enqueues a call in 15-30 us, so back-to-back calls
//    (~26 us) wait on the device, and the fill runs under the scatter's
//    loads.
// Readings of this entry point, ms (float32 entry point on the same
// values; share of the bound: g at 2 bytes a value, idx and the output
// once, over 3.35 TB/s): density_128 0.1185 (0.1806; 61%), density_300
// (4,255,744 x 64) 0.2646 (0.4290; 66%), appearance_128 0.1009 (0.1205;
// 34%), appearance_300 (262,144 x 192 into 90,000 rows) 0.1783 (0.2025;
// 29%), the bf16 path's largest strata 0.0269 (0.0347; 50%, appearance)
// and 0.0296 (0.0387; 49%, density 333,824 x 64).  Where a call's bound is
// a few microseconds (C = 12, odd C) its fixed cost and its reductions set
// the time, and it is no faster than the float32 entry point.
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

// The bf16 entry point's source columns: four bf16 channels (8 bytes), or
// one.
struct Bf16x4 {
  uint2 bits;
};
struct Bf16 {
  unsigned short bits;
};

// bf16 -> fp32 is exact: the bf16's bits are the fp32's upper half.  A
// 32-bit word holds two bf16, the lower-addressed one in its low half.
__device__ __forceinline__ float bf16_low(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_high(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// A streamed (evict-first) load of one source column, widened to its
// accumulator type.
__device__ __forceinline__ float4 load_stream(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float4 load_stream(const Bf16x4* p) {
  const uint2 w = __ldcs(&p->bits);
  return make_float4(bf16_low(w.x), bf16_high(w.x), bf16_low(w.y), bf16_high(w.y));
}
__device__ __forceinline__ float load_stream(const Bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldcs(&p->bits)) << 16);
}

__device__ __forceinline__ void accumulate(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}
__device__ __forceinline__ void accumulate(float& acc, float v) { acc += v; }

// One reduction into L2: a float4 is one red.global.add.v4.f32.
__device__ __forceinline__ void reduce(float4* p, const float4& v) { atomicAdd(p, v); }
__device__ __forceinline__ void reduce(float* p, float v) { atomicAdd(p, v); }

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
    reduce(out + cur * stride + col, acc);
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

// T is the accumulator of one column: float4 (four channels) or float
// (one); S the column as g stores it: T itself for fp32, Bf16x4 or Bf16
// for bf16.  A block holds `groups` = blockDim.x /
// cols_per_block groups; group j owns source rows
// [s * seg_rows, (s + 1) * seg_rows) of segment s = blockIdx.x * groups + j
// and walks them one tile of `tile` rows at a time.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreadsPerBlock)
scatter_add_runs_kernel(const int32_t* __restrict__ idx, const S* __restrict__ g,
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
      const S* src = g + base * stride + col;
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
bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

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

template <typename T, typename S>
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
  const S* src = static_cast<const S*>(g);
  T* dst = static_cast<T*>(out);
  return launch_pdl(scatter_add_runs_kernel<T, S>, grid, threads, stream, idx, src, dst,
                    static_cast<int64_t>(n_src), static_cast<int64_t>(n_rows), n_cols,
                    cols_per_block, seg_rows, tile);
}

// Zero-fills the (n_rows, n_chan) fp32 output on `stream`; returns the
// launch's CUDA error.
int zero_fill(void* out, long long n_rows, int n_chan, cudaStream_t stream) {
  const long long n_out = n_rows * n_chan;
  long long fill_blocks = (n_out / 4 + kThreadsPerBlock - 1) / kThreadsPerBlock;
  if (fill_blocks > 8LL * sm_count()) fill_blocks = 8LL * sm_count();
  if (fill_blocks < 1) fill_blocks = 1;
  zero_fill_kernel<<<static_cast<unsigned int>(fill_blocks), kThreadsPerBlock, 0, stream>>>(
      static_cast<float*>(out), static_cast<int64_t>(n_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  idx: (n_src,) int32; g: (n_src, n_chan)
// row-major, fp32 (tftorch_scatter_add_f32) or bf16
// (tftorch_scatter_add_bf16); out: (n_rows, n_chan) fp32, zero-filled here;
// stream: the caller's cudaStream_t.  Returns the first CUDA error of the
// fill or the scatter's launch (0 = both enqueued).  n_src, n_rows and
// n_chan must be positive.
extern "C" int tftorch_scatter_add_f32(const void* idx, const void* g, void* out,
                                       long long n_src, long long n_rows, int n_chan,
                                       void* stream) {
  if (n_src <= 0 || n_chan <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fill = zero_fill(out, n_rows, n_chan, s);
  if (fill != 0) return fill;
  const int32_t* index = static_cast<const int32_t*>(idx);
  if (n_chan % 4 == 0 && aligned16(g) && aligned16(out)) {
    return launch<float4, float4>(index, g, out, n_src, n_rows, n_chan / 4, s);
  }
  return launch<float, float>(index, g, out, n_src, n_rows, n_chan, s);
}

extern "C" int tftorch_scatter_add_bf16(const void* idx, const void* g, void* out,
                                        long long n_src, long long n_rows, int n_chan,
                                        void* stream) {
  if (n_src <= 0 || n_chan <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fill = zero_fill(out, n_rows, n_chan, s);
  if (fill != 0) return fill;
  const int32_t* index = static_cast<const int32_t*>(idx);
  if (n_chan % 4 == 0 && aligned8(g) && aligned16(out)) {
    return launch<float4, Bf16x4>(index, g, out, n_src, n_rows, n_chan / 4, s);
  }
  return launch<float, Bf16>(index, g, out, n_src, n_rows, n_chan, s);
}
