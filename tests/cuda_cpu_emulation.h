// Runs a CUDA C++ kernel source on the CPU, for tests on a machine without
// a GPU or nvcc (tests/test_torch_scatter_emulated.py).  Force-included
// ahead of the source (g++ -include), which must first have its
// `kernel<<<grid, block, smem, stream>>>(args)` launches rewritten as
// `cuda_cpu::launch(kernel, grid, block, smem, stream)(args)` and its
// inline PTX (`asm volatile(...)`) removed.
//
// A block's threads are std::threads meeting at a std::barrier for
// __syncthreads; blocks run one after another on the same threads, so
// `__shared__` (here a function-local static) is one block's shared memory
// at a time, and so is a launch's dynamic shared memory
// (`cuda_cpu::dynamic_smem()`, which a test puts in place of the source's
// `extern __shared__` array).  Device memory is host memory.  Atomics take a lock and are
// counted: cuda_cpu_reductions() returns (and clears) the number of float
// and float4 atomicAdds since the last call, the L2 reductions the kernel
// would send.  cuda_cpu_set_sm_count sets what the device reports as its
// SM count, the input of a launch's size arithmetic.
#pragma once

#include <barrier>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x) __attribute__((aligned(x)))
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 {
  float x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
struct uint4 {
  unsigned x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

inline thread_local dim3 threadIdx(0, 0, 0);
inline dim3 blockIdx(0, 0, 0), blockDim(1, 1, 1), gridDim(1, 1, 1);

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaDevAttrMultiProcessorCount = 16,
  cudaLaunchAttributeProgrammaticStreamSerialization = 5,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
struct cudaLaunchAttributeValue {
  int programmaticStreamSerializationAllowed;
};
struct cudaLaunchAttribute {
  int id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

namespace cuda_cpu {
inline std::barrier<>* block_barrier = nullptr;
inline std::mutex atomic_lock;
inline long long reductions = 0;
inline int sm_count = 132;
inline std::vector<float> dynamic_smem_buf;

// The running block's dynamic shared memory.
inline float* dynamic_smem() { return dynamic_smem_buf.data(); }

// Runs `kernel(args...)` over `grid` blocks of `block` threads: block.x
// std::threads take every block in turn.  A thread that returns leaves the
// block's barrier (it waits at none of its later __syncthreads), then all
// meet at the block's end, where the next block's index and barrier are set.
template <typename... P, typename... A>
cudaError_t run(dim3 grid, dim3 block, size_t smem, void (*kernel)(P...), A... args) {
  if (block.x < 1 || block.x > 1024 || grid.y > 65535) return cudaErrorInvalidConfiguration;
  dynamic_smem_buf.assign((smem + sizeof(float) - 1) / sizeof(float), 0.0f);
  gridDim = grid;
  blockDim = block;
  const unsigned long long n_blocks = static_cast<unsigned long long>(grid.x) * grid.y;
  unsigned long long b = 0;
  std::optional<std::barrier<>> in_block;
  auto start = [&]() noexcept {
    blockIdx = dim3(static_cast<unsigned>(b % grid.x), static_cast<unsigned>(b / grid.x), 0);
    in_block.emplace(block.x);
    block_barrier = &*in_block;
  };
  auto next = [&]() noexcept {
    ++b;
    if (b < n_blocks) start();
  };
  start();
  std::barrier<decltype(next)> block_end(block.x, next);
  std::vector<std::thread> threads;
  threads.reserve(block.x);
  for (unsigned t = 0; t < block.x; ++t) {
    threads.emplace_back([&, t] {
      threadIdx = dim3(t, 0, 0);
      while (b < n_blocks) {
        kernel(static_cast<P>(args)...);
        in_block->arrive_and_drop();
        block_end.arrive_and_wait();
      }
    });
  }
  for (auto& th : threads) th.join();
  return cudaSuccess;
}

template <typename... P>
struct Launch {
  void (*kernel)(P...);
  dim3 grid, block;
  size_t smem;
  template <typename... A>
  void operator()(A... args) const {
    run(grid, block, smem, kernel, args...);
  }
};

template <typename... P>
Launch<P...> launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem = 0,
                    cudaStream_t = nullptr) {
  return Launch<P...>{kernel, grid, block, smem};
}
}  // namespace cuda_cpu

template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A... args) {
  return cuda_cpu::run(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, kernel, args...);
}
template <typename K>
cudaError_t cudaFuncSetAttribute(K*, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  *value = cuda_cpu::sm_count;
  return cudaSuccess;
}

inline void __syncthreads() { cuda_cpu::block_barrier->arrive_and_wait(); }
template <typename T>
T __ldg(const T* p) {
  return *p;
}
template <typename T>
T __ldcs(const T* p) {
  return *p;
}
// float32 arithmetic rounded step by step, never contracted into an FMA
// (g++ in an ISO mode contracts nothing)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> hold(cuda_cpu::atomic_lock);
  ++cuda_cpu::reductions;
  const float old = *p;
  *p += v;
  return old;
}
inline float4 atomicAdd(float4* p, float4 v) {
  std::lock_guard<std::mutex> hold(cuda_cpu::atomic_lock);
  ++cuda_cpu::reductions;
  const float4 old = *p;
  p->x += v.x;
  p->y += v.y;
  p->z += v.z;
  p->w += v.w;
  return old;
}

extern "C" long long cuda_cpu_reductions() {
  std::lock_guard<std::mutex> hold(cuda_cpu::atomic_lock);
  const long long n = cuda_cpu::reductions;
  cuda_cpu::reductions = 0;
  return n;
}
extern "C" void cuda_cpu_set_sm_count(int n) { cuda_cpu::sm_count = n; }
