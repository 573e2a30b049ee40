// The CUDA runtime as the GEMM kernels use it (launches, dynamic shared
// memory, cp.async), or, with POSIT_CODEC_HOST defined, a host emulation
// of that part, so that the kernels' sources also build with g++ and run
// on the CPU (tests/test_torch_gemm.py): every block runs in turn, its
// CUDA threads as fibers that yield at __syncthreads(), and cp.async is a
// plain copy.  Slow, and only for small shapes.
#pragma once

#ifndef POSIT_CODEC_HOST

#include <cuda_runtime.h>

// POSIT_LAUNCH(grid, block, smem, stream, kernel<...>)(args...)
#define POSIT_LAUNCH(grid, block, smem, stream, ...) \
  __VA_ARGS__<<<grid, block, smem, stream>>>
#define POSIT_DYNAMIC_SMEM(type, name) \
  extern __shared__ __align__(16) type name[]

// 16-byte global -> shared copy; zero-fills when !pred (src-size 0).
__device__ __forceinline__ void cp_async16(float *dst, const float *src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#else  // host emulation

#include <ucontext.h>

#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static        // one block runs at a time
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }

using cudaError_t = int;
using cudaStream_t = void *;
constexpr cudaError_t cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int *dev) {
  *dev = 0;
  return cudaSuccess;
}

inline dim3 threadIdx, blockIdx, gridDim, blockDim;

// The CUDA threads of a block are fibers (ucontext) on the calling host
// thread.  Each round resumes every live fiber until its next
// __syncthreads() or its end, so no fiber passes a barrier before all
// live ones have reached it.
namespace posit_host {
alignas(16) inline unsigned char dynamic_smem[232448];

struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack{new char[1 << 16]};   // left uninitialised
  dim3 tid;
  bool done = false;
};
inline ucontext_t scheduler;
inline Fiber *current = nullptr;
inline std::function<void()> body;
inline std::vector<Fiber> fibers;                     // reused by every block

inline void fiber_main() {
  body();
  current->done = true;          // uc_link returns to the scheduler
}

inline void run_block(unsigned nt, const dim3 &blk) {
  if (fibers.size() < nt) fibers.resize(nt);
  for (unsigned t = 0; t < nt; ++t) {
    Fiber &f = fibers[t];
    f.tid = dim3(t % blk.x, t / blk.x % blk.y, t / (blk.x * blk.y));
    f.done = false;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.get();
    f.ctx.uc_stack.ss_size = 1 << 16;
    f.ctx.uc_link = &scheduler;
    makecontext(&f.ctx, fiber_main, 0);
  }
  for (bool live = true; live;) {
    live = false;
    for (unsigned t = 0; t < nt; ++t) {
      Fiber &f = fibers[t];
      if (f.done) continue;
      current = &f;
      threadIdx = f.tid;
      swapcontext(&scheduler, &f.ctx);
      live = live || !f.done;
    }
  }
}

template <class K>
struct Launch {
  dim3 grid, block;
  size_t smem;
  K kernel;
  template <class... A>
  void operator()(A... args) const {
    gridDim = grid;
    blockDim = block;
    const K kern = kernel;
    body = [=] { kern(args...); };
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          std::memset(dynamic_smem, 0xFF, smem);   // garbage, not zeros
          blockIdx = dim3(bx, by, bz);
          run_block(block.x * block.y * block.z, block);
        }
  }
};
}  // namespace posit_host

inline void __syncthreads() {
  swapcontext(&posit_host::current->ctx, &posit_host::scheduler);
}

#define POSIT_LAUNCH(grid, block, smem, stream, ...)                 \
  posit_host::Launch<decltype(&__VA_ARGS__)>{dim3(grid), dim3(block), \
                                             (size_t)(smem), &__VA_ARGS__}
#define POSIT_DYNAMIC_SMEM(type, name) \
  type *name = reinterpret_cast<type *>(posit_host::dynamic_smem)

inline void cp_async16(float *dst, const float *src, bool pred) {
  if (pred) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

#endif
