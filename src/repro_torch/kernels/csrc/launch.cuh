// The CUDA runtime as the GEMM kernels use it (launches, dynamic shared
// memory, cp.async, thread-block clusters), or, with POSIT_CODEC_HOST
// defined, a host emulation of that part, so that the kernels' sources also
// build with g++ and run on the CPU (tests/test_torch_gemm.py,
// tests/test_torch_quant_gemm.py): every block runs in turn, its CUDA
// threads as fibers that yield at __syncthreads(), and cp.async is a plain
// copy; a cluster's blocks run together, each with its own dynamic shared
// memory, and the cluster barrier is a yield like __syncthreads() (so
// every block of a cluster must run the same barriers in the same order,
// as the skinny kernel's do).  Slow, and only for small shapes.
#pragma once

#ifndef POSIT_CODEC_HOST

#include <cooperative_groups.h>
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

// Thread-block clusters: the barrier of every thread of the cluster (also
// in two halves: arrive, then wait for every thread's arrival), and a
// pointer into the shared memory of the cluster's block `rank` at the
// place of `p` in this block's.
__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
template <class T>
__device__ __forceinline__ T *cluster_map(T *p, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// Launch `kernel` with clusters of `cluster_x` blocks along x.
template <class... P, class... A>
cudaError_t posit_launch_cluster(void (*kernel)(P...), dim3 grid, dim3 block,
                                 size_t smem, cudaStream_t s,
                                 unsigned cluster_x, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

#else  // host emulation

#include <ucontext.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static        // one block at a time (a cluster kernel
                                 // takes dynamic shared memory only)
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
inline float __fmul_rn(float a, float b) { return a * b; }
inline int min(int a, int b) { return a < b ? a : b; }

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

// The CUDA threads of a block (or of every block of a cluster) are fibers
// (ucontext) on the calling host thread.  Each round resumes every live
// fiber until its next __syncthreads() or its end, so no fiber passes a
// barrier before all live ones have reached it.
namespace posit_host {
alignas(16) inline unsigned char dynamic_smem[232448];

struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack{new char[1 << 16]};   // left uninitialised
  dim3 tid, bid;
  unsigned char *smem = nullptr;                      // its block's
  bool done = false;
};
inline ucontext_t scheduler;
inline Fiber *current = nullptr;
inline std::function<void()> body;
inline std::vector<Fiber> fibers;                     // reused by every block
inline std::vector<unsigned char *> cluster_smem;     // by rank in the cluster
inline std::vector<float4> cluster_arena;             // 16-byte aligned

inline void fiber_main() {
  body();
  current->done = true;          // uc_link returns to the scheduler
}

// Runs the blocks `bids` together (one block, or the blocks of a cluster
// by rank), each with `smem` bytes of dynamic shared memory filled with
// garbage, not zeros.
inline void run_blocks(const dim3 &blk, const std::vector<dim3> &bids,
                       size_t smem) {
  const unsigned nt = blk.x * blk.y * blk.z;
  const size_t nb = bids.size();
  unsigned char *base = dynamic_smem;
  const size_t stride = (smem + 15) / 16 * 16;
  if (nb > 1) {
    cluster_arena.assign(stride * nb / 16 + 1, float4{});
    base = reinterpret_cast<unsigned char *>(cluster_arena.data());
  }
  std::memset(base, 0xFF, stride * nb);
  cluster_smem.assign(nb, nullptr);
  for (size_t r = 0; r < nb; ++r) cluster_smem[r] = base + r * stride;
  if (fibers.size() < nt * nb) fibers.resize(nt * nb);
  for (size_t r = 0; r < nb; ++r)
    for (unsigned t = 0; t < nt; ++t) {
      Fiber &f = fibers[r * nt + t];
      f.tid = dim3(t % blk.x, t / blk.x % blk.y, t / (blk.x * blk.y));
      f.bid = bids[r];
      f.smem = cluster_smem[r];
      f.done = false;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = 1 << 16;
      f.ctx.uc_link = &scheduler;
      makecontext(&f.ctx, fiber_main, 0);
    }
  for (bool live = true; live;) {
    live = false;
    for (size_t t = 0; t < nt * nb; ++t) {
      Fiber &f = fibers[t];
      if (f.done) continue;
      current = &f;
      threadIdx = f.tid;
      blockIdx = f.bid;
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
        for (unsigned bx = 0; bx < grid.x; ++bx)
          run_blocks(block, {dim3(bx, by, bz)}, smem);
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
  type *name = reinterpret_cast<type *>(posit_host::current->smem)

inline void cluster_sync() { __syncthreads(); }
inline void cluster_arrive() {}
inline void cluster_wait() { __syncthreads(); }
template <class T>
inline T *cluster_map(T *p, unsigned rank) {
  const auto off = reinterpret_cast<unsigned char *>(p) -
                   posit_host::current->smem;
  return reinterpret_cast<T *>(posit_host::cluster_smem[rank] + off);
}

template <class K, class... A>
cudaError_t posit_launch_cluster(K kernel, dim3 grid, dim3 block, size_t smem,
                                 cudaStream_t, unsigned cluster_x,
                                 A... args) {
  gridDim = grid;
  blockDim = block;
  posit_host::body = [=] { kernel(args...); };
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; bx += cluster_x) {
        std::vector<dim3> bids;
        for (unsigned r = 0; r < cluster_x; ++r)
          bids.push_back(dim3(bx + r, by, bz));
        posit_host::run_blocks(block, bids, smem);
      }
  return cudaSuccess;
}

// As on the card, both addresses must be 16-byte aligned.
inline void cp_async16(float *dst, const float *src, bool pred) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 != 0 ||
      (pred && reinterpret_cast<uintptr_t>(src) % 16 != 0))
    std::abort();
  if (pred) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

#endif
