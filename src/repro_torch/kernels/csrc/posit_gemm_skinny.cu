// Skinny-M posit GEMM for NVIDIA Hopper (sm_90a): a posit-quantized linear
// at few activation rows, y = (encode(x) @ words) * 2^sexp, in one launch.
//
// Replaces, on the serving path, the Pallas TPU kernel of the JAX package:
//   repro/kernels/posit_gemm.py::_kernel (pl.pallas_call in
//   _posit_gemm_call) as repro/serving/quantize.py::quant_matmul
//   (backend="pallas") reaches it through posit_gemm_f32 (split3, bk=32),
//   with the activation encode (encode_posit_f32) and the channel scale
//   multiply that surround that call.  The tiled kernel (posit_gemm.cu)
//   computes the same products for every M; this one is for M <= M_max
//   (kernels/posit_gemm.py SKINNY_M_MAX) and formats of <= 16 bits.
//
// What it computes.  For x [M, K] f32, words [K, N] (the stored int16 or
// int8 posit words, sign-extended) and sexp [N] int8, bit for bit
//   posit_gemm_f32(encode_posit_f32(x), words.to(int32), bk=kc,
//                  mode="split3") * 2^sexp
// as the encode kernel, the decode pre-pass and the tiled kernel compute it
// (posit_gemm.cu's header): each activation word is encode_posit of x,
// each operand decodes to its hi value (no lo part at <= 16 bits), each
// output's K range splits into kc-row chunks, a chunk's partial is one
// fmaf(a, b, ph) chain over k ascending from +0, then ph + 0.0f (the
// tiled kernel's ph + px with px = 0), and the partials fold into an f32
// accumulator from +0 in ascending chunk order.  The chains of different
// chunks do not depend on each other, so they can run anywhere on the card;
// only the fold is ordered.  The result is multiplied by 2^sexp (built from
// its exponent bits) in one f32 multiply, as y * scale.
//
// What bounds it.  From the stored words the work is the words once (2 B
// a weight at p16e1), x and y once, and 2*M*K*N flops: at (4, 4864, 896)
// 8.81 MB, 0.0026 ms at 3.35 TB/s, against 0.0010 ms of FFMA at 67
// TFLOP/s.  But every word is decoded once in integer instructions (~20 a
// word), 4.4 M words at that shape, every block encodes its activations
// again, and the fold of a K of 152 chunks is 152 dependent adds: by
// instruction count and latency, not the bytes, is the limit (PERF.md §6
// has the measured times, with parts of the kernel taken out one at a
// time).
//
// What the design does about it (the tiled kernel's grid at M = 4 is 28
// blocks of a 128-row tile, 97 % of its FFMAs on padding rows, after a
// widen of the words and a pre-pass that writes an f32 plane):
// * No padding rows: the rows of a launch are a template MT in {1, 2, 4,
//   8, 16} (the next power of two >= M); M > 16 takes ceil(M / 16) row
//   groups (grid z), each decoding the words again.
// * One thread per column and chunk: a chain of kc words, so a serve shape
//   runs 3,600-136,000 threads.  Four columns a thread (one 8-byte load a
//   row) would leave 128 dependent decodes a thread and 1-4 warps an SM:
//   latency-bound.
// * The words are read as stored: a block copies its tile of words (the
//   pass's rows x 32 or 64 columns) into shared memory with 16-byte
//   cp.async, all issued before the activation encode so that the copy
//   hides under it, where the rows are 16-byte aligned (element by element
//   otherwise).
//   Each word is decoded once, in registers, by posit_codec.cuh's
//   decode_hi: decode_split's hi for a <= 16-bit format, built from the
//   word's bits without a branch (equal to it on every pattern; the tests
//   and chip_smoke.py check that).  Nothing is widened, no plane written.
// * The activations of a block's K range are encoded (encode_posit, the
//   encode kernel's device function) and decoded into shared memory by the
//   block, replacing the separate encode launch.
// * Split K, fold in order: a thread-block cluster of up to 8 blocks along
//   K covers the K range (cluster rank = blockIdx.x: chunks rank*kb on).
//   Column j of the tile is folded by block j % cs: each chain thread
//   stores its partials straight into that block's shared memory
//   (distributed shared memory), and after a cluster barrier one thread
//   per output reads them from its own shared memory, 16 loads ahead, and
//   folds them from +0 in ascending chunk order.  No atomics, no global
//   scratch, one launch, one round of remote accesses (stores, which do
//   not stall the thread) and one barrier after the chains.
// * Tile width: 32 columns a block (fewer where N is), 64 where N >= 512
//   and the block's chunks fit 1024 threads: a serve shape makes 28-532
//   blocks (the tiled kernel gave (4, 896, 128) and (4, 4864, 896) 4 and
//   28), and a wider tile encodes the activations fewer times.
// * Epilogue: the channel scale 2^sexp, one __fmul_rn, the f32 store.

// Compile without --use_fast_math: the chains rely on fmaf and the fold
// and epilogue on IEEE f32 adds and multiplies, in this order.

#include <cstdint>
#include <type_traits>

#include "launch.cuh"
#include "posit_codec.cuh"

namespace {

using posit_codec::decode_hi;
using posit_codec::encode_posit;

constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int SMEM_LIMIT = 232448; // dynamic shared memory a block can use
constexpr int TILE = 32;           // columns a block, at least

// Threads a block: at most 64 registers a thread at 1024; MT = 16 keeps
// its 32 accumulator and activation registers under 512.
template <int MT>
constexpr int kMaxThreads = MT >= 16 ? 512 : 1024;

template <int NBITS>
using Word = std::conditional_t<(NBITS > 8), int16_t, int8_t>;

struct SkinnyArgs {
  const float *x;         // [M, K] activations, rows K apart
  const void *w;          // [K, N] posit words (int16 / int8), rows N apart
  const int8_t *sexp;     // [N] channel scale exponents
  float *y;               // [M, N], rows N apart
  int m, n, k, kc;        // kc: K rows of a chunk
  int nchunk;             // ceil(K / kc)
  int kb;                 // chunks of a block (the cluster's last: fewer)
  int ks;                 // chunk slots of a block: threads = g * ks
  int g;                  // columns of a block
  int npass;              // ceil(kb / ks): chunk slots are reused
  int gq;                 // columns a block folds: ceil(g / cluster)
  int lseg;               // log2(16-byte copies a row), -1: no cp.async
};

// Start copying the words of rows [k0, k0 + rows) of the block's column
// tile into ws ([rows][g] words, zeros past K and N): 16-byte cp.async
// where the rows allow it (lseg >= 0), else element by element.
template <class W>
__device__ __forceinline__ void stage_words(const SkinnyArgs &g, W *ws,
                                            int k0, int rows, int col0) {
  const W *w = static_cast<const W *>(g.w);
  constexpr int PER = 16 / sizeof(W);      // words a cp.async
  if (g.lseg >= 0) {
    for (int i = threadIdx.x; i < rows << g.lseg; i += blockDim.x) {
      const int r = i >> g.lseg, c = (i & ((1 << g.lseg) - 1)) * PER;
      const bool ok = k0 + r < g.k && col0 + c < g.n;
      const W *src = ok ? w + (int64_t)(k0 + r) * g.n + col0 + c : w;
      cp_async16(reinterpret_cast<float *>(ws + r * g.g + c),
                 reinterpret_cast<const float *>(src), ok);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < rows * g.g; i += blockDim.x) {
      const int r = i / g.g, c = i % g.g;
      ws[i] = k0 + r < g.k && col0 + c < g.n
                  ? w[(int64_t)(k0 + r) * g.n + col0 + c] : W(0);
    }
  }
}

// The MT decoded activations of one k from shared memory.
template <int MT>
__device__ __forceinline__ void load_acts(float (&a)[MT], const float *src) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < MT / 4; ++q) {
      const float4 v = reinterpret_cast<const float4 *>(src)[q];
      a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) a[m] = src[m];
  }
}

// Grid: x = the cluster's blocks along K (rank r takes chunks r*kb on),
// y = tiles of g columns, z = row groups of MT rows.  Column j of the tile
// is folded by the cluster's block j % cs, as its local column j / cs.
// Shared memory: the fold's partials ([nchunk][MT][gq], written by every
// block of the cluster), the decoded activations of ks chunks ([ks * kc]
// [MT]) and the words of ks chunks ([ks * kc][g]).  Every block runs the same
// barriers (npass is the cluster's), as the cluster barrier needs.
template <int NBITS, int ES, int MT>
__global__ void __launch_bounds__(kMaxThreads<MT>)
posit_gemm_skinny_kernel(const SkinnyArgs g) {
  using W = Word<NBITS>;
  POSIT_DYNAMIC_SMEM(float, smem);
  cluster_arrive();                         // this block's memory is live
  const int fs = MT * g.gq;                 // partials of a chunk
  const int rows = g.ks * g.kc;             // K rows of a pass
  float *fold = smem;
  float *xa = fold + (g.nchunk * fs + 3) / 4 * 4;   // 16-byte aligned
  W *ws = reinterpret_cast<W *>(xa + rows * MT);

  const int tid = threadIdx.x;
  const int rank = blockIdx.x, cs = gridDim.x;
  const int c_first = rank * g.kb;
  const int nc = min(g.kb, g.nchunk - c_first);
  const int col0 = blockIdx.y * g.g;
  const int row0 = blockIdx.z * MT;
  const int cl = tid % g.g, slot = tid / g.g;
  const int col = col0 + cl;
  // where this thread's partials go: block cl % cs, column cl / cs
  float *dst = cluster_map(fold, cl % cs) + cl / cs;

  for (int pass = 0; pass < g.npass; ++pass) {
    const int k0 = (c_first + pass * g.ks) * g.kc;   // the pass's first row
    stage_words(g, ws, k0, rows, col0);
    // Encode the pass's activations into [row][m] while the words arrive.
    const int k_end = min(g.k, (c_first + nc) * g.kc);
    for (int i = tid; i < MT * rows; i += blockDim.x) {
      const int m = i % MT, kk = k0 + i / MT;
      xa[i] = row0 + m < g.m && kk < k_end
                  ? decode_hi<NBITS, ES>(encode_posit<NBITS, ES>(
                        g.x[(int64_t)(row0 + m) * g.k + kk]))
                  : 0.0f;
    }
    cp_async_wait<0>();
    __syncthreads();
    const int c = pass * g.ks + slot;       // the thread's chunk (local)
    float ph[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) ph[m] = 0.0f;
    const bool chains = c < nc && col < g.n;
    if (chains) {
      const int rows_c = min(g.kc, g.k - (c_first + c) * g.kc);
      const float *xc = xa + slot * g.kc * MT;
      const W *wc = ws + slot * g.kc * g.g + cl;
#pragma unroll 4
      for (int r = 0; r < rows_c; ++r) {   // fmaf(a, b, ph): the tiled order
        const float b = decode_hi<NBITS, ES>(wc[r * g.g]);
        float a[MT];
        load_acts<MT>(a, xc + r * MT);
#pragma unroll
        for (int m = 0; m < MT; ++m) ph[m] = fmaf(a[m], b, ph[m]);
      }
    }
    if (pass == 0) cluster_wait();          // every block has started
    if (chains) {
      float *d = dst + (c_first + c) * fs;
#pragma unroll
      for (int m = 0; m < MT; ++m)          // the chunk's partial
        d[m * g.gq] = __fadd_rn(ph[m], 0.0f);
    }
    __syncthreads();                        // the slots are free again
  }
  cluster_sync();                           // every partial has arrived

  // Fold column rank + cs * (t % gq) of row t / gq from +0, chunks in order.
  for (int t = tid; t < fs; t += blockDim.x) {
    const int m = t / g.gq, j = rank + cs * (t % g.gq);
    const int row = row0 + m, cn = col0 + j;
    if (j < g.g && row < g.m && cn < g.n) {
      const float *f = fold + t;
      float acc = 0.0f;
      int c = 0;
      for (; c + 16 <= g.nchunk; c += 16) { // loads ahead of the adds
        float p[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) p[i] = f[(c + i) * fs];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc = __fadd_rn(acc, p[i]);
      }
      for (; c < g.nchunk; ++c) acc = __fadd_rn(acc, f[c * fs]);
      const uint32_t e = ((uint32_t)((int)g.sexp[cn] + 127)) << 23;
      g.y[(int64_t)row * g.n + cn] =
          __fmul_rn(acc, __int_as_float((int32_t)e));
    }
  }
}

size_t smem_bytes(int kc, int mt, int ks, int nchunk, int g, int gq,
                  int wsize) {
  const size_t rows = (size_t)ks * kc;
  return sizeof(float) * (((size_t)nchunk * mt * gq + 3) / 4 * 4 + rows * mt) +
         (size_t)wsize * rows * g;
}

template <int NBITS, int ES, int MT>
cudaError_t launch_mt(const SkinnyArgs &a, dim3 grid, size_t smem,
                      cudaStream_t s) {
  auto kern = posit_gemm_skinny_kernel<NBITS, ES, MT>;
  // Once per device (not inside a CUDA graph capture after the first call).
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) attr_set[dev] = true;
  }
  e = posit_launch_cluster(kern, grid, dim3(a.g * a.ks), smem, s, grid.x, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int NBITS, int ES>
cudaError_t launch_fmt(const SkinnyArgs &a, dim3 grid, int mt, size_t smem,
                       cudaStream_t s) {
  switch (mt) {
    case 1: return launch_mt<NBITS, ES, 1>(a, grid, smem, s);
    case 2: return launch_mt<NBITS, ES, 2>(a, grid, smem, s);
    case 4: return launch_mt<NBITS, ES, 4>(a, grid, smem, s);
    case 8: return launch_mt<NBITS, ES, 8>(a, grid, smem, s);
    default: return launch_mt<NBITS, ES, 16>(a, grid, smem, s);
  }
}

}  // namespace

// y[M, N] = (encode(x) @ words) * 2^sexp, as posit_gemm_skinny.cu's header
// says: x [M, K] f32 and words [K, N] (int16 for p16e1, int8 for p8e2 and
// p8e0) row-major and contiguous, sexp [N] int8, K summed in chunks of kc
// (a multiple of 16).  Formats: 1 = p16e1, 2 = p8e2, 3 = p8e0; p32e2 (0),
// whose words have a lo part, keeps the tiled kernel.  Returns the
// cudaError_t of the launch (0 on success), 1001 for a format this kernel
// does not take, 1002 for bad arguments.
extern "C" int posit_gemm_skinny_launch(const void *x, const void *w,
                                        const void *sexp, void *y, int m,
                                        int n, int k, int fmt, int kc,
                                        void *stream) {
  if (fmt < 1 || fmt > 3) return 1001;
  if (m <= 0 || n <= 0 || k <= 0 || kc <= 0 || kc % 16 != 0) return 1002;
  const int mt = m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : 16;
  const int zrows = (m + mt - 1) / mt;
  const int nchunk = (k + kc - 1) / kc;
  int cs = nchunk < MAX_CLUSTER ? nchunk : MAX_CLUSTER;
  const int kb = (nchunk + cs - 1) / cs;
  cs = (nchunk + kb - 1) / kb;              // every block has a chunk
  const int max_threads = mt >= 16 ? kMaxThreads<16> : kMaxThreads<1>;
  const int wsize = fmt == 1 ? 2 : 1;
  // 32 columns (fewer where N is), 64 where N is wide and K short
  const int g = n < TILE ? n : n >= 512 && 2 * TILE * kb <= max_threads
                                   ? 2 * TILE : TILE;
  const int gq = (g + cs - 1) / cs;
  int ks = kb < max_threads / g ? kb : max_threads / g;
  while (smem_bytes(kc, mt, ks, nchunk, g, gq, wsize) > (size_t)SMEM_LIMIT) {
    if (ks == 1) return 1002;              // the fold's partials do not fit
    ks = (ks + 1) / 2;
  }
  const int tiles = (n + g - 1) / g;
  if (tiles > 65535 || zrows > 65535) return 1002;
  // 16-byte copies: rows and the tile's columns on 16-byte boundaries
  int lseg = -1;
  if (g * wsize >= 16 && (g & (g - 1)) == 0 && (int64_t)n * wsize % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0)
    for (lseg = 0; (16 << lseg) < g * wsize;) ++lseg;
  const SkinnyArgs a{static_cast<const float *>(x), w,
                     static_cast<const int8_t *>(sexp),
                     static_cast<float *>(y), m, n, k, kc, nchunk, kb, ks, g,
                     (kb + ks - 1) / ks, gq, lseg};
  const size_t smem = smem_bytes(kc, mt, ks, nchunk, g, gq, wsize);
  const dim3 grid(cs, tiles, zrows);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 1: return launch_fmt<16, 1>(a, grid, mt, smem, s);
    case 2: return launch_fmt<8, 2>(a, grid, mt, smem, s);
    default: return launch_fmt<8, 0>(a, grid, mt, smem, s);
  }
}
