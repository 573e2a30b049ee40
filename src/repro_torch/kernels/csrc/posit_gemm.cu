// Posit GEMM for NVIDIA Hopper (sm_90a), with its posit decode/encode
// device functions and their elementwise test kernels.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro/kernels/posit_gemm.py::_kernel (pl.pallas_call in
//   _posit_gemm_call), reached through posit_gemm_f32 (f32 accumulator
//   out) and posit_gemm (in-kernel posit encode, optional negate), and its
//   in-kernel helpers decode_split_f32 (+_floor_log2_i32, _pow2_f32) and
//   encode_posit_f32 (encode_p32_f32 / encode_p16_f32).
//
// What it computes.  C = A @ B over sign-extended int32 posit words of one
// format.  Each word decodes exactly to an f32 pair hi + lo (hi: the top 24
// significand bits, lo: the bottom 4; lo is zero for formats of <= 16
// bits).  Per K chunk of `kc` columns the kernel sums
//     partial = sum(Ah*Bh) + sum(Ah*Bl + Al*Bh)
// and adds it into an f32 accumulator, plainly (split3) or with a Knuth
// TwoSum error term (split3_comp).  Al*Bl (< 2^-48 relative) is dropped, as
// on the TPU.  The final value is either stored as f32 or negated (exactly)
// and rounded once to posit words in the epilogue.
//
// What bounds it.  The exact hi/lo products need full f32 multiplies: TF32
// tensor cores keep 10 mantissa bits and would break the 24-bit hi plane,
// so the products run as FFMA on the CUDA cores.  3 products of 2 flops per
// (m, k, n) against the H100's 67 TFLOP/s FP32 rate make it bound by
// operations at every shape the factorizations issue (the (4032, 64, 4032)
// trailing update moves 67 MB but does 6.2 GFLOP).
//
// What the design does about it.  One 256-thread block per 64x64 output
// tile, 4x4 outputs per thread held in registers; each 16-column K tile of
// A and B is loaded once into shared memory and decoded there once (not
// once per product), so the inner loop is 3 FFMA per output per k fed by
// 4 shared loads per 48 FFMA.  The K loop inside the block takes the place
// of the TPU's sequential grid axis; ragged M, N and K edges are masked in
// the kernel (out-of-range words read as posit zero), so callers do not pad.
// Kept simple on purpose: no wgmma, TMA or software pipelining yet.
//
// The decode/encode device functions live in posit_codec.cuh.  Compile
// without --use_fast_math, so the TwoSum and the f32 adds are neither
// reassociated nor flushed.

#include <cstdint>
#include <cuda_runtime.h>

#include "posit_codec.cuh"

namespace {

using posit_codec::decode_split;
using posit_codec::encode_posit;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;          // K tile staged in shared memory
constexpr int THREADS = 256;    // 16 x 16, each thread 4 x 4 outputs

template <int NBITS, int ES>
__global__ void decode_split_kernel(const int32_t *__restrict__ p,
                                    float *__restrict__ hi,
                                    float *__restrict__ lo, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float h, l;
    decode_split<NBITS, ES>(p[i], h, l);
    hi[i] = h;
    lo[i] = l;
  }
}

template <int NBITS, int ES>
__global__ void encode_posit_kernel(const float *__restrict__ x,
                                    int32_t *__restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = encode_posit<NBITS, ES>(x[i]);
  }
}

// C[M, N] = op(A[M, K] @ B[K, N]); A and B row-major with leading
// dimensions lda and ldb, C contiguous with leading dimension ldc.
template <int NBITS, int ES, bool COMP, bool EMIT>
__global__ void __launch_bounds__(THREADS)
posit_gemm_kernel(const int32_t *__restrict__ A, const int32_t *__restrict__ B,
                  void *__restrict__ C, int M, int N, int K, int64_t lda,
                  int64_t ldb, int64_t ldc, int kc, int negate) {
  constexpr bool HAS_LO = NBITS > 16;    // lo == 0 for <= 16-bit formats
  __shared__ float As_hi[BK][BM + 1];   // +1: conflict-free staging
  __shared__ float Bs_hi[BK][BN];
  __shared__ float As_lo[HAS_LO ? BK : 1][BM + 1];
  __shared__ float Bs_lo[HAS_LO ? BK : 1][BN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4], err[4][4], ph[4][4], px[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.0f; err[i][j] = 0.0f; ph[i][j] = 0.0f; px[i][j] = 0.0f;
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage and decode one K tile: A tile BM x BK (K fastest, coalesced),
    // B tile BK x BN (N fastest); out-of-range words read as posit zero.
#pragma unroll
    for (int t = 0; t < (BM * BK) / THREADS; ++t) {
      const int l = threadIdx.x + t * THREADS;
      const int r = l / BK, c = l % BK;
      const int gr = row0 + r, gc = k0 + c;
      const int32_t w = (gr < M && gc < K) ? A[gr * lda + gc] : 0;
      float h, lo;
      decode_split<NBITS, ES>(w, h, lo);
      As_hi[c][r] = h;
      if constexpr (HAS_LO) As_lo[c][r] = lo;
    }
#pragma unroll
    for (int t = 0; t < (BK * BN) / THREADS; ++t) {
      const int l = threadIdx.x + t * THREADS;
      const int r = l / BN, c = l % BN;
      const int gr = k0 + r, gc = col0 + c;
      const int32_t w = (gr < K && gc < N) ? B[gr * ldb + gc] : 0;
      float h, lo;
      decode_split<NBITS, ES>(w, h, lo);
      Bs_hi[r][c] = h;
      if constexpr (HAS_LO) Bs_lo[r][c] = lo;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ah[4], bh[4], al[4], bl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = As_hi[kk][ty + 16 * i];
        bh[i] = Bs_hi[kk][tx + 16 * i];
        if constexpr (HAS_LO) {
          al[i] = As_lo[kk][ty + 16 * i];
          bl[i] = Bs_lo[kk][tx + 16 * i];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ph[i][j] = fmaf(ah[i], bh[j], ph[i][j]);
          if constexpr (HAS_LO) {
            px[i][j] = fmaf(ah[i], bl[j], px[i][j]);
            px[i][j] = fmaf(al[i], bh[j], px[i][j]);
          }
        }
    }
    __syncthreads();

    // End of a K chunk (every kc columns, and at the end of K): fold the
    // chunk's partial into the accumulator, as one TPU grid step does.
    const int k1 = k0 + BK;
    if (k1 % kc == 0 || k1 >= K) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float partial = __fadd_rn(ph[i][j], px[i][j]);
          if constexpr (COMP) {                        // Knuth TwoSum
            const float a0 = acc[i][j];
            const float s = __fadd_rn(a0, partial);
            const float bp = __fsub_rn(s, a0);
            const float e0 = __fadd_rn(__fsub_rn(a0, __fsub_rn(s, bp)),
                                       __fsub_rn(partial, bp));
            err[i][j] = __fadd_rn(err[i][j], e0);
            acc[i][j] = s;
          } else {
            acc[i][j] = __fadd_rn(acc[i][j], partial);
          }
          ph[i][j] = 0.0f;
          px[i][j] = 0.0f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc >= N) continue;
      float val = COMP ? __fadd_rn(acc[i][j], err[i][j]) : acc[i][j];
      if (negate) val = -val;                          // exact sign flip
      if constexpr (EMIT) {
        static_cast<int32_t *>(C)[gr * ldc + gc] = encode_posit<NBITS, ES>(val);
      } else {
        static_cast<float *>(C)[gr * ldc + gc] = val;
      }
    }
  }
}

template <int NBITS, int ES>
cudaError_t launch_gemm(const int32_t *a, const int32_t *b, void *c, int m,
                        int n, int k, int64_t lda, int64_t ldb, int64_t ldc,
                        int compensated, int emit_posit, int negate, int kc,
                        cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block(THREADS);
  if (compensated && emit_posit)
    posit_gemm_kernel<NBITS, ES, true, true><<<grid, block, 0, stream>>>(
        a, b, c, m, n, k, lda, ldb, ldc, kc, negate);
  else if (compensated)
    posit_gemm_kernel<NBITS, ES, true, false><<<grid, block, 0, stream>>>(
        a, b, c, m, n, k, lda, ldb, ldc, kc, negate);
  else if (emit_posit)
    posit_gemm_kernel<NBITS, ES, false, true><<<grid, block, 0, stream>>>(
        a, b, c, m, n, k, lda, ldb, ldc, kc, negate);
  else
    posit_gemm_kernel<NBITS, ES, false, false><<<grid, block, 0, stream>>>(
        a, b, c, m, n, k, lda, ldb, ldc, kc, negate);
  return cudaGetLastError();
}

// Grid of a grid-stride elementwise launch over n > 0 items.
int grid_for(int64_t n) {
  const int64_t g = (n + 255) / 256;
  return (int)(g < (1 << 20) ? g : (1 << 20));
}

}  // namespace

// Formats: 0 = p32e2, 1 = p16e1, 2 = p8e2, 3 = p8e0.  Every entry point
// returns the cudaError_t of its launch (0 on success); 1001 flags an
// unknown format, 1002 bad arguments.
extern "C" int posit_gemm_launch(const void *a, const void *b, void *c, int m,
                                 int n, int k, int64_t lda, int64_t ldb,
                                 int64_t ldc, int fmt, int compensated,
                                 int emit_posit, int negate, int kc,
                                 void *stream) {
  if (m <= 0 || n <= 0 || k <= 0 || kc <= 0 || kc % BK != 0) return 1002;
  const auto *pa = static_cast<const int32_t *>(a);
  const auto *pb = static_cast<const int32_t *>(b);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_gemm<32, 2>(pa, pb, c, m, n, k, lda, ldb, ldc,
                                      compensated, emit_posit, negate, kc, s);
    case 1: return launch_gemm<16, 1>(pa, pb, c, m, n, k, lda, ldb, ldc,
                                      compensated, emit_posit, negate, kc, s);
    case 2: return launch_gemm<8, 2>(pa, pb, c, m, n, k, lda, ldb, ldc,
                                     compensated, emit_posit, negate, kc, s);
    case 3: return launch_gemm<8, 0>(pa, pb, c, m, n, k, lda, ldb, ldc,
                                     compensated, emit_posit, negate, kc, s);
    default: return 1001;
  }
}

extern "C" int posit_decode_split_launch(const void *p, void *hi, void *lo,
                                         int64_t n, int fmt, void *stream) {
  if (n <= 0) return 1002;
  const auto *pp = static_cast<const int32_t *>(p);
  auto *h = static_cast<float *>(hi);
  auto *l = static_cast<float *>(lo);
  auto s = static_cast<cudaStream_t>(stream);
  const int g = grid_for(n);
  switch (fmt) {
    case 0: decode_split_kernel<32, 2><<<g, 256, 0, s>>>(pp, h, l, n); break;
    case 1: decode_split_kernel<16, 1><<<g, 256, 0, s>>>(pp, h, l, n); break;
    case 2: decode_split_kernel<8, 2><<<g, 256, 0, s>>>(pp, h, l, n); break;
    case 3: decode_split_kernel<8, 0><<<g, 256, 0, s>>>(pp, h, l, n); break;
    default: return 1001;
  }
  return cudaGetLastError();
}

extern "C" int posit_encode_launch(const void *x, void *out, int64_t n,
                                   int fmt, void *stream) {
  if (n <= 0) return 1002;
  const auto *px = static_cast<const float *>(x);
  auto *po = static_cast<int32_t *>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int g = grid_for(n);
  switch (fmt) {
    case 0: encode_posit_kernel<32, 2><<<g, 256, 0, s>>>(px, po, n); break;
    case 1: encode_posit_kernel<16, 1><<<g, 256, 0, s>>>(px, po, n); break;
    case 2: encode_posit_kernel<8, 2><<<g, 256, 0, s>>>(px, po, n); break;
    case 3: encode_posit_kernel<8, 0><<<g, 256, 0, s>>>(px, po, n); break;
    default: return 1001;
  }
  return cudaGetLastError();
}
