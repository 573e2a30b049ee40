// The first Hopper posit GEMM (sm_90a), kept as the yardstick of bits and
// time for the tiled kernel in posit_gemm.cu.  No study calls it: only
// the card tests and chip_smoke.py do, through posit_gemm_f32_simple /
// posit_gemm_simple.  The tiled kernel must give its bits.
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
// Design.  One 256-thread block per 64x64 output tile, 4x4 outputs per
// thread held in registers; each 16-column K tile of A and B is loaded
// synchronously into shared memory and decoded there, by every block that
// reads it (63 times per word at (4032, 64, 4032)).  The inner loop makes
// 16 scalar shared loads (4 each of ah, bh, al, bl) for 48 FFMA per
// thread and k, which caps it near 75 % of the FP32 rate; nothing
// overlaps the loads.  Ragged M, N and K edges are masked in the kernel
// (out-of-range words read as posit zero).

#include <cstdint>

#include "launch.cuh"
#include "posit_codec.cuh"

namespace {

using posit_codec::decode_split;
using posit_codec::encode_posit;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;          // K tile staged in shared memory
constexpr int THREADS = 256;    // 16 x 16, each thread 4 x 4 outputs

// C[M, N] = op(A[M, K] @ B[K, N]); A and B row-major with leading
// dimensions lda and ldb, C contiguous with leading dimension ldc.
template <int NBITS, int ES, bool COMP, bool EMIT>
__global__ void __launch_bounds__(THREADS)
posit_gemm_simple_kernel(const int32_t *__restrict__ A,
                         const int32_t *__restrict__ B, void *__restrict__ C,
                         int M, int N, int K, int64_t lda, int64_t ldb,
                         int64_t ldc, int kc, int negate) {
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
cudaError_t launch_simple(const int32_t *a, const int32_t *b, void *c, int m,
                          int n, int k, int64_t lda, int64_t ldb, int64_t ldc,
                          int compensated, int emit_posit, int negate, int kc,
                          cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block(THREADS);
  if (compensated && emit_posit)
    POSIT_LAUNCH(grid, block, 0, stream,
                 posit_gemm_simple_kernel<NBITS, ES, true, true>)(
        a, b, c, m, n, k, lda, ldb, ldc, kc, negate);
  else if (compensated)
    POSIT_LAUNCH(grid, block, 0, stream,
                 posit_gemm_simple_kernel<NBITS, ES, true, false>)(
        a, b, c, m, n, k, lda, ldb, ldc, kc, negate);
  else if (emit_posit)
    POSIT_LAUNCH(grid, block, 0, stream,
                 posit_gemm_simple_kernel<NBITS, ES, false, true>)(
        a, b, c, m, n, k, lda, ldb, ldc, kc, negate);
  else
    POSIT_LAUNCH(grid, block, 0, stream,
                 posit_gemm_simple_kernel<NBITS, ES, false, false>)(
        a, b, c, m, n, k, lda, ldb, ldc, kc, negate);
  return cudaGetLastError();
}

}  // namespace

// Formats: 0 = p32e2, 1 = p16e1, 2 = p8e2, 3 = p8e0.  Returns the
// cudaError_t of the launch (0 on success); 1001 flags an unknown format,
// 1002 bad arguments.
extern "C" int posit_gemm_simple_launch(const void *a, const void *b, void *c,
                                        int m, int n, int k, int64_t lda,
                                        int64_t ldb, int64_t ldc, int fmt,
                                        int compensated, int emit_posit,
                                        int negate, int kc, void *stream) {
  if (m <= 0 || n <= 0 || k <= 0 || kc <= 0 || kc % BK != 0) return 1002;
  const auto *pa = static_cast<const int32_t *>(a);
  const auto *pb = static_cast<const int32_t *>(b);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_simple<32, 2>(pa, pb, c, m, n, k, lda, ldb, ldc,
                                        compensated, emit_posit, negate, kc, s);
    case 1: return launch_simple<16, 1>(pa, pb, c, m, n, k, lda, ldb, ldc,
                                        compensated, emit_posit, negate, kc, s);
    case 2: return launch_simple<8, 2>(pa, pb, c, m, n, k, lda, ldb, ldc,
                                       compensated, emit_posit, negate, kc, s);
    case 3: return launch_simple<8, 0>(pa, pb, c, m, n, k, lda, ldb, ldc,
                                       compensated, emit_posit, negate, kc, s);
    default: return 1001;
  }
}
