// Posit GEMM for NVIDIA Hopper (sm_90a): a decode pre-pass and a tiled
// FFMA kernel, bit-identical to the first kernel (posit_gemm_simple.cu).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro/kernels/posit_gemm.py::_kernel (pl.pallas_call in
//   _posit_gemm_call), reached through posit_gemm_f32 (f32 accumulator
//   out) and posit_gemm (in-kernel posit encode, optional negate), with its
//   in-kernel decode_split_f32 (here the pre-pass) and encode_posit_f32
//   (here the epilogue).
//
// What it computes.  C = A @ B over sign-extended int32 posit words of one
// format.  Each word decodes exactly to an f32 pair hi + lo (hi: the top 24
// significand bits, lo: the bottom 4; lo is zero for formats of <= 16
// bits).  For every output, ph accumulates Ah*Bh and px accumulates
// Ah*Bl then Al*Bh, each as one fmaf chain over k ascending from +0.  At
// the end of every kc-column chunk (and of K), partial = ph + px is folded
// into an f32 accumulator, plainly (split3) or with a Knuth TwoSum error
// term (split3_comp), and ph, px restart at +0.  Al*Bl (< 2^-48 relative)
// is dropped, as on the TPU.  The result is stored as f32, or negated
// (exactly) and rounded once to posit words.  Any tiling that keeps that
// order per output gives the first kernel's bits.
//
// What bounds it.  The hi plane carries 24 bits, which TF32 and bf16 tensor
// cores do not keep, so the three products run as FFMA on the CUDA cores:
// 6*M*K*N flops at 67 TFLOP/s, 0.0932 ms at (4032, 64, 4032), where the
// bytes (one read of A and B, one write of C) take 0.02 ms.  The first
// kernel reached a third of that bound, for three reasons: every block
// decoded its own strips (63 decodes per word at that shape, ~35 integer
// instructions each), its inner loop issued 16 scalar shared loads per 48
// FFMA (one shared wavefront per load, against 4 FFMA warp-instructions an
// SM issues a clock, caps it near 75 %), and no load overlapped compute.
//
// What the design does about it.
// * Decode once.  decode_planes_kernel decodes A and B into f32 hi/lo
//   planes in one launch (0.52 M decodes instead of 32.5 M at the shape
//   above), reading both operands through any strides.  The planes are
//   K-major (A transposed), with K padded to a multiple of 16 by zero
//   words and the leading dimensions to 4 floats, zeros beyond the edges.
//   Zero words decode to (0, 0); ph and px never hold -0, so the padding's
//   fmaf steps change no bit.  <= 16-bit formats have no lo planes.
// * Register tiles fed at 16 bytes a load.  128 threads (16 x 8; a warp
//   covers 4 x 8) hold a 128 x 32 block tile, 8 x 4 outputs a thread.  Per
//   k a thread loads its 8 A and 4 B values of each plane as 3 float4
//   (LDS.128, one wavefront each per warp): 6 loads for 96 FFMA.  The
//   registers hold ph and px; acc and err exist only where K spans
//   several chunks (template SINGLE false).  At most 168 registers, so
//   three blocks share an SM and one block's prologue and epilogue hide
//   under the others' FFMA (two blocks where all four planes are kept:
//   p32 split3_comp over several chunks).  The first version held 8 x 8 a
//   thread (228 registers, two blocks an SM).  Against the simple kernel
//   in the same chip_smoke.py call (H100 80GB HBM3, 700 W) at (4032, 64,
//   4032) it ran p32e2 split3 1.80x as fast (f32) and 1.35x (fused), and
//   0.99x for the fused split3_comp form; 8 x 4 runs 1.92x, 1.43x and
//   1.36x: the fused forms' integer encode finds more warps to hide under.
// * Overlap.  Stages of 16 K rows (every legal kc is a multiple of 16, so
//   chunk ends fall between stages) are copied with 16-byte cp.async into
//   a ring of 3, zero-filled past the planes' edges, with one
//   __syncthreads() per stage.
// * Epilogue.  Fold, negate, then encode_posit or the f32 store, as the
//   first kernel does; ragged M and N are masked here, with 16-byte stores
//   where the row allows.
//
// * Batches.  A leading batch axis (the reference vmaps the Pallas call,
//   which gives the TPU kernel a batch grid axis) is blockIdx.z of the
//   GEMM, with a batch stride for the output; the planes of matrix z lie
//   one after another.  The pre-pass folds the batch into its z axis as
//   2 * matrix + operand, so a batch of B products is two launches, as
//   one product is.  Each matrix's outputs are the 2-D launch's bits.
//   The batch offsets are a template flag (BATCHED), set only for
//   launches of more than one matrix: with them always compiled in, the
//   2-D kernel had more instructions and ran slower (PERF.md §6, timed by
//   tools/gemm_ab.py), so a 2-D launch runs the unbatched code.
//
// Where it stands (chip_smoke.py, H100 80GB HBM3, 700 W): 0.146 ms for the
// p32e2 split3 f32 form at (4032, 64, 4032), pre-pass included: 64 % of
// the FFMA bound.  Moving the cross terms to bf16 tensor cores would lower
// that bound to the hi x hi FFMA alone (0.031 ms) but change the bits.
//
// Compile without --use_fast_math: the fold relies on IEEE f32 adds
// (__fadd_rn/__fsub_rn) and the products on fmaf, in this order.

#include <cstdint>

#include "launch.cuh"
#include "posit_codec.cuh"

namespace {

using posit_codec::decode_split;
using posit_codec::encode_posit;

constexpr int BK = 16;         // K rows per stage; kc is a multiple of it
constexpr int NSTAGE = 3;      // depth of the cp.async ring
constexpr int THREADS = 128;   // 16 row-threads x 8 column-threads
constexpr int TM = 8;          // rows a thread: ty*4 + i and 64 + ty*4 + i
constexpr int TN = 4;          // columns a thread: tx*4 + j
constexpr int BM = 16 * TM;    // 128
constexpr int BN = 8 * TN;     // 32
constexpr int PT = 32;         // pre-pass tile edge

// Blocks an SM holds: three (<= 168 registers a thread) where a thread
// keeps at most three accumulator planes of 8 x 4 (ph; px with lo planes;
// acc over several K chunks; err for split3_comp), two where it keeps all
// four, which would spill in 168.
template <bool HAS_LO, bool COMP, bool SINGLE>
constexpr int kMinBlocks =
    (HAS_LO ? 2 : 1) + (SINGLE ? 0 : (COMP ? 2 : 1)) > 3 ? 2 : 3;

template <int NBITS>
constexpr int kSmemBytes =
    NSTAGE * (NBITS > 16 ? 2 : 1) * BK * (BM + BN) * (int)sizeof(float);

struct PlaneArgs {
  const int32_t *a, *b;          // A[Z, M, K], B[Z, K, N], element strides
  int64_t saz, sa0, sa1, sbz, sb0, sb1;
  float *a_hi, *a_lo, *b_hi, *b_lo;   // lo: null for <= 16-bit formats
  int m, n, k, k_pad, lda, ldb;
};

struct GemmArgs {
  const float *a_hi, *a_lo, *b_hi, *b_lo;   // planes of decode_planes
  void *c;                       // C[Z, M, N]: batch stride scz, rows ldc
  int m, n, k, k_pad, lda, ldb;
  int64_t scz, ldc;
  int kc, negate;
};

// Plane row r of A holds A[:, r] (so sr = sa1, sc = sa0); of B, B[r, :].
// blockIdx.z is 2 * matrix + operand, (y, x) a 32 x 32 tile of the
// plane.  The tile goes through shared memory so that reads follow the
// source's unit stride and writes the plane's.
template <int NBITS, int ES>
__global__ void __launch_bounds__(256) decode_planes_kernel(const PlaneArgs p) {
  constexpr bool HAS_LO = NBITS > 16;
  __shared__ float t_hi[PT][PT + 1];
  __shared__ float t_lo[HAS_LO ? PT : 1][PT + 1];
  const bool is_a = blockIdx.z % 2 == 0;
  const int64_t z = blockIdx.z / 2;
  const int32_t *src = is_a ? p.a + z * p.saz : p.b + z * p.sbz;
  const int cols = is_a ? p.m : p.n;
  const int ld = is_a ? p.lda : p.ldb;
  const int64_t sr = is_a ? p.sa1 : p.sb0;
  const int64_t sc = is_a ? p.sa0 : p.sb1;
  const int64_t plane = z * p.k_pad * ld;    // planes of matrix z
  float *hi = (is_a ? p.a_hi : p.b_hi) + plane;
  float *lo = HAS_LO ? (is_a ? p.a_lo : p.b_lo) + plane : nullptr;
  const int r0 = blockIdx.y * PT, c0 = blockIdx.x * PT;
  if (r0 >= p.k_pad || c0 >= ld) return;
  const int tx = threadIdx.x % PT, ty = threadIdx.x / PT;
  const bool along_r = sr == 1 && sc != 1;   // source contiguous along k
#pragma unroll
  for (int t = 0; t < PT * PT / 256; ++t) {
    const int i = ty + t * (256 / PT);
    const int lr = along_r ? tx : i, lc = along_r ? i : tx;
    const int r = r0 + lr, c = c0 + lc;
    float h = 0.0f, l = 0.0f;
    if (r < p.k && c < cols) decode_split<NBITS, ES>(src[r * sr + c * sc], h, l);
    t_hi[lr][lc] = h;
    if constexpr (HAS_LO) t_lo[lr][lc] = l;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < PT * PT / 256; ++t) {
    const int i = ty + t * (256 / PT);
    const int r = r0 + i, c = c0 + tx;
    if (r < p.k_pad && c < ld) {
      hi[(int64_t)r * ld + c] = t_hi[i][tx];
      if constexpr (HAS_LO) lo[(int64_t)r * ld + c] = t_lo[i][tx];
    }
  }
}

// Four floats from shared memory in one 16-byte load (LDS.128).
__device__ __forceinline__ void load4(float *dst, const float *src) {
  const float4 v = *reinterpret_cast<const float4 *>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

// One chunk's partial into the accumulator, as the first kernel (and one
// TPU grid step) does it.
template <bool COMP>
__device__ __forceinline__ void fold(float &acc, float &err, float ph,
                                     float px) {
  const float partial = __fadd_rn(ph, px);
  if constexpr (COMP) {                                // Knuth TwoSum
    const float a0 = acc;
    const float s = __fadd_rn(a0, partial);
    const float bp = __fsub_rn(s, a0);
    const float e0 = __fadd_rn(__fsub_rn(a0, __fsub_rn(s, bp)),
                               __fsub_rn(partial, bp));
    err = __fadd_rn(err, e0);
    acc = s;
  } else {
    acc = __fadd_rn(acc, partial);
  }
}

// SINGLE: K fits one chunk (k_pad <= kc), so the only fold is the last,
// done in the epilogue from acc = err = +0.  BATCHED: matrix blockIdx.z of
// a batch, whose planes are rows z * k_pad onward of the batch's planes
// (a row offset of the loads) and whose output starts z * scz on.
template <int NBITS, int ES, bool COMP, bool SINGLE, bool EMIT, bool BATCHED>
__global__ void __launch_bounds__(THREADS,
                                  kMinBlocks<(NBITS > 16), COMP, SINGLE>)
posit_gemm_kernel(const GemmArgs g) {
  constexpr bool HAS_LO = NBITS > 16;
  constexpr int NP = HAS_LO ? 2 : 1;       // planes staged per operand
  constexpr int SA = BK * BM;              // floats of one A plane a stage
  constexpr int SB = BK * BN;
  constexpr int LO = HAS_LO ? TM : 1;      // px only with lo planes
  constexpr int AM = SINGLE ? 1 : TM;      // acc only over several chunks
  constexpr int EM = SINGLE || !COMP ? 1 : TM;
  POSIT_DYNAMIC_SMEM(float, smem);
  float *sa = smem;                        // [NSTAGE][NP][BK][BM]
  float *sb = smem + NSTAGE * NP * SA;     // [NSTAGE][NP][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = g.k_pad / BK;
  const int64_t kz = BATCHED ? (int64_t)blockIdx.z * g.k_pad : 0;
  const int64_t cz = BATCHED ? blockIdx.z * g.scz : 0;

  auto load_stage = [&](int kt) {
    const int slot = kt % NSTAGE;
    const int64_t k0 = kz + (int64_t)kt * BK;
#pragma unroll
    for (int t = 0; t < SA / 4 / THREADS; ++t) {
      const int f = tid + t * THREADS;
      const int r = f / (BM / 4), c = f % (BM / 4) * 4;
      const bool ok = row0 + c < g.lda;
      const int64_t off = ok ? (k0 + r) * g.lda + row0 + c : 0;
      float *dst = sa + slot * NP * SA + r * BM + c;
      cp_async16(dst, g.a_hi + off, ok);
      if constexpr (HAS_LO) cp_async16(dst + SA, g.a_lo + off, ok);
    }
#pragma unroll
    for (int t = 0; t < SB / 4 / THREADS; ++t) {
      const int f = tid + t * THREADS;
      const int r = f / (BN / 4), c = f % (BN / 4) * 4;
      const bool ok = col0 + c < g.ldb;
      const int64_t off = ok ? (k0 + r) * g.ldb + col0 + c : 0;
      float *dst = sb + slot * NP * SB + r * BN + c;
      cp_async16(dst, g.b_hi + off, ok);
      if constexpr (HAS_LO) cp_async16(dst + SB, g.b_lo + off, ok);
    }
  };

  float ph[TM][TN], px[LO][HAS_LO ? TN : 1];
  float acc[AM][SINGLE ? 1 : TN], err[EM][EM == 1 ? 1 : TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      ph[i][j] = 0.0f;
      if constexpr (HAS_LO) px[i][j] = 0.0f;
      if constexpr (!SINGLE) acc[i][j] = 0.0f;
      if constexpr (!SINGLE && COMP) err[i][j] = 0.0f;
    }

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NSTAGE - 2>();           // stage kt has landed (this thread)
    __syncthreads();                       // ... for all; slot kt-1 is free
    if (kt + NSTAGE - 1 < nk) load_stage(kt + NSTAGE - 1);
    cp_async_commit();

    const int slot = kt % NSTAGE;
    const float *as = sa + slot * NP * SA + ty * 4;
    const float *bs = sb + slot * NP * SB + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ah[TM], bh[TN], al[TM], bl[TN];
      load4(ah, as + kk * BM);
      load4(ah + 4, as + kk * BM + 64);
      load4(bh, bs + kk * BN);
      if constexpr (HAS_LO) {
        load4(al, as + SA + kk * BM);
        load4(al + 4, as + SA + kk * BM + 64);
        load4(bl, bs + SB + kk * BN);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          ph[i][j] = fmaf(ah[i], bh[j], ph[i][j]);
          if constexpr (HAS_LO) {
            px[i][j] = fmaf(ah[i], bl[j], px[i][j]);
            px[i][j] = fmaf(al[i], bh[j], px[i][j]);
          }
        }
    }

    if constexpr (!SINGLE) {
      const int k1 = (kt + 1) * BK;        // end of a chunk, or of K
      if (k1 % g.kc == 0 || k1 >= g.k) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float pxv = 0.0f, unused = 0.0f;
            if constexpr (HAS_LO) pxv = px[i][j];
            if constexpr (COMP) fold<true>(acc[i][j], err[i][j], ph[i][j], pxv);
            else fold<false>(acc[i][j], unused, ph[i][j], pxv);
            ph[i][j] = 0.0f;
            if constexpr (HAS_LO) px[i][j] = 0.0f;
          }
      }
    }
  }
  cp_async_wait<0>();

  const bool vec = g.ldc % 4 == 0;         // 16-byte stores where aligned
  const int gc = col0 + tx * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (gr >= g.m) continue;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float a0 = 0.0f, e0 = 0.0f;
      if constexpr (SINGLE) {
        float pxv = 0.0f;
        if constexpr (HAS_LO) pxv = px[i][j];
        fold<COMP>(a0, e0, ph[i][j], pxv);
      } else {
        a0 = acc[i][j];
        if constexpr (COMP) e0 = err[i][j];
      }
      v[j] = COMP ? __fadd_rn(a0, e0) : a0;
      if (g.negate) v[j] = -v[j];                      // exact sign flip
    }
    if constexpr (EMIT) {
      int32_t w[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = encode_posit<NBITS, ES>(v[j]);
      int32_t *out = static_cast<int32_t *>(g.c) + cz + gr * g.ldc + gc;
      if (vec && gc + 3 < g.n) {
        *reinterpret_cast<int4 *>(out) = make_int4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (gc + j < g.n) out[j] = w[j];
      }
    } else {
      float *out = static_cast<float *>(g.c) + cz + gr * g.ldc + gc;
      if (vec && gc + 3 < g.n) {
        *reinterpret_cast<float4 *>(out) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (gc + j < g.n) out[j] = v[j];
      }
    }
  }
}

template <int NBITS, int ES, bool COMP, bool SINGLE, bool EMIT, bool BATCHED>
cudaError_t launch_kernel(const GemmArgs &g, int batch, cudaStream_t s) {
  constexpr int bytes = kSmemBytes<NBITS>;
  // Once per device (not inside a CUDA graph capture after the first call).
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(
        posit_gemm_kernel<NBITS, ES, COMP, SINGLE, EMIT, BATCHED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) attr_set[dev] = true;
  }
  const dim3 grid((g.n + BN - 1) / BN, (g.m + BM - 1) / BM, batch);
  POSIT_LAUNCH(grid, THREADS, bytes, s,
               posit_gemm_kernel<NBITS, ES, COMP, SINGLE, EMIT, BATCHED>)(g);
  return cudaGetLastError();
}

template <int NBITS, int ES, bool COMP, bool SINGLE, bool EMIT>
cudaError_t launch_tiled(const GemmArgs &g, int batch, cudaStream_t s) {
  if (batch > 1)
    return launch_kernel<NBITS, ES, COMP, SINGLE, EMIT, true>(g, batch, s);
  return launch_kernel<NBITS, ES, COMP, SINGLE, EMIT, false>(g, batch, s);
}

// The f32-out kernel depends on the format only through its lo planes.
template <int NBITS, int ES, bool COMP, bool SINGLE>
cudaError_t launch_form(const GemmArgs &g, int batch, bool emit,
                        cudaStream_t s) {
  if (emit) return launch_tiled<NBITS, ES, COMP, SINGLE, true>(g, batch, s);
  if constexpr (NBITS > 16)
    return launch_tiled<32, 2, COMP, SINGLE, false>(g, batch, s);
  else
    return launch_tiled<16, 1, COMP, SINGLE, false>(g, batch, s);
}

template <int NBITS, int ES>
cudaError_t launch_gemm(const GemmArgs &g, int batch, bool comp, bool emit,
                        cudaStream_t s) {
  const bool single = g.k_pad <= g.kc;
  if (comp)
    return single ? launch_form<NBITS, ES, true, true>(g, batch, emit, s)
                  : launch_form<NBITS, ES, true, false>(g, batch, emit, s);
  return single ? launch_form<NBITS, ES, false, true>(g, batch, emit, s)
                : launch_form<NBITS, ES, false, false>(g, batch, emit, s);
}

template <int NBITS, int ES>
cudaError_t launch_planes(const PlaneArgs &p, int batch, cudaStream_t s) {
  const int ld = p.lda > p.ldb ? p.lda : p.ldb;
  const dim3 grid((ld + PT - 1) / PT, (p.k_pad + PT - 1) / PT, 2 * batch);
  POSIT_LAUNCH(grid, 256, 0, s, decode_planes_kernel<NBITS, ES>)(p);
  return cudaGetLastError();
}

bool plane_dims_ok(int batch, int m, int n, int k, int k_pad, int lda,
                   int ldb) {
  return batch >= 1 && batch <= 65535 / 2 && m >= 0 && n >= 0 && k > 0 &&
         k_pad == (k + BK - 1) / BK * BK &&
         lda >= m && lda % 4 == 0 && ldb >= n && ldb % 4 == 0 &&
         (k_pad + PT - 1) / PT <= 65535;
}

}  // namespace

// Formats: 0 = p32e2, 1 = p16e1, 2 = p8e2, 3 = p8e0.  Every entry point
// returns the cudaError_t of its launch (0 on success); 1001 flags an
// unknown format, 1002 bad arguments.

// Decode a batch of A[M, K] and B[K, N] (element strides saz, sa0, sa1 and
// sbz, sb0, sb1; the z strides step from matrix to matrix) into the GEMM's
// planes: per matrix, a_* is [k_pad, lda] (A transposed) and b_* is
// [k_pad, ldb], k_pad = K rounded up to 16, lda >= M and ldb >= N
// multiples of 4, zeros beyond the operands; the batch's planes lie one
// after another.  a_lo and b_lo are not touched for <= 16-bit formats.
extern "C" int posit_decode_planes_launch(
    const void *a, const void *b, int batch, int m, int n, int k,
    int64_t saz, int64_t sa0, int64_t sa1, int64_t sbz, int64_t sb0,
    int64_t sb1, void *a_hi, void *a_lo, void *b_hi, void *b_lo, int k_pad,
    int lda, int ldb, int fmt, void *stream) {
  if (!plane_dims_ok(batch, m, n, k, k_pad, lda, ldb) ||
      (lda == 0 && ldb == 0))
    return 1002;
  if (fmt == 0 && (a_lo == nullptr || b_lo == nullptr)) return 1002;
  const PlaneArgs p{static_cast<const int32_t *>(a),
                    static_cast<const int32_t *>(b), saz, sa0, sa1, sbz, sb0,
                    sb1,
                    static_cast<float *>(a_hi), static_cast<float *>(a_lo),
                    static_cast<float *>(b_hi), static_cast<float *>(b_lo),
                    m, n, k, k_pad, lda, ldb};
  auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_planes<32, 2>(p, batch, s);
    case 1: return launch_planes<16, 1>(p, batch, s);
    case 2: return launch_planes<8, 2>(p, batch, s);
    case 3: return launch_planes<8, 0>(p, batch, s);
    default: return 1001;
  }
}

// For each matrix z of the batch, C[z] = ±(A[z] @ B[z]) from the planes of
// posit_decode_planes_launch, K summed in chunks of kc (a multiple of 16);
// C[z] starts at c + z * scz (elements), rows ldc apart; f32 out, or posit
// words of format fmt when emit_posit.
extern "C" int posit_gemm_launch(const void *a_hi, const void *a_lo,
                                 const void *b_hi, const void *b_lo, void *c,
                                 int batch, int m, int n, int k, int k_pad,
                                 int lda, int ldb, int64_t scz, int64_t ldc,
                                 int fmt, int compensated, int emit_posit,
                                 int negate, int kc, void *stream) {
  if (m <= 0 || n <= 0 || !plane_dims_ok(batch, m, n, k, k_pad, lda, ldb) ||
      ldc < n || (batch > 1 && scz < (int64_t)(m - 1) * ldc + n) ||
      kc <= 0 || kc % BK != 0 || (m + BM - 1) / BM > 65535)
    return 1002;
  if (fmt == 0 && (a_lo == nullptr || b_lo == nullptr)) return 1002;
  const GemmArgs g{static_cast<const float *>(a_hi),
                   static_cast<const float *>(a_lo),
                   static_cast<const float *>(b_hi),
                   static_cast<const float *>(b_lo), c, m, n, k, k_pad, lda,
                   ldb, scz, ldc, kc, negate};
  auto s = static_cast<cudaStream_t>(stream);
  const bool comp = compensated != 0, emit = emit_posit != 0;
  switch (fmt) {
    case 0: return launch_gemm<32, 2>(g, batch, comp, emit, s);
    case 1: return launch_gemm<16, 1>(g, batch, comp, emit, s);
    case 2: return launch_gemm<8, 2>(g, batch, comp, emit, s);
    case 3: return launch_gemm<8, 0>(g, batch, comp, emit, s);
    default: return 1001;
  }
}
