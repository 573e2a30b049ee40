// Elementwise kernels of the posit codec device functions (posit_codec.cuh).
//
// encode_posit_kernel is on the serving path: the paged KV cache encodes
// every K/V row it stores with it (serving/kv_cache.py encode_kv, straight
// into the int16/int8 wire words), and quant_matmul encodes the
// activations of more rows than the skinny kernel takes
// (serving/quantize.py).  decode_split_kernel is a test kernel: the GEMM
// path decodes inside the pre-pass (posit_gemm.cu), and the elementwise
// decode is there so decode_split can be checked exhaustively on the card
// against its plain version, as encode_posit is.
//
// What bounds the encode.  It reads 4 bytes a value and writes 4, 2 or 1:
// at 2^24 values, int32 out, 134 MB, 0.040 ms at the H100's 3.35 TB/s.
// Instructions must stay under that: at 135 SASS instructions a value
// (a field-by-field encode) issuing them alone takes ~68 us at that size.
// The loop issues 27 a value (~14 us; tools/kernel_sass.py) and runs in
// 0.047 ms, 85 % of the byte bound (H100 80GB HBM3, 700 W,
// tools/gemm_ab.py; PERF.md §6).  So:
// * the device function is branch-free integer arithmetic (posit_codec.cuh);
// * 32-bit indices (the launcher takes fewer than 2^31 values; the wrapper
//   splits larger tensors), a grid-stride loop over groups of four: one
//   16-byte load of four floats, four encodes, one store of four words,
//   and the n % 4 tail by the first threads after it;
// * the output width is a template argument (OB = 4, 2 or 1 bytes), so a
//   caller that keeps the narrow wire words gets them from this launch
//   with no cast after it (each word fits its wire dtype, so the narrow
//   word is the int32 word narrowed);
// * pointers that are not aligned to the vector widths take the scalar
//   loop (VEC false), with the same bits.

#include <cstdint>

#include "launch.cuh"
#include "posit_codec.cuh"

namespace {

using posit_codec::decode_split;
using posit_codec::encode_posit;

// The storage of a word of OB bytes, and of four of them.
template <int OB> struct Words;
template <> struct Words<4> { using T = int32_t; using V4 = int4; };
template <> struct Words<2> { using T = int16_t; using V4 = short4; };
template <> struct Words<1> { using T = int8_t; using V4 = char4; };

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

template <int NBITS, int ES, int OB, bool VEC>
__global__ void encode_posit_kernel(const float *__restrict__ x,
                                    void *__restrict__ out_, uint32_t n) {
  using T = typename Words<OB>::T;
  using V4 = typename Words<OB>::V4;
  T *out = static_cast<T *>(out_);
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t stride = gridDim.x * blockDim.x;
  if constexpr (VEC) {
    const uint32_t n4 = n / 4;
    const float4 *x4 = reinterpret_cast<const float4 *>(x);
    V4 *o4 = reinterpret_cast<V4 *>(out);
    for (uint32_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      V4 w;
      w.x = (T)encode_posit<NBITS, ES>(v.x);
      w.y = (T)encode_posit<NBITS, ES>(v.y);
      w.z = (T)encode_posit<NBITS, ES>(v.z);
      w.w = (T)encode_posit<NBITS, ES>(v.w);
      o4[i] = w;
    }
    if (tid < n - 4 * n4)                  // the n % 4 tail
      out[4 * n4 + tid] = (T)encode_posit<NBITS, ES>(x[4 * n4 + tid]);
  } else {
    for (uint32_t i = tid; i < n; i += stride)
      out[i] = (T)encode_posit<NBITS, ES>(x[i]);
  }
}

// Grid of a grid-stride elementwise launch over n > 0 items.
int grid_for(int64_t n) {
  const int64_t g = (n + 255) / 256;
  return (int)(g < (1 << 20) ? g : (1 << 20));
}

template <int NBITS, int ES>
cudaError_t launch_decode(const int32_t *p, float *hi, float *lo, int64_t n,
                          cudaStream_t s) {
  POSIT_LAUNCH(grid_for(n), 256, 0, s, decode_split_kernel<NBITS, ES>)(p, hi,
                                                                       lo, n);
  return cudaGetLastError();
}

template <int NBITS, int ES, int OB>
cudaError_t launch_encode(const float *x, void *out, uint32_t n,
                          cudaStream_t s) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % (4 * OB) == 0);
  if (vec)
    POSIT_LAUNCH(grid_for((n + 3) / 4), 256, 0, s,
                 encode_posit_kernel<NBITS, ES, OB, true>)(x, out, n);
  else
    POSIT_LAUNCH(grid_for(n), 256, 0, s,
                 encode_posit_kernel<NBITS, ES, OB, false>)(x, out, n);
  return cudaGetLastError();
}

// Only the widths that hold the format's words are built.
template <int NBITS, int ES>
cudaError_t launch_encode_to(const float *x, void *out, uint32_t n,
                             int out_bytes, cudaStream_t s) {
  if (out_bytes == 4) return launch_encode<NBITS, ES, 4>(x, out, n, s);
  if constexpr (NBITS <= 16)
    if (out_bytes == 2) return launch_encode<NBITS, ES, 2>(x, out, n, s);
  if constexpr (NBITS <= 8)
    if (out_bytes == 1) return launch_encode<NBITS, ES, 1>(x, out, n, s);
  return (cudaError_t)1002;
}

}  // namespace

// Formats: 0 = p32e2, 1 = p16e1, 2 = p8e2, 3 = p8e0.  Every entry point
// returns the cudaError_t of its launch (0 on success); 1001 flags an
// unknown format, 1002 bad arguments.
extern "C" int posit_decode_split_launch(const void *p, void *hi, void *lo,
                                         int64_t n, int fmt, void *stream) {
  if (n <= 0) return 1002;
  const auto *pp = static_cast<const int32_t *>(p);
  auto *h = static_cast<float *>(hi);
  auto *l = static_cast<float *>(lo);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_decode<32, 2>(pp, h, l, n, s);
    case 1: return launch_decode<16, 1>(pp, h, l, n, s);
    case 2: return launch_decode<8, 2>(pp, h, l, n, s);
    case 3: return launch_decode<8, 0>(pp, h, l, n, s);
    default: return 1001;
  }
}

// out: n words of out_bytes bytes each (4: int32, 2: int16, 1: int8; the
// word must fit: 2 for formats of <= 16 bits, 1 for <= 8), 0 < n < 2^31.
extern "C" int posit_encode_launch(const void *x, void *out, int64_t n,
                                   int fmt, int out_bytes, void *stream) {
  if (n <= 0 || n >= (int64_t(1) << 31)) return 1002;
  const auto *px = static_cast<const float *>(x);
  auto s = static_cast<cudaStream_t>(stream);
  const auto m = static_cast<uint32_t>(n);
  switch (fmt) {
    case 0: return launch_encode_to<32, 2>(px, out, m, out_bytes, s);
    case 1: return launch_encode_to<16, 1>(px, out, m, out_bytes, s);
    case 2: return launch_encode_to<8, 2>(px, out, m, out_bytes, s);
    case 3: return launch_encode_to<8, 0>(px, out, m, out_bytes, s);
    default: return 1001;
  }
}
