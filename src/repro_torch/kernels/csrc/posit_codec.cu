// Elementwise kernels of the GEMM's posit codec device functions
// (posit_codec.cuh), so that decode_split and encode_posit can be checked
// exhaustively on the card against their plain versions.  They are test
// kernels: the GEMM path reaches the device functions inside the decode
// pre-pass and the fused epilogue (posit_gemm.cu), not through these.
// Both are bound by bytes (one word in, two f32 out; one f32 in, one word
// out), so each is a plain grid-stride loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "posit_codec.cuh"

namespace {

using posit_codec::decode_split;
using posit_codec::encode_posit;

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

// Grid of a grid-stride elementwise launch over n > 0 items.
int grid_for(int64_t n) {
  const int64_t g = (n + 255) / 256;
  return (int)(g < (1 << 20) ? g : (1 << 20));
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
