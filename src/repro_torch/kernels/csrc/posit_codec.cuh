// Posit codec device functions of the Hopper GEMM (posit_gemm.cu).
//
// decode_split: the counterpart of repro/kernels/posit_gemm.py
// decode_split_f32 (+_floor_log2_i32, _pow2_f32); encode_posit: of
// encode_posit_f32.  Bit-identical to them, and to the plain PyTorch
// versions in repro_torch/kernels/posit_gemm.py.
//
// Every shift is done on uint32 with a count below 32: C++ leaves larger
// counts and signed overflow undefined, where XLA defines them.  Where the
// JAX code shifts an int32 right arithmetically, the result is masked, so a
// logical shift gives the same bits.  The header is plain C++ apart from
// the CUDA qualifiers and intrinsics named below, so it can also be built
// for the host by defining them (POSIT_CODEC_HOST).
#pragma once

#include <cstdint>

#ifdef POSIT_CODEC_HOST
#include <cstring>
#define POSIT_FN inline
static inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
static inline float __int_as_float(int32_t b) {
  float f; std::memcpy(&f, &b, 4); return f;
}
static inline int32_t __float_as_int(float f) {
  int32_t b; std::memcpy(&b, &f, 4); return b;
}
#else
#define POSIT_FN __device__ __forceinline__
#endif

namespace posit_codec {

// NaR and maxpos patterns, sign-extended into int32.
template <int NBITS>
constexpr int32_t kNar = (int32_t)(0xFFFFFFFFu << (NBITS - 1));
template <int NBITS>
constexpr int32_t kMaxpos = (int32_t)((1u << (NBITS - 1)) - 1u);

// 2.0f**e by exponent-field construction; e is clamped to f32's normal
// range and the caller masks e < -126 (as _pow2_f32 does).
POSIT_FN float pow2_f32(int e) {
  int f = e + 127;
  f = f < 1 ? 1 : (f > 254 ? 254 : f);
  return __int_as_float(f << 23);
}

// decode_split_f32: posit word -> (hi, lo) with hi + lo == value exactly for
// |value| >= 2^-99; zero -> (0, 0); NaR -> (NaN, 0).
template <int NBITS, int ES>
POSIT_FN void decode_split(int32_t p, float &hi, float &lo) {
  const bool is_zero = p == 0;
  const bool is_nar = p == kNar<NBITS>;
  const bool signbit = p < 0;
  const uint32_t a = signbit ? 0u - (uint32_t)p : (uint32_t)p;
  const uint32_t body = a << (33 - NBITS);           // regime MSB at bit 31
  const bool r0 = (body >> 31) != 0u;
  uint32_t y = r0 ? ~body : body;                    // bit 31 == 0 now
  y = y == 0u ? 1u : y;
  const int m = __clz(y);                            // regime run length
  const int k = r0 ? m - 1 : -m;
  const uint32_t u = (body << m) << 1;               // m <= 31: two shifts
  int e = 0;
  if constexpr (ES > 0) e = (int)((u >> (32 - ES)) & ((1u << ES) - 1u));
  const uint32_t frac = u << ES;                     // frac MSB at bit 31
  const int sig = (int)((1u << 27) | ((frac >> 5) & ((1u << 27) - 1u)));
  const int scale = k * (1 << ES) + e;

  const float sgn = signbit ? -1.0f : 1.0f;
  const bool dead = is_zero || is_nar;
  const float ph = (scale - 23 >= -126 && !dead) ? pow2_f32(scale - 23) : 0.0f;
  const float plo = (scale - 27 >= -126 && !dead) ? pow2_f32(scale - 27) : 0.0f;
  hi = (float)(sig >> 4) * ph * sgn;
  lo = (float)(sig & 15) * plo * sgn;
  if (is_nar) hi = __int_as_float(0x7FC00000);
}

// encode_posit_f32: f32 -> posit word, RNE with ties to the even pattern,
// clamped to maxpos/minpos, inf/NaN -> NaR.
template <int NBITS, int ES>
POSIT_FN int32_t encode_posit(float x) {
  constexpr int MS = (NBITS - 2) << ES;              // max_scale
  const int32_t bits = __float_as_int(x);
  const bool sign = bits < 0;
  const int expf = (bits >> 23) & 0xFF;
  const uint32_t man = (uint32_t)bits & 0x7FFFFFu;
  const bool is_zero = expf == 0 && man == 0u;
  const bool is_nar = expf == 255;
  const int scale = expf == 0 ? -150 : expf - 127;
  const bool over = scale >= MS;
  const bool under = scale < -MS && !is_zero;
  const int sc = scale < -MS ? -MS : (scale > MS - 1 ? MS - 1 : scale);

  const int k = sc >> ES;                            // floor(sc / 2^ES)
  const uint32_t e = (uint32_t)sc & ((1u << ES) - 1u);
  const int reg_len = k >= 0 ? k + 2 : 1 - k;
  const int avail = (NBITS - 1) - reg_len;           // room for [e|frac]
  const uint32_t regime = k >= 0 ? ((1u << (k + 1)) - 1u) << 1 : 1u;
  const uint32_t ef = (1u << (ES + 23)) | (e << 23) | man;   // [1|e|frac23]
  const int d0 = (ES + 23) - avail;
  const int d = d0 > 0 ? d0 : 0;                     // [e|frac] bits dropped
  const int shl = d0 < 0 ? -d0 : 0;                  // or left-padded
  const uint32_t kf = (ef >> d) - (1u << ((ES + 23) - d));   // strip hidden
  const uint32_t pat0 = (regime << avail) | (kf << shl);
  const uint32_t dropped = ef & ((1u << d) - 1u);
  const uint32_t half = (1u << d) >> 1;
  const bool rnd = dropped > half ||
                   (dropped == half && dropped != 0u && (pat0 & 1u));
  uint32_t pat = pat0 + (rnd ? 1u : 0u);

  if (over) pat = (uint32_t)kMaxpos<NBITS>;
  if (under) pat = 1u;
  uint32_t out = sign ? 0u - pat : pat;
  if (is_zero) out = 0u;
  if (is_nar) out = (uint32_t)kNar<NBITS>;
  return (int32_t)out;
}

}  // namespace posit_codec
