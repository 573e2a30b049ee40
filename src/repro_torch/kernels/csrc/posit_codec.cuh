// Posit codec device functions of the Hopper GEMM (posit_gemm.cu).
//
// decode_split: the counterpart of repro/kernels/posit_gemm.py
// decode_split_f32 (+_floor_log2_i32, _pow2_f32); encode_posit: of
// encode_posit_f32.  Bit-identical to them, and to the plain PyTorch
// versions in repro_torch/kernels/posit_gemm.py.
//
// Every shift has a count below 32 and no add overflows: C++ leaves larger
// counts and signed overflow undefined, where XLA defines them.  decode_split
// shifts uint32 only (where the JAX code shifts an int32 right
// arithmetically, the result is masked, so a logical shift gives the same
// bits); encode_posit shifts an int32 right arithmetically on purpose (the
// regime run), which g++ and nvcc define.  The header is plain C++ apart from
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
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31u));
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

// decode_split's hi for a format of <= 16 bits, built from the word's bits:
// such a word's value has at most 13 fraction bits and a scale within
// f32's normal range, so hi is the value exactly (lo is zero), sign and
// magnitude as decode_split's product gives them, +0 for zero, and the
// same NaN for NaR.  It skips decode_split's int-to-float conversion and
// two multiplies; tests/test_torch_quant_gemm.py and chip_smoke.py hold
// it to decode_split on every pattern of the three formats.
template <int NBITS, int ES>
POSIT_FN float decode_hi(int32_t p) {
  static_assert(NBITS <= 16, "decode_hi: formats of <= 16 bits");
  const uint32_t a = p < 0 ? 0u - (uint32_t)p : (uint32_t)p;
  const uint32_t body = a << (33 - NBITS);           // regime MSB at bit 31
  const bool r0 = (body >> 31) != 0u;
  const uint32_t y = r0 ? ~body : body;              // bit 31 == 0 now
  const int m = __clz(y | 1u);                       // regime run length
  const int k = r0 ? m - 1 : -m;
  const uint32_t u = (body << m) << 1;               // strip regime+term
  int e = 0;
  if constexpr (ES > 0) e = (int)(u >> (32 - ES));
  const uint32_t frac = u << ES;                     // frac MSB at bit 31
  const int scale = k * (1 << ES) + e;
  const uint32_t bits = ((uint32_t)p & 0x80000000u) |
                        ((uint32_t)(scale + 127) << 23) | (frac >> 9);
  // selects, not branches: a branch per word keeps a warp from overlapping
  // the decodes of neighbouring words (PERF.md §6)
  const int32_t zero_or = p == 0 ? 0 : (int32_t)bits;
  return __int_as_float(p == kNar<NBITS> ? 0x7FC00000 : zero_or);
}

// encode_posit_f32: f32 -> posit word, RNE with ties to the even pattern,
// clamped to maxpos/minpos, f32 subnormals -> ±minpos, ±0 -> 0, inf/NaN ->
// NaR.  Written for the integer pipes: one clamp, one 64-bit pattern, one
// rounding add, one negate, two selects, and no branch: 27 SASS
// instructions a value in encode_posit_kernel's loop (tools/kernel_sass.py,
// sm_90a), against 135 for the reference's field-by-field form.
//
// * Clamp the magnitude bits a = |x| to [2^-MS, 2^MS - ulp]: every value
//   beyond maxpos's scale becomes the f32 below 2^MS, which rounds up to
//   maxpos, and everything below 2^-MS (subnormals too) becomes 2^-MS,
//   which is minpos exactly.  The scale needs no clamp after that.
// * c + 2^23 adds 1 to the biased exponent E, so its low ES exponent bits
//   are e = (E - 127) mod 2^ES (127 = -1 mod 2^ES) and its field above them
//   is k + 128 / 2^ES, k = floor((E - 127) / 2^ES): [e|frac] is c + 2^23's
//   low ES + 23 bits.
// * The pattern: t = [1 0 | e | frac] (k >= 0) or [0 1 | e | frac]
//   (k < 0) from bit 31 down, shifted right arithmetically by k or
//   -k - 1 (k ^ (k >> 31), at most NBITS - 3): the regime run and its
//   terminator, then [e|frac].  The bits that leave the word go to the
//   low half of a 64-bit value (one funnel shift), so the NBITS - 1
//   pattern bits, the guard and the sticky bits are all there.
// * RNE: with g bits below the pattern, add 2^(g-1) - 1 + the pattern's
//   lsb: the carry rounds up above half, and at a tie only when the lsb
//   is 1.  The pattern is never all ones (the regime always has its
//   terminator), so the carry stays inside it.
// * The sign by one negate; zero and inf/NaN by the final selects.
template <int NBITS, int ES>
POSIT_FN int32_t encode_posit(float x) {
  constexpr int MS = (NBITS - 2) << ES;              // max_scale
  constexpr uint32_t kLow = (uint32_t)(127 - MS) << 23;         // 2^-MS
  constexpr uint32_t kHigh = ((uint32_t)(127 + MS) << 23) - 1u; // < 2^MS
  const int32_t bits = __float_as_int(x);
  const uint32_t a = (uint32_t)bits & 0x7FFFFFFFu;
  uint32_t c = a < kLow ? kLow : a;
  c = c > kHigh ? kHigh : c;
  const uint32_t c1 = c + (1u << 23);
  const int k = (int)(c1 >> (23 + ES)) - (128 >> ES);  // floor(scale / 2^ES)
  const int km = k >> 31;                            // -1 where k < 0
  const uint32_t t = (km ? 0x40000000u : 0x80000000u) |
                     ((c1 << (7 - ES)) & 0x3FFFFFFFu);  // [run|e|frac]
  const uint32_t s = (uint32_t)(k ^ km);             // k or -k - 1
  const uint32_t hi = (uint32_t)((int32_t)t >> s);   // regime, then [e|frac]
  const uint32_t lo = __funnelshift_r(0u, t, s);     // the bits shifted out
  const uint64_t v = ((uint64_t)hi << 32) | lo;      // pattern at bits 63..
  const uint32_t lsb = (hi >> (33 - NBITS)) & 1u;
  const uint64_t r = v + ((1ull << (64 - NBITS)) - 1u) + lsb;
  const int32_t pat = (int32_t)(r >> (65 - NBITS));
  const int32_t sm = bits >> 31;                     // -1 where negative
  const int32_t out = (pat ^ sm) - sm;
  return a >= 0x7F800000u ? kNar<NBITS> : (a == 0u ? 0 : out);
}

}  // namespace posit_codec
