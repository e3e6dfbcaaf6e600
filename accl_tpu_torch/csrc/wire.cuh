// The wire dtypes' conversions, bit for bit as JAX's astype computes them
// on the CPU (accl_tpu_torch/wire.py::astype is the plain version).
//
// Every conversion goes through float32, which holds every value of the
// five lane dtypes exactly:
//  * widening keeps JAX's NaN bits (bfloat16 by a shift, float16 with the
//    quiet bit set and its payload, fp8 as the quiet NaN with its sign);
//  * narrowing rounds to nearest even with integer arithmetic (bfloat16,
//    fp8) or the _rn intrinsic (float16), keeps subnormals, and writes
//    NaN as the target's quiet NaN with the source's sign (float16 keeps
//    the top of the payload).  float8_e4m3fn has no infinity: infinities
//    and magnitudes above 464 become NaN.  float8_e5m2 overflows to
//    infinity.  JAX writes 0x7F, unsigned, for an e5m2 NaN converted from
//    bfloat16, float16 or e4m3; `src` names the source dtype for that.
//
// The fp8 conversions are written out instead of calling cuda_fp8.h's
// __nv_cvt_float_to_fp8: its NaN and overflow encodings are not JAX's.
#pragma once

#include "common.cuh"

namespace accl {

struct F32 {
  using T = float;
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v, int) { return v; }
};

struct BF16 {
  using T = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t b) {
    return __uint_as_float((uint32_t)b << 16);
  }
  static __device__ __forceinline__ uint16_t narrow(float v, int) {
    const uint32_t u = __float_as_uint(v);
    if ((u & 0x7FFFFFFFu) > 0x7F800000u)
      return (uint16_t)(((u >> 16) & 0x8000u) | 0x7FC0u);
    return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
  }
};

struct F16 {
  using T = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t h) {
    if ((h & 0x7C00u) == 0x7C00u && (h & 0x3FFu))
      return __uint_as_float(((uint32_t)(h & 0x8000u) << 16) | 0x7FC00000u |
                             ((uint32_t)(h & 0x3FFu) << 13));
    return __half2float(__ushort_as_half(h));
  }
  static __device__ __forceinline__ uint16_t narrow(float v, int) {
    const uint32_t u = __float_as_uint(v);
    if ((u & 0x7FFFFFFFu) > 0x7F800000u)
      return (uint16_t)(((u >> 16) & 0x8000u) | 0x7E00u |
                        ((u & 0x7FFFFFu) >> 13));
    return __half_as_ushort(__float2half_rn(v));
  }
};

// fp8 with M mantissa bits and exponent bias BIAS; FN: no infinity (e4m3fn)
template <int M, int BIAS, bool FN> struct FP8 {
  using T = uint8_t;
  static constexpr int E = 7 - M;
  static __device__ __forceinline__ float widen(uint8_t b) {
    const uint32_t sign = (uint32_t)(b & 0x80u) << 24;
    const uint32_t e = (b >> M) & ((1u << E) - 1);
    const uint32_t m = b & ((1u << M) - 1);
    const uint32_t emax = (1u << E) - 1;
    if (FN ? (e == emax && m == (1u << M) - 1) : (e == emax && m))
      return __uint_as_float(sign | 0x7FC00000u);
    if (!FN && e == emax) return __uint_as_float(sign | 0x7F800000u);
    if (e == 0)  // subnormal: m * 2^(1 - BIAS - M), exact
      return __uint_as_float(
          sign | __float_as_uint(__fmul_rn((float)m, sub_quantum())));
    return __uint_as_float(sign | ((e - BIAS + 127) << 23) | (m << (23 - M)));
  }
  static __device__ __forceinline__ uint8_t narrow(float v, int src) {
    const uint32_t u = __float_as_uint(v);
    const uint32_t sign = (u >> 24) & 0x80u;
    const uint32_t a = u & 0x7FFFFFFFu;
    if (a > 0x7F800000u) {  // NaN
      if (FN) return (uint8_t)(sign | 0x7Fu);
      if (src == DT_BF16 || src == DT_F16 || src == DT_E4M3) return 0x7Fu;
      return (uint8_t)(sign | 0x7Eu);
    }
    if (a == 0x7F800000u) return (uint8_t)(sign | (FN ? 0x7Fu : 0x7Cu));
    uint32_t code;
    if (a < ((uint32_t)(128 - BIAS) << 23)) {
      // below the smallest normal: round |v| / 2^(1 - BIAS - M) to an
      // integer (the scaling is exact); 2^M is the smallest normal's code
      code = (uint32_t)rintf(__fmul_rn(__uint_as_float(a),
                                       1.0f / sub_quantum()));
    } else {
      constexpr int shift = 23 - M;
      const uint32_t r = a + ((1u << (shift - 1)) - 1) + ((a >> shift) & 1u);
      code = (r >> shift) - ((uint32_t)(127 - BIAS) << M);
    }
    const uint32_t top = FN ? 0x7Eu : 0x7Bu;  // largest finite code
    if (code > top) return (uint8_t)(sign | (FN ? 0x7Fu : 0x7Cu));
    return (uint8_t)(sign | code);
  }
  static __device__ __forceinline__ float sub_quantum() {
    return __uint_as_float((uint32_t)(127 + 1 - BIAS - M) << 23);
  }
};

using E4M3 = FP8<3, 7, true>;
using E5M2 = FP8<2, 15, false>;

// float32 -> int8 as XLA converts it (the ring's raw int8 wire lane):
// toward zero, saturating, NaN to 0
__device__ __forceinline__ int8_t to_int8_saturating(float v) {
  if (v != v) return 0;
  return (int8_t)fminf(fmaxf(truncf(v), -128.0f), 127.0f);
}

// the stochastic-rounding bits of element `i` under `seed`: the Murmur3
// finalizer over (i * 2654435761) ^ seed (accl_tpu_torch/wire.py::sr_bits)
__device__ __forceinline__ uint32_t sr_bits(uint32_t i, uint32_t seed) {
  uint32_t h = (i * 2654435761u) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Mix a rank into a call seed (accl_tpu_torch/wire.py::rank_seed): ranks
// draw independent streams from one slot's seed; seed 0 stays 0 (round to
// nearest even)
__device__ __forceinline__ uint32_t rank_seed(uint32_t seed, uint32_t rank) {
  if (seed == 0) return 0;
  uint32_t h = seed ^ (rank * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h ? h : 1u;
}

// Stochastic rounding, mask-add-truncate: where x is finite, |x| >= tiny
// and `sr`, add the counter bits of element i to the `mask` low mantissa
// bits the target drops and truncate them (the narrowing cast of the
// result is then exact); else x as it is
__device__ __forceinline__ float sr_round(float x, uint32_t i, uint32_t seed,
                                          uint32_t mask, float tiny,
                                          bool sr) {
  if (sr && isfinite(x) && fabsf(x) >= tiny) {
    const uint32_t u = __float_as_uint(x);
    x = __uint_as_float((u + (sr_bits(i, seed) & mask)) & ~mask);
  }
  return x;
}

template <typename S, typename D>
__device__ __forceinline__ typename D::T sr_convert(typename S::T v,
                                                    uint32_t i, uint32_t seed,
                                                    uint32_t mask, float tiny,
                                                    bool sr) {
  // the rounded value is a float32 value
  return D::narrow(sr_round(S::widen(v), i, seed, mask, tiny, sr), DT_F32);
}

// The int8 lane's value of element i (of a row) under its segment's
// scale: x / scale rounded to nearest even, or floor(x / scale + u) with
// u = sr_bits(i, seed) * 2^-32 under a nonzero seed, clipped to +-127; a
// NaN quotient is 0
__device__ __forceinline__ int8_t quantize_one(float x, float scale,
                                               uint32_t i, uint32_t seed) {
  float q = __fdiv_rn(x, scale);
  if (seed) {
    const float u = __fmul_rn(__uint2float_rn(sr_bits(i, seed)),
                              2.3283064365386963e-10f);  // 2^-32
    q = floorf(__fadd_rn(q, u));
  } else {
    q = rintf(q);
  }
  if (q != q) return 0;
  return (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
}

// a segment's scale from its absmax: max(absmax / 127, 1e-30), NaN kept
__device__ __forceinline__ float segment_scale(float amax) {
  return max_nan(__fdiv_rn(amax, 127.0f), 1e-30f);
}

// round a float32 value of source dtype `src` through wire dtype `wire`
// and back to float32 (the fp8 and raw int8 lanes of the ring)
__device__ __forceinline__ float wire_roundtrip(float v, int wire, int src) {
  switch (wire) {
    case DT_E4M3: return E4M3::widen(E4M3::narrow(v, src));
    case DT_E5M2: return E5M2::widen(E5M2::narrow(v, src));
    case DT_I8: return (float)to_int8_saturating(v);
  }
  return v;
}

}  // namespace accl
