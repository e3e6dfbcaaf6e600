// Shared numerics of the hand-written kernels.
//
// The results must equal the JAX package's bit for bit, so every rule
// here copies what its jnp counterpart does:
//  * 16-bit floats compute in float and round back to nearest-even after
//    EVERY operation (XLA's upcast-op-round), with the cuda_fp16.h /
//    cuda_bf16.h _rn intrinsics that match astype's rounding;
//  * MAX propagates NaN like jnp.maximum / torch.maximum (fmaxf does not);
//  * integer SUM wraps, computed on unsigned values so overflow is defined.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// DataType codes, shared with accl_tpu_torch/constants.py
enum : int {
  DT_F16 = 1, DT_F32 = 2, DT_F64 = 3, DT_I32 = 4, DT_I64 = 5, DT_BF16 = 6,
  DT_I8 = 7, DT_E4M3 = 8, DT_E5M2 = 9,
};
// ReduceFunction codes
enum : int { OP_SUM = 0, OP_MAX = 1 };

namespace accl {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename F> __device__ __forceinline__ F max_nan(F a, F b) {
  return (a != a || a > b) ? a : b;  // a NaN a wins; a NaN b falls through
}

template <typename T> struct Arith {  // float and double
  static __device__ __forceinline__ T apply(int op, T a, T b) {
    return op == OP_SUM ? a + b : max_nan(a, b);
  }
};
template <> struct Arith<__half> {
  static __device__ __forceinline__ __half apply(int op, __half a, __half b) {
    return from_float<__half>(Arith<float>::apply(op, to_float(a), to_float(b)));
  }
};
template <> struct Arith<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 apply(int op,
                                                        __nv_bfloat16 a,
                                                        __nv_bfloat16 b) {
    return from_float<__nv_bfloat16>(
        Arith<float>::apply(op, to_float(a), to_float(b)));
  }
};
template <> struct Arith<int32_t> {
  static __device__ __forceinline__ int32_t apply(int op, int32_t a,
                                                  int32_t b) {
    return op == OP_SUM ? (int32_t)((uint32_t)a + (uint32_t)b)
                        : (a > b ? a : b);
  }
};
template <> struct Arith<int64_t> {
  static __device__ __forceinline__ int64_t apply(int op, int64_t a,
                                                  int64_t b) {
    return op == OP_SUM ? (int64_t)((uint64_t)a + (uint64_t)b)
                        : (a > b ? a : b);
  }
};

// Element conversion with astype's rounding.  16-bit targets round from
// float (a double or 64-bit integer source goes through float first, as
// PyTorch's conversion does); other targets use the C conversion.
template <typename O> struct Convert {
  template <typename T> static __device__ __forceinline__ O from(T v) {
    return static_cast<O>(v);
  }
  static __device__ __forceinline__ O from(__half v) {
    return static_cast<O>(__half2float(v));
  }
  static __device__ __forceinline__ O from(__nv_bfloat16 v) {
    return static_cast<O>(__bfloat162float(v));
  }
};
template <> struct Convert<__half> {
  template <typename T> static __device__ __forceinline__ __half from(T v) {
    return __float2half_rn(static_cast<float>(v));
  }
  static __device__ __forceinline__ __half from(__half v) { return v; }
  static __device__ __forceinline__ __half from(__nv_bfloat16 v) {
    return __float2half_rn(__bfloat162float(v));
  }
};
template <> struct Convert<__nv_bfloat16> {
  template <typename T>
  static __device__ __forceinline__ __nv_bfloat16 from(T v) {
    return __float2bfloat16_rn(static_cast<float>(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 from(__half v) {
    return __float2bfloat16_rn(__half2float(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 from(__nv_bfloat16 v) {
    return v;
  }
};

// Grid for a grid-stride loop over `items` work items of 256 threads:
// enough blocks to fill 132 SMs several times over, no more.
inline int grid_for(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return blocks < 1 ? 1 : (int)blocks;
}

constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;

// The per-rank pointer table of the ring kernels (a kernel argument:
// 2 x 64 pointers = 1 KiB of the 4 KiB parameter space).  A null output
// pointer means: that rank takes no result, skip its stores.
struct RankPtrs {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

inline RankPtrs table(const void* const* in, void* const* out, int n_in,
                      int n_out) {
  RankPtrs t = {};
  for (int i = 0; i < n_in; ++i) t.in[i] = in[i];
  for (int i = 0; i < n_out; ++i) t.out[i] = out[i];
  return t;
}

template <typename T> __device__ __forceinline__ T zero() {
  return Convert<T>::from(0.0f);
}
template <> __device__ __forceinline__ int32_t zero<int32_t>() { return 0; }

// V consecutive elements starting at e (a multiple of V); elements at or
// past n read as zero.  V > 1 takes one 16-byte access when whole.
template <typename T, int V>
__device__ __forceinline__ void load(T (&v)[V], const void* base, long long e,
                                     long long n) {
  const T* p = static_cast<const T*>(base);
  if (V > 1 && e + V <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + e);
    const T* pv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = pv[k];
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = e + k < n ? p[e + k] : zero<T>();
  }
}

// store V elements at e, only those before `limit`
template <typename T, int V>
__device__ __forceinline__ void store(void* base, long long e, const T (&v)[V],
                                      long long limit) {
  T* p = static_cast<T*>(base);
  if (V > 1 && e + V <= limit) {
    uint4 raw;
    T* pv = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) pv[k] = v[k];
    *reinterpret_cast<uint4*>(p + e) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (e + k < limit) p[e + k] = v[k];
  }
}

__device__ __forceinline__ int ring_mod(int r, int P) {
  r %= P;
  return r < 0 ? r + P : r;
}

}  // namespace accl

extern "C" const char* accl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
