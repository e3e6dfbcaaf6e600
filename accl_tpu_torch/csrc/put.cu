// Row 13: the fused compute-and-put over P ranks that share one device:
// out[(r + distance) mod P] = compute(x[r]) for every rank r, one launch.
//
// Replaces accl_tpu/ops/pallas/put.py::_kernel (:66, pallas_call at :108,
// entry fused_shift :83), the kernel behind examples/vadd_put.py's fully
// fused form.  On the TPU each rank's kernel computes in VMEM and then
// issues a remote DMA to its neighbour (remote_block_put :44) after a
// neighbor_barrier.  With every rank's rows on one card the put is a
// store into the destination rank's output through the pointer table:
// no barrier and no remote copy are needed.  The peer stores and the
// flag barrier come back with several cards (ROADMAP B1 / B14).
//
// compute is identity (a raw copy of any element width), v + c or v * c.
// Each is one IEEE operation (__fadd_rn / __fmul_rn, never a fused
// multiply-add: fmaf(2, -0.0, 0) is +0.0 where JAX gives -0.0); 16-bit
// floats compute in float and round once, as XLA computes a weak-typed
// scalar op; integers wrap (computed on unsigned values).  The wrapper
// passes the constant as a double already rounded as JAX's weak-typed
// Python scalar meets the operand (ops/cuda/put.py::_constant: to a
// 16-bit dtype through float32, so exact in float); it is used as float
// for float, half and bfloat16 operands, as double for double, as an
// integer for integer operands.
//
// Bound on the H100: bytes.  It reads P * n elements and writes P * n
// and does at most one operation per element, far below the card's
// operations-per-byte line, so its least time is
// 2 * P * n * sizeof(T) / 3.35 TB/s (0.1603 ms for 4 x 64 MiB).  The
// design moves only those bytes on the streaming tile core
// (common.cuh): blockIdx.y is the source rank r, each warp loads one
// tile of in[r] (64 bytes a lane, all in flight before the first
// operation), computes each element in registers and stores the words
// into out[(r + distance) mod P]; a rank whose input or output is not
// 16-byte aligned takes the scalar path, the others stay whole.
#include "common.cuh"

namespace {

using accl::from_float;
using accl::RankPtrs;
using accl::to_float;

enum : int { CP_IDENTITY = 0, CP_ADD = 1, CP_MUL = 2 };

template <typename T> struct Compute {  // __half and __nv_bfloat16
  static __device__ __forceinline__ T apply(int op, T v, double c,
                                            long long) {
    const float x = to_float(v), cf = static_cast<float>(c);
    return from_float<T>(op == CP_ADD ? __fadd_rn(x, cf) : __fmul_rn(x, cf));
  }
};
template <> struct Compute<float> {
  static __device__ __forceinline__ float apply(int op, float v, double c,
                                                long long) {
    const float cf = static_cast<float>(c);
    return op == CP_ADD ? __fadd_rn(v, cf) : __fmul_rn(v, cf);
  }
};
template <> struct Compute<double> {
  static __device__ __forceinline__ double apply(int op, double v, double c,
                                                 long long) {
    return op == CP_ADD ? __dadd_rn(v, c) : __dmul_rn(v, c);
  }
};
template <> struct Compute<int32_t> {
  static __device__ __forceinline__ int32_t apply(int op, int32_t v, double,
                                                  long long ci) {
    const uint32_t a = static_cast<uint32_t>(v);
    const uint32_t b = static_cast<uint32_t>(ci);
    return static_cast<int32_t>(op == CP_ADD ? a + b : a * b);
  }
};
template <> struct Compute<int64_t> {
  static __device__ __forceinline__ int64_t apply(int op, int64_t v, double,
                                                  long long ci) {
    const uint64_t a = static_cast<uint64_t>(v);
    const uint64_t b = static_cast<uint64_t>(ci);
    return static_cast<int64_t>(op == CP_ADD ? a + b : a * b);
  }
};
// identity: the element's bits, whatever its type
template <> struct Compute<uint8_t> {
  static __device__ __forceinline__ uint8_t apply(int, uint8_t v, double,
                                                  long long) {
    return v;
  }
};
template <> struct Compute<uint16_t> {
  static __device__ __forceinline__ uint16_t apply(int, uint16_t v, double,
                                                   long long) {
    return v;
  }
};
template <> struct Compute<uint32_t> {
  static __device__ __forceinline__ uint32_t apply(int, uint32_t v, double,
                                                   long long) {
    return v;
  }
};
template <> struct Compute<uint64_t> {
  static __device__ __forceinline__ uint64_t apply(int, uint64_t v, double,
                                                   long long) {
    return v;
  }
};

template <typename T>
__global__ void __launch_bounds__(accl::kThreads)
    fused_put_kernel(const __grid_constant__ RankPtrs t, int P, int distance,
                     long long n, int op, double c, long long ci) {
  using S = accl::TileShape<sizeof(T), sizeof(T)>;
  const int r = blockIdx.y;  // the source rank
  const T* in = static_cast<const T*>(t.in[r]);
  T* out = static_cast<T*>(t.out[(r + distance) % P]);
  accl::tile_walk<S::E>(
      n, accl::aligned(in) && accl::aligned(out),
      [&](long long e, int lane) {
        uint4 w[S::U];
        accl::tile_load<S::V>(w, in + e, lane);
#pragma unroll
        for (int u = 0; u < S::U; ++u) {
          alignas(16) T x[S::V];
          *reinterpret_cast<uint4*>(x) = w[u];
#pragma unroll
          for (int k = 0; k < S::V; ++k)
            x[k] = Compute<T>::apply(op, x[k], c, ci);
          w[u] = *reinterpret_cast<const uint4*>(x);
        }
        accl::tile_store<S::V>(out + e, lane, w);
      },
      [&](long long i) { out[i] = Compute<T>::apply(op, in[i], c, ci); });
}

template <typename T>
int launch(const RankPtrs& t, int P, int distance, long long n, int op,
           double c, long long ci, cudaStream_t stream) {
  using S = accl::TileShape<sizeof(T), sizeof(T)>;
  fused_put_kernel<T><<<dim3(accl::tile_blocks(n, S::E, true), P),
                        accl::kThreads, 0, stream>>>(t, P, distance, n, op,
                                                     c, ci);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in[r] / out[r]: rank r's operand and output; 0 <= distance < P.
// op: CP_IDENTITY (any dtype, by `itemsize`) or CP_ADD / CP_MUL (float32,
// float16, bfloat16, float64, int32, int64 by DataType code).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int accl_fused_put(const void* const* in, void* const* out, int P,
                              int distance, long long n, int dtype,
                              int itemsize, int op, double c, long long ci,
                              void* stream) {
  if (P < 1 || P > accl::kMaxRanks || distance < 0 || distance >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs t = accl::table(in, out, P, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == CP_IDENTITY) {
    switch (itemsize) {
      case 1: return launch<uint8_t>(t, P, distance, n, op, c, ci, s);
      case 2: return launch<uint16_t>(t, P, distance, n, op, c, ci, s);
      case 4: return launch<uint32_t>(t, P, distance, n, op, c, ci, s);
      case 8: return launch<uint64_t>(t, P, distance, n, op, c, ci, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (op != CP_ADD && op != CP_MUL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case DT_F16: return launch<__half>(t, P, distance, n, op, c, ci, s);
    case DT_F32: return launch<float>(t, P, distance, n, op, c, ci, s);
    case DT_F64: return launch<double>(t, P, distance, n, op, c, ci, s);
    case DT_I32: return launch<int32_t>(t, P, distance, n, op, c, ci, s);
    case DT_I64: return launch<int64_t>(t, P, distance, n, op, c, ci, s);
    case DT_BF16:
      return launch<__nv_bfloat16>(t, P, distance, n, op, c, ci, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
