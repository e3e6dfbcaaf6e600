// K4: elementwise combine, out = op(a, b).astype(out_dtype).
//
// Replaces accl_tpu/ops/pallas/combine.py::_kernel (pallas_call at :100,
// entry combine :47).  op is SUM or MAX; out may alias a (the in-place
// `accumulate` form: each element is read before it is written, by the
// same thread).
//
// Bound on the H100: bytes.  It reads 2n input elements and writes n
// outputs and does one operation per element, far below the card's
// operations-per-byte line, so its least time is
// (2 * sizeof(T) + sizeof(O)) * n / 3.35 TB/s.  The design moves only
// those bytes, on the streaming tile core (common.cuh): each warp owns one
// tile, issues all of both operands' loads of it (64 bytes of each a lane)
// before the first operation, and stores whole warp-contiguous 16-byte
// words: an output as wide as the input stores the words it computed, a
// wider one reads the operands as 8- or 4-byte words, and a narrower one
// (f32 -> bf16 / f16, 64-bit -> 32- or 16-bit) trades halves or quarters
// between 2 or 4 lanes by shuffles.  Each element is one Arith<T>::apply
// and one Convert<O>, as in the plain version; the in-place form (out is
// a) stays exact because each lane stores only the elements it loaded
// (the trade happens only when the output is narrower, which the in-place
// form refuses).
#include "common.cuh"

namespace {

using accl::Arith;
using accl::Convert;
using accl::kThreads;

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* a, const T* b, O* out, long long n, int op,
                   bool vec) {
  using S = accl::TileShape<sizeof(T), sizeof(O)>;
  using WIn = typename accl::Word<S::IN>::T;
  constexpr int PW = S::OUT / 4;  // 32-bit words a lane computes, a chunk
  accl::tile_walk<S::E>(
      n, vec,
      [&](long long e, int lane) {
        WIn wa[S::U], wb[S::U];  // both operands in flight before any add
        accl::tile_load<S::V>(wa, a + e, lane);
        accl::tile_load<S::V>(wb, b + e, lane);
        uint4 full[S::G == 1 ? S::U : 1];
        uint32_t words[S::U][PW];
#pragma unroll
        for (int u = 0; u < S::U; ++u) {
          alignas(16) T xa[S::V];
          alignas(16) T xb[S::V];
          alignas(16) O y[S::V];
          *reinterpret_cast<WIn*>(xa) = wa[u];
          *reinterpret_cast<WIn*>(xb) = wb[u];
#pragma unroll
          for (int k = 0; k < S::V; ++k)
            y[k] = Convert<O>::from(Arith<T>::apply(op, xa[k], xb[k]));
          if constexpr (S::G == 1) {
            full[u] = *reinterpret_cast<const uint4*>(y);
          } else {
#pragma unroll
            for (int q = 0; q < PW; ++q)
              words[u][q] = reinterpret_cast<const uint32_t*>(y)[q];
          }
        }
        if constexpr (S::G == 1) {
          accl::tile_store<S::V>(out + e, lane, full);
        } else {
#pragma unroll
          for (int c0 = 0; c0 < S::U; c0 += S::G)
            accl::store_group<S::G, PW, S::U>(
                reinterpret_cast<uint4*>(out + e +
                                         (c0 + lane % S::G) * 32 * S::V) +
                    lane / S::G,
                c0, lane, words);
        }
      },
      [&](long long i) {
        out[i] = Convert<O>::from(Arith<T>::apply(op, a[i], b[i]));
      });
}

template <typename T, typename O>
int launch(const void* a, const void* b, void* out, long long n, int op,
           int vec, cudaStream_t stream) {
  using S = accl::TileShape<sizeof(T), sizeof(O)>;
  combine_kernel<T, O><<<accl::tile_blocks(n, S::E, vec != 0), kThreads, 0,
                         stream>>>(static_cast<const T*>(a),
                                   static_cast<const T*>(b),
                                   static_cast<O*>(out), n, op, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_out(const void* a, const void* b, void* out, long long n,
               int out_dtype, int op, int vec, cudaStream_t s) {
  switch (out_dtype) {
    case DT_F16: return launch<T, __half>(a, b, out, n, op, vec, s);
    case DT_F32: return launch<T, float>(a, b, out, n, op, vec, s);
    case DT_F64: return launch<T, double>(a, b, out, n, op, vec, s);
    case DT_I32: return launch<T, int32_t>(a, b, out, n, op, vec, s);
    case DT_I64: return launch<T, int64_t>(a, b, out, n, op, vec, s);
    case DT_BF16: return launch<T, __nv_bfloat16>(a, b, out, n, op, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int accl_combine(const void* a, const void* b, void* out,
                            long long n, int dtype, int out_dtype, int op,
                            int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F16: return launch_out<__half>(a, b, out, n, out_dtype, op, vec, s);
    case DT_F32: return launch_out<float>(a, b, out, n, out_dtype, op, vec, s);
    case DT_F64: return launch_out<double>(a, b, out, n, out_dtype, op, vec, s);
    case DT_I32: return launch_out<int32_t>(a, b, out, n, out_dtype, op, vec, s);
    case DT_I64: return launch_out<int64_t>(a, b, out, n, out_dtype, op, vec, s);
    case DT_BF16:
      return launch_out<__nv_bfloat16>(a, b, out, n, out_dtype, op, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
