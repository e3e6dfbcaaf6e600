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
// those bytes, with 16-byte vector loads (and stores, where the output
// element is as wide as the input) from a grid-stride loop.
#include "common.cuh"

namespace {

using accl::Arith;
using accl::Convert;

template <typename T, typename O>
__global__ void combine_kernel(const T* a, const T* b, O* out, long long n,
                               int op, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nvec = n / V;
    for (long long i = tid; i < nvec; i += stride) {
      const uint4 ra = reinterpret_cast<const uint4*>(a)[i];
      const uint4 rb = reinterpret_cast<const uint4*>(b)[i];
      const T* va = reinterpret_cast<const T*>(&ra);
      const T* vb = reinterpret_cast<const T*>(&rb);
      if constexpr (sizeof(O) == sizeof(T)) {
        uint4 ro;
        O* vo = reinterpret_cast<O*>(&ro);
#pragma unroll
        for (int k = 0; k < V; ++k)
          vo[k] = Convert<O>::from(Arith<T>::apply(op, va[k], vb[k]));
        reinterpret_cast<uint4*>(out)[i] = ro;
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          out[i * V + k] = Convert<O>::from(Arith<T>::apply(op, va[k], vb[k]));
      }
    }
    done = nvec * V;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = Convert<O>::from(Arith<T>::apply(op, a[i], b[i]));
}

template <typename T, typename O>
int launch(const void* a, const void* b, void* out, long long n, int op,
           int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int threads = 256;
  combine_kernel<T, O><<<accl::grid_for(vec ? n / V + 1 : n, threads),
                         threads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<O*>(out), n, op, vec);
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
