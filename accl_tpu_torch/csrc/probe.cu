// Row 19: the kernel-load probe's copy of one (8, 128) float32 block.
//
// Replaces the copy kernel `k` of accl_tpu/compat.py::_probe_interpret_params
// (:230, pallas_call at :251), which proves that a Pallas kernel really
// runs under the TPU interpreter.  Here it proves that the port's kernels
// build with this machine's nvcc for sm_90a, load through ctypes and run
// on this card: accl_tpu_torch/compat.py launches it once and holds the
// copy against its input.
//
// Bound on the H100: bytes (4 KiB in, 4 KiB out), far below a launch's own
// cost, so its time is the launch.  The design launches ONE block of 256
// threads whatever the count (the (8, 128) block is one float4 a thread;
// a larger count loops inside the block), with a scalar path for any other count or
// alignment: a second block would only add a block's scheduling to the
// launch.
#include "common.cuh"

namespace {

__global__ void probe_copy_kernel(const float* in, float* out, long long n,
                                  int vec) {
  const long long tid = threadIdx.x;
  const long long stride = blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nvec = n / 4;
    for (long long i = tid; i < nvec; i += stride)
      reinterpret_cast<float4*>(out)[i] =
          reinterpret_cast<const float4*>(in)[i];
    done = nvec * 4;
  }
  for (long long i = done + tid; i < n; i += stride) out[i] = in[i];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The float4
// path needs both pointers 16-byte aligned; the entry tells, so the
// wrapper's launch path does not.
extern "C" int accl_probe_copy(const void* in, void* out, long long n,
                               void* stream) {
  const int vec = (((uintptr_t)in | (uintptr_t)out) & 15u) == 0;
  probe_copy_kernel<<<1, accl::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}
