// Tile helpers of the flash-attention kernels: the float32 FFMA kernels'
// tile loads into padded shared memory (the forwards in attention.cu and
// ring_attention.cu, the backward's in attention_bwd.cu), the rounding of
// a float32 pair to a packed 16-bit operand (pack, the 16-bit kernels' P
// and dS as wgmma's A operand in registers, flash_sm90.cuh), the
// launcher, and the float32 kernels' tile sizes.
#pragma once

#include "common.cuh"

namespace flash {

constexpr int kBQ = 64;  // query rows per block of the float32 kernels
constexpr int kBK = 64;  // keys per K/V tile of the float32 kernels
constexpr float kNeg = -1e30f;

struct Strides {  // in elements; the head dim is contiguous
  long long b, h, t;
};

// A ROWS x DP tile of rows [row0, row0 + ROWS) of one head into shared
// memory with row stride SD; rows at or past T and columns at or past D
// read as zero.  vec: D == DP and every row starts on 16 bytes.
template <typename E, int DP, int SD, int NT, int ROWS = 64>
__device__ __forceinline__ void load_tile(E* sm, const E* base, long long st,
                                          int row0, int T, int D, int vec) {
  constexpr int V = 16 / sizeof(E);
  if (vec) {
    constexpr int CPR = DP / V;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
      const int r = c / CPR, col = (c % CPR) * V;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (row0 + r < T)
        raw = *reinterpret_cast<const uint4*>(base + (row0 + r) * st + col);
      if constexpr ((SD * sizeof(E)) % 16 == 0) {
        *reinterpret_cast<uint4*>(sm + r * SD + col) = raw;
      } else {
        const E* pv = reinterpret_cast<const E*>(&raw);
#pragma unroll
        for (int e = 0; e < V; ++e) sm[r * SD + col + e] = pv[e];
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NT) {
      const int r = e / DP, col = e % DP;
      E val = accl::zero<E>();
      if (row0 + r < T && col < D) val = base[(row0 + r) * st + col];
      sm[r * SD + col] = val;
    }
  }
}

template <typename E> __device__ __forceinline__ uint32_t pack(float lo,
                                                               float hi);
template <> __device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float lo,
                                                                    float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack<__half>(float lo,
                                                             float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Launch with `smem` bytes of dynamic shared memory (raising the limit
// above 48 KB first); returns cudaGetLastError() after the launch.
template <typename Kernel, typename A>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const A& a,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The register tile width for a head dim: 32, 64 or 128 (D <= 128)
inline int padded_dim(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

}  // namespace flash
