// Tile helpers of the flash-attention kernels that run on mma.sync and
// FFMA: the backward's dQ and dK/dV (attention_bwd.cu) and the float32
// forwards (attention.cu, ring_attention.cu): tile loads into padded
// shared memory (cp.async when rows are 16-byte aligned), ldmatrix
// fragment loads, mma.sync m16n8k16 with f32 accumulation, and the
// rounding of P to a 16-bit operand (pack, shared with the 16-bit
// forwards' wgmma core, flash_sm90.cuh).
//
// Fragment layout (PTX m16n8k16): lane (g = lane / 4, t = lane % 4) of a
// warp holds rows g and g + 8 and columns 2t, 2t + 1 of each 8-wide tile
// of the f32 accumulator; an accumulator pair of 8-wide tiles, rounded
// and packed, is the A operand of the next product (no shared memory).
#pragma once

#include "common.cuh"

namespace flash {

constexpr int kBQ = 64;  // query rows per block (the forward and dQ)
constexpr int kBK = 64;  // keys per K/V tile
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

// d += a (16x16, row) * b (16x8, col), f32 accumulate
template <typename E>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix: four 8x8 b16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8.  .trans hands each lane a column
// pair instead of a row pair (the B operand of a product whose reduced
// dim is the tile's rows, e.g. P V from row-major V).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared without passing through registers; a row at
// or past T copies nothing and fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool whole) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(whole ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A ROWS-row tile as load_tile does (128 threads), but asynchronously
// when vec (the copy completes at the next cp_async_wait); synchronously
// otherwise.
template <typename E, int DP, int SD, int ROWS = 64>
__device__ __forceinline__ void tile_async(E* sm, const E* base, long long st,
                                           int row0, int T, int D, int vec) {
  if (!vec) {
    load_tile<E, DP, SD, 128, ROWS>(sm, base, st, row0, T, D, 0);
    return;
  }
  constexpr int CPR = DP * sizeof(E) / 16;
  for (int c = threadIdx.x; c < ROWS * CPR; c += 128) {
    const int r = c / CPR, col = (c % CPR) * (16 / sizeof(E));
    const bool in = row0 + r < T;
    cp_async16(sm + r * SD + col, base + (in ? (row0 + r) * st + col : 0),
               in);
  }
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
