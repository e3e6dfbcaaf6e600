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

// -- the streaming tile core of the byte-bound kernels -----------------------
//
// A kernel that moves each byte once (a copy, an elementwise combine) is
// bound by HBM, and on the H100 it reaches its rate only with every access
// whole and warp-contiguous and enough bytes in flight.  So a warp owns one
// TILE of the tensor: U chunks, a chunk being 32 lanes x one word of each
// stream, lane l at bytes [16 l, 16 l + 16) of each 512-byte chunk of the
// widest stream (and at the same elements, a 4- or 8-byte word, of a
// narrower one).  The kernel issues all U loads of every input stream of
// its tile (64 bytes of each input a lane, TileShape::U) before it uses
// any, then computes and stores.  The grid gives each warp one tile
// (tile_blocks: no grid-stride cap, the block scheduler spreads the tiles
// over the SMs as they free up); the elements past the last whole tile, and
// every element of a view not aligned to 16 bytes, take the kernel's scalar
// path (tile_walk).

template <typename X> __device__ __forceinline__ bool aligned(const X* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// A B-byte word: one lane's access of a chunk
template <int B> struct Word;
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// The tile of a stream pair whose elements are SB bytes (read) and DB
// bytes (written): V elements a lane a chunk, IN and OUT bytes of them,
// G lanes that trade a narrower output into 16-byte stores (store_group),
// U chunks a tile (64 bytes of the read side in flight a lane), E elements
// a tile.
template <int SB, int DB> struct TileShape {
  static constexpr int V = 16 / (SB > DB ? SB : DB);
  static constexpr int IN = V * SB;
  static constexpr int OUT = V * DB;
  static constexpr int G = IN > OUT ? IN / OUT : 1;
  static constexpr int U = 64 / IN;
  static constexpr long long E = 32LL * V * U;
  static_assert(U % G == 0, "a tile holds whole groups of G chunks");
};

// Load the U words of lane `lane` of the tile starting at `base` (a typed
// pointer to the tile's first element of a stream with V elements a lane a
// chunk): chunk u's word lies 32 V elements after chunk u - 1's.
template <int V, int U, typename W, typename X>
__device__ __forceinline__ void tile_load(W (&w)[U], const X* base,
                                          int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    w[u] = reinterpret_cast<const W*>(base + u * 32 * V)[lane];
}

template <int V, int U, typename W, typename X>
__device__ __forceinline__ void tile_store(X* base, int lane,
                                           const W (&w)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    reinterpret_cast<W*>(base + u * 32 * V)[lane] = w[u];
}

// Walk this thread's share of n elements: `tile(first_element, lane)` for
// each whole tile of E elements its warp owns (when `vec`: every stream
// 16-byte aligned), then `scalar(i)` for the elements past the whole tiles
// (every element when !vec), spread over all of the grid's threads.
template <long long E, typename Tile, typename Scalar>
__device__ __forceinline__ void tile_walk(long long n, bool vec, Tile&& tile,
                                          Scalar&& scalar) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long tiles = n / E;
    for (long long w = tid / 32; w < tiles; w += threads / 32)
      tile(w * E, (int)(threadIdx.x % 32));
    done = tiles * E;
  }
  for (long long i = done + tid; i < n; i += threads) scalar(i);
}

// Blocks of kThreads for tile_walk: one tile a warp when `vec` (at least
// one block, for the scalar rest), else one element a thread; above the
// grid's limit threads take several.
inline unsigned tile_blocks(long long n, long long E, bool vec) {
  const long long per_block = vec ? E * (kThreads / 32) : kThreads;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) blocks = 0x7FFFFFFFLL;
  return blocks < 1 ? 1u : (unsigned)blocks;
}

// The G lanes of a group (lane / G the same) hold, for G consecutive
// chunks c0.., the converted words `w[c][*]` of their own V elements.
// Lane g = lane % G gathers chunk c0 + g's words of the whole group, in
// lane order (its 16 contiguous bytes), and stores them: G - 1 exchanges,
// in each of which a lane sends the word its partner lane ^ r gathers.
template <int G, int PW, int U>
__device__ __forceinline__ void store_group(uint4* dst, int c0, int lane,
                                            const uint32_t (&w)[U][PW]) {
  const int g = lane % G;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const int k = g ^ r;  // the chunk c0 + k the partner gathers
#pragma unroll
    for (int q = 0; q < PW; ++q) {
      uint32_t mine = w[c0][q];
#pragma unroll
      for (int j = 1; j < G; ++j)
        if (k == j) mine = w[c0 + j][q];
      const uint32_t got = r ? __shfl_xor_sync(0xFFFFFFFFu, mine, r) : mine;
#pragma unroll
      for (int j = 0; j < G; ++j)  // the partner's place in the group
        if (k == j) out[j * PW + q] = got;
    }
  }
  *dst = make_uint4(out[0], out[1], out[2], out[3]);
}

}  // namespace accl

extern "C" const char* accl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
