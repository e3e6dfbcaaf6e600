// Rows 5-8: the wire compression kernels (cast, stochastic cast, int8
// quantize, int8 dequantize).
//
// Replace accl_tpu/ops/pallas/compression.py:
//   row 5 _cast_kernel :35             (pallas_call :118, entry cast :63)
//   row 6 _stochastic_cast_kernel :42  (pallas_call :106)
//   row 7 _quantize_kernel :129        (pallas_call :171, entry quantize_int8 :154)
//   row 8 _dequantize_kernel :141      (pallas_call :199, entry dequantize_int8 :185)
// and carry the wire lanes of accl_tpu/ops/wire.py (_cast_lane :70,
// quantize_int8 :95, dequantize_int8 :124) on the card.
//
// Each kernel takes R rows at once (the P ranks of a gang call: one
// launch per call, not one per rank), through a table of per-row pointers
// or a row stride; each row has its own stochastic-rounding seed.
//
// What they compute, bit for bit as the plain versions in
// accl_tpu_torch/ops/cuda/compression.py and the numpy codec:
//  * cast: out = astype(x) with JAX's rounding and NaN rules (wire.cuh);
//  * stochastic cast: mask-add-truncate on the `drop` float32 mantissa
//    bits the target drops, with the repo's counter bits sr_bits(i, seed)
//    (the TPU's hardware PRNG cannot be matched, so the port uses the
//    wire codec's own generator for both uses): where x is finite,
//    |x| >= tiny and (seed != 0 or `always`), x's bits become
//    (u + (sr_bits & mask)) & ~mask, then the narrowing cast, which is
//    exact there.  Row 6 is drop 16, tiny 0, always; the fp8 / f16 /
//    bf16 wire lanes use their dropped-bit counts and smallest normals,
//    and seed 0 is the plain round-to-nearest-even cast;
//  * quantize: per segment of L elements (the wire's 256, or the Pallas
//    tier's tile of block_rows * 128), scale = max(absmax / 127, 1e-30)
//    computed here by a reduction (the TPU kernel takes it from an XLA
//    pre-pass), q = clip(rint(x / scale), +-127), or
//    clip(floor(x / scale + u), +-127) with u = sr_bits * 2^-32 when the
//    row's seed is nonzero; a NaN q is written as 0.  Elements at or past
//    n read as 0 (the padding of the Pallas tier's layout);
//  * dequantize: out = astype(float(q) * scale of q's segment).
// The arithmetic is IEEE division, multiplication, addition and rounding
// written with the _rn intrinsics, so FMA contraction (on in the tier's
// NVCC_FLAGS) cannot merge x / scale + u into one rounding.
//
// Bound on the H100: bytes.  Each kernel reads its input once and writes
// its output once, doing a few operations per element (the quantize
// reduction included), far below the card's operations-per-byte line:
// cast f32 -> bf16 moves 6 bytes an element, quantize 5 (+ 4 per
// segment), dequantize 5, so their least time is those bytes over
// 3.35 TB/s.  The cast (redesigned for Hopper's memory system) keeps
// every access a whole, warp-contiguous one and enough bytes in flight:
// lane l moves bytes [16 l, 16 l + 16) of each 512-byte chunk of the
// wider side, four (or, widening, up to sixteen) loads a lane are issued
// before any conversion (64 source bytes in flight), the narrower output
// is traded between 2 or 4 lanes with warp shuffles so every store is 16
// bytes, and each warp takes one tile of 512-2048 elements.  (On the
// H100, `.cs` / `.nc` cache hints and a persistent grid of whole waves
// measured slower than plain accesses and a tile a warp.)  The
// others move 16 bytes a thread per access where the row pointers are
// aligned, in one grid-stride pass (quantize: one warp per segment of up
// to 8192 elements, one block of 256 threads above, with a second read
// of the segment that L1/L2 serve; dequantize: 16 bytes written a thread,
// so a warp's stores are contiguous).  Unaligned rows take every kernel's
// scalar path.
#include <type_traits>

#include "wire.cuh"

namespace {

using accl::aligned;
using accl::BF16;
using accl::E4M3;
using accl::E5M2;
using accl::F16;
using accl::F32;
using accl::kMaxRanks;
using accl::kThreads;
using accl::max_nan;
using accl::sr_bits;
using accl::store_group;
using accl::Word;

struct RowPtrs {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  uint32_t seed[kMaxRanks];
};

// ---------------------------------------------------------------------------
// row 5: cast
// ---------------------------------------------------------------------------

// `unsigned_nan`: NaN loses its sign on the way (the Pallas tier's cast
// from float8_e5m2, as JAX's interpreted kernel computes it)
template <typename S, typename D>
__device__ __forceinline__ typename D::T convert(typename S::T v, int src,
                                                 bool unsigned_nan) {
  if constexpr (std::is_same<S, D>::value) {
    return v;  // a copy keeps bits
  } else {
    float x = S::widen(v);
    if (unsigned_nan && x != x) x = __uint_as_float(0x7FC00000u);
    return D::narrow(x, src);
  }
}

// The cast's access shape, source S to target D.  A chunk is 512 bytes of
// the WIDER side: lane l takes its bytes [16 l, 16 l + 16), so each
// warp-wide access of that side covers four whole 128-byte lines, and the
// narrower side's access of the same V elements a lane is one 16 / G or
// 16 * SB / DB byte word, as warp-contiguous.  A tile is U chunks, one
// warp's work, whose U loads are issued before any conversion: 64 bytes of
// the source in flight a lane.  Narrowing by G (2: f32 -> 16-bit, 16-bit
// -> fp8; 4: f32 -> fp8), G lanes trade their converted words so that each
// stores 16 bytes.
template <typename S, typename D>
struct CastShape {
  static constexpr int SB = sizeof(typename S::T);
  static constexpr int DB = sizeof(typename D::T);
  static constexpr int V = 16 / (SB > DB ? SB : DB);  // elements a lane, a chunk
  static constexpr int IN = V * SB;   // bytes a lane loads, a chunk
  static constexpr int OUT = V * DB;  // bytes a lane converts, a chunk
  static constexpr int G = IN > OUT ? IN / OUT : 1;
  static constexpr int U = 64 / IN;       // chunks a tile
  static constexpr int E = 32 * V * U;    // elements a warp's tile
  static_assert(U % G == 0, "a tile holds whole groups of G chunks");
};

template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(RowPtrs t, long long n, int src, bool unsigned_nan) {
  using TS = typename S::T;
  using TD = typename D::T;
  using C = CastShape<S, D>;
  using WIn = typename Word<C::IN>::T;
  constexpr int PW = C::OUT / 4;  // 32-bit words a lane converts, a chunk
  const int row = blockIdx.y;
  const TS* x = static_cast<const TS*>(t.in[row]);
  TD* y = static_cast<TD*>(t.out[row]);
  const int lane = threadIdx.x % 32;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (aligned(x) && aligned(y)) {
    const long long tiles = n / C::E;
    for (long long w = tid / 32; w < tiles; w += stride / 32) {
      const long long base = w * C::E;
      WIn in[C::U];
#pragma unroll
      for (int u = 0; u < C::U; ++u)  // every load before any conversion
        in[u] = reinterpret_cast<const WIn*>(x + base + u * 32 * C::V)[lane];
      uint32_t words[C::U][PW];
#pragma unroll
      for (int u = 0; u < C::U; ++u) {
        alignas(16) TS vs[C::V];
        alignas(16) TD vd[C::V];
        *reinterpret_cast<WIn*>(vs) = in[u];
#pragma unroll
        for (int k = 0; k < C::V; ++k)
          vd[k] = convert<S, D>(vs[k], src, unsigned_nan);
        if constexpr (C::G == 1) {  // 16 bytes a lane already
          reinterpret_cast<uint4*>(y + base + u * 32 * C::V)[lane] =
              *reinterpret_cast<const uint4*>(vd);
        } else {
#pragma unroll
          for (int q = 0; q < PW; ++q)
            words[u][q] = reinterpret_cast<const uint32_t*>(vd)[q];
        }
      }
      if constexpr (C::G > 1) {
#pragma unroll
        for (int c0 = 0; c0 < C::U; c0 += C::G)
          store_group<C::G, PW, C::U>(
              reinterpret_cast<uint4*>(y + base +
                                       (c0 + lane % C::G) * 32 * C::V) +
                  lane / C::G,
              c0, lane, words);
      }
    }
    done = tiles * C::E;
  }
  for (long long i = done + tid; i < n; i += stride)
    y[i] = convert<S, D>(x[i], src, unsigned_nan);
}

// One tile a warp: the block scheduler spreads the tiles over the SMs as
// they free up, which measured faster on the H100 than a persistent grid
// of whole waves (its last wave runs part-empty).
template <typename S, typename D>
int cast_as(const RowPtrs& t, int R, long long n, int src, bool unsigned_nan,
            cudaStream_t s) {
  constexpr int kWarps = kThreads / 32;
  constexpr long long E = CastShape<S, D>::E;
  long long blocks = ((n + E - 1) / E + kWarps - 1) / kWarps;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // then warps take several
  cast_kernel<S, D><<<dim3((unsigned)blocks, R), kThreads, 0, s>>>(
      t, n, src, unsigned_nan);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int cast_to(const RowPtrs& t, int R, long long n, int src, int dst,
            bool un, cudaStream_t s) {
  switch (dst) {
    case DT_F32: return cast_as<S, F32>(t, R, n, src, un, s);
    case DT_BF16: return cast_as<S, BF16>(t, R, n, src, un, s);
    case DT_F16: return cast_as<S, F16>(t, R, n, src, un, s);
    case DT_E4M3: return cast_as<S, E4M3>(t, R, n, src, un, s);
    case DT_E5M2: return cast_as<S, E5M2>(t, R, n, src, un, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// row 6: stochastic cast (mask-add-truncate)
// ---------------------------------------------------------------------------

// 16 elements a thread where both row pointers are 16-byte aligned
constexpr int kChunk = 16;

template <typename S, typename D>
__device__ __forceinline__ typename D::T sr_convert(typename S::T v,
                                                    uint32_t i, uint32_t seed,
                                                    uint32_t mask, float tiny,
                                                    bool sr) {
  float x = S::widen(v);
  if (sr && isfinite(x) && fabsf(x) >= tiny) {
    const uint32_t u = __float_as_uint(x);
    x = __uint_as_float((u + (sr_bits(i, seed) & mask)) & ~mask);
  }
  return D::narrow(x, DT_F32);  // the rounded value is a float32 value
}

template <typename S, typename D>
__global__ void stochastic_cast_kernel(RowPtrs t, long long n, uint32_t mask,
                                       float tiny, int always) {
  using TS = typename S::T;
  using TD = typename D::T;
  const int row = blockIdx.y;
  const TS* x = static_cast<const TS*>(t.in[row]);
  TD* y = static_cast<TD*>(t.out[row]);
  const uint32_t seed = t.seed[row];
  const bool sr = always || seed != 0;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (aligned(x) && aligned(y)) {
    const long long nchunk = n / kChunk;
    for (long long c = tid; c < nchunk; c += stride) {
      alignas(16) TS vs[kChunk];
      alignas(16) TD vd[kChunk];
      const uint4* src4 = reinterpret_cast<const uint4*>(x + c * kChunk);
#pragma unroll
      for (int k = 0; k < (int)(kChunk * sizeof(TS) / 16); ++k)
        reinterpret_cast<uint4*>(vs)[k] = src4[k];
      const uint32_t i0 = (uint32_t)(c * kChunk);
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        vd[k] = sr_convert<S, D>(vs[k], i0 + k, seed, mask, tiny, sr);
      uint4* dst4 = reinterpret_cast<uint4*>(y + c * kChunk);
#pragma unroll
      for (int k = 0; k < (int)(kChunk * sizeof(TD) / 16); ++k)
        dst4[k] = reinterpret_cast<const uint4*>(vd)[k];
    }
    done = nchunk * kChunk;
  }
  for (long long i = done + tid; i < n; i += stride)
    y[i] = sr_convert<S, D>(x[i], (uint32_t)i, seed, mask, tiny, sr);
}

template <typename S, typename D>
int sr_as(const RowPtrs& t, int R, long long n, uint32_t mask, float tiny,
          int always, cudaStream_t s) {
  const int per_row = (accl::grid_for((n + kChunk - 1) / kChunk, kThreads) +
                       R - 1) / R;
  dim3 grid(per_row < 1 ? 1 : per_row, R);
  stochastic_cast_kernel<S, D><<<grid, kThreads, 0, s>>>(t, n, mask, tiny,
                                                         always);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int sr_to(const RowPtrs& t, int R, long long n, int dst, uint32_t mask,
          float tiny, int always, cudaStream_t s) {
  switch (dst) {
    case DT_BF16: return sr_as<S, BF16>(t, R, n, mask, tiny, always, s);
    case DT_F16: return sr_as<S, F16>(t, R, n, mask, tiny, always, s);
    case DT_E4M3: return sr_as<S, E4M3>(t, R, n, mask, tiny, always, s);
    case DT_E5M2: return sr_as<S, E5M2>(t, R, n, mask, tiny, always, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// row 7: int8 quantize
// ---------------------------------------------------------------------------

// G threads per segment: a warp (G = 32) or a block (G = kThreads)
template <int G>
__device__ __forceinline__ float group_max(float v, float* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  if (G == 32) return v;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // smem is free (the previous segment read it)
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = smem[0];
#pragma unroll
  for (int w = 1; w < G / 32; ++w) v = max_nan(v, smem[w]);
  return v;
}

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

// V consecutive elements of a row as float32 (one 16-byte load)
template <typename S, int V>
__device__ __forceinline__ void load_vec(float (&v)[V],
                                         const typename S::T* p) {
  static_assert(V * sizeof(typename S::T) == 16, "one 16-byte access");
  alignas(16) typename S::T raw[V];
  *reinterpret_cast<uint4*>(raw) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = S::widen(raw[k]);
}

// `in`: the R row pointers; `values`: R rows of `out_len` int8 (row
// stride out_len); `scales`: R rows of nseg float32.  A segment that
// lies wholly inside the operand, with 16-byte aligned input and V-byte
// aligned output, takes 16-byte loads (V elements a thread per access);
// the others, one element a thread per access.
template <typename S, int G>
__global__ void quantize_kernel(RowPtrs t, long long n, long long L,
                                long long nseg, long long out_len,
                                int8_t* values, float* scales, int R) {
  using TS = typename S::T;
  constexpr int V = 16 / sizeof(TS);
  __shared__ float smem[kThreads / 32];
  const int groups_per_block = blockDim.x / G;
  const int lane = threadIdx.x % G;
  const long long group =
      (long long)blockIdx.x * groups_per_block + threadIdx.x / G;
  const long long ngroups = (long long)gridDim.x * groups_per_block;
  const long long total = (long long)R * nseg;
  for (long long g = group; g < total; g += ngroups) {
    const int row = (int)(g / nseg);
    const long long s = g % nseg;
    const TS* x = static_cast<const TS*>(t.in[row]);
    const uint32_t seed = t.seed[row];
    const long long lo = s * L;
    int8_t* q = values + (long long)row * out_len;
    const bool vec = lo + L <= n && L % (V * G) == 0 && aligned(x + lo) &&
                     ((uintptr_t)(q + lo) % V) == 0;
    float amax = 0.0f;
    if (vec) {
      for (long long k = (long long)lane * V; k < L; k += (long long)G * V) {
        float v[V];
        load_vec<S, V>(v, x + lo + k);
#pragma unroll
        for (int j = 0; j < V; ++j) amax = max_nan(amax, fabsf(v[j]));
      }
    } else {
      for (long long k = lane; k < L; k += G) {
        const long long i = lo + k;
        if (i < n) amax = max_nan(amax, fabsf(S::widen(x[i])));
      }
    }
    amax = group_max<G>(amax, smem);
    const float scale = max_nan(__fdiv_rn(amax, 127.0f), 1e-30f);
    if (lane == 0) scales[(long long)row * nseg + s] = scale;
    if (vec) {  // the segment lies before n <= out_len
      for (long long k = (long long)lane * V; k < L; k += (long long)G * V) {
        float v[V];
        load_vec<S, V>(v, x + lo + k);
        alignas(V) int8_t out[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          out[j] = quantize_one(v[j], scale, (uint32_t)(lo + k + j), seed);
        if constexpr (V == 4)
          *reinterpret_cast<uint32_t*>(q + lo + k) =
              *reinterpret_cast<const uint32_t*>(out);
        else
          *reinterpret_cast<uint2*>(q + lo + k) =
              *reinterpret_cast<const uint2*>(out);
      }
    } else {
      for (long long k = lane; k < L; k += G) {
        const long long i = lo + k;
        if (i >= out_len) break;
        const float v = i < n ? S::widen(x[i]) : 0.0f;
        q[i] = quantize_one(v, scale, (uint32_t)i, seed);
      }
    }
  }
}

template <typename S>
int quantize_as(const RowPtrs& t, int R, long long n, long long L,
                long long nseg, long long out_len, int8_t* values,
                float* scales, cudaStream_t s) {
  const long long total = (long long)R * nseg;
  if (L <= 8192) {
    constexpr int per_block = kThreads / 32;
    const long long blocks = (total + per_block - 1) / per_block;
    const int grid = blocks > 132 * 16 ? 132 * 16 : (int)blocks;
    quantize_kernel<S, 32><<<grid, kThreads, 0, s>>>(t, n, L, nseg, out_len,
                                                     values, scales, R);
  } else {
    const int grid = total > 132 * 8 ? 132 * 8 : (int)total;
    quantize_kernel<S, kThreads><<<grid, kThreads, 0, s>>>(
        t, n, L, nseg, out_len, values, scales, R);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// row 8: int8 dequantize
// ---------------------------------------------------------------------------

// row r: q at values + r * q_stride, its scales at scales + r * s_stride,
// n outputs at out + r * n.  Each thread writes 16 bytes an access (V
// outputs: 4 float32 or 8 16-bit), so a warp's stores are contiguous.
template <typename D>
__global__ void dequantize_kernel(const int8_t* values, long long q_stride,
                                  const float* scales, long long s_stride,
                                  void* out, long long n, long long L) {
  using TD = typename D::T;
  constexpr int V = 16 / sizeof(TD);
  const int row = blockIdx.y;
  const int8_t* q = values + (long long)row * q_stride;
  const float* sc = scales + (long long)row * s_stride;
  TD* y = static_cast<TD*>(out) + (long long)row * n;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (((uintptr_t)q % V) == 0 && aligned(y) && L % V == 0) {
    const long long nchunk = n / V;
    for (long long c = tid; c < nchunk; c += stride) {
      alignas(V) int8_t vq[V];
      if constexpr (V == 4)
        *reinterpret_cast<uint32_t*>(vq) =
            *reinterpret_cast<const uint32_t*>(q + c * V);
      else
        *reinterpret_cast<uint2*>(vq) =
            *reinterpret_cast<const uint2*>(q + c * V);
      const float scale = sc[c * V / L];  // one segment per chunk
      alignas(16) TD vd[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        vd[k] = D::narrow(__fmul_rn((float)vq[k], scale), DT_F32);
      *reinterpret_cast<uint4*>(y + c * V) =
          *reinterpret_cast<const uint4*>(vd);
    }
    done = nchunk * V;
  }
  for (long long i = done + tid; i < n; i += stride)
    y[i] = D::narrow(__fmul_rn((float)q[i], sc[i / L]), DT_F32);
}

template <typename D>
int dequantize_as(const int8_t* values, long long q_stride,
                  const float* scales, long long s_stride, void* out, int R,
                  long long n, long long L, cudaStream_t s) {
  constexpr int V = 16 / sizeof(typename D::T);
  const int per_row = (accl::grid_for((n + V - 1) / V, kThreads) + R - 1) / R;
  dim3 grid(per_row < 1 ? 1 : per_row, R);
  dequantize_kernel<D><<<grid, kThreads, 0, s>>>(values, q_stride, scales,
                                                 s_stride, out, n, L);
  return static_cast<int>(cudaGetLastError());
}

RowPtrs rows(const void* const* in, void* const* out, const uint32_t* seeds,
             int R) {
  RowPtrs t = {};
  for (int r = 0; r < R; ++r) {
    t.in[r] = in[r];
    if (out) t.out[r] = out[r];
    if (seeds) t.seed[r] = seeds[r];
  }
  return t;
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 on
// success).  `in`/`out` are host arrays of R device pointers, `seeds` a
// host array of R seeds; dtypes are accl_tpu_torch DataType codes.

// `e5m2_nan_unsigned`: a float8_e5m2 operand's NaN loses its sign (the
// Pallas tier's cast); the wire lanes keep it, as JAX's astype does
extern "C" int accl_cast(const void* const* in, void* const* out, int R,
                         long long n, int src, int dst,
                         int e5m2_nan_unsigned, void* stream) {
  if (R < 1 || R > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  const RowPtrs t = rows(in, out, nullptr, R);
  const bool un = e5m2_nan_unsigned && src == DT_E5M2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src) {
    case DT_F32: return cast_to<F32>(t, R, n, src, dst, un, s);
    case DT_BF16: return cast_to<BF16>(t, R, n, src, dst, un, s);
    case DT_F16: return cast_to<F16>(t, R, n, src, dst, un, s);
    case DT_E4M3: return cast_to<E4M3>(t, R, n, src, dst, un, s);
    case DT_E5M2: return cast_to<E5M2>(t, R, n, src, dst, un, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int accl_stochastic_cast(const void* const* in, void* const* out,
                                    const uint32_t* seeds, int R,
                                    long long n, int src, int dst, int drop,
                                    float tiny, int always, void* stream) {
  if (R < 1 || R > kMaxRanks || drop < 1 || drop > 23)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowPtrs t = rows(in, out, seeds, R);
  const uint32_t mask = (1u << drop) - 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src) {
    case DT_F32: return sr_to<F32>(t, R, n, dst, mask, tiny, always, s);
    case DT_BF16: return sr_to<BF16>(t, R, n, dst, mask, tiny, always, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int accl_quantize_int8(const void* const* in,
                                  const uint32_t* seeds, int R, long long n,
                                  long long L, long long nseg,
                                  long long out_len, void* values,
                                  void* scales, int src, void* stream) {
  if (R < 1 || R > kMaxRanks || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowPtrs t = rows(in, nullptr, seeds, R);
  int8_t* v = static_cast<int8_t*>(values);
  float* sc = static_cast<float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src) {
    case DT_F32: return quantize_as<F32>(t, R, n, L, nseg, out_len, v, sc, s);
    case DT_BF16:
      return quantize_as<BF16>(t, R, n, L, nseg, out_len, v, sc, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int accl_dequantize_int8(const void* values, long long q_stride,
                                    const void* scales, long long s_stride,
                                    void* out, int R, long long n,
                                    long long L, int dst, void* stream) {
  if (R < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* v = static_cast<const int8_t*>(values);
  const float* sc = static_cast<const float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dst) {
    case DT_F32: return dequantize_as<F32>(v, q_stride, sc, s_stride, out, R, n, L, s);
    case DT_BF16:
      return dequantize_as<BF16>(v, q_stride, sc, s_stride, out, R, n, L, s);
    case DT_F16: return dequantize_as<F16>(v, q_stride, sc, s_stride, out, R, n, L, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
