// K1-K3: ring collectives over P ranks whose buffers share one device.
//
// Replace accl_tpu/ops/pallas/ring.py:
//   K1 _allreduce_kernel :123       (pallas_call in _call :316, entry ring_allreduce :329)
//   K2 _reduce_scatter_kernel :224  (entry ring_reduce_scatter :392)
//   K3 _allgather_kernel :288 with relay_allgather_hops :259 (entry ring_allgather :418)
//
// On the TPU each hop is a remote DMA to the ring neighbour with slot-ack
// semaphores.  Here every rank's buffer lies in the same device memory,
// reached through a table of per-rank pointers, so no hop has a wire to
// cross: each thread walks the ring's hop schedule for its own elements in
// registers.  The ring's FOLD ORDER is kept exactly (it decides the float
// result): in direction lane d (sign sg = +1, or -1 for the second half of
// a bidirectional ring) block b starts at rank b+sg and visits ranks
// b+2sg, ..., b+P*sg = b, each hop computing acc = op(wire(acc), x_r[b]);
// rank b keeps its block at full precision and every other rank receives
// it through the wire lane (narrow, then widen).  Blocks come from the
// JAX package's padding rule, computed by the Python wrapper; elements
// past n are read as zeros.  No block waits on another, so the kernels
// cannot deadlock.
//
// Bound on the H100: bytes.  K1 reads P*n elements and writes P*n;
// K2 reads P*n and writes the P padded blocks (P*L/P = L >= n); K3 reads
// P*n and writes P*n for each rank that takes the result (P*P*n as an
// allgather, P*n as the root-only gather).  Each does at most one
// operation per element read, so the least time is those bytes over
// 3.35 TB/s.  The design reads each
// input element once and writes each output element once, 16 bytes per
// access where pointers are aligned; K3's two forms (every rank's result,
// and the root's alone) move their bytes on the streaming tile core
// (common.cuh), which on the H100 beat a bulk copy (cp.async.bulk through
// shared memory) of the same bytes (PERF.md).
#include "wire.cuh"

namespace {

using accl::Arith;
using accl::Convert;
using accl::kMaxRanks;
using accl::kThreads;
using accl::load;
using accl::RankIn;
using accl::RankPtrs;
using accl::ring_mod;
using accl::store;
using accl::table;

template <typename T> struct Code;
template <> struct Code<float> { static constexpr int value = DT_F32; };
template <> struct Code<__nv_bfloat16> { static constexpr int value = DT_BF16; };
template <> struct Code<__half> { static constexpr int value = DT_F16; };

// round a value of the accumulate type T through the wire dtype and back
// (the fp8 lanes and the raw int8 cast as JAX's astype computes them,
// wire.cuh)
template <typename T> __device__ __forceinline__ T wire_round(T v, int wire) {
  if (wire == DT_BF16)
    return Convert<T>::from(__float2bfloat16_rn(accl::to_float(v)));
  if (wire == DT_F16)
    return Convert<T>::from(__float2half_rn(accl::to_float(v)));
  if (wire)
    return Convert<T>::from(
        accl::wire_roundtrip(accl::to_float(v), wire, Code<T>::value));
  return v;
}
template <> __device__ __forceinline__ int32_t wire_round(int32_t v, int) {
  return v;  // the wrapper refuses a wire lane on integer operands
}

// K1: `half` = padded elements per direction lane, `blk` = per block
template <typename T, int V>
__global__ void ring_allreduce_kernel(RankPtrs ptrs, int P, long long n,
                                      long long half, long long blk, int op,
                                      int wire) {
  const long long stride = (long long)gridDim.x * blockDim.x * V;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < n; e += stride) {
    const int d = (int)(e / half);
    const int b = (int)((e - d * half) / blk);
    const int sg = d == 0 ? 1 : -1;
    int r = ring_mod(b + sg, P);
    T acc[V];
    load<T, V>(acc, ptrs.in[r], e, n);
    for (int s = 1; s < P; ++s) {
      r = ring_mod(r + sg, P);
      T x[V];
      load<T, V>(x, ptrs.in[r], e, n);
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] = Arith<T>::apply(op, wire_round(acc[k], wire), x[k]);
    }
    T sent[V];
#pragma unroll
    for (int k = 0; k < V; ++k) sent[k] = wire_round(acc[k], wire);
    for (int q = 0; q < P; ++q) {
      if (q == b)
        store<T, V>(ptrs.out[q], e, acc, n);
      else
        store<T, V>(ptrs.out[q], e, sent, n);
    }
  }
}

// K2: rank b's output is the padded block b (`blk` elements)
template <typename T, int V>
__global__ void ring_reduce_scatter_kernel(RankPtrs ptrs, int P, long long n,
                                           long long blk, int op) {
  const long long total = (long long)P * blk;
  const long long stride = (long long)gridDim.x * blockDim.x * V;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < total; e += stride) {
    const int b = (int)(e / blk);
    int r = ring_mod(b + 1, P);
    T acc[V];
    load<T, V>(acc, ptrs.in[r], e, n);
    for (int s = 1; s < P; ++s) {
      r = ring_mod(r + 1, P);
      T x[V];
      load<T, V>(x, ptrs.in[r], e, n);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = Arith<T>::apply(op, acc[k], x[k]);
    }
    store<T, V>(ptrs.out[b], e - b * blk, acc, blk);
  }
}

// K3: out_r[q*n + k] = in_q[k] for every rank r whose output pointer is
// not null; blockIdx.y = q.  Pure data movement, so only the element width
// matters.  On the streaming tile core (common.cuh): each warp loads one
// 2 KiB tile of rank q's input (four 16-byte words a lane, all in flight
// before any store) and stores it into every output; a rank whose input
// or any output slot is not 16-byte aligned takes the scalar path.
// __grid_constant__ lets the block index the pointer table by rank in
// place, without a copy into local memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_allgather_kernel(const __grid_constant__ RankPtrs ptrs, int P,
                          long long n) {
  using S = accl::TileShape<sizeof(T), sizeof(T)>;
  const T* src = static_cast<const T*>(ptrs.in[blockIdx.y]);
  const long long slot = blockIdx.y * n;
  bool vec = accl::aligned(src);
  for (int r = 0; r < P; ++r)
    if (ptrs.out[r])
      vec = vec && accl::aligned(static_cast<const T*>(ptrs.out[r]) + slot);
  accl::tile_walk<S::E>(
      n, vec,
      [&](long long e, int lane) {
        uint4 w[S::U];
        accl::tile_load<S::V>(w, src + e, lane);
        for (int r = 0; r < P; ++r)
          if (ptrs.out[r])
            accl::tile_store<S::V>(static_cast<T*>(ptrs.out[r]) + slot + e,
                                   lane, w);
      },
      [&](long long i) {
        const T v = src[i];
        for (int r = 0; r < P; ++r)
          if (ptrs.out[r]) static_cast<T*>(ptrs.out[r])[slot + i] = v;
      });
}

// K3, root only (the rooted gather): out[q*n + k] = in_q[k]; blockIdx.y =
// q.  K3's copy with one output, a plain argument: no table of P outputs
// to walk and test for null.  A block reads its rank's input pointer
// once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_gather_root_kernel(const __grid_constant__ RankIn ranks, T* out,
                            long long n) {
  using S = accl::TileShape<sizeof(T), sizeof(T)>;
  const T* src = static_cast<const T*>(ranks.in[blockIdx.y]);
  T* dst = out + blockIdx.y * n;
  accl::tile_walk<S::E>(
      n, accl::aligned(src) && accl::aligned(dst),
      [&](long long e, int lane) {
        uint4 w[S::U];
        accl::tile_load<S::V>(w, src + e, lane);
        accl::tile_store<S::V>(dst + e, lane, w);
      },
      [&](long long i) { dst[i] = src[i]; });
}

template <typename T>
int allreduce_as(const RankPtrs& t, int P, long long n, long long half,
                 long long blk, int op, int wire, int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    ring_allreduce_kernel<T, V><<<accl::grid_for((n + V - 1) / V, kThreads),
                                  kThreads, 0, s>>>(t, P, n, half, blk, op,
                                                    wire);
  else
    ring_allreduce_kernel<T, 1><<<accl::grid_for(n, kThreads), kThreads, 0,
                                  s>>>(t, P, n, half, blk, op, wire);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int reduce_scatter_as(const RankPtrs& t, int P, long long n, long long blk,
                      int op, int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long total = (long long)P * blk;
  if (vec)
    ring_reduce_scatter_kernel<T, V>
        <<<accl::grid_for(total / V, kThreads), kThreads, 0, s>>>(t, P, n,
                                                                  blk, op);
  else
    ring_reduce_scatter_kernel<T, 1>
        <<<accl::grid_for(total, kThreads), kThreads, 0, s>>>(t, P, n, blk,
                                                              op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int allgather_as(const RankPtrs& t, int P, long long n, cudaStream_t s) {
  using S = accl::TileShape<sizeof(T), sizeof(T)>;
  ring_allgather_kernel<T><<<dim3(accl::tile_blocks(n, S::E, true), P),
                             kThreads, 0, s>>>(t, P, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gather_root_as(const RankIn& t, void* out, int P, long long n,
                   cudaStream_t s) {
  using S = accl::TileShape<sizeof(T), sizeof(T)>;
  ring_gather_root_kernel<T><<<dim3(accl::tile_blocks(n, S::E, true), P),
                               kThreads, 0, s>>>(t, static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 on
// success).  `in`/`out` are host arrays of P device pointers; `vec`
// selects 16-byte accesses (every pointer 16-byte aligned, n a multiple
// of the vector width).

extern "C" int accl_ring_allreduce(const void* const* in, void* const* out,
                                   int P, long long n, long long half,
                                   long long blk, int dtype, int op,
                                   int wire, int vec, void* stream) {
  if (P < 1 || P > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs t = table(in, out, P, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return allreduce_as<float>(t, P, n, half, blk, op, wire, vec, s);
    case DT_BF16:
      return allreduce_as<__nv_bfloat16>(t, P, n, half, blk, op, wire, vec, s);
    case DT_F16: return allreduce_as<__half>(t, P, n, half, blk, op, wire, vec, s);
    case DT_I32: return allreduce_as<int32_t>(t, P, n, half, blk, op, 0, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int accl_ring_reduce_scatter(const void* const* in,
                                        void* const* out, int P, long long n,
                                        long long blk, int dtype, int op,
                                        int vec, void* stream) {
  if (P < 1 || P > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs t = table(in, out, P, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return reduce_scatter_as<float>(t, P, n, blk, op, vec, s);
    case DT_BF16:
      return reduce_scatter_as<__nv_bfloat16>(t, P, n, blk, op, vec, s);
    case DT_F16: return reduce_scatter_as<__half>(t, P, n, blk, op, vec, s);
    case DT_I32: return reduce_scatter_as<int32_t>(t, P, n, blk, op, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int accl_ring_allgather(const void* const* in, void* const* out,
                                   int P, long long n, int elem_bytes,
                                   void* stream) {
  if (P < 1 || P > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs t = table(in, out, P, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return allgather_as<uint8_t>(t, P, n, s);
    case 2: return allgather_as<uint16_t>(t, P, n, s);
    case 4: return allgather_as<uint32_t>(t, P, n, s);
    case 8: return allgather_as<uint64_t>(t, P, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The root-only gather: `out` (the root's result) receives the P ranks'
// n-element inputs `in` in rank order.
extern "C" int accl_ring_gather_root(const void* const* in, void* out, int P,
                                     long long n, int elem_bytes,
                                     void* stream) {
  if (P < 1 || P > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  RankIn t = {};
  for (int i = 0; i < P; ++i) t.in[i] = in[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return gather_root_as<uint8_t>(t, out, P, n, s);
    case 2: return gather_root_as<uint16_t>(t, out, P, n, s);
    case 4: return gather_root_as<uint32_t>(t, out, P, n, s);
    case 8: return gather_root_as<uint64_t>(t, out, P, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
