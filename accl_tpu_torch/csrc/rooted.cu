// Rows 9-11: the rooted ring relays over P ranks whose buffers share one
// device.
//
// Replace accl_tpu/ops/pallas/rooted.py:
//   _bcast_kernel :59    (entry ring_bcast :187, pallas_call through ring._call)
//   _reduce_kernel :95   (entry ring_reduce :211)
//   _scatter_kernel :133 (entry ring_scatter :240)
// The rooted gather (ring_gather :280) reuses K3 in ring.cu with a null
// output for every rank but the root.
//
// On the TPU each relay is P-1 remote-DMA hops around the ring, every
// rank sending its carry each hop and adopting / folding / keeping what
// arrives by its distance from the root.  With every rank's buffer in
// one device memory, reached through the per-rank pointer table, no hop
// has a wire to cross: in the bcast and the reduce each thread owns a
// column of 16-byte vectors (scalar where a pointer is unaligned or n
// ragged) and walks the relay's hop schedule for it in registers; the
// scatter is a copy of P blocks on the streaming tile core (common.cuh).
// No block waits on another.
// Only the REDUCE fold order decides a value: the rank at root-distance
// rel ends with op(x_rel, partial_{rel+1}) (op(own, incoming), as
// rooted.py:125 folds), partial_{P-1} = x_{root+P-1}; so the root holds
// op(x_root, op(x_{root+1}, ... x_{root+P-1})).  The relays fold
// elementwise, so num_segments and the TPU's lane packing change no value
// and the kernels take neither.
//
// A null output pointer skips that rank's stores: the in-place bcast
// passes null for the root (its buffer already holds the payload), the
// facade's reduce passes the root's output alone.
//
// Bound on the H100: bytes.  bcast reads n and writes n per output;
// reduce reads P*n, does (P-1)*n operations and writes n per output;
// scatter reads P*n and writes n per output (0.1603 ms for 4 x 64 MiB).
// Far below the card's operations-per-byte line, so the least time is
// those bytes over 3.35 TB/s.  The design reads each input element once
// and writes each output element once, 16 bytes per access where
// pointers are aligned; the scatter's warps each load a whole tile (64
// bytes a lane in flight) before they store it.
#include "common.cuh"

namespace {

using accl::Arith;
using accl::kMaxRanks;
using accl::kThreads;
using accl::load;
using accl::RankOut;
using accl::RankPtrs;
using accl::store;
using accl::table;

// row 9: out_q = in_root for every non-null out_q, in relay order
// (root+1, ..., root+P-1, then the root).  Only the element width matters.
template <typename T, int V>
__global__ void ring_bcast_kernel(RankPtrs ptrs, int P, int root,
                                  long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x * V;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < n; e += stride) {
    T v[V];
    load<T, V>(v, ptrs.in[root], e, n);
    for (int d = 1; d <= P; ++d) {
      const int q = (root + d) % P;
      if (ptrs.out[q]) store<T, V>(ptrs.out[q], e, v, n);
    }
  }
}

// row 10: partials flow from root-distance P-1 toward the root, each
// relay folding its own operand in; every non-null out_r gets its partial.
template <typename T, int V>
__global__ void ring_reduce_kernel(RankPtrs ptrs, int P, int root,
                                   long long n, int op) {
  const long long stride = (long long)gridDim.x * blockDim.x * V;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < n; e += stride) {
    int r = (root + P - 1) % P;
    T acc[V];
    load<T, V>(acc, ptrs.in[r], e, n);
    if (ptrs.out[r]) store<T, V>(ptrs.out[r], e, acc, n);
    for (int rel = P - 2; rel >= 0; --rel) {
      r = (root + rel) % P;
      T x[V];
      load<T, V>(x, ptrs.in[r], e, n);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = Arith<T>::apply(op, x[k], acc[k]);
      if (ptrs.out[r]) store<T, V>(ptrs.out[r], e, acc, n);
    }
  }
}

// row 11: out_q[k] = src[q*n + k], src the root's operand; blockIdx.y =
// q.  The TPU injects the blocks farthest-first, one per hop; here each
// destination's copy is independent of the others: the mirror of K3's
// root-only gather (ring.cu), one operand read at P offsets into P
// outputs, on the streaming tile core.  Each row decides its alignment
// (its block of src and its output), so a ragged n sends only the rows
// it misaligns to the scalar path.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_scatter_kernel(const T* src, const __grid_constant__ RankOut ranks,
                        long long n) {
  using S = accl::TileShape<sizeof(T), sizeof(T)>;
  const T* from = src + blockIdx.y * n;
  T* dst = static_cast<T*>(ranks.out[blockIdx.y]);
  accl::tile_walk<S::E>(
      n, accl::aligned(from) && accl::aligned(dst),
      [&](long long e, int lane) {
        uint4 w[S::U];
        accl::tile_load<S::V>(w, from + e, lane);
        accl::tile_store<S::V>(dst + e, lane, w);
      },
      [&](long long i) { dst[i] = from[i]; });
}

template <typename T>
int bcast_as(const RankPtrs& t, int P, int root, long long n, int vec,
             cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    ring_bcast_kernel<T, V><<<accl::grid_for((n + V - 1) / V, kThreads),
                              kThreads, 0, s>>>(t, P, root, n);
  else
    ring_bcast_kernel<T, 1><<<accl::grid_for(n, kThreads), kThreads, 0, s>>>(
        t, P, root, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int reduce_as(const RankPtrs& t, int P, int root, long long n, int op,
              int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    ring_reduce_kernel<T, V><<<accl::grid_for((n + V - 1) / V, kThreads),
                               kThreads, 0, s>>>(t, P, root, n, op);
  else
    ring_reduce_kernel<T, 1><<<accl::grid_for(n, kThreads), kThreads, 0,
                               s>>>(t, P, root, n, op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter_as(const void* src, const RankOut& t, int P, long long n,
               cudaStream_t s) {
  using S = accl::TileShape<sizeof(T), sizeof(T)>;
  ring_scatter_kernel<T><<<dim3(accl::tile_blocks(n, S::E, true), P),
                           kThreads, 0, s>>>(static_cast<const T*>(src), t,
                                             n);
  return static_cast<int>(cudaGetLastError());
}

bool bad_ranks(int P, int root) {
  return P < 1 || P > kMaxRanks || root < 0 || root >= P;
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 on
// success).  `in`/`out` are host arrays of P device pointers (an out entry
// of the bcast and the reduce may be null: that rank's stores are
// skipped); `vec` selects 16-byte accesses (every pointer used 16-byte
// aligned, n a multiple of the vector width).  `n` is the element count
// per rank (for scatter: per destination block of the root's P*n
// operand).

extern "C" int accl_ring_bcast(const void* const* in, void* const* out,
                               int P, int root, long long n, int elem_bytes,
                               int vec, void* stream) {
  if (bad_ranks(P, root)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs t = table(in, out, P, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return bcast_as<uint8_t>(t, P, root, n, vec, s);
    case 2: return bcast_as<uint16_t>(t, P, root, n, vec, s);
    case 4: return bcast_as<uint32_t>(t, P, root, n, vec, s);
    case 8: return bcast_as<uint64_t>(t, P, root, n, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int accl_ring_reduce(const void* const* in, void* const* out,
                                int P, int root, long long n, int dtype,
                                int op, int vec, void* stream) {
  if (bad_ranks(P, root)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs t = table(in, out, P, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return reduce_as<float>(t, P, root, n, op, vec, s);
    case DT_BF16: return reduce_as<__nv_bfloat16>(t, P, root, n, op, vec, s);
    case DT_F16: return reduce_as<__half>(t, P, root, n, op, vec, s);
    case DT_I32: return reduce_as<int32_t>(t, P, root, n, op, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scatter: `src` (the root's P*n-element operand) sends block q to
// `out[q]`, P device pointers, none null.
extern "C" int accl_ring_scatter(const void* src, void* const* out, int P,
                                 long long n, int elem_bytes, void* stream) {
  if (P < 1 || P > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  RankOut t = {};
  for (int i = 0; i < P; ++i) t.out[i] = out[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return scatter_as<uint8_t>(src, t, P, n, s);
    case 2: return scatter_as<uint16_t>(src, t, P, n, s);
    case 4: return scatter_as<uint32_t>(src, t, P, n, s);
    case 8: return scatter_as<uint64_t>(src, t, P, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
