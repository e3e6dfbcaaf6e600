// Row 14: the command-ring sequencer over P ranks whose buffers share one
// device, one launch per refill window.
//
// Replaces accl_tpu/ops/pallas/cmdring.py::_sequencer_kernel :534
// (pallas_call :737, _pallas_windows :639, run_windows :853), the TPU
// counterpart of ACCL's CCLO firmware run loop.  There, per slot, every
// rank's block is gathered by the ring's remote-DMA relay, the slot's
// opcode / function / root / peer / fparam words are read from SMEM, and
// slot_epilogue (:179) computes the rank's result; a neighbour barrier
// separates slots.
//
// Here every rank's operand is one pointer away, so no block crosses a
// wire.  The window travels as ONE descriptor (Window below, packed by
// ops/cuda/cmdring.py::pack_window into one host buffer and passed in
// the kernel's parameter block, __grid_constant__, read in place): the
// slot words, per slot the widths, width class, wire dtype, barrier flag
// and work geometry, and the ranks' pointers.  The opcode, function,
// root, peer and fparam of a slot are data decoded on the device; the
// element type (a template) and per slot the width class (the relations
// slot_epilogue branches on), the wire and the chunk pick the code path,
// as the window's shape keys the JAX program cache.
//
// Numerics equal slot_epilogue's bit for bit: the fold runs in rank order
// b0 op b1 op ... (common.cuh's Arith: NaN-propagating MAX, wrapping int
// SUM, round-to-nearest-even after every 16-bit operation); each
// contribution is rounded through the wire dtype before the fold while a
// rank's own operand stays unrounded; fp = float(fparam) * 2^-16 cast to
// the operand type; products and differences use the _rn intrinsics so
// no multiply-add is contracted; alltoall moves every rank's wire-rounded
// chunks.
//
// Bound on the H100: bytes.  A window reads each operand element it uses
// once and writes each result element once, with at most P-1 operations
// per result element: far below the card's operations-per-byte line.
// The design (redesigned for Hopper) moves those bytes on the streaming
// tile core's access shape (common.cuh):
//  * a WORK ITEM is one tile of a slot's columns, E = 32 lanes x V
//    elements (16 bytes) x U chunks, lane l at elements [V l, V l + V) of
//    each 32 V-element chunk; an alltoall item is one tile of one rank
//    PAIR (a, b), which swaps chunk a of rank b with chunk b of rank a; a
//    reduce-scatter's or fused apply's item is one tile of one rank's
//    result where no result of the slot lies over an operand (else of
//    every rank's);
//  * the items of every slot of a PHASE (the slots between two barriers)
//    form one flat list (Window::first, the per-slot prefix of item
//    counts, filled by the launch), so the slots of a phase run side by
//    side; each warp takes one item;
//  * inside an item every load of every rank's words is issued before the
//    fold and before any store, up to NP = 4 ranks at once (more ranks
//    fold in groups of 4): an allreduce's over the whole tile (NP x U =
//    16 16-byte words a lane, 256 bytes in flight, at 4-byte elements),
//    every other class's
//    chunk by chunk (NP words); the loops over ranks and results stay
//    rolled and the column offsets 32-bit, since one kernel's register
//    count is its worst class's;
//  * a tile past the slot's last whole one, or of a slot whose operands
//    or results are not all 16-byte aligned (at every chunk offset its
//    class uses), takes the element path: its columns one element a
//    lane.  That is decided per slot and tile, not at every access: a
//    fallback at every access took the kernel to ptxas's 255 registers
//    with spills, and multiplied its build time;
//  * a window with no barrier is one plain launch of one item a warp with
//    no grid cap; a window with one keeps a cooperative, co-resident grid
//    that walks each phase's items and meets at a grid barrier whose
//    counter the last block to arrive resets, so no memset is launched.
//
// Results that keep their operand's column (in place: allreduce, bcast,
// send / recv, the MPI in-place allgather, reduce-scatter, fused apply and
// matmul-reduce-scatter at the result's chunk 0, alltoall, the attention
// hop up to 8 ranks) are right: an item reads every word any of its
// stores overwrites first (the reduce-scatter forms compute rank 0's
// result, the only one that reads chunk 0, before storing any other and
// store it last).  The wrapper stages any other overlap as a copy on the
// same stream.  Slots of one phase never write what another reads or
// writes (the wrapper puts a barrier before such a slot; a slot that
// reads what an earlier slot writes is refused by the engine,
// data_dependency, as in JAX, where each slot reads its operands as they
// were before the window).
#include <cstddef>
#include <cstring>

#include "common.cuh"

namespace {

using accl::aligned;
using accl::Arith;
using accl::Convert;
using accl::kThreads;
using accl::zero;

constexpr int kMaxSlots = 64;   // CMDRING_MAX_DEPTH
constexpr int kMaxPtrs = 512;   // rank-slots per launch (64 slots x 8 ranks)
constexpr int kWords = 11;      // CMDRING_SLOT_WORDS
constexpr int kMaxP = 64;       // ranks of one window (common.cuh kMaxRanks)
constexpr int kWarps = kThreads / 32;

// slot word indices (CMDRING_FIELDS)
enum : int { W_SEQN = 0, W_OPCODE = 1, W_FUNCTION = 4, W_ROOT = 5,
             W_PEER = 8, W_FPARAM = 10 };
// CmdOpcode values used by the epilogue
enum : int { OPC_ALLREDUCE = 1, OPC_BCAST = 2, OPC_REDUCE_SCATTER = 4,
             OPC_ALLGATHER = 5, OPC_ALLTOALL = 6, OPC_SEND = 8, OPC_RECV = 9,
             OPC_MATMUL_RS = 10, OPC_APPLY = 11, OPC_ATTN_HOP = 12,
             OPC_MAX = 12 };
// width classes (ops/cuda/cmdring.py::slot_class)
enum : int { CLS_SAME = 0, CLS_AG = 1, CLS_APPLY = 2, CLS_RS = 3,
             CLS_ATTN = 4, CLS_SOLO = 5 };

// The window descriptor, field for field ops/cuda/cmdring.py::WINDOW.
// Per slot: the operand and result widths, the per-rank chunk (0: none),
// the columns of one part and the parts (rank pairs of an alltoall,
// else 1), the width class, wire DataType (0: none) and barrier flag.
// `in` / `out` hold slot s, rank r at s * P + r (null operand: zeros;
// null result: that rank takes none).  `first` is filled by the launch.
struct Window {
  int32_t words[kMaxSlots][kWords];
  int64_t in_w[kMaxSlots], out_w[kMaxSlots], chunk[kMaxSlots],
      cols[kMaxSlots];
  int64_t first[kMaxSlots + 1];
  int32_t cls[kMaxSlots], wire[kMaxSlots], sync[kMaxSlots],
      parts[kMaxSlots];
  int32_t n_slots, P, dtype, pad;
  const void* in[kMaxPtrs];
  void* out[kMaxPtrs];
};
static_assert(offsetof(Window, in_w) == 2816, "descriptor layout");
static_assert(offsetof(Window, first) == 4864, "descriptor layout");
static_assert(offsetof(Window, cls) == 5384, "descriptor layout");
static_assert(offsetof(Window, n_slots) == 6408, "descriptor layout");
static_assert(offsetof(Window, in) == 6424, "descriptor layout");
static_assert(sizeof(Window) == 14616, "descriptor layout");

template <typename T> struct Mul {  // float: no contraction into an FMA
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __fsub_rn(a, b); }
};
template <> struct Mul<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
};
template <> struct Mul<__half> {
  static __device__ __forceinline__ __half mul(__half a, __half b) {
    return __float2half_rn(__fmul_rn(__half2float(a), __half2float(b)));
  }
  static __device__ __forceinline__ __half sub(__half a, __half b) {
    return __float2half_rn(__fsub_rn(__half2float(a), __half2float(b)));
  }
};
template <> struct Mul<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  static __device__ __forceinline__ __nv_bfloat16 sub(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fsub_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};
template <> struct Mul<int32_t> {  // wrapping, as jnp int32
  static __device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
  }
  static __device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
  }
};
template <> struct Mul<int64_t> {
  static __device__ __forceinline__ int64_t mul(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a * (uint64_t)b);
  }
  static __device__ __forceinline__ int64_t sub(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a - (uint64_t)b);
  }
};

// one contribution through the slot's wire lane (0 = none)
template <typename T>
__device__ __forceinline__ T wire_round(T v, int wire) {
  if (wire == DT_BF16) return Convert<T>::from(Convert<__nv_bfloat16>::from(v));
  if (wire == DT_F16) return Convert<T>::from(Convert<__half>::from(v));
  return v;
}

// -- one lane's 16-byte word of V elements ----------------------------------

template <typename T> struct Lane {
  static constexpr int V = 16 / sizeof(T);

  // elements [e, e + V) of p (aligned, whole): one 16-byte access; a null
  // operand reads zeros, a null result takes nothing
  static __device__ __forceinline__ uint4 load(const void* p, int e) {
    if (p == nullptr) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(static_cast<const T*>(p) + e);
  }
  static __device__ __forceinline__ void store(void* p, int e, uint4 w) {
    if (p != nullptr) *reinterpret_cast<uint4*>(static_cast<T*>(p) + e) = w;
  }

  template <typename F>
  static __device__ __forceinline__ uint4 map(uint4 a, uint4 b, F f) {
    alignas(16) T x[V], y[V];
    *reinterpret_cast<uint4*>(x) = a;
    *reinterpret_cast<uint4*>(y) = b;
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = f(x[k], y[k]);
    return *reinterpret_cast<const uint4*>(x);
  }

  static __device__ __forceinline__ uint4 rounded(uint4 a, int wire) {
    if (wire == 0) return a;
    return map(a, a, [wire](T v, T) { return wire_round(v, wire); });
  }
  static __device__ __forceinline__ uint4 apply(int op, uint4 a, uint4 b) {
    return map(a, b, [op](T x, T y) { return Arith<T>::apply(op, x, y); });
  }
  static __device__ __forceinline__ uint4 scale(T fp, uint4 a) {
    return map(a, a, [fp](T x, T) { return Mul<T>::mul(fp, x); });
  }
  // own - fp * grad
  static __device__ __forceinline__ uint4 apply_update(uint4 own, T fp,
                                                       uint4 grad) {
    return map(own, grad,
               [fp](T o, T g) { return Mul<T>::sub(o, Mul<T>::mul(fp, g)); });
  }
  // (own * visiting) * fp
  static __device__ __forceinline__ uint4 hop(uint4 own, uint4 vis, T fp) {
    return map(own, vis, [fp](T o, T v) {
      return Mul<T>::mul(Mul<T>::mul(o, v), fp);
    });
  }
};

// one element: a null operand reads zero, a null result takes nothing
template <typename T>
__device__ __forceinline__ T ld(const void* p, int e) {
  return p ? static_cast<const T*>(p)[e] : zero<T>();
}
template <typename T>
__device__ __forceinline__ void st(void* p, int e, T v) {
  if (p) static_cast<T*>(p)[e] = v;
}

// What one item needs of its slot, read from the descriptor.
struct Item {
  const void* const* in;
  void* const* out;
  int n;   // columns of one part (the item's bound); every offset of
  int c0;  // a slot is below 2^31 elements (the wrapper checks)
  int part, P, op, fop, root, peer, wire, cls;
};

// -- the 16-byte path: a whole tile of aligned operands and results --------
// Lane l takes elements [V l, V l + V) of each of the tile's U chunks of
// 32 V; every load of a rank group's words precedes their fold and every
// store.

template <typename T, int U>
__device__ __forceinline__ int col(const Item& it, int lane, int u) {
  return it.c0 + u * 32 * Lane<T>::V + lane * Lane<T>::V;
}

// acc[u] = the rank-order fold of every rank's wire-rounded word u at
// element off + column: the loads of NP ranks at a time are all issued
// before they are folded
template <typename T, int NP, int U>
__device__ __forceinline__ void fold_v(uint4 (&acc)[U], const Item& it,
                                       int lane, int off) {
  using L = Lane<T>;
#pragma unroll 1
  for (int g = 0; g < it.P; g += NP) {
    uint4 b[NP][U];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (g + j < it.P)
          b[j][u] = L::load(it.in[g + j], off + col<T, U>(it, lane, u));
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (g + j < it.P) {
          const uint4 v = L::rounded(b[j][u], it.wire);
          acc[u] = g + j == 0 ? v : L::apply(it.fop, acc[u], v);
        }
  }
}

template <typename T, int U>
__device__ __forceinline__ void store_v(void* p, int off,
                                        const Item& it, int lane,
                                        const uint4 (&w)[U]) {
  if (p == nullptr) return;
#pragma unroll
  for (int u = 0; u < U; ++u)
    Lane<T>::store(p, off + col<T, U>(it, lane, u), w[u]);
}

// out[me] = in[me] at element off_of(me) + column, for every rank: NP
// ranks' loads issued before their stores
template <typename T, int NP, int U>
__device__ __forceinline__ void own_v(const Item& it, int lane,
                                      bool own_chunk) {
#pragma unroll 1
  for (int g = 0; g < it.P; g += NP) {
    uint4 b[NP][U];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (g + j < it.P)
          b[j][u] = Lane<T>::load(it.in[g + j],
                                  (own_chunk ? (g + j) * it.n : 0) +
                                      col<T, U>(it, lane, u));
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (g + j < it.P) store_v<T, U>(it.out[g + j], 0, it, lane, b[j]);
  }
}

template <typename T, int NP, int U>
__device__ __forceinline__ void item_v(const Item& it, int lane, T fp) {
  using L = Lane<T>;
  const int P = it.P;
  if (it.cls == CLS_SOLO) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = L::load(it.in[0], col<T, U>(it, lane, u));
    store_v<T, U>(it.out[0], 0, it, lane, v);
  } else if (it.cls == CLS_AG) {  // out[q][j n + c] = wire(in[j][c])
    const bool gather = it.op == OPC_ALLGATHER;
#pragma unroll 1
    for (int g = 0; g < P; g += NP) {
      uint4 b[NP][U];
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (g + j < P)
            b[j][u] = L::rounded(L::load(it.in[g + j], col<T, U>(it, lane, u)),
                                 gather ? it.wire : 0);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (g + j >= P) continue;
#pragma unroll 1
        for (int k = 0; k < P; ++k)  // a mis-encoded slot tiles its own
          if (gather) store_v<T, U>(it.out[k], (g + j) * it.n, it, lane, b[j]);
          else store_v<T, U>(it.out[g + j], k * it.n, it, lane, b[j]);
      }
    }
  } else if ((it.cls == CLS_RS &&
              (it.op == OPC_REDUCE_SCATTER || it.op == OPC_MATMUL_RS)) ||
             (it.cls == CLS_APPLY && it.op == OPC_APPLY)) {
    // one rank's result an item (part = the rank) where no result of the
    // slot lies over an operand; else every rank's, rank 0's first (it
    // alone reads chunk 0, which an in-place result overwrites), stored
    // last
    const bool all = it.part < 0;
    uint4 first[U];
#pragma unroll 1
    for (int me = all ? 0 : it.part; me < (all ? P : it.part + 1); ++me) {
      if (it.out[me] == nullptr) continue;
      uint4 r[U];
      fold_v<T, NP, U>(r, it, lane, me * it.n);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (it.op == OPC_APPLY)
          r[u] = L::apply_update(
              L::load(it.in[me], P * it.n + col<T, U>(it, lane, u)), fp,
              r[u]);
        else if (it.op == OPC_MATMUL_RS)
          r[u] = L::scale(fp, r[u]);
        if (all && me == 0) first[u] = r[u];
      }
      if (!all || me > 0) store_v<T, U>(it.out[me], 0, it, lane, r);
    }
    if (all && it.out[0] != nullptr)
      store_v<T, U>(it.out[0], 0, it, lane, first);
  } else if (it.op == OPC_ATTN_HOP &&
             (it.cls == CLS_ATTN || (it.cls == CLS_RS && P == 2))) {
    // (own[n:2n] * wire(visiting[:n])) * fp, visiting rank me - peer's
    // operand; chunk by chunk every rank's words load before any store
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = col<T, U>(it, lane, u);
#pragma unroll 1
      for (int g = 0; g < P; g += NP) {
        uint4 vis[NP], own[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j)
          if (g + j < P) {
            vis[j] = L::load(it.in[accl::ring_mod(g + j - it.peer, P)], c);
            own[j] = L::load(it.in[g + j], it.n + c);
          }
#pragma unroll
        for (int j = 0; j < NP; ++j)
          if (g + j < P && it.out[g + j] != nullptr)
            L::store(it.out[g + j], c,
                     L::hop(own[j], L::rounded(vis[j], it.wire), fp));
      }
    }
  } else if (it.cls != CLS_SAME) {  // a mis-encoded slot: its own chunk
    own_v<T, NP, U>(it, lane, it.cls == CLS_RS);
  } else if (it.op == OPC_ALLTOALL && it.part >= 0) {
    // rank pair (a <= b): out[a] chunk b <- in[b] chunk a, out[b] chunk a
    // <- in[a] chunk b, both loaded before either store
    int a = 0, p = it.part;
    while (p >= P - a) p -= P - a++;
    const int b = a + p;
    uint4 x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = col<T, U>(it, lane, u);
      x[u] = L::rounded(L::load(it.in[b], a * it.n + c), it.wire);
      y[u] = L::rounded(L::load(it.in[a], b * it.n + c), it.wire);
    }
    store_v<T, U>(it.out[a], b * it.n, it, lane, x);
    if (a != b) store_v<T, U>(it.out[b], a * it.n, it, lane, y);
  } else if (it.op == OPC_ALLREDUCE) {
    uint4 acc[U];
    fold_v<T, NP, U>(acc, it, lane, 0);
#pragma unroll 1
    for (int me = 0; me < P; ++me) store_v<T, U>(it.out[me], 0, it, lane, acc);
  } else if (it.op == OPC_BCAST || it.op == OPC_SEND || it.op == OPC_RECV) {
    uint4 v[U];  // the root's word, loaded before any store
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = L::rounded(L::load(it.in[it.root], col<T, U>(it, lane, u)),
                        it.wire);
#pragma unroll 1
    for (int me = 0; me < P; ++me) {
      if (it.op == OPC_BCAST || me == it.peer) {
        store_v<T, U>(it.out[me], 0, it, lane, v);
      } else if (it.out[me] != nullptr) {  // send / recv: the rest keep theirs
        uint4 own[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          own[u] = L::load(it.in[me], col<T, U>(it, lane, u));
        store_v<T, U>(it.out[me], 0, it, lane, own);
      }
    }
  } else {  // BARRIER and every other opcode: the own operand
    own_v<T, NP, U>(it, lane, false);
  }
}

// The 16-byte path of one tile: an allreduce (the main path's window)
// loads all U chunks of every rank before its fold; every other class
// takes the tile one chunk at a time (U = 1), which keeps the kernel's
// registers to those of the allreduce.
template <typename T, int NP, int U>
__device__ __forceinline__ void tile_v(const Item& it, int lane, T fp) {
  if (it.cls == CLS_SAME && it.op == OPC_ALLREDUCE) {
    uint4 acc[U];
    fold_v<T, NP, U>(acc, it, lane, 0);
#pragma unroll 1
    for (int me = 0; me < it.P; ++me)
      store_v<T, U>(it.out[me], 0, it, lane, acc);
    return;
  }
#pragma unroll 1
  for (int q = 0; q < U; ++q) {
    Item chunk = it;
    chunk.c0 = it.c0 + q * 32 * Lane<T>::V;
    item_v<T, NP, 1>(chunk, lane, fp);
  }
}

// -- the element path: a tile's columns one element a lane ------------------
// For a tile past the slot's last whole one, and for a slot whose operands
// or results are not all 16-byte aligned.  Each column reads what its
// stores overwrite first, as the 16-byte path does; the reductions take K
// columns a lane a step, their loads issued together.

// acc[k] = the rank-order fold at element off + c + 32 k (k < K, those
// before `end`): the loads of NP ranks' K elements are all issued before
// they are folded, each warp-wide load one contiguous 32-element run
template <typename T, int NP, int K>
__device__ __forceinline__ void fold_ek(T (&acc)[K], const Item& it, int off,
                                        int c, int end) {
#pragma unroll 1
  for (int g = 0; g < it.P; g += NP) {
    T b[NP][K];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (g + j < it.P && c + 32 * k < end)
          b[j][k] = ld<T>(it.in[g + j], off + c + 32 * k);
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (g + j < it.P && c + 32 * k < end) {
          const T v = wire_round(b[j][k], it.wire);
          acc[k] = g + j == 0 ? v : Arith<T>::apply(it.fop, acc[k], v);
        }
  }
}

// the element path's reductions, K columns c + 32 k a lane: allreduce,
// reduce-scatter, matmul-reduce-scatter and fused apply (as item_v's)
template <typename T, int NP, int K>
__device__ __forceinline__ void fold_item_e(const Item& it, int c, int end,
                                            T fp) {
  T r[K];
  if (it.op == OPC_ALLREDUCE && it.cls == CLS_SAME) {
    fold_ek<T, NP, K>(r, it, 0, c, end);
#pragma unroll 1
    for (int me = 0; me < it.P; ++me)
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (c + 32 * k < end) st<T>(it.out[me], c + 32 * k, r[k]);
    return;
  }
  const bool all = it.part < 0;
  T first[K];
#pragma unroll 1
  for (int me = all ? 0 : it.part; me < (all ? it.P : it.part + 1); ++me) {
    if (it.out[me] == nullptr) continue;
    fold_ek<T, NP, K>(r, it, me * it.n, c, end);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = c + 32 * k;
      if (e >= end) continue;
      if (it.op == OPC_APPLY)
        r[k] = Mul<T>::sub(ld<T>(it.in[me], it.P * it.n + e),
                           Mul<T>::mul(fp, r[k]));
      else if (it.op == OPC_MATMUL_RS)
        r[k] = Mul<T>::mul(fp, r[k]);
      if (all && me == 0) first[k] = r[k];
      else st<T>(it.out[me], e, r[k]);
    }
  }
  if (all)
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c + 32 * k < end) st<T>(it.out[0], c + 32 * k, first[k]);
}

// every other class of the element path, one column
template <typename T, int NP>
__device__ __forceinline__ void item_e(const Item& it, int c, T fp) {
  const int P = it.P;
  if (it.cls == CLS_SOLO) {
    st<T>(it.out[0], c, ld<T>(it.in[0], c));
  } else if (it.cls == CLS_AG) {
    for (int j = 0; j < P; ++j) {
      if (it.op == OPC_ALLGATHER) {
        const T v = wire_round(ld<T>(it.in[j], c), it.wire);
        for (int q = 0; q < P; ++q) st<T>(it.out[q], j * it.n + c, v);
      } else {
        const T v = ld<T>(it.in[j], c);
        for (int k = 0; k < P; ++k) st<T>(it.out[j], k * it.n + c, v);
      }
    }
  } else if (it.op == OPC_ATTN_HOP &&
             (it.cls == CLS_ATTN || (it.cls == CLS_RS && P == 2))) {
    for (int g = 0; g < P; g += NP) {
      T vis[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (g + j < P)
          vis[j] = wire_round(
              ld<T>(it.in[accl::ring_mod(g + j - it.peer, P)], c), it.wire);
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (g + j < P && it.out[g + j] != nullptr)
          st<T>(it.out[g + j], c,
                Mul<T>::mul(Mul<T>::mul(ld<T>(it.in[g + j], it.n + c),
                                        vis[j]),
                            fp));
    }
  } else if (it.cls != CLS_SAME) {  // a mis-encoded slot: its own chunk
    for (int me = 0; me < P; ++me)
      st<T>(it.out[me], c,
            ld<T>(it.in[me], (it.cls == CLS_RS ? me * it.n : 0) + c));
  } else if (it.op == OPC_ALLTOALL && it.part >= 0) {
    int a = 0, p = it.part;
    while (p >= P - a) p -= P - a++;
    const int b = a + p;
    const T x = wire_round(ld<T>(it.in[b], a * it.n + c), it.wire);
    const T y = wire_round(ld<T>(it.in[a], b * it.n + c), it.wire);
    st<T>(it.out[a], b * it.n + c, x);
    if (a != b) st<T>(it.out[b], a * it.n + c, y);
  } else if (it.op == OPC_BCAST || it.op == OPC_SEND || it.op == OPC_RECV) {
    const T v = wire_round(ld<T>(it.in[it.root], c), it.wire);
    for (int me = 0; me < P; ++me)
      st<T>(it.out[me], c,
            (it.op == OPC_BCAST || me == it.peer) ? v : ld<T>(it.in[me], c));
  } else {
    for (int me = 0; me < P; ++me) st<T>(it.out[me], c, ld<T>(it.in[me], c));
  }
}

// Whether every operand and result the item touches is 16-byte aligned
// at each offset it uses (a chunk offset j n of its width class too).
template <typename T>
__device__ __forceinline__ bool aligned_slot(const Item& it, bool chunked) {
  if (chunked && (it.n * (int)sizeof(T)) % 16 != 0) return false;
  bool ok = true;
  for (int r = 0; r < it.P; ++r)
    ok &= aligned(static_cast<const char*>(it.in[r])) &&
          aligned(static_cast<const char*>(it.out[r]));
  return ok;
}

// the slot of flat item `item`: the last s with first[s] <= item
__device__ __forceinline__ int slot_of(const Window& w, long long item) {
  int lo = 0, hi = w.n_slots - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (w.first[mid] <= item) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename T, int NP, int U>
__device__ __forceinline__ void run_item(const Window& w, long long item,
                                         int lane) {
  constexpr long long E = 32LL * Lane<T>::V * U;
  const int s = slot_of(w, item);
  const long long t = item - w.first[s];
  const long long tiles = (w.cols[s] + E - 1) / E;
  const int P = w.P;
  const int* words = w.words[s];
  Item it;
  it.in = w.in + s * P;
  it.out = w.out + s * P;
  it.n = (int)w.cols[s];
  it.part = (int)(t / tiles);
  it.c0 = (int)((t % tiles) * E);
  it.P = P;
  it.op = words[W_OPCODE];
  it.fop = words[W_FUNCTION] == 1 ? OP_MAX : OP_SUM;
  const int root_word = words[W_ROOT];
  it.root = (root_word > 0 && root_word < P) ? root_word : 0;
  it.peer = words[W_PEER];
  it.wire = w.wire[s];
  it.cls = w.cls[s];
  // an alltoall's items are rank pairs; a reduce-scatter's or fused
  // apply's of `parts` P are one rank's result each; else all ranks'
  const bool pairs = it.cls == CLS_SAME && it.op == OPC_ALLTOALL &&
                     w.chunk[s] > 0;
  const bool split = w.parts[s] > 1 &&
                     ((it.cls == CLS_RS && (it.op == OPC_REDUCE_SCATTER ||
                                            it.op == OPC_MATMUL_RS)) ||
                      (it.cls == CLS_APPLY && it.op == OPC_APPLY));
  if (!pairs && !split) it.part = -1;
  const T fp = Convert<T>::from(
      __fmul_rn((float)words[W_FPARAM], 1.0f / 65536.0f));
  const bool chunked = (it.cls != CLS_SAME && it.cls != CLS_SOLO) || pairs;
  if (it.c0 + E <= it.n && aligned_slot<T>(it, chunked)) {
    tile_v<T, NP, U>(it, lane, fp);
  } else {
    const int end = it.c0 + E < it.n ? (int)(it.c0 + E) : it.n;
    constexpr int K = 4;  // columns a lane a step of the reductions
    if ((it.cls == CLS_SAME && it.op == OPC_ALLREDUCE) ||
        (it.cls == CLS_RS &&
         (it.op == OPC_REDUCE_SCATTER || it.op == OPC_MATMUL_RS)) ||
        (it.cls == CLS_APPLY && it.op == OPC_APPLY)) {
#pragma unroll 1
      for (int c = it.c0 + lane; c < end; c += 32 * K)
        fold_item_e<T, NP, K>(it, c, end, fp);
    } else {
#pragma unroll 1
      for (int c = it.c0 + lane; c < end; c += 32) item_e<T, NP>(it, c, fp);
    }
  }
}

// Every block arrives on bar[0]; the last to arrive resets it to 0 and
// advances the generation bar[1], which the others wait on.  So the
// counter is 0 again after every barrier and no launch has to clear it.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;  // read before arriving
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// coop: a co-resident grid walks each phase's items and meets at a grid
// barrier between phases; else the window is one phase and the grid has
// one warp an item.  One loop for both, so the item's code is inlined
// once.
template <typename T, int NP, int U>
__global__ void __launch_bounds__(kThreads)
sequencer_kernel(const __grid_constant__ Window w, int* status,
                 unsigned* bar, int coop) {
  if (blockIdx.x == 0) {  // status words, as status_words computes them
    for (int s = threadIdx.x; s < w.n_slots; s += blockDim.x) {
      const int op = w.words[s][W_OPCODE];
      status[2 * s] = w.words[s][W_SEQN];
      status[2 * s + 1] = (op >= 0 && op <= OPC_MAX) ? 1 : 2;
    }
  }
  const int lane = threadIdx.x % 32;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const long long warps = (long long)gridDim.x * kWarps;
  int s = 0;
  while (s < w.n_slots) {
    int e = s + 1;
    while (e < w.n_slots && !(coop && w.sync[e])) ++e;
    for (long long item = w.first[s] + warp; item < w.first[e];
         item += warps)
      run_item<T, NP, U>(w, item, lane);
    if (e < w.n_slots) grid_barrier(bar);
    s = e;
  }
}

// Fill the item prefix; returns whether any slot after the first waits at
// a barrier, and the most items of one phase.
template <typename T, int U>
bool plan(Window& w, long long* widest) {
  constexpr long long E = 32LL * Lane<T>::V * U;
  bool sync = false;
  long long total = 0, phase = 0;
  *widest = 0;
  for (int s = 0; s < w.n_slots; ++s) {
    if (s > 0 && w.sync[s]) {
      sync = true;
      phase = total;
    }
    w.first[s] = total;
    total += (long long)w.parts[s] * ((w.cols[s] + E - 1) / E);
    if (total - phase > *widest) *widest = total - phase;
  }
  w.first[w.n_slots] = total;
  return sync;
}

template <typename T, int NP, int U>
int launch(Window& w, int* status, unsigned* bar, cudaStream_t s) {
  long long widest = 0;
  const bool coop = plan<T, U>(w, &widest);
  long long blocks = (widest + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  if (!coop) {
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    sequencer_kernel<T, NP, U>
        <<<(unsigned)blocks, kThreads, 0, s>>>(w, status, nullptr, 0);
    return static_cast<int>(cudaGetLastError());
  }
  if (bar == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  static int max_blocks = 0;  // co-resident blocks: the barrier's limit
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sequencer_kernel<T, NP, U>, kThreads, 0);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    max_blocks = per_sm * sms;
  }
  if (blocks > max_blocks) blocks = max_blocks;
  int one = 1;
  void* args[] = {&w, &status, &bar, &one};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sequencer_kernel<T, NP, U>),
      dim3((unsigned)blocks), dim3(kThreads), args, 0, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// NP ranks' words in flight a lane, U chunks a tile: NP = 4 for every P
// (more ranks fold in groups of 4), U = 4 for 4-byte elements (16 words
// a lane; at P = 4 timed against 1 and 2 by scripts/tile_variants.py)
// and 2 for the others, whose per-element arithmetic (16-bit floats
// through float, 8-byte words) spilled at 4.
template <typename T>
int launch_for(Window& w, int* status, unsigned* bar, cudaStream_t s) {
  return launch<T, 4, sizeof(T) == 4 ? 4 : 2>(w, status, bar, s);
}

int check(const Window& w) {
  if (w.n_slots < 1 || w.n_slots > kMaxSlots || w.P < 1 || w.P > kMaxP ||
      w.n_slots * w.P > kMaxPtrs)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < w.n_slots; ++s)  // offsets are 32-bit
    if (w.cols[s] < 0 || w.parts[s] < 0 || w.in_w[s] > 0x7FFFFFFFLL ||
        w.out_w[s] > 0x7FFFFFFFLL || w.cols[s] * w.P > 0x7FFFFFFFLL)
      return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

#ifndef ACCL_KERNELS_ONLY  // scripts/tile_variants.cu includes the kernels
// One launch for the window `desc` (a Window, as pack_window lays it
// out; copied into the parameter block).  `status` receives (seqn,
// retcode) per slot; `barrier` is two device words, zero between
// launches, used only by a window with a barrier flag after its first
// slot (may be null otherwise).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int accl_sequencer(const void* desc, int* status, void* barrier,
                              void* stream) {
  Window w;
  memcpy(&w, desc, sizeof(Window));
  const int rc = check(w);
  if (rc) return rc;
  unsigned* bar = static_cast<unsigned*>(barrier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w.dtype) {
    case DT_F32: return launch_for<float>(w, status, bar, s);
    case DT_BF16: return launch_for<__nv_bfloat16>(w, status, bar, s);
    case DT_F16: return launch_for<__half>(w, status, bar, s);
    case DT_I32: return launch_for<int32_t>(w, status, bar, s);
    case DT_F64: return launch_for<double>(w, status, bar, s);
    case DT_I64: return launch_for<int64_t>(w, status, bar, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // ACCL_KERNELS_ONLY
