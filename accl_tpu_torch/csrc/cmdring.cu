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
// The fp8 and int8 wire lanes (and a 16-bit lane under a nonzero seed) take
// their own instantiation (LANES), chosen on the host from the window's
// wires, so the plain and 16-bit windows keep their kernel and registers.
// There, rank r's contribution to a slot rounds as JAX's _decode_slot_xla
// rounds it (accl_tpu/ops/pallas/cmdring.py:320-375): its seed is
// rank_seed(flags, r), flags the slot's seed word (0: round to nearest
// even), and the counter of element e of r's operand row is e itself, so a
// chunk at a * n keeps its offset; fp8 rounds stochastically through
// wire.cuh's sr_round and JAX's conversions (e4m3 overflows to NaN); int8
// quantizes with one absmax / 127 scale per 256 elements of the whole row,
// anchored at element 0.
//
// Bound of the LANES kernel: the same bytes as the plain one, but 40-60
// instructions an element of rounding (the counter hash, the fp8
// conversions, the int8 division), each waiting on its rank's loads.
// Measured on an H100 (scripts/lane_profile.py), the rounding and the
// latency it leaves open bound it, not the bytes.  So:
//  * an item is one 256-element int8 segment (kSeg) of a slot's columns
//    (seg_item: two 16-byte words a lane at 4-byte elements, one at
//    2-byte), and a rank's words of it are rounded together: its seed,
//    scale and wire branch taken once a rank (round_seg);
//  * an int8 segment's scale is the warp's own: the absmax of the words
//    it loaded, a butterfly over the warp, then segment_scale, with no
//    scale phase, wherever every int8 slot reads whole segments of its
//    rows at 16-byte aligned addresses (lane_segments, decided on the
//    host when a window launches or is planned for a run: its columns,
//    and so every chunk offset a * n its class reads, a multiple of 256);
//  * a window whose int8 slot reads partial segments (a chunk at a * n
//    off the 256-element grid, a ragged tail, a misaligned operand) keeps
//    a scale phase: every (slot, rank, segment) scale into a device
//    scratch buffer, then a grid barrier (the co-resident grid), then the
//    fold, which reads a scale a word (the element path a scale an
//    element);
//  * the ranks fold one at a time, at four blocks an SM (kLaneRanks,
//    kLaneBlocks: more warps hide the rounding's wait better than more
//    loads in flight a warp).
// The division stays __fdiv_rn, JAX's eager codec bit for bit (ROADMAP
// §C); the quantized value stays in float (int8_value).  On 8 x allreduce
// 1 Mi float32 at P = 4 (an H100 at 700 W) int8 takes 0.152 ms and e4m3
// 0.138, against 0.387 and 0.262 with 128-element items, a scale phase and
// a rounding an element at a time; the bound is 0.080.
//
// The persistent form (persistent_kernel, the counterpart of JAX's xla
// lowering session, accl_tpu/ops/pallas/cmdring.py:30-37) is one
// cooperative launch that drains a stream of windows from host-mapped
// memory.  A window travels in its posted form, the used extents of its
// Window (planned once a descriptor template on the host: 1,344 bytes at 8
// slots of 4 ranks, against 14,616), crosses the bus once into one of two
// device stages, and every block reads it there in place.  When the next
// window is already posted, the last warp fetches it during the current
// window, and one grid barrier (the run's own, an arrival count that only
// grows) both ends the one and publishes the other; else block 0's thread
// 0 polls the doorbell (ld.acquire.sys) until a window is posted, the HALT
// doorbell rings, the window budget is spent or %globaltimer shows the
// mailbox idle for the linger.  A plain run's blocks walk a window's items
// in lockstep, one item a warp a round.  After each closing barrier the
// last block's thread 0 writes the count of done windows with
// __threadfence_system() and a release store.  An idle run so holds the
// device for the linger at most.  On an H100 at 700 W
// (scripts/run_profile.py, 8 x allreduce 1 Mi float32 at P = 4, every
// window posted ahead) a window takes 0.1016 ms of device time in a run,
// against 0.0947 a one-shot launch and 0.1242 in the earlier form, which
// moved the whole 14,616-byte descriptor over the bus at every window
// (0.0114 ms, by the run's clock), copied it into every block's shared
// memory and met at two grid barriers.  Its LANES form's items run ~1.3x
// the one-shot's: they read the window from device memory in a 64-register
// kernel, where the one-shot reads its parameter block.
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
#include <type_traits>

#include "wire.cuh"

namespace {

using accl::aligned;
using accl::Arith;
using accl::BF16;
using accl::Convert;
using accl::E4M3;
using accl::E5M2;
using accl::F16;
using accl::F32;
using accl::kThreads;
using accl::max_nan;
using accl::zero;

constexpr int kMaxSlots = 64;   // CMDRING_MAX_DEPTH
constexpr int kMaxPtrs = 512;   // rank-slots per launch (64 slots x 8 ranks)
constexpr int kWords = 11;      // CMDRING_SLOT_WORDS
constexpr int kMaxP = 64;       // ranks of one window (common.cuh kMaxRanks)
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 256;       // WIRE_SEGMENT_ELEMS: the int8 lane's segment

// slot word indices (CMDRING_FIELDS)
enum : int { W_SEQN = 0, W_OPCODE = 1, W_FUNCTION = 4, W_ROOT = 5,
             W_FLAGS = 6, W_PEER = 8, W_FPARAM = 10 };
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
// null result: that rank takes none).  `first` and `maxseg` (the most
// int8 segments of one slot's operand row, 0 without an int8 slot) are
// filled by the launch, or by accl_sequencer_plan for a posted window.
struct Window {
  int32_t words[kMaxSlots][kWords];
  int64_t in_w[kMaxSlots], out_w[kMaxSlots], chunk[kMaxSlots],
      cols[kMaxSlots];
  int64_t first[kMaxSlots + 1];
  int32_t cls[kMaxSlots], wire[kMaxSlots], sync[kMaxSlots],
      parts[kMaxSlots];
  int32_t n_slots, P, dtype, maxseg;
  const void* in[kMaxPtrs];
  void* out[kMaxPtrs];
};
static_assert(offsetof(Window, in_w) == 2816, "descriptor layout");
static_assert(offsetof(Window, first) == 4864, "descriptor layout");
static_assert(offsetof(Window, cls) == 5384, "descriptor layout");
static_assert(offsetof(Window, n_slots) == 6408, "descriptor layout");
static_assert(offsetof(Window, in) == 6424, "descriptor layout");
static_assert(sizeof(Window) == 14616, "descriptor layout");
static_assert(sizeof(Window) % 8 == 0, "expanded in 8-byte words");

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

// The float operand types as wire.cuh's conversions take them: widened to
// float32 and narrowed back as JAX's astype computes them (NaN bits kept).
template <typename T> struct Wide;
template <> struct Wide<float> {
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
};
template <> struct Wide<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return BF16::widen(__bfloat16_as_ushort(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float x) {
    return __ushort_as_bfloat16(BF16::narrow(x, DT_F32));
  }
};
template <> struct Wide<__half> {
  static __device__ __forceinline__ float widen(__half v) {
    return F16::widen(__half_as_ushort(v));
  }
  static __device__ __forceinline__ __half narrow(float x) {
    return __ushort_as_half(F16::narrow(x, DT_F32));
  }
};

// Element e of one rank's operand row through the int8 lane under its
// segment's `scale`: wire.cuh's quantize_one, dequantized, as JAX's eager
// codec, with the quantized value kept in float (an integer in [-127,
// 127], -0 made +0 as the int8 round trip makes it): no conversion to
// int8 and back, which run at a quarter of the float rate
template <typename T>
__device__ __forceinline__ T int8_value(T v, float scale, uint32_t seed,
                                        int e) {
  const float x = Wide<T>::widen(v);
  float q = __fdiv_rn(x, scale);
  if (seed) {
    const float u = __fmul_rn(
        __uint2float_rn(accl::sr_bits((uint32_t)e, seed)),
        2.3283064365386963e-10f);  // 2^-32
    q = floorf(__fadd_rn(q, u));
  } else {
    q = rintf(q);
  }
  q = q == q ? __fadd_rn(fminf(fmaxf(q, -127.0f), 127.0f), 0.0f) : 0.0f;
  return Wide<T>::narrow(__fmul_rn(q, scale));
}

// Element e of one rank's operand row through the slot's lane, in the
// LANES instantiation: `seed` is rank_seed(flags, rank), `sc` that rank's
// int8 segment scales.  As JAX's wire_lane_roundtrip: the value widened
// to float32, stochastically rounded (seed != 0) or rounded to nearest
// even into the wire dtype, or quantized against its segment's scale and
// dequantized, then narrowed back to the operand type.  A 16-bit lane
// under seed 0 is the plain instantiation's cast.
template <typename T>
__device__ __forceinline__ T lane_value(T v, int wire, uint32_t seed, int e,
                                        const float* sc) {
  const float x = Wide<T>::widen(v);
  const uint32_t i = (uint32_t)e;
  float y;
  switch (wire) {
    case DT_I8:
      return int8_value(v, sc[e / kSeg], seed, e);
    case DT_E4M3:  // 20 dropped mantissa bits, SR above 2^-6
      y = E4M3::widen(E4M3::narrow(
          accl::sr_round(x, i, seed, (1u << 20) - 1, 0.015625f, seed != 0),
          DT_F32));
      break;
    case DT_E5M2:  // 21 dropped bits, SR above 2^-14
      y = E5M2::widen(E5M2::narrow(
          accl::sr_round(x, i, seed, (1u << 21) - 1, 6.103515625e-05f,
                         seed != 0),
          DT_F32));
      break;
    case DT_BF16:
      if (seed == 0) return wire_round(v, wire);
      y = BF16::widen(BF16::narrow(
          accl::sr_round(x, i, seed, 0xFFFFu, 1.1754943508222875e-38f, true),
          DT_F32));
      break;
    case DT_F16:
      if (seed == 0) return wire_round(v, wire);
      y = F16::widen(F16::narrow(
          accl::sr_round(x, i, seed, (1u << 13) - 1, 6.103515625e-05f, true),
          DT_F32));
      break;
    default:
      return v;
  }
  return Wide<T>::narrow(y);
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
  // LANES only: the slot's seed word, and its ranks' int8 scales from the
  // scale phase (rank r at sc + r * maxseg; maxseg 0: no scale phase, the
  // scales come from the warp's registers)
  uint32_t flags;
  int maxseg;
  const float* sc;
};

// Rank `rank`'s element e through the slot's lane (the element path)
template <typename T, bool LANES>
__device__ __forceinline__ T round_elem(T v, const Item& it, int rank,
                                        int e) {
  if constexpr (!LANES) {
    return wire_round(v, it.wire);
  } else {
    if (it.wire == 0) return v;
    return lane_value<T>(v, it.wire,
                         accl::rank_seed(it.flags, (uint32_t)rank), e,
                         it.sc + rank * it.maxseg);
  }
}

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
          if (g + j < P) {
            const int c = col<T, U>(it, lane, u);
            b[j][u] = L::load(it.in[g + j], c);
            if (gather) b[j][u] = L::rounded(b[j][u], it.wire);
          }
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
    for (int u = 0; u < U; ++u) {
      const int c = col<T, U>(it, lane, u);
      v[u] = L::rounded(L::load(it.in[it.root], c), it.wire);
    }
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

// -- the LANES instantiation's item: one int8 segment -----------------------
// An item of the fp8 / int8 instantiation is one 256-element int8 segment
// (kSeg) of a slot's columns: lane l holds elements [V l, V l + V) of each
// of the segment's U = kSeg / 32 V chunks (two 16-byte words a lane for
// float32, one for 16-bit operands), and a rank's words of one segment are
// all loaded before any of them is rounded, every rank's of a group of NP
// before the first is.

// 16-byte words a lane of one segment
template <typename T> __host__ __device__ constexpr int lanes_u() {
  return kSeg / (32 * Lane<T>::V);
}
// The LANES kernels' ranks a fold step (NP) and blocks an SM (their launch
// bounds: 64 registers).  Their rounding, 40-60 instructions an element,
// waits on a rank's loads, and more warps an SM hide that wait better
// than more loads in flight a warp: on an H100 (scripts/lane_profile.py,
// 8 x allreduce 1 Mi float32 at P = 4) int8 / e4m3 took 0.1517 / 0.1382
// ms at one rank a step and four blocks an SM, against 0.1728 / 0.1512
// at three blocks, 0.2018 / 0.1843 at five, 0.1701 / 0.1471 at two ranks
// and three blocks and 0.1915 / 0.1875 at four ranks (every rank's words
// loaded before the first rounds) and two blocks.  Loading the next
// rank's words during a rounding (0.2004 / 0.1859) or the next segment's
// (one block an SM, 0.3318 / 0.3571) spends the registers that hold the
// warps.  The kernels spill at 64 registers (400-2,300 bytes of spill
// stores in their code); with fewer spills at 80 they ran slower.
constexpr int kLaneRanks = 1;
constexpr int kLaneBlocks = 4;
// the attention hop's group, which the wrapper's HOLD_RANKS assumes:
// every visiting word of up to 4 ranks read before any store
constexpr int kHold = 4;

// f(v, u, e) over every element of a lane's words u < U, e its element of
// the operand row (e0 that of the lane's first word)
template <typename T, int U, typename F>
__device__ __forceinline__ void map_words(uint4 (&a)[U], int e0, F f) {
  constexpr int V = Lane<T>::V;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    alignas(16) T x[V];
    *reinterpret_cast<uint4*>(x) = a[u];
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = f(x[k], u, e0 + u * 32 * V + k);
    a[u] = *reinterpret_cast<const uint4*>(x);
  }
}

// Rank `rank`'s words of one segment item through the slot's lane, e0 the
// row element of the lane's first word.  The seed, the int8 scale and the
// wire's branch are taken once a rank, not once an element.  The int8
// scale comes from the warp's own registers when the window has no scale
// phase (maxseg 0: every int8 slot's items are whole, aligned segments):
// the absmax of the words loaded, then a butterfly over the warp; max
// with NaN propagation does not depend on order, so it equals the scale
// phase's.  Else it is the scale phase's, read once a word (a word never
// straddles a segment).  The division stays __fdiv_rn, JAX's eager codec
// bit for bit.
template <typename T, int U>
__device__ __forceinline__ void round_seg(uint4 (&a)[U], const Item& it,
                                          int rank, int e0) {
  constexpr int V = Lane<T>::V;
  const int wire = it.wire;
  if (wire == 0) return;
  const uint32_t seed = accl::rank_seed(it.flags, (uint32_t)rank);
  switch (wire) {
    case DT_I8: {
      float scale[U];
      if (it.maxseg == 0) {
        float m = 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          alignas(16) T x[V];
          *reinterpret_cast<uint4*>(x) = a[u];
#pragma unroll
          for (int k = 0; k < V; ++k)
            m = max_nan(m, fabsf(Wide<T>::widen(x[k])));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = max_nan(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
        const float sc = accl::segment_scale(m);
#pragma unroll
        for (int u = 0; u < U; ++u) scale[u] = sc;
      } else {
        const float* sc = it.sc + rank * it.maxseg;
#pragma unroll
        for (int u = 0; u < U; ++u) scale[u] = sc[(e0 + u * 32 * V) / kSeg];
      }
      map_words<T, U>(a, e0, [&](T v, int u, int e) {
        return int8_value<T>(v, scale[u], seed, e);
      });
      break;
    }
    case DT_E4M3:
      map_words<T, U>(a, e0, [seed](T v, int, int e) {
        return lane_value<T>(v, DT_E4M3, seed, e, nullptr);
      });
      break;
    case DT_E5M2:
      map_words<T, U>(a, e0, [seed](T v, int, int e) {
        return lane_value<T>(v, DT_E5M2, seed, e, nullptr);
      });
      break;
    case DT_BF16:
      map_words<T, U>(a, e0, [seed](T v, int, int e) {
        return lane_value<T>(v, DT_BF16, seed, e, nullptr);
      });
      break;
    case DT_F16:
      map_words<T, U>(a, e0, [seed](T v, int, int e) {
        return lane_value<T>(v, DT_F16, seed, e, nullptr);
      });
      break;
  }
}

// acc[u] = the rank-order fold of every rank's segment at element off +
// column, each rank's words rounded once all NP ranks' words are loaded
template <typename T, int NP, int U>
__device__ __forceinline__ void fold_seg(uint4 (&acc)[U], const Item& it,
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
      if (g + j < it.P) {
        round_seg<T, U>(b[j], it, g + j, off + col<T, U>(it, lane, 0));
#pragma unroll
        for (int u = 0; u < U; ++u)
          acc[u] = g + j == 0 ? b[j][u] : L::apply(it.fop, acc[u], b[j][u]);
      }
  }
}

// One segment item of every class, as item_v computes it.  A result is
// stored only once every word it overwrites has been read, as there.
template <typename T, int NP, int U>
__device__ __forceinline__ void seg_item(const Item& it, int lane, T fp) {
  using L = Lane<T>;
  const int P = it.P;
  const int c0 = col<T, U>(it, lane, 0);  // the lane's first column
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
          if (g + j < P) b[j][u] = L::load(it.in[g + j], col<T, U>(it, lane, u));
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (g + j >= P) continue;
        if (gather) round_seg<T, U>(b[j], it, g + j, c0);
#pragma unroll 1
        for (int k = 0; k < P; ++k)  // a mis-encoded slot tiles its own
          if (gather) store_v<T, U>(it.out[k], (g + j) * it.n, it, lane, b[j]);
          else store_v<T, U>(it.out[g + j], k * it.n, it, lane, b[j]);
      }
    }
  } else if ((it.cls == CLS_RS &&
              (it.op == OPC_REDUCE_SCATTER || it.op == OPC_MATMUL_RS)) ||
             (it.cls == CLS_APPLY && it.op == OPC_APPLY)) {
    const bool all = it.part < 0;  // as item_v: rank 0's result stored last
    uint4 first[U];
#pragma unroll 1
    for (int me = all ? 0 : it.part; me < (all ? P : it.part + 1); ++me) {
      if (it.out[me] == nullptr) continue;
      uint4 r[U];
      fold_seg<T, NP, U>(r, it, lane, me * it.n);
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
    // (own[n:2n] * wire(visiting[:n])) * fp: a group's visiting segments
    // load before any store, kHold ranks a group whatever NP (up to the
    // wrapper's HOLD_RANKS in place); the own operand's second half,
    // which no store of the slot writes, after
#pragma unroll 1
    for (int g = 0; g < P; g += kHold) {
      uint4 vis[kHold][U];
#pragma unroll
      for (int j = 0; j < kHold; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (g + j < P)
            vis[j][u] = L::load(it.in[accl::ring_mod(g + j - it.peer, P)],
                                col<T, U>(it, lane, u));
#pragma unroll
      for (int j = 0; j < kHold; ++j)
        if (g + j < P)
          round_seg<T, U>(vis[j], it, accl::ring_mod(g + j - it.peer, P), c0);
#pragma unroll
      for (int j = 0; j < kHold; ++j) {
        if (g + j >= P || it.out[g + j] == nullptr) continue;
        uint4 r[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          r[u] = L::hop(L::load(it.in[g + j], it.n + col<T, U>(it, lane, u)),
                        vis[j][u], fp);
        store_v<T, U>(it.out[g + j], 0, it, lane, r);
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
      x[u] = L::load(it.in[b], a * it.n + c);
      y[u] = L::load(it.in[a], b * it.n + c);
    }
    round_seg<T, U>(x, it, b, a * it.n + c0);
    round_seg<T, U>(y, it, a, b * it.n + c0);
    store_v<T, U>(it.out[a], b * it.n, it, lane, x);
    if (a != b) store_v<T, U>(it.out[b], a * it.n, it, lane, y);
  } else if (it.op == OPC_ALLREDUCE) {
    uint4 acc[U];
    fold_seg<T, NP, U>(acc, it, lane, 0);
#pragma unroll 1
    for (int me = 0; me < P; ++me) store_v<T, U>(it.out[me], 0, it, lane, acc);
  } else if (it.op == OPC_BCAST || it.op == OPC_SEND || it.op == OPC_RECV) {
    uint4 v[U];  // the root's segment, loaded before any store
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = L::load(it.in[it.root], col<T, U>(it, lane, u));
    round_seg<T, U>(v, it, it.root, c0);
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

// -- the element path: a tile's columns one element a lane ------------------
// For a tile past the slot's last whole one, and for a slot whose operands
// or results are not all 16-byte aligned.  Each column reads what its
// stores overwrite first, as the 16-byte path does; the reductions take K
// columns a lane a step, their loads issued together.

// acc[k] = the rank-order fold at element off + c + 32 k (k < K, those
// before `end`): the loads of NP ranks' K elements are all issued before
// they are folded, each warp-wide load one contiguous 32-element run
template <typename T, int NP, int K, bool LANES>
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
          const T v = round_elem<T, LANES>(b[j][k], it, g + j,
                                           off + c + 32 * k);
          acc[k] = g + j == 0 ? v : Arith<T>::apply(it.fop, acc[k], v);
        }
  }
}

// the element path's reductions, K columns c + 32 k a lane: allreduce,
// reduce-scatter, matmul-reduce-scatter and fused apply (as item_v's)
template <typename T, int NP, int K, bool LANES>
__device__ __forceinline__ void fold_item_e(const Item& it, int c, int end,
                                            T fp) {
  T r[K];
  if (it.op == OPC_ALLREDUCE && it.cls == CLS_SAME) {
    fold_ek<T, NP, K, LANES>(r, it, 0, c, end);
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
    fold_ek<T, NP, K, LANES>(r, it, me * it.n, c, end);
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
template <typename T, int NP, bool LANES>
__device__ __forceinline__ void item_e(const Item& it, int c, T fp) {
  const int P = it.P;
  if (it.cls == CLS_SOLO) {
    st<T>(it.out[0], c, ld<T>(it.in[0], c));
  } else if (it.cls == CLS_AG) {
    for (int j = 0; j < P; ++j) {
      if (it.op == OPC_ALLGATHER) {
        const T v = round_elem<T, LANES>(ld<T>(it.in[j], c), it, j, c);
        for (int q = 0; q < P; ++q) st<T>(it.out[q], j * it.n + c, v);
      } else {
        const T v = ld<T>(it.in[j], c);
        for (int k = 0; k < P; ++k) st<T>(it.out[j], k * it.n + c, v);
      }
    }
  } else if (it.op == OPC_ATTN_HOP &&
             (it.cls == CLS_ATTN || (it.cls == CLS_RS && P == 2))) {
    for (int g = 0; g < P; g += kHold) {  // as seg_item's
      T vis[kHold];
#pragma unroll
      for (int j = 0; j < kHold; ++j)
        if (g + j < P) {
          const int src = accl::ring_mod(g + j - it.peer, P);
          vis[j] = round_elem<T, LANES>(ld<T>(it.in[src], c), it, src, c);
        }
#pragma unroll
      for (int j = 0; j < kHold; ++j)
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
    const T x = round_elem<T, LANES>(ld<T>(it.in[b], a * it.n + c), it, b,
                                     a * it.n + c);
    const T y = round_elem<T, LANES>(ld<T>(it.in[a], b * it.n + c), it, a,
                                     b * it.n + c);
    st<T>(it.out[a], b * it.n + c, x);
    if (a != b) st<T>(it.out[b], a * it.n + c, y);
  } else if (it.op == OPC_BCAST || it.op == OPC_SEND || it.op == OPC_RECV) {
    const T v = round_elem<T, LANES>(ld<T>(it.in[it.root], c), it, it.root,
                                     c);
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

template <typename T, int NP, int U, bool LANES>
__device__ __forceinline__ void run_item(const Window& w, long long item,
                                         int lane, const float* scales) {
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
  if constexpr (LANES) {
    it.flags = (uint32_t)words[W_FLAGS];
    it.maxseg = w.maxseg;
    it.sc = scales + (long long)s * P * w.maxseg;
  }
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
    if constexpr (LANES) seg_item<T, NP, U>(it, lane, fp);
    else tile_v<T, NP, U>(it, lane, fp);
  } else {
    const int end = it.c0 + E < it.n ? (int)(it.c0 + E) : it.n;
    constexpr int K = 4;  // columns a lane a step of the reductions
    if ((it.cls == CLS_SAME && it.op == OPC_ALLREDUCE) ||
        (it.cls == CLS_RS &&
         (it.op == OPC_REDUCE_SCATTER || it.op == OPC_MATMUL_RS)) ||
        (it.cls == CLS_APPLY && it.op == OPC_APPLY)) {
#pragma unroll 1
      for (int c = it.c0 + lane; c < end; c += 32 * K)
        fold_item_e<T, NP, K, LANES>(it, c, end, fp);
    } else {
#pragma unroll 1
      for (int c = it.c0 + lane; c < end; c += 32)
        item_e<T, NP, LANES>(it, c, fp);
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

// The int8 lane's scale phase: one warp a (slot, rank, segment) of every
// int8 slot, the segment's absmax over its 256 elements (those past the
// operand row, and a null operand's, read as 0), its scale written to
// scales[(s * P + r) * maxseg + segment].
template <typename T>
__device__ void scale_phase(const Window& w, float* scales, long long warp,
                            long long warps, int lane) {
  const int P = w.P, ms = w.maxseg;
  const long long total = (long long)w.n_slots * P * ms;
  for (long long item = warp; item < total; item += warps) {
    const int g = (int)(item % ms);
    const int sr = (int)(item / ms);
    const int s = sr / P;
    if (w.wire[s] != DT_I8) continue;
    const long long in_w = w.in_w[s];
    if (g > 0 && (long long)g * kSeg >= in_w) continue;
    const T* x = static_cast<const T*>(w.in[sr]);
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < kSeg / 32; ++k) {
      const long long e = (long long)g * kSeg + k * 32 + lane;
      if (x != nullptr && e < in_w)
        amax = max_nan(amax, fabsf(Wide<T>::widen(x[e])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = max_nan(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
    if (lane == 0) scales[item] = accl::segment_scale(amax);
  }
}

// One window's work on the calling grid: the status words (block 0), the
// scale phase of an int8 window, then each phase's items, a grid barrier
// between phases when `coop`.  One loop for every one-shot form, so the
// item's code is inlined once a kernel.  LOCKSTEP (a plain persistent
// run): a block's warps take its items round by round, meeting at
// __syncthreads after each, as a one-shot launch's blocks of one item a
// warp start and end together (scripts/run_profile.py, an H100: 0.1016 ms
// a window against 0.1050 with each warp on its own).
template <typename T, int NP, int U, bool LANES, bool LOCKSTEP = false>
__device__ __forceinline__ void run_window(const Window& w, int* status,
                                           float* scales, unsigned* bar,
                                           int coop) {
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
  if constexpr (LANES) {
    if (w.maxseg > 0) {
      scale_phase<T>(w, scales, warp, warps, lane);
      grid_barrier(bar);
    }
  }
  int s = 0;
  while (s < w.n_slots) {
    int e = s + 1;
    while (e < w.n_slots && !(coop && w.sync[e])) ++e;
    if constexpr (LOCKSTEP) {
      for (long long base = w.first[s] + (long long)blockIdx.x * kWarps;
           base < w.first[e]; base += warps) {
        const long long item = base + threadIdx.x / 32;
        if (item < w.first[e]) run_item<T, NP, U, LANES>(w, item, lane, scales);
        __syncthreads();
      }
    } else {
      for (long long item = w.first[s] + warp; item < w.first[e];
           item += warps)
        run_item<T, NP, U, LANES>(w, item, lane, scales);
    }
    if (e < w.n_slots) grid_barrier(bar);
    s = e;
  }
}

// coop: a co-resident grid walks each phase's items and meets at a grid
// barrier between phases; else the window is one phase and the grid has
// one warp an item.
template <typename T, int NP, int U>
__global__ void __launch_bounds__(kThreads)
sequencer_kernel(const __grid_constant__ Window w, int* status,
                 unsigned* bar, int coop, float* scales) {
  run_window<T, NP, U, false>(w, status, scales, bar, coop);
}

// The LANES instantiation: one segment a tile, one rank a fold step,
// kLaneBlocks blocks an SM (see kLaneRanks).
template <typename T>
__global__ void __launch_bounds__(kThreads, kLaneBlocks)
sequencer_lanes_kernel(const __grid_constant__ Window w, int* status,
                       unsigned* bar, int coop, float* scales) {
  run_window<T, kLaneRanks, lanes_u<T>(), true>(w, status, scales, bar, coop);
}

template <typename T, int NP, int U, bool LANES>
auto sequencer_of() {
  if constexpr (LANES) return sequencer_lanes_kernel<T>;
  else return sequencer_kernel<T, NP, U>;
}

// -- the persistent form -----------------------------------------------------

// A run's control words, in host-mapped memory: the host's (`posted`, the
// windows posted, each written after its descriptor; `halt`, the HALT
// doorbell) and, on their own 128-byte line, the run's (`done`, the
// windows completed; `exited`, 0 while the run lives, then why it returned:
// 1 the HALT doorbell, 2 the window budget, 3 the linger; `closing`, k + 1
// while the run decides to close at window k, 0 once it took the window;
// `ahead`, the windows it fetched ahead, stored before each `done`).
struct RunCtl {
  int posted, halt;
  int pad0[30];
  int done, exited, closing, ahead;
  int pad1[28];
};
static_assert(sizeof(RunCtl) == 256, "run control layout");
static_assert(offsetof(RunCtl, done) == 128, "run control layout");
static_assert(offsetof(RunCtl, ahead) == 140, "run control layout");
enum : int { EXIT_HALT = 1, EXIT_BUDGET = 2, EXIT_LINGER = 3 };

// A window posted to a run travels in its posted form: the extents of
// Window's fields that a window of n slots of P ranks uses, each at a
// 16-byte boundary, in the order below (ops/cuda/cmdring.py::RUN_SEGMENTS).
// Field i spans per_slot * n + per_rank_slot * n * P + fixed bytes at
// offset `off` of Window, and is copied in 8-byte words (a 4-byte field
// of odd n takes its next, unused entry with it).  At 8 slots of 4 ranks
// that is 1,344 bytes of the 14,616.
struct RunSeg {
  int off, per_slot, per_rank_slot, fixed;
};
constexpr int kRunSegs = 13;
__constant__ const RunSeg kRunSeg[kRunSegs] = {
    {offsetof(Window, n_slots), 0, 0, 16},  // n_slots, P, dtype, maxseg
    {offsetof(Window, words), 44, 0, 0},
    {offsetof(Window, in_w), 8, 0, 0},
    {offsetof(Window, out_w), 8, 0, 0},
    {offsetof(Window, chunk), 8, 0, 0},
    {offsetof(Window, cols), 8, 0, 0},
    {offsetof(Window, first), 8, 0, 8},
    {offsetof(Window, cls), 4, 0, 0},
    {offsetof(Window, wire), 4, 0, 0},
    {offsetof(Window, sync), 4, 0, 0},
    {offsetof(Window, parts), 4, 0, 0},
    {offsetof(Window, in), 0, 8, 0},
    {offsetof(Window, out), 0, 8, 0},
};

__device__ __forceinline__ int seg_bytes(const RunSeg& g, int n, int P) {
  return g.per_slot * n + g.per_rank_slot * n * P + g.fixed;
}

// bytes of the posted form of n slots of P ranks (a multiple of 16)
__device__ __forceinline__ int run_bytes(int n, int P) {
  int b = 0;
#pragma unroll
  for (int i = 0; i < kRunSegs; ++i) b += (seg_bytes(kRunSeg[i], n, P) + 15) & ~15;
  return b;
}

__device__ __forceinline__ int ld_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.b32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void fence_sc_sys() {
  asm volatile("fence.sc.sys;" ::: "memory");
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A run's stamps, compiled in only under ACCL_RUN_STAMPS (the build of
// scripts/run_profile.py): per window, %globaltimer at the points below,
// the copy and work ends over every block (the first and last copy, the
// last work), and the run's grid.  Read with accl_run_stamps once the run
// returned.
constexpr int kMaxRunWindows = 128;  // CMDRING_MAX_RUN_WINDOWS
enum : int { ST_POLL = 0, ST_SEEN, ST_STAGED, ST_COPY_MIN, ST_COPY_MAX,
             ST_WORK_MAX, ST_CLOSED, ST_DONE, ST_GRID, ST_N };
#ifdef ACCL_RUN_STAMPS
__device__ unsigned long long g_stamps[kMaxRunWindows][ST_N];
__device__ __forceinline__ void stamp(int k, int i) {
  g_stamps[k][i] = i == ST_GRID ? gridDim.x : globaltimer();
}
// the calling block's stamp i of window k, the earliest or the latest of
// every block's (its threads synchronised first)
__device__ __forceinline__ void stamp_blocks(int k, int i, bool latest) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (latest) atomicMax(&g_stamps[k][i], globaltimer());
    else atomicMin(&g_stamps[k][i], globaltimer());
  }
}
#else
__device__ __forceinline__ void stamp(int, int) {}
__device__ __forceinline__ void stamp_blocks(int, int, bool) {}
#endif

// One warp fetches a window's posted form (`bytes`, a multiple of 16) from
// host-mapped memory, uncached, 4 loads of 16 bytes in flight a lane (at 8
// slots of 4 ranks one trip over the bus; 8 took the plain run's kernels
// past 255 registers, into spills), and writes each field at its place in
// the device Window `dst`, 8 bytes at a time.
__device__ __forceinline__ void fetch_posted(const char* src, Window* dst,
                                             int bytes, int n, int P) {
  const int lane = threadIdx.x % 32;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  char* d = reinterpret_cast<char*>(dst);
  const int words = bytes / 16;
  for (int base = lane; base < words; base += 4 * 32) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (base + 32 * u < words) v[u] = __ldcv(s + base + 32 * u);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 16 * (base + 32 * u);  // its offset in the posted form
      if (c >= bytes) continue;
      int start = 0, i = 0, b = seg_bytes(kRunSeg[0], n, P);
      while (c >= start + ((b + 15) & ~15)) {  // the field it falls in
        start += (b + 15) & ~15;
        b = seg_bytes(kRunSeg[++i], n, P);
      }
      const int rel = c - start, copied = (b + 7) & ~7;
      uint2* out = reinterpret_cast<uint2*>(d + kRunSeg[i].off + rel);
      if (rel < copied) out[0] = make_uint2(v[u].x, v[u].y);
      if (rel + 8 < copied) out[1] = make_uint2(v[u].z, v[u].w);
    }
  }
  __threadfence();  // the stage before the flag that publishes it
}

// The run's grid barrier: an arrival count of its own (zero at launch)
// that only grows, so the last block to arrive releases the rest by its
// arrival alone (no reset, no generation word): barrier number b of the
// run is passed once the count reaches (b + 1) x gridDim.x.  `target`
// (shared memory, thread 0's) holds the count to reach.
__device__ __forceinline__ void run_barrier(unsigned* count,
                                            unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(count)
                 : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v)
                   : "l"(count) : "memory");
    } while ((int)(v - target) < 0);
  }
  __syncthreads();
}

// How window j reached the blocks, in bar[2 + j % 2] (written by one
// thread before the barrier that publishes it, read by every block after):
// not fetched ahead (the run waits for it), published at a barrier of its
// own, fetched ahead (published by window j - 1's closing barrier), or the
// run ends (kFlagEnd + the exit reason).  bar[4] is the run's barrier
// count; bar[0..1] the one-shot form's grid barrier, which a window's
// phases and int8 scale phase use inside the run.
enum : unsigned { kFlagWait = 0, kFlagPublished = 1, kFlagAhead = 2,
                  kFlagEnd = 16 };

// The fetching warp: window j fetched into its stage if it is posted
// (`posted` read with acquire first) and within the budget; whether it was.
__device__ __forceinline__ bool fetch_ahead(RunCtl* ctl, const char* descs,
                                            Window* stage, int j,
                                            int run_windows, int n, int P) {
  if (j >= run_windows) return false;
  const int bytes = run_bytes(n, P);
  int seen = 0;
  if (threadIdx.x % 32 == 0) seen = ld_acquire_sys(&ctl->posted) > j;
  seen = __shfl_sync(0xFFFFFFFFu, seen, 0);
  __syncwarp();
  if (!seen) return false;
  if (threadIdx.x % 32 == 0) stamp(j, ST_SEEN);
  fetch_posted(descs + (long long)j * bytes, stage + j % 2, bytes, n, P);
  __syncwarp();
  if (threadIdx.x % 32 == 0) stamp(j, ST_STAGED);
  return true;
}

// One run: up to `run_windows` windows posted into `descs` (host-mapped,
// window k's posted form at k * run_bytes(n_slots, P)), each run as the
// one-shot kernel runs it, its status words into status + k * 2 *
// kMaxSlots (host-mapped).  `stage` holds two Windows in device memory,
// for windows of even and odd k.
//
// A window crosses the bus once, in its posted form, and one warp writes
// its fields into a stage; a barrier publishes it, and every block reads
// it in place (as the one-shot kernel reads its parameter block), with no
// copy of its own.  When window k + 1 is already posted as window k ends,
// the last warp of the last block (the warp with the fewest items of a
// grid-stride walk) fetches it after its own items, and window k's closing
// barrier both ends k and publishes k + 1: one grid barrier a window.
// Else block 0's thread 0 polls the doorbell (ld.acquire.sys) until the
// window is posted, the HALT doorbell rings or %globaltimer shows the
// mailbox idle for the linger, and a barrier of its own publishes the
// window or the end.  The last block's thread 0 stores `ahead`, then
// `done` (the window count) with __threadfence_system() and a release
// store after each closing barrier, and `exited` at the end, while the
// other threads go on.  An idle run so holds the device for the linger at
// most.
//
// Closing at the linger is a handshake with the host's post (Dekker's):
// the run stores closing = k + 1, fences, and reads `posted` again; the
// host stores `posted`, fences, and reads `closing` (accl_sequencer_ring).
// At least one of the two sees the other's store, so either the run takes
// window k (and clears `closing`), or the host learns that the run closed
// without reading it and posts the window elsewhere.  A window is fetched
// ahead only once its `posted` was read with acquire, and never at the
// linger.
template <typename T, int NP, int U, bool LANES>
__device__ __forceinline__ void persistent_body(
    RunCtl* ctl, const char* descs, int* status, Window* stage,
    unsigned* bar, float* scales, int run_windows, long long linger_ns,
    int n_slots, int P) {
  // what one thread or warp keeps across windows lives in shared memory,
  // out of the registers of the window's items: the barrier count to
  // reach (thread 0), the windows fetched ahead (the last block's thread
  // 0) and whether the fetching warp fetched the next window
  __shared__ unsigned target;
  __shared__ int ahead, fetched;
  if (threadIdx.x == 0) target = 0, ahead = 0, fetched = 0;
  __syncthreads();
  volatile unsigned* flag = bar + 2;
  unsigned f = kFlagWait;
  int k = 0;
  for (; k < run_windows; ++k) {
    if (f != kFlagAhead) {  // wait for window k: block 0's warp 0
      if (blockIdx.x == 0 && threadIdx.x < 32) {
        unsigned d = kFlagPublished;
        if (threadIdx.x == 0) {
          const unsigned long long t0 = globaltimer();
          stamp(k, ST_POLL);
          stamp(k, ST_GRID);
          for (;;) {
            if (ld_acquire_sys(&ctl->posted) > k) break;
            if (ld_acquire_sys(&ctl->halt)) { d = kFlagEnd + EXIT_HALT; break; }
            if ((long long)(globaltimer() - t0) > linger_ns) {
              *(volatile int*)&ctl->closing = k + 1;
              fence_sc_sys();
              if (ld_acquire_sys(&ctl->posted) > k) {
                st_release_sys(&ctl->closing, 0);
                break;
              }
              d = kFlagEnd + EXIT_LINGER;
              break;
            }
            __nanosleep(256);
          }
          if (d == kFlagPublished) stamp(k, ST_SEEN);
        }
        d = __shfl_sync(0xFFFFFFFFu, d, 0);
        __syncwarp();
        if (d == kFlagPublished) {
          const int bytes = run_bytes(n_slots, P);
          fetch_posted(descs + (long long)k * bytes, stage + k % 2, bytes,
                       n_slots, P);
          __syncwarp();
          if (threadIdx.x == 0) stamp(k, ST_STAGED);
        }
        if (threadIdx.x == 0) flag[k % 2] = d;
      }
      run_barrier(bar + 4, target);
      f = flag[k % 2];
      if (f >= kFlagEnd) break;
    }
    stamp_blocks(k, ST_COPY_MIN, false);
    stamp_blocks(k, ST_COPY_MAX, true);
    // window k + 1, if posted, fetched ahead by the last warp of the last
    // block: before its items when it already is (they are the fewest of
    // the grid), else after them
    const bool fetcher = blockIdx.x == gridDim.x - 1 &&
                         threadIdx.x / 32 == kWarps - 1;
    if (fetcher) {
      const bool got = fetch_ahead(ctl, descs, stage, k + 1, run_windows,
                                   n_slots, P);
      if (threadIdx.x % 32 == 0) fetched = got;
      __syncwarp();
    }
    run_window<T, NP, U, LANES, !LANES>(
        stage[k % 2], status + (long long)k * 2 * kMaxSlots, scales, bar, 1);
    stamp_blocks(k, ST_WORK_MAX, true);
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x / 32 == kWarps - 1) {
      const bool got = fetched || fetch_ahead(ctl, descs, stage, k + 1,
                                              run_windows, n_slots, P);
      if (threadIdx.x % 32 == 0) flag[(k + 1) % 2] = got ? kFlagAhead : kFlagWait;
    }
    run_barrier(bar + 4, target);  // every item of window k has finished
    f = flag[(k + 1) % 2];
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
      stamp(k, ST_CLOSED);
      if (f == kFlagAhead) *(volatile int*)&ctl->ahead = ++ahead;
      __threadfence_system();
      st_release_sys(&ctl->done, k + 1);
      stamp(k, ST_DONE);
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(&ctl->exited,
                   k == run_windows ? EXIT_BUDGET : (int)(f - kFlagEnd));
  }
}

template <typename T, int NP, int U>
__global__ void __launch_bounds__(kThreads)
persistent_kernel(RunCtl* ctl, const char* descs, int* status,
                  Window* stage, unsigned* bar, float* scales,
                  int run_windows, long long linger_ns, int n_slots, int P) {
  persistent_body<T, NP, U, false>(ctl, descs, status, stage, bar, scales,
                                   run_windows, linger_ns, n_slots, P);
}

// the LANES persistent form, at the bounds of sequencer_lanes_kernel
template <typename T>
__global__ void __launch_bounds__(kThreads, kLaneBlocks)
persistent_lanes_kernel(RunCtl* ctl, const char* descs, int* status,
                        Window* stage, unsigned* bar, float* scales,
                        int run_windows, long long linger_ns, int n_slots,
                        int P) {
  persistent_body<T, kLaneRanks, lanes_u<T>(), true>(
      ctl, descs, status, stage, bar, scales, run_windows, linger_ns, n_slots,
      P);
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

// the most int8 segments of one slot's operand row (0: no int8 slot)
int max_segments(const Window& w) {
  long long m = 0;
  for (int s = 0; s < w.n_slots; ++s)
    if (w.wire[s] == DT_I8) {
      const long long nseg = w.in_w[s] > 0 ? (w.in_w[s] + kSeg - 1) / kSeg : 1;
      if (nseg > m) m = nseg;
    }
  return (int)m;
}

// whether an opcode's slot rounds a contribution through its wire
bool rounds(int op) {
  switch (op) {
    case OPC_ALLREDUCE: case OPC_BCAST: case OPC_REDUCE_SCATTER:
    case OPC_ALLGATHER: case OPC_ALLTOALL: case OPC_SEND: case OPC_RECV:
    case OPC_MATMUL_RS: case OPC_APPLY: case OPC_ATTN_HOP:
      return true;
  }
  return false;
}

// maxseg of a LANES window: 0 (the segment form: no scale phase, each
// int8 scale from the warp's registers) where every int8 slot that rounds
// reads whole segments of its rows, that is its columns are a multiple of
// kSeg (so is every chunk offset a * cols its class reads, and every item
// is one whole segment) and its operands and results are 16-byte aligned
// (so every item takes the 16-byte path); else the most segments of one
// int8 row, for the scale phase
int lane_segments(const Window& w) {
  for (int s = 0; s < w.n_slots; ++s) {
    if (w.wire[s] != DT_I8 || !rounds(w.words[s][W_OPCODE])) continue;
    if (w.cols[s] % kSeg != 0) return max_segments(w);
    for (int r = 0; r < w.P; ++r)
      if ((reinterpret_cast<uintptr_t>(w.in[s * w.P + r]) |
           reinterpret_cast<uintptr_t>(w.out[s * w.P + r])) % 16 != 0)
        return max_segments(w);
  }
  return 0;
}

// whether the calling thread's last launch took the LANES segment form
thread_local int t_segment = 0;

// whether the window takes the LANES instantiation: an fp8 or int8 wire,
// or a 16-bit wire under a nonzero seed
bool lanes_of(const Window& w) {
  for (int s = 0; s < w.n_slots; ++s) {
    const int wire = w.wire[s];
    if (wire == DT_E4M3 || wire == DT_E5M2 || wire == DT_I8) return true;
    if ((wire == DT_BF16 || wire == DT_F16) && w.words[s][W_FLAGS] != 0)
      return true;
  }
  return false;
}

// co-resident blocks of a kernel (the grid barrier's limit), once a kernel
template <typename K>
int co_resident(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return per_sm * sms;
}

// grid > 0: a cooperative launch of `grid` blocks whatever the window
// (scripts/run_profile.py times the one-shot kernel at a run's grid)
template <typename T, int NP, int U, bool LANES = false>
int launch(Window& w, int* status, unsigned* bar, cudaStream_t s,
           float* scales = nullptr, long long scales_len = 0, int grid = 0) {
  long long widest = 0;
  bool coop = plan<T, U>(w, &widest) || grid > 0;
  w.maxseg = LANES ? lane_segments(w) : 0;
  t_segment = LANES && w.maxseg == 0;
  if (w.maxseg > 0) {
    coop = true;  // the scale phase ends at a grid barrier
    if (scales == nullptr ||
        scales_len < (long long)w.n_slots * w.P * w.maxseg)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (widest + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  if (!coop) {
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    sequencer_of<T, NP, U, LANES>()
        <<<(unsigned)blocks, kThreads, 0, s>>>(w, status, nullptr, 0, scales);
    return static_cast<int>(cudaGetLastError());
  }
  if (bar == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  static int max_blocks = 0;  // co-resident blocks: the barrier's limit
  if (max_blocks == 0) {
    max_blocks = co_resident(sequencer_of<T, NP, U, LANES>());
    if (max_blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (grid > 0) blocks = grid;
  if (blocks > max_blocks) blocks = max_blocks;
  int one = 1;
  void* args[] = {&w, &status, &bar, &one, &scales};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sequencer_of<T, NP, U, LANES>()),
      dim3((unsigned)blocks), dim3(kThreads), args, 0, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// NP ranks' words in flight a lane, U chunks a tile: NP = 4 for every P
// (more ranks fold in groups of 4), U = 4 for 4-byte elements (16 words
// a lane; at P = 4 timed against 1 and 2 by scripts/tile_variants.py)
// and 2 for the others, whose per-element arithmetic (16-bit floats
// through float, 8-byte words) spilled at 4.  The LANES instantiation
// (float operands alone) takes one int8 segment a tile (lanes_u).
template <typename T> constexpr int tile_u() { return sizeof(T) == 4 ? 4 : 2; }

// the operand types of the LANES instantiation
template <typename T>
constexpr bool kFloatLanes = std::is_same<T, float>::value ||
                             std::is_same<T, __half>::value ||
                             std::is_same<T, __nv_bfloat16>::value;

template <typename T>
int launch_for(Window& w, int* status, unsigned* bar, float* scales,
               long long scales_len, cudaStream_t s, int grid = 0) {
  if (lanes_of(w)) {
    if constexpr (kFloatLanes<T>)
      return launch<T, kLaneRanks, lanes_u<T>(), true>(w, status, bar, s, scales,
                                                 scales_len, grid);
    else
      return static_cast<int>(cudaErrorInvalidValue);  // float lanes only
  }
  return launch<T, 4, tile_u<T>()>(w, status, bar, s, nullptr, 0, grid);
}

// the persistent kernel of a dtype, plain or LANES, on its co-resident grid
template <typename T>
int launch_run(bool lanes, RunCtl* ctl, const char* descs, int* status,
               Window* stage, unsigned* bar, float* scales, int run_windows,
               long long linger_ns, int n_slots, int P, cudaStream_t s) {
  const void* fn;
  int blocks;
  if (lanes) {
    if constexpr (kFloatLanes<T>) {
      static int b = co_resident(persistent_lanes_kernel<T>);
      fn = reinterpret_cast<const void*>(persistent_lanes_kernel<T>);
      blocks = b;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    static int b = co_resident(persistent_kernel<T, 4, tile_u<T>()>);
    fn = reinterpret_cast<const void*>(persistent_kernel<T, 4, tile_u<T>()>);
    blocks = b;
  }
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&ctl, &descs, &status, &stage, &bar, &scales, &run_windows,
                  &linger_ns, &n_slots, &P};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      fn, dim3((unsigned)blocks), dim3(kThreads), args, 0, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
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

// the tile of a dtype's instantiation, plain or LANES
template <typename T>
void plan_for(Window& w) {
  long long widest = 0;
  if (lanes_of(w)) {
    plan<T, lanes_u<T>()>(w, &widest);
    w.maxseg = lane_segments(w);
  } else {
    plan<T, tile_u<T>()>(w, &widest);
    w.maxseg = 0;
  }
}

}  // namespace

#ifndef ACCL_KERNELS_ONLY  // scripts/tile_variants.cu includes the kernels
// One launch for the window `desc` (a Window, as pack_window lays it
// out; copied into the parameter block).  `status` receives (seqn,
// retcode) per slot; `barrier` is two device words, zero between
// launches, used only by a window with a barrier flag after its first
// slot or an int8 slot (may be null otherwise); `scales` is a device
// scratch buffer of `scales_len` floats, at least n_slots * P * the most
// 256-element segments of an int8 slot's operand row (null without an
// int8 slot).  Returns cudaGetLastError() after the launch (0 on
// success).
namespace {
int sequencer_at(const void* desc, int* status, void* barrier, void* scales,
                 long long scales_len, void* stream, int grid) {
  Window w;
  memcpy(&w, desc, sizeof(Window));
  const int rc = check(w);
  if (rc) return rc;
  unsigned* bar = static_cast<unsigned*>(barrier);
  float* sc = static_cast<float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = scales_len;
  switch (w.dtype) {
    case DT_F32: return launch_for<float>(w, status, bar, sc, n, s, grid);
    case DT_BF16:
      return launch_for<__nv_bfloat16>(w, status, bar, sc, n, s, grid);
    case DT_F16: return launch_for<__half>(w, status, bar, sc, n, s, grid);
    case DT_I32: return launch_for<int32_t>(w, status, bar, sc, n, s, grid);
    case DT_F64: return launch_for<double>(w, status, bar, sc, n, s, grid);
    case DT_I64: return launch_for<int64_t>(w, status, bar, sc, n, s, grid);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

extern "C" int accl_sequencer(const void* desc, int* status, void* barrier,
                              void* scales, long long scales_len,
                              void* stream) {
  return sequencer_at(desc, status, barrier, scales, scales_len, stream, 0);
}

// scripts/run_profile.py's entry points.  accl_sequencer_grid: the one-shot
// kernel launched cooperatively at `grid` blocks (capped at co-resident),
// as a run's grid walks a window; `barrier` two zeroed device words.
extern "C" int accl_sequencer_grid(const void* desc, int* status,
                                   void* barrier, void* scales,
                                   long long scales_len, int grid,
                                   void* stream) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  return sequencer_at(desc, status, barrier, scales, scales_len, stream,
                      grid);
}

// The run stamps (kMaxRunWindows x ST_N unsigned 64-bit words) into `buf`
// (write 0) or from it (write 1); cudaErrorNotSupported in a build without
// ACCL_RUN_STAMPS.
extern "C" int accl_run_stamps(void* buf, int write) {
#ifdef ACCL_RUN_STAMPS
  const size_t n = sizeof(unsigned long long) * kMaxRunWindows * ST_N;
  return static_cast<int>(write ? cudaMemcpyToSymbol(g_stamps, buf, n)
                                : cudaMemcpyFromSymbol(buf, g_stamps, n));
#else
  (void)buf;
  (void)write;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// Whether the calling thread's last accl_sequencer launch took the fp8 /
// int8 instantiation's segment form (no scale phase): 1, else 0.
extern "C" int accl_sequencer_segment() { return t_segment; }

// Check the window `desc` and fill its item prefix and maxseg in place, as
// a launch would: a window posted to a persistent run travels planned.
// Returns 0, or cudaErrorInvalidValue for a window no kernel takes.
extern "C" int accl_sequencer_plan(void* desc) {
  Window* w = static_cast<Window*>(desc);
  const int rc = check(*w);
  if (rc) return rc;
  const bool lanes = lanes_of(*w);
  switch (w->dtype) {
    case DT_F32: plan_for<float>(*w); return 0;
    case DT_BF16: plan_for<__nv_bfloat16>(*w); return 0;
    case DT_F16: plan_for<__half>(*w); return 0;
    case DT_I32: if (lanes) break; plan_for<int32_t>(*w); return 0;
    case DT_F64: if (lanes) break; plan_for<double>(*w); return 0;
    case DT_I64: if (lanes) break; plan_for<int64_t>(*w); return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch one persistent run on `stream` for windows of `n_slots` slots of
// `P` ranks: `ctl` (a RunCtl, zeroed), `descs` (run_windows posted forms,
// each ops/cuda/cmdring.py::run_bytes(n_slots, P) bytes, planned as
// accl_sequencer_plan plans a window) and `status` (run_windows x 64 x 2
// ints) in host-mapped memory; `stage` two Windows and `barrier` eight
// zeroed words of device memory; `scales` as for accl_sequencer (the
// largest window's need; may be null for a run without int8 slots).
// `lanes` picks the LANES instantiation for every window of the run.
extern "C" int accl_sequencer_run(void* ctl, const void* descs, int* status,
                                  void* stage, void* barrier, void* scales,
                                  int dtype, int lanes, int run_windows,
                                  long long linger_ns, int n_slots, int P,
                                  void* stream) {
  if (run_windows < 1 || n_slots < 1 || n_slots > kMaxSlots || P < 1 ||
      P > kMaxP || n_slots * P > kMaxPtrs)
    return static_cast<int>(cudaErrorInvalidValue);
  RunCtl* c = static_cast<RunCtl*>(ctl);
  const char* d = static_cast<const char*>(descs);
  Window* st = static_cast<Window*>(stage);
  unsigned* bar = static_cast<unsigned*>(barrier);
  float* sc = static_cast<float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool l = lanes != 0;
  const int n = n_slots;
  switch (dtype) {
    case DT_F32:
      return launch_run<float>(l, c, d, status, st, bar, sc, run_windows,
                               linger_ns, n, P, s);
    case DT_BF16:
      return launch_run<__nv_bfloat16>(l, c, d, status, st, bar, sc,
                                       run_windows, linger_ns, n, P, s);
    case DT_F16:
      return launch_run<__half>(l, c, d, status, st, bar, sc, run_windows,
                                linger_ns, n, P, s);
    case DT_I32:
      return launch_run<int32_t>(l, c, d, status, st, bar, sc, run_windows,
                                 linger_ns, n, P, s);
    case DT_F64:
      return launch_run<double>(l, c, d, status, st, bar, sc, run_windows,
                                linger_ns, n, P, s);
    case DT_I64:
      return launch_run<int64_t>(l, c, d, status, st, bar, sc, run_windows,
                                 linger_ns, n, P, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The host's doorbells of a run: `posted` windows posted (each after its
// descriptor was written), or with `halt` the HALT doorbell.  Sequentially
// consistent stores, so a descriptor is visible before its doorbell.  A
// post returns the run's `closing` word read after a full fence: when it
// is `posted` (the run is closing at that window) the host waits for the
// run's decision (see persistent_body); any other value means the run
// will read the window.
extern "C" int accl_sequencer_ring(void* ctl, int posted, int halt) {
  RunCtl* c = static_cast<RunCtl*>(ctl);
  if (halt) {
    __atomic_store_n(&c->halt, 1, __ATOMIC_SEQ_CST);
    return 0;
  }
  __atomic_store_n(&c->posted, posted, __ATOMIC_SEQ_CST);
  __atomic_thread_fence(__ATOMIC_SEQ_CST);
  return __atomic_load_n(&c->closing, __ATOMIC_SEQ_CST);
}

// Host memory of `bytes` mapped into the device's address space (UVA: the
// host pointer is the device pointer), zeroed; its address into *out.
extern "C" int accl_mapped_alloc(void* out, long long bytes) {
  void* p = nullptr;
  const cudaError_t rc = cudaHostAlloc(&p, (size_t)bytes,
                                       cudaHostAllocMapped |
                                           cudaHostAllocPortable);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  memset(p, 0, (size_t)bytes);
  void* dev = nullptr;
  const cudaError_t rc2 = cudaHostGetDevicePointer(&dev, p, 0);
  if (rc2 != cudaSuccess || dev != p) {
    cudaFreeHost(p);
    return static_cast<int>(rc2 != cudaSuccess ? rc2 : cudaErrorInvalidValue);
  }
  *static_cast<void**>(out) = p;
  return 0;
}
#endif  // ACCL_KERNELS_ONLY
