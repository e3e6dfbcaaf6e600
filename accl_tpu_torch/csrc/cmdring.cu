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
// wire.  The window's slot words travel in the kernel's parameter block
// (__grid_constant__, read in place, no host-to-device copy and no
// staging buffer a previous window might still read) and are decoded on
// the device: the opcode, function, root, peer and fparam of a slot are
// data, never template or host branches.  Only the window's SHAPE picks
// the code path, as it keys the JAX program cache: the element type (a
// template), and per slot the width class (the relations slot_epilogue
// branches on), the wire dtype and the per-rank chunk.
//
// Per slot, a thread owns a column c below the slot's column count and
// computes every rank's result at c (and, for the P-wide ops, at c + k*n
// for every chunk k).  It reads everything those results need before it
// writes any of them (the reduce-scatter, fused and alltoall results go
// through a per-thread staging array; allreduce, bcast and allgather
// results are written after their reads), so a result that keeps its
// operand's column (in place: allreduce, bcast, the MPI in-place
// allgather, reduce-scatter, alltoall, the fused ops) is correct.  The
// wrapper stages any other overlap as a copy on the same stream.
//
// Slots run in order.  Where a slot writes memory that an earlier slot
// of the launch reads or writes, a grid-wide barrier separates the two
// (the counterpart of the TPU kernel's _ring_barrier :556); the launch is
// cooperative, so every block is resident and the atomic-counter barrier
// cannot deadlock.  A slot that reads what an earlier slot writes is
// refused by the engine (data_dependency), as in JAX, where each slot
// reads its operands as they were before the window.
//
// Numerics equal slot_epilogue's bit for bit: the fold runs in rank order
// b0 op b1 op ... (common.cuh's Arith: NaN-propagating MAX, wrapping int
// SUM, round-to-nearest-even after every 16-bit operation); each
// contribution is rounded through the wire dtype before the fold while a
// rank's own operand stays unrounded; fp = float(fparam) * 2^-16 cast to
// the operand type; products and differences use the _rn intrinsics so
// no multiply-add is contracted.
//
// Bound on the H100: bytes.  A window reads each operand element it uses
// once and writes each result element once, with at most P-1 operations
// per result element: far below the card's operations-per-byte line.
#include "common.cuh"

namespace {

using accl::Arith;
using accl::Convert;
using accl::kMaxRanks;
using accl::kThreads;

constexpr int kMaxSlots = 64;   // CMDRING_MAX_DEPTH
constexpr int kMaxPtrs = 512;   // rank-slots per launch (64 slots x 8 ranks)
constexpr int kWords = 11;      // CMDRING_SLOT_WORDS
constexpr int kStageA2A = 64;   // alltoall staging: P*P values, P <= 8

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

struct SlotShape {
  long long in_w, out_w, chunk;  // chunk: per-rank sub-block, 0 for none
  int cls, wire, sync, pad;      // sync: grid barrier before this slot
};

struct Window {
  int words[kMaxSlots][kWords];
  SlotShape shape[kMaxSlots];
  const void* in[kMaxPtrs];  // slot s, rank r at s * P + r; null = zeros
  void* out[kMaxPtrs];       // null = that rank takes no result
  int n_slots, P;
};
static_assert(sizeof(Window) <= 32000, "window descriptor too large");

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

template <typename T>
__device__ __forceinline__ T ld(const void* p, long long e) {
  return p ? static_cast<const T*>(p)[e] : Convert<T>::from(0.0f);
}

template <typename T>
__device__ __forceinline__ void st(void* p, long long e, T v) {
  if (p) static_cast<T*>(p)[e] = v;
}

// one contribution through the slot's wire lane (0 = none)
template <typename T>
__device__ __forceinline__ T wire_round(T v, int wire) {
  if (wire == DT_BF16) return Convert<T>::from(Convert<__nv_bfloat16>::from(v));
  if (wire == DT_F16) return Convert<T>::from(Convert<__half>::from(v));
  return v;
}

// rank-order fold of every rank's (wire-rounded) element e
template <typename T>
__device__ __forceinline__ T fold(const void* const* in, int P, long long e,
                                  int op, int wire) {
  T acc = wire_round(ld<T>(in[0], e), wire);
  for (int j = 1; j < P; ++j)
    acc = Arith<T>::apply(op, acc, wire_round(ld<T>(in[j], e), wire));
  return acc;
}

__device__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (*reinterpret_cast<volatile unsigned*>(count) < target)
      __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sequencer_kernel(const __grid_constant__ Window w, int* status,
                 unsigned* sync) {
  const int P = w.P;
  if (blockIdx.x == 0) {  // status words, as status_words computes them
    for (int s = threadIdx.x; s < w.n_slots; s += blockDim.x) {
      const int op = w.words[s][W_OPCODE];
      status[2 * s] = w.words[s][W_SEQN];
      status[2 * s + 1] = (op >= 0 && op <= OPC_MAX) ? 1 : 2;
    }
  }
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned barriers = 0;
  for (int s = 0; s < w.n_slots; ++s) {
    const SlotShape& sh = w.shape[s];
    if (sh.sync) grid_barrier(sync, ++barriers * gridDim.x);
    // decode the slot words on the device
    const int op = w.words[s][W_OPCODE];
    const int fop = w.words[s][W_FUNCTION] == 1 ? OP_MAX : OP_SUM;
    const int root_word = w.words[s][W_ROOT];
    const int root = (root_word > 0 && root_word < P) ? root_word : 0;
    const int peer = w.words[s][W_PEER];
    const T fp = Convert<T>::from(
        __fmul_rn((float)w.words[s][W_FPARAM], 1.0f / 65536.0f));
    const void* const* in = w.in + s * P;
    void* const* out = w.out + s * P;
    const int wire = sh.wire;
    T stage[kMaxRanks];

    if (sh.cls == CLS_SOLO) {  // one rank: its own operand
      const long long cols = sh.out_w < sh.in_w ? sh.out_w : sh.in_w;
      for (long long c = tid; c < cols; c += stride)
        st<T>(out[0], c, ld<T>(in[0], c));
    } else if (sh.cls == CLS_AG) {
      const long long n = sh.in_w;
      for (long long c = tid; c < n; c += stride) {
        for (int q = 0; q < P; ++q) {
          if (!out[q]) continue;
          if (op == OPC_ALLGATHER) {
            for (int j = 0; j < P; ++j)
              st<T>(out[q], j * n + c, wire_round(ld<T>(in[j], c), wire));
          } else {  // a mis-encoded slot tiles its own operand
            const T v = ld<T>(in[q], c);
            for (int j = 0; j < P; ++j) st<T>(out[q], j * n + c, v);
          }
        }
      }
    } else if (sh.cls == CLS_RS || sh.cls == CLS_APPLY ||
               sh.cls == CLS_ATTN) {
      const long long n = sh.out_w;
      for (long long c = tid; c < n; c += stride) {
        for (int me = 0; me < P; ++me) {
          if (!out[me]) continue;
          const int src = accl::ring_mod(me - peer, P);
          T r;
          if (sh.cls == CLS_APPLY) {
            r = op == OPC_APPLY
                    ? Mul<T>::sub(ld<T>(in[me], P * n + c),
                                  Mul<T>::mul(fp, fold<T>(in, P, me * n + c,
                                                          fop, wire)))
                    : ld<T>(in[me], c);
          } else if (sh.cls == CLS_RS &&
                     (op == OPC_REDUCE_SCATTER || op == OPC_MATMUL_RS)) {
            const T mine = fold<T>(in, P, me * n + c, fop, wire);
            r = op == OPC_REDUCE_SCATTER ? mine : Mul<T>::mul(fp, mine);
          } else if (op == OPC_ATTN_HOP && (sh.cls == CLS_ATTN || P == 2)) {
            r = Mul<T>::mul(Mul<T>::mul(ld<T>(in[me], n + c),
                                        wire_round(ld<T>(in[src], c), wire)),
                            fp);
          } else {  // a mis-encoded slot keeps its own chunk
            r = ld<T>(in[me], (sh.cls == CLS_RS ? me * n : 0) + c);
          }
          stage[me] = r;
        }
        for (int me = 0; me < P; ++me) st<T>(out[me], c, stage[me]);
      }
    } else if (op == OPC_ALLTOALL && sh.chunk > 0) {
      const long long n = sh.chunk;
      for (long long c = tid; c < n; c += stride) {
        if (P * P <= kStageA2A) {
          T v[kStageA2A];
          for (int j = 0; j < P; ++j)
            for (int k = 0; k < P; ++k)
              v[j * P + k] = wire_round(ld<T>(in[j], k * n + c), wire);
          for (int me = 0; me < P; ++me)
            for (int j = 0; j < P; ++j)
              st<T>(out[me], j * n + c, v[j * P + me]);
        } else {  // the wrapper copies any operand a result overlaps
          for (int me = 0; me < P; ++me)
            for (int j = 0; j < P; ++j)
              st<T>(out[me], j * n + c,
                    wire_round(ld<T>(in[j], me * n + c), wire));
        }
      }
    } else {  // the same-width class
      const long long cols = sh.chunk > 0 ? sh.chunk : sh.in_w;
      const int nk = sh.chunk > 0 ? P : 1;
      for (long long c = tid; c < cols; c += stride) {
        for (int k = 0; k < nk; ++k) {
          const long long e = k * cols + c;
          if (op == OPC_ALLREDUCE) {
            const T v = fold<T>(in, P, e, fop, wire);
            for (int me = 0; me < P; ++me) st<T>(out[me], e, v);
          } else if (op == OPC_BCAST || op == OPC_SEND || op == OPC_RECV) {
            const T v = wire_round(ld<T>(in[root], e), wire);
            for (int me = 0; me < P; ++me)
              st<T>(out[me], e,
                    (op == OPC_BCAST || me == peer) ? v : ld<T>(in[me], e));
          } else {  // BARRIER and every other opcode: the own operand
            for (int me = 0; me < P; ++me) st<T>(out[me], e, ld<T>(in[me], e));
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const Window& w, int* status, unsigned* sync, long long cols,
           cudaStream_t s) {
  static int max_blocks = 0;  // co-resident blocks: the barrier's limit
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sequencer_kernel<T>, kThreads, 0);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    max_blocks = per_sm * sms;
  }
  long long blocks = (cols + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  cudaError_t rc = cudaMemsetAsync(sync, 0, sizeof(unsigned), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  void* args[] = {const_cast<Window*>(&w), &status, &sync};
  rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sequencer_kernel<T>),
      dim3((unsigned)blocks), dim3(kThreads), args, 0, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch for `n_slots` slots of `P` ranks (n_slots <= 64,
// n_slots * P <= 512).  `words` is the (n_slots, 11) int32 slot words;
// per slot the operand width, result width, per-rank chunk (0: none),
// width class, wire DataType (0: none) and barrier flag; `in`/`out` are
// n_slots * P device pointers, slot-major.  `status` receives
// (seqn, retcode) per slot; `sync` is one device word of barrier counter.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int accl_sequencer(const int* words, const long long* in_w,
                              const long long* out_w, const long long* chunk,
                              const int* cls, const int* wire,
                              const int* sync_flags, const void* const* in,
                              void* const* out, int n_slots, int P, int dtype,
                              int* status, unsigned* sync, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots || P < 1 || P > kMaxRanks ||
      n_slots * P > kMaxPtrs)
    return static_cast<int>(cudaErrorInvalidValue);
  Window local = {};  // the parameter block, copied at launch
  long long cols = 1;
  for (int s = 0; s < n_slots; ++s) {
    for (int k = 0; k < kWords; ++k) local.words[s][k] = words[s * kWords + k];
    SlotShape& sh = local.shape[s];
    sh.in_w = in_w[s];
    sh.out_w = out_w[s];
    sh.chunk = chunk[s];
    sh.cls = cls[s];
    sh.wire = wire[s];
    sh.sync = sync_flags[s];
    const long long c = sh.cls == CLS_AG ? sh.in_w
                        : sh.cls == CLS_SAME ? (sh.chunk ? sh.chunk : sh.in_w)
                                             : sh.out_w;
    if (c > cols) cols = c;
  }
  for (int i = 0; i < n_slots * P; ++i) {
    local.in[i] = in[i];
    local.out[i] = out[i];
  }
  local.n_slots = n_slots;
  local.P = P;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return launch<float>(local, status, sync, cols, s);
    case DT_BF16: return launch<__nv_bfloat16>(local, status, sync, cols, s);
    case DT_F16: return launch<__half>(local, status, sync, cols, s);
    case DT_I32: return launch<int32_t>(local, status, sync, cols, s);
    case DT_F64: return launch<double>(local, status, sync, cols, s);
    case DT_I64: return launch<int64_t>(local, status, sync, cols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
