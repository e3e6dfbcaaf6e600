// Row 15: ring attention's forward over P ranks that share one device,
// contiguous or striped sequence shards, causal or full, one launch for
// every rank.
//
// Replaces accl_tpu/ops/pallas/attention.py::_attention_kernel (:111;
// pallas_call at :265 in ring_attention :216; its fold _fold :77).  What
// it computes, exactly as there, for each rank `me`: scores in float32
// scaled by 1/sqrt(D) of the logical head dim, masked scores set to
// -1e30; the online-softmax state (o, m, l) in float32 from m = -1e30,
// l = 0, o = 0; m_new = max(m, rowmax), p = exp(s - m_new), alpha =
// exp(m - m_new), o = o alpha + round(p) V with p rounded to the operand
// dtype, l = l alpha + sum(p) of the unrounded p; out = o / max(l, 1e-30)
// in the operand dtype.  The own block folds first, then the block of
// origin (me - s) mod P for s = 1..P-1, the order in which the TPU ring
// delivers them.  The causal mask of a hop from `origin`: contiguous
// shards, triangular when origin == me, all keys when origin < me, none
// when origin > me; striped shards (models.stripe_sequence), triangular
// when me >= origin, strictly triangular otherwise.
//
// On the TPU the K/V blocks rotate between chips by remote DMA, two comm
// slots double-buffered behind a slot-ack protocol, while the MXU folds
// the block that arrived.  On one card no hop is a transfer: a block
// reads each visiting rank's K/V tiles straight from that rank's
// allocation (its tensor map; the float32 kernel's pointer table), so no
// slot and no ack exist.  Maps and table are what peer pointers across
// NVLink fill later (ROADMAP B14).
//
// Work that changes no bit is skipped.  A hop whose mask is all false (a
// contiguous causal hop from a later rank) and, inside a causal hop, the
// key tiles past the diagonal tile add p = exp(-1e30 - m) = 0 exactly and
// alpha = exp(0) = 1 exactly once m is finite, and m is finite after the
// first key tile of the own block (every query row sees key 0 there), so
// the TPU's fold of those keys leaves (o, m, l) as it found them.
//
// Bound on the H100: operations.  Each query row folds the keys its mask
// allows, 4 D flops a (query, key) pair (Q K^T and P V); at the long-
// context width (4 ranks x (2, 32, 1024, 128) bf16, causal) both layouts
// fold T (T + 1) / 2 pairs of the global T = 4096, 2.75e11 operations,
// 0.278 ms at 989 TFLOP/s, against 0.080 ms for the bytes.  The first
// port folded them with row 16's mma.sync tiles (154 TFLOP/s); now the
// 16-bit kernel is row 16's redesign on the same fold core
// (flash_sm90.cuh): a persistent block of a TMA producer and two wgmma
// consumer warpgroups per SM keeps a work item's (o, m, l) in registers
// across every hop, while the producer walks (hop, key tile) and loads
// each tile of the visiting rank's K/V through that rank's tensor map
// into the stage ring, which never drains across hops or items.  Work
// items go head by head, so the blocks in flight share a few heads' K/V
// in L2, the heaviest (rank, query tile) of each head first (the last
// query tiles of the last ranks for contiguous causal shards, the last
// query tiles for striped), drawn from a shared counter.
//
// float32 operands never go through the tensor cores (no TF32, the TPU
// kernel's _mxu_precision rule): a separate kernel folds with FFMA, 4
// threads per query row, as row 16's does.
#include "flash.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;

enum : int { HOP_SKIP = 0, HOP_FULL = 1, HOP_TRI = 2, HOP_STRICT = 3 };

// every rank's q, k, v and output, (B, H, T, D) contiguous: 4 x 64
// pointers = 2 KiB of the 4 KiB parameter space
struct Args {
  const void* q[accl::kMaxRanks];
  const void* k[accl::kMaxRanks];
  const void* v[accl::kMaxRanks];
  void* o[accl::kMaxRanks];
  int P, T, D, nq, causal, striped, vec;
  float scale;
};

// the rank and query tile of block row y, heaviest first (y = 0); A is
// either kernel's arguments
template <typename A>
__device__ __forceinline__ void block_task(const A& a, int y, int& me,
                                           int& iq) {
  if (a.causal && !a.striped) {  // rank me folds me full hops + its own
    me = a.P - 1 - y / a.nq;
    iq = a.nq - 1 - y % a.nq;
  } else {  // every rank alike: the query tile decides
    iq = a.nq - 1 - y / a.P;
    me = y % a.P;
  }
}

template <typename A>
__device__ __forceinline__ int hop_kind(const A& a, int me, int origin) {
  if (!a.causal) return HOP_FULL;
  if (a.striped) return me >= origin ? HOP_TRI : HOP_STRICT;
  return origin == me ? HOP_TRI : origin < me ? HOP_FULL : HOP_SKIP;
}

// The walk over (hop s, key tile j): hop s folds the block of origin
// (me - s) mod P, FULL hops every key tile, causal ones up to the
// diagonal tile iq, SKIP hops none.
struct Walk {
  int s, j, origin, kind, ntiles;
};

template <typename A>
__device__ __forceinline__ void enter_hop(const A& a, int me, int iq, int nkt,
                                          Walk& w) {
  w.j = 0;
  for (; w.s < a.P; ++w.s) {
    w.origin = accl::ring_mod(me - w.s, a.P);
    w.kind = hop_kind(a, me, w.origin);
    w.ntiles = w.kind == HOP_SKIP ? 0 : w.kind == HOP_FULL ? nkt : iq + 1;
    if (w.ntiles) return;
  }
}

// the step after w; w.s == P past the last tile
template <typename A>
__device__ __forceinline__ Walk advance(const A& a, int me, int iq, int nkt,
                                        Walk w) {
  if (++w.j < w.ntiles) return w;
  ++w.s;
  enter_hop(a, me, iq, nkt, w);
  return w;
}

// masked: keys at or past T, and by the hop's causal mask
__device__ __forceinline__ bool masked(int kind, int row, int key, int T) {
  return key >= T || (kind == HOP_TRI && row < key) ||
         (kind == HOP_STRICT && row <= key);
}

// The 16-bit kernel's arguments: every rank's q, k and v tensor maps (by
// value, a __grid_constant__ parameter: 3 x 64 maps of 128 bytes, 24 KiB
// of the 32 KiB a kernel's parameters may take since CUDA 12.1) and
// output pointers.
struct TmaArgs {
  CUtensorMap q[accl::kMaxRanks], k[accl::kMaxRanks], v[accl::kMaxRanks];
  void* o[accl::kMaxRanks];
  int* sched;  // the work counters (sm90::next_item), zero at launch
  int P, H, T, D, nq, causal, striped, pairs, items;
  float scale2;  // scale * log2(e)
};

// Persistent: one block per SM draws work items (sm90::next_item) from
// the B H P nq (batch-head, rank, 128-row query tile) items, item w the
// batch-head w / (P nq) and block_task's row w % (P nq), heaviest first:
// the blocks in flight at once share a few heads' K/V, which stay in L2.
// The producer loads the item's Q from rank me once, then walks (hop, key
// tile) and loads each tile of the visiting rank's K/V into the stage
// ring, across hops and items without draining it; the stage's record
// tells the consumers the hop's mask kind, the tile's first key and
// whether it is the item's last.  The consumers fold as row 16's do.
template <typename E, int DP>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    ring_attention_wgmma(const __grid_constant__ TmaArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const sm90::Smem<DP> sm(smem);
  sm.init();
  const int T = a.T, NY = a.nq * a.P;  // (rank, query tile) rows
  const int nkt = (T + sm90::kBN - 1) / sm90::kBN;

  if (threadIdx.x < 128) {  // the producer
    sm90::regs_down<sm90::kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::Ring qr, kv;
      for (int w; (w = sm90::next_item(a.sched, a.items)) >= 0;) {
        int me, iq;
        block_task(a, w % NY, me, iq);
        const int b = (w / NY) / a.H, h = (w / NY) % a.H;
        sm.load_q(qr, &a.q[me], w, iq * sm90::kBM, h, b);
        Walk wk;
        wk.s = 0;
        enter_hop(a, me, iq, nkt, wk);  // the own hop: never skipped
        while (wk.s < a.P) {
          const Walk nx = advance(a, me, iq, nkt, wk);
          const sm90::Record rec = {wk.kind, wk.j * sm90::kBN, nx.s >= a.P,
                                    0};
          sm.load_kv(kv, &a.k[wk.origin], &a.v[wk.origin],
                     wk.j * sm90::kBN, h, b, &rec);
          wk = nx;
        }
      }
      sm.end_items(qr);
    }
  } else {  // the consumers
    sm90::regs_up<sm90::kConsumerRegs>();
    // the consumer warpgroup, warp-uniform (shuffled from lane 0) so that
    // its shared addresses and wgmma descriptors live in uniform registers
    const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int tid = threadIdx.x % 128;
    sm90::Ring qr, kv;
    for (int w; (w = sm.wait_item(qr)) >= 0; qr.next<2>()) {
      int me, iq;
      block_task(a, w % NY, me, iq);
      sm90::Fold<E, DP> f;
      f.init(iq * sm90::kBM + cw * 64 + (tid / 32) * 16 + (tid % 32) / 4);
      sm90::consume(
          sm, f, kv, qr, cw, a.scale2,
          [=](int, int stage, int& k0, bool& edge, int& kind) {
            const sm90::Record r = sm.recs[stage];
            k0 = r.k0;
            kind = r.kind;
            edge = (kind >= HOP_TRI && k0 == iq * sm90::kBN) ||
                   k0 + sm90::kBN > T;
            return r.last != 0;
          },
          [=](int kind, int row, int key) {
            return masked(kind, row, key, T);
          });
      f.store(static_cast<E*>(a.o[me]) + (long long)(w / NY) * T * a.D, a.D,
              T, a.D, a.pairs, nullptr);
    }
  }
}

// float32: the same walk and fold with FFMA.  Thread (r = tid / 4, u =
// tid % 4) owns query row r of the block, keys u, u + 4, ... of each tile
// and output columns u, u + 4, ...; the 4 threads of a row are
// neighbouring lanes and combine their row max and sum by shuffles.
template <int DP>
__global__ void __launch_bounds__(256) ring_attention_f32(Args a) {
  constexpr int SQ = DP + 1;   // Q and K rows: conflict-free column walks
  constexpr int SP = kBK + 1;  // probability rows
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * SQ;
  float* Vs = Ks + kBK * SQ;
  float* Ps = Vs + kBK * DP;

  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  int me, iq;
  block_task(a, blockIdx.y, me, iq);
  const int T = a.T, D = a.D, q0 = iq * kBQ, row = q0 + r;
  const long long head = (long long)blockIdx.x * T * D;
  const int nkt = (T + kBK - 1) / kBK;

  load_tile<float, DP, SQ, 256>(
      Qs, static_cast<const float*>(a.q[me]) + head, D, q0, T, D, a.vec);
  float acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  Walk w;
  w.s = 0;
  for (enter_hop(a, me, iq, nkt, w); w.s < a.P;
       w = advance(a, me, iq, nkt, w)) {
    const int k0 = w.j * kBK;
    __syncthreads();
    load_tile<float, DP, SQ, 256>(
        Ks, static_cast<const float*>(a.k[w.origin]) + head, D, k0, T, D,
        a.vec);
    load_tile<float, DP, DP, 256>(
        Vs, static_cast<const float*>(a.v[w.origin]) + head, D, k0, T, D,
        a.vec);
    __syncthreads();

    const bool edge = (w.kind >= HOP_TRI && w.j == iq) || k0 + kBK > T;
    float s[kBK / 4];
    float mx = m;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int key = u + 4 * i;
      const float* qr = Qs + r * SQ;
      const float* kr = Ks + key * SQ;
      float x = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) x = fmaf(qr[d], kr[d], x);
      x *= a.scale;
      if (edge && masked(w.kind, row, k0 + key, T)) x = kNeg;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const float p = expf(s[i] - m);
      Ps[r * SP + u + 4 * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    __syncwarp();  // the row's probabilities come from its 4 lanes
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int d = u + 4 * i;
      float y = 0.f;
#pragma unroll 16
      for (int key = 0; key < kBK; ++key)
        y = fmaf(Ps[r * SP + key], Vs[key * DP + d], y);
      acc[i] = acc[i] * alpha + y;
    }
  }

  if (row >= T) return;
  const float den = fmaxf(l, 1e-30f);
  float* orow = static_cast<float*>(a.o[me]) + head + (long long)row * D;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    const int d = u + 4 * i;
    if (d < D) orow[d] = acc[i] / den;
  }
}

template <int DP>
int launch_f32(dim3 grid, const Args& a, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBK) * (DP + 1) + kBK * DP + kBQ * (kBK + 1));
  return launch(ring_attention_f32<DP>, grid, 256, smem, a, s);
}

template <typename E, int DP>
int launch_wgmma(dim3 grid, const TmaArgs& a, cudaStream_t s) {
  return launch(ring_attention_wgmma<E, DP>, grid, sm90::kThreads,
                sm90::Layout<DP>::kDynamic, a, s);
}

template <typename E>
int launch_16bit(int dp, dim3 grid, const TmaArgs& a, cudaStream_t s) {
  return dp <= 64 ? launch_wgmma<E, 64>(grid, a, s)
                  : launch_wgmma<E, 128>(grid, a, s);
}

}  // namespace

// q[r], k[r], v[r], o[r]: rank r's (B, H, T, D) tensors, all ranks one
// shape and dtype.  float32: contiguous, tma null.  bfloat16 / float16: o
// contiguous; tma = the geometry of every rank's q, then k, then v (3 P x
// 9 values, ops/cuda/attention.py::_tma_geometry), whose maps may hold a
// head dim padded with zeros past D, and sched two int32 work counters,
// zero, which the launch leaves zero.  D <= 128; P * ceil(T / 64) <= 65535
// (float32), P * ceil(T / 128) <= 65535 (16-bit).  Returns 0 or a
// cudaError_t (after the launch, cudaGetLastError()).
extern "C" int accl_ring_attention(const void* const* q, const void* const* k,
                                   const void* const* v, void* const* o,
                                   const long long* tma, int* sched, int P,
                                   int B, int H,
                                   int T, int D, int dtype, int causal,
                                   int striped, int vec, float scale,
                                   void* stream) {
  if (P < 1 || P > accl::kMaxRanks || B <= 0 || H <= 0 || T <= 0 || D <= 0 ||
      D > 128 || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    const long long nq = (T + kBQ - 1) / kBQ;
    if (nq * P > 65535) return static_cast<int>(cudaErrorInvalidValue);
    Args a;
    for (int r = 0; r < P; ++r) {
      a.q[r] = q[r];
      a.k[r] = k[r];
      a.v[r] = v[r];
      a.o[r] = o[r];
    }
    a.P = P;
    a.T = T;
    a.D = D;
    a.nq = static_cast<int>(nq);
    a.causal = causal;
    a.striped = striped;
    const int dp = padded_dim(D);
    a.vec = vec && D == dp;  // the vector path reads whole padded rows
    a.scale = scale;
    const dim3 grid((unsigned)(B * H), (unsigned)(nq * P));
    switch (dp) {
      case 32: return launch_f32<32>(grid, a, s);
      case 64: return launch_f32<64>(grid, a, s);
      case 128: return launch_f32<128>(grid, a, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((dtype != DT_BF16 && dtype != DT_F16) || !tma || !sched)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nq = (T + sm90::kBM - 1) / sm90::kBM;
  if (nq * P > 65535) return static_cast<int>(cudaErrorInvalidValue);
  TmaArgs a;
  a.sched = sched;
  const void* const* ptrs[3] = {q, k, v};
  CUtensorMap* maps[3] = {a.q, a.k, a.v};
  int dp = 64;
  for (int i = 0; i < 3; ++i) {
    for (int r = 0; r < P; ++r) {
      const long long* g = tma + 9 * (i * P + r);
      if (!sm90::standard_box(g) || g[0] < D || g[0] > 128)
        return static_cast<int>(cudaErrorInvalidValue);
      if (g[0] > 64) dp = 128;
      const int e = sm90::encode(&maps[i][r], ptrs[i][r], g, dtype);
      if (e) return e;
    }
  }
  bool pairs = D % 2 == 0;
  for (int r = 0; r < P; ++r) {
    a.o[r] = o[r];
    pairs = pairs && reinterpret_cast<uintptr_t>(o[r]) % 4 == 0;
  }
  a.P = P;
  a.H = H;
  a.T = T;
  a.D = D;
  a.nq = static_cast<int>(nq);
  a.causal = causal;
  a.striped = striped;
  a.pairs = pairs;
  a.scale2 = scale * sm90::kLog2e;
  const long long items = (long long)B * H * nq * P;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.items = static_cast<int>(items);
  const dim3 grid(sm90::persistent_grid(items));
  return dtype == DT_BF16 ? launch_16bit<__nv_bfloat16>(dp, grid, a, s)
                          : launch_16bit<__half>(dp, grid, a, s);
}
