// Rows 17 and 18: the single-device flash-attention backward, dQ and
// dK/dV, causal or full, with grouped-query K/V, and the delta pass
// before them.
//
// Replaces accl_tpu/ops/pallas/attention.py::_flash_bwd_dq_kernel (:451)
// and _flash_bwd_dkv_kernel (:503) (pallas_calls at :605 and :617 in
// _flash_bwd_impl :562; the custom_vjp of flash_attention :635-653), and
// the delta XLA forms there (:570-572).  What they compute, exactly as
// there, from the forward's per-row logsumexp lse and delta = rowsum(dO *
// O) (both (B, H, T) float32; delta by accl_flash_bwd_delta below):
//   s  = Q K^T * scale                     (float32)
//   p  = mask ? exp(s - lse) : 0           (mask: key < T, query < T and,
//                                           when causal, query >= key;
//                                           explicit, so a padded row
//                                           never revives as p = 1)
//   dp = dO V^T                            (float32)
//   ds = p * (dp - delta) * scale
//   dQ  = sum over keys    of ds (rounded to K's dtype) K
//   dV  = sum over queries of p^T (rounded to dO's dtype) dO
//   dK  = sum over queries of ds^T (rounded to Q's dtype) Q
// each accumulated in float32 and written once in the operand dtype.
// q head h reads kv head h / (H / Hkv); dK and dV come out PER Q HEAD
// (every output written by one block, no atomics, so a gradient is the
// same bits from run to run) and the wrapper sums each group of H / Hkv
// heads in float32 afterwards, as the TPU form does (_flash_bwd_impl
// :627-631).
//
// Bound on the H100: at the training shape (8, 32, 1024, 128) bf16
// causal, dQ does 3 and dK/dV 4 products of 2 D operations over the
// T (T + 1) / 2 visible pairs: 103 and 138 GFLOP, 0.104 and 0.139 ms at
// 989 TFLOP/s, just above their byte bounds (0.101 and 0.120 ms); the
// delta pass reads dO and O once (2 x 64 MiB) and writes 1 MiB, 0.040 ms
// at 3.35 TB/s.  What held the first port (mma.sync m16n8k16 from blocks
// of 4 warps that also copied with cp.async, two __syncthreads a tile,
// expf, 32-query dK/dV tiles; 125-136 TFLOP/s) back, and what the 16-bit
// kernels do about it, on the forward's core (flash_sm90.cuh):
//  * only wgmma reaches the tensor cores' rate: every product is a wgmma
//    of one warpgroup's 64 rows.  The scores s and dp (or their
//    transposes) are m64n64k16 with both operands in shared memory; p and
//    ds pass from those accumulators to the A operand of the next
//    products in registers (flash::pack), whose B is the same shared tile
//    read MN-major (desc_mn) where the scores read it K-major (desc_k);
//  * copies compete with the products: one warp walks the loads (Walk),
//    keeping a ring of kStages streamed tiles full with TMA (the operands'
//    own 4-D strides, zero-filled past T and D); its lanes copy each
//    streamed query tile's lse and delta rows with cp.async, which arrive
//    on the tile's barrier when they land;
//  * short folds pay a block's start-up: blocks are persistent (one per
//    SM) and draw work items of 128 rows from a per-stream counter head
//    by head, heaviest first, so the blocks in flight share a few heads'
//    streamed operands in L2 and the light items fill in at the end;
//  * exp competes with the products: scale log2(e) and lse log2(e) fold
//    into one FFMA before one EX2.
//  - dK/dV (flash_bwd_dkv_wgmma): an item is 128 keys of one (b, q head),
//    64 a consumer warpgroup; its K and V load once; it streams 64-query
//    tiles of Q and dO from floor(k0 / 64) when causal.  Per tile s^T =
//    K Q^T and dp^T = V dO^T, then dV += p^T dO and dK += ds^T Q.  dK and
//    dV take 64 + 64 registers a thread, s^T and dp^T 32 + 32: more than
//    ptxas keeps wgmmas in flight with in a block of 384 threads (168
//    registers at launch; it serialises and spills, C7512, whatever
//    setmaxnreg grants), so the block is the two consumer warpgroups
//    alone (255 registers), and the second one's first warp walks the
//    loads one tile ahead of its own products.
//  - dQ (flash_bwd_dq_wgmma): an item is 128 query rows of one (b, h);
//    its Q and dO load once; it streams 64-key tiles of K and V up to the
//    diagonal when causal.  Per tile s = Q K^T and dp = dO V^T, then
//    dQ += ds K.  dQ, s and dp take 64 + 32 + 32 registers, so the block
//    keeps the forward's shape: a producer warpgroup (setmaxnreg down to
//    24) whose warp 0 walks the loads, and two consumers (up to 240).
// Only the diagonal and the ragged tiles apply the mask; a consumer skips
// a tile its mask leaves wholly empty (dK/dV: warpgroup 1's first of each
// causal item; dQ: warpgroup 0's last).
//
// float32 operands never go through the tensor cores (no TF32): separate
// kernels fold with FFMA, 4 threads per query row (dQ) or key row (dK/dV).
#include "flash.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, T) contiguous
  const float* delta;  // (B, H, T) contiguous
  void* d0;            // dQ, or dK (per q head)
  void* d1;            // null, or dV (per q head)
  Strides sq, sk, sv, sdo, s0, s1;
  int H, Hkv, T, D, causal, vec;
  float scale;
};

__device__ __forceinline__ bool visible(int q, int key, int T, int causal) {
  return q < T && key < T && (!causal || q >= key);
}

// -- the 16-bit kernels: wgmma fed by TMA ------------------------------------

constexpr int kItemRows = 128;  // rows of a work item: keys (dK/dV), queries (dQ)
constexpr int kTileRows = 64;   // rows of a streamed tile: queries (dK/dV), keys (dQ)
constexpr int kStages = 2;
constexpr int kConsumers = 256;  // two consumer warpgroups a block
// dQ's block adds a producer warpgroup (sm90::kThreads threads), which
// drops to kProducerRegs registers so that the consumers rise to
// kConsumerRegs; dK/dV's block is kConsumers threads (see the note above)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 24 + 2 x 240 = 3 x 168, the launch's

// The 16-bit kernels' arguments: the four operands' tensor maps (by value:
// a __grid_constant__ parameter), the outputs and their element strides.
struct TmaArgs {
  CUtensorMap q, k, v, dout;
  const float* lse;    // (B, H, T) contiguous
  const float* delta;  // (B, H, T) contiguous
  void* d0;            // dQ, or dK (per q head)
  void* d1;            // null, or dV (per q head)
  Strides s0, s1;
  int* sched;  // the work counters (sm90::next_item), zero at launch
  int H, Hkv, T, D, causal, pairs, n, items;  // n: items a head
  float scale, scale2;  // scale, scale * log2(e)
};

// The shared memory of a block, in bytes from a 1024-aligned base: two
// item buffers of two 128-row tensors each (a block folds one item while
// the next one's loads), kStages stages of two 64-row streamed tiles, each
// stage's lse and delta rows (dK/dV), the mbarriers (a "full" and an
// "empty" one per item buffer and per stage) and each item buffer's work
// item.
template <int DP>
struct Layout {
  static constexpr int kItem = kItemRows * DP * 2;  // one item tensor
  static constexpr int kTile = kTileRows * DP * 2;  // one streamed tile
  static constexpr int kItems = 0;                  // [2][2]
  static constexpr int kTiles = 4 * kItem;          // [kStages][2]
  static constexpr int kStats = kTiles + 2 * kStages * kTile;  // [kStages][2][64] f32
  static constexpr int kBars = kStats + 2 * kStages * kTileRows * 4;
  static constexpr int kWork = kBars + 8 * (4 + 2 * kStages);
  static constexpr int kBytes = kWork + 4 * 2;
  static constexpr int kDynamic = kBytes + 1024;  // room to align the base
  static_assert(kDynamic <= 232448, "over the 227 KB a block may use");
};

template <int DP>
struct Smem {
  using L = Layout<DP>;
  uint32_t base;
  unsigned char* raw;  // the generic address of base
  __device__ __forceinline__ explicit Smem(unsigned char* p)
      : base((sm90::smem_addr(p) + 1023u) & ~1023u),
        raw(p + (base - sm90::smem_addr(p))) {}
  // tensor x (0 or 1) of item buffer i, of stage s
  __device__ __forceinline__ uint32_t item(int i, int x) const {
    return base + L::kItems + (2 * i + x) * L::kItem;
  }
  __device__ __forceinline__ uint32_t tile(int s, int x) const {
    return base + L::kTiles + (2 * s + x) * L::kTile;
  }
  // stage s's lse (x = 0) or delta (x = 1) rows
  __device__ __forceinline__ float* stats(int s, int x) const {
    return reinterpret_cast<float*>(raw + L::kStats) + (2 * s + x) * kTileRows;
  }
  __device__ __forceinline__ int* work() const {
    return reinterpret_cast<int*>(raw + L::kWork);
  }
  __device__ __forceinline__ uint32_t bar(int i) const {
    return base + L::kBars + 8 * i;
  }
  __device__ __forceinline__ uint32_t item_full(int i) const { return bar(i); }
  __device__ __forceinline__ uint32_t item_empty(int i) const {
    return bar(2 + i);
  }
  __device__ __forceinline__ uint32_t tile_full(int s) const {
    return bar(4 + s);
  }
  __device__ __forceinline__ uint32_t tile_empty(int s) const {
    return bar(4 + kStages + s);
  }

  // An item buffer's full barrier takes the walk's one arrival (with the
  // TMA bytes), a stage's 33: one from each lane of the walking warp when
  // its lse and delta copies land, and lane 0's with the TMA bytes; every
  // empty barrier one from each consumer thread.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2; ++i) {
        sm90::mbar_init(item_full(i), 1);
        sm90::mbar_init(item_empty(i), kConsumers);
      }
      for (int s = 0; s < kStages; ++s) {
        sm90::mbar_init(tile_full(s), 33);
        sm90::mbar_init(tile_empty(s), kConsumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// Work item w of a launch: batch-head w / n and, for dK/dV, key block
// w % n (the heaviest, the most query tiles under causal masking, first);
// for dQ, query block n - 1 - w % n.  Returns the item's first row.
template <bool kDkv>
__device__ __forceinline__ int item_rows(int w, int n) {
  return (kDkv ? w % n : n - 1 - w % n) * kItemRows;
}

// The streamed tiles of an item whose first row is r0: from `first`,
// `count` of them (dK/dV: the query tiles from the one holding key r0
// when causal; dQ: the key tiles up to the item's last row when causal).
template <bool kDkv>
__device__ __forceinline__ void tile_range(int r0, int T, int causal,
                                           int& first, int& count) {
  const int all = (T + kTileRows - 1) / kTileRows;
  if (kDkv) {
    first = causal ? r0 / kTileRows : 0;
    count = all - first;
  } else {
    first = 0;
    count = causal ? min((r0 + kItemRows - 1) / kTileRows + 1, all) : all;
  }
}

// cp.async of 4 bytes from src into shared memory at dst; zeros when !in
__device__ __forceinline__ void copy4(uint32_t dst, const float* src,
                                      bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// An arrival on bar once this thread's earlier cp.async copies land
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The loads' walk over a launch's work, run by one warp: the items drawn
// from the work counter, each item's two 128-row tensors (dK/dV: K and V
// of the kv head; dQ: Q and dO) into the item ring, then its streamed
// 64-row tiles (dK/dV: Q and dO of the q head, with their lse and delta
// rows; dQ: K and V) into the stage ring.  issue() issues one tile,
// drawing and loading the next item first when the current one has none
// left, and ends the item ring (item -1) when the counter has none.
// Lane 0 draws and issues the TMA copies; every lane copies its lse and
// delta rows with cp.async and arrives when they land.
template <bool kDkv, int DP>
struct Walk {
  int bh = 0, b = 0, ih = 0, th = 0, j = 0, end = 0;
  bool done = false;
  sm90::Ring it, st;

  __device__ __forceinline__ void issue(const Smem<DP>& sm,
                                        const TmaArgs& a) {
    using L = Layout<DP>;
    const int lane = threadIdx.x % 32;
    if (done) return;
    if (j == end) {  // the next item
      int w = 0;
      if (lane == 0) w = sm90::next_item(a.sched, a.items);
      w = __shfl_sync(0xffffffffu, w, 0);
      sm90::mbar_wait(sm.item_empty(it.slot), it.phase ^ 1);
      if (w < 0) {  // none is left: item -1, its barrier without bytes
        if (lane == 0) {
          sm.work()[it.slot] = -1;
          sm90::mbar_arrive(sm.item_full(it.slot));
        }
        done = true;
        return;
      }
      const int r0 = item_rows<kDkv>(w, a.n);
      bh = w / a.n;
      b = bh / a.H;
      const int h = bh % a.H, kvh = h / (a.H / a.Hkv);
      ih = kDkv ? kvh : h;
      th = kDkv ? h : kvh;
      if (lane == 0) {
        sm.work()[it.slot] = w;
        sm90::mbar_expect_tx(sm.item_full(it.slot), 2 * L::kItem);
        sm90::tma_tile<DP>(sm.item(it.slot, 0), kDkv ? &a.k : &a.q,
                           sm.item_full(it.slot), r0, ih, b);
        sm90::tma_tile<DP>(sm.item(it.slot, 1), kDkv ? &a.v : &a.dout,
                           sm.item_full(it.slot), r0, ih, b);
      }
      it.next<2>();
      int count;
      tile_range<kDkv>(r0, a.T, a.causal, j, count);
      end = j + count;
    }
    const int t0 = j * kTileRows;
    sm90::mbar_wait(sm.tile_empty(st.slot), st.phase ^ 1);
    if (kDkv) {
      const long long row = (long long)bh * a.T;
      for (int r = lane; r < kTileRows; r += 32) {
        const bool in = t0 + r < a.T;
        const long long i = row + (in ? t0 + r : 0);
        copy4(sm90::smem_addr(sm.stats(st.slot, 0) + r), a.lse + i, in);
        copy4(sm90::smem_addr(sm.stats(st.slot, 1) + r), a.delta + i, in);
      }
    }
    copies_arrive(sm.tile_full(st.slot));
    if (lane == 0) {
      sm90::mbar_expect_tx(sm.tile_full(st.slot), 2 * L::kTile);
      sm90::tma_tile<DP, kTileRows>(sm.tile(st.slot, 0), kDkv ? &a.q : &a.k,
                                    sm.tile_full(st.slot), t0, th, b);
      sm90::tma_tile<DP, kTileRows>(sm.tile(st.slot, 1),
                                    kDkv ? &a.dout : &a.v,
                                    sm.tile_full(st.slot), t0, th, b);
    }
    st.next<kStages>();
    ++j;
  }
};

// s = A0 B0^T and d = A1 B1^T over one warpgroup's 64 rows: A0 and A1 its
// rows of two 128-row item tensors, B0 and B1 two 64-row streamed tiles,
// all K-major; one commit group a product, both waited.
template <typename E, int DP>
__device__ __forceinline__ void scores(float (&s)[32], float (&d)[32],
                                       uint32_t a0, uint32_t b0, uint32_t a1,
                                       uint32_t b1) {
  uint64_t da[DP / 16], db[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    da[kk] = sm90::pinned(sm90::desc_k<kItemRows>(a0, kk));
    db[kk] = sm90::pinned(sm90::desc_k<kTileRows>(b0, kk));
  }
  sm90::wgmma_fence();  // s was last read by ordinary code
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    sm90::wgmma_ss64<E>(s, da[kk], db[kk], kk);
  sm90::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    da[kk] = sm90::pinned(sm90::desc_k<kItemRows>(a1, kk));
    db[kk] = sm90::pinned(sm90::desc_k<kTileRows>(b1, kk));
  }
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    sm90::wgmma_ss64<E>(d, da[kk], db[kk], kk);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(d);
}

// The rounded m64n64 accumulator x as the A operand of 4 k16 steps
template <typename E>
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[c][i] = pack<E>(x[8 * c + 2 * i], x[8 * c + 2 * i + 1]);
}

// acc += A B over one k16 step: A in registers, B a 64-row streamed tile
// read MN-major at step c
template <typename E, int DP>
__device__ __forceinline__ void product(float (&acc)[DP / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  if constexpr (DP == 128)
    sm90::wgmma_rs128<E>(acc, a, db);
  else
    sm90::wgmma_rs64<E>(acc, a, db);
}

// The m64nDP accumulator x in the operand dtype at base (row stride st),
// rows row[0..1] below T, columns below D; pairs: two neighbouring
// columns in one 4-byte store.
template <typename E, int DP>
__device__ __forceinline__ void store_rows(const float (&x)[DP / 2], E* base,
                                           long long st, const int (&row)[2],
                                           int T, int D, bool pairs) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    E* orow = base + row[r] * st;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t;
      const float lo = x[4 * n + 2 * r], hi = x[4 * n + 2 * r + 1];
      if (pairs) {
        if (c < D) *reinterpret_cast<uint32_t*>(orow + c) = pack<E>(lo, hi);
      } else {
        if (c < D) orow[c] = accl::from_float<E>(lo);
        if (c + 1 < D) orow[c + 1] = accl::from_float<E>(hi);
      }
    }
  }
}

// dK and dV of one q head, bf16/f16: persistent blocks of two consumer
// warpgroups of 64 keys each, the second one's first warp walking the
// loads one tile ahead of the products.
template <typename E, int DP>
__global__ void __launch_bounds__(kConsumers, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ TmaArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const Smem<DP> sm(smem_tiles);
  sm.init();
  {
    // the consumer warpgroup, warp-uniform (shuffled from lane 0) so that
    // its shared addresses and wgmma descriptors live in uniform registers
    const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    // warpgroup 1 skips each causal item's first tile (below), so its
    // first warp walks the loads
    const bool walker = threadIdx.x / 32 == 4;
    Walk<true, DP> walk;
    if (walker)  // the first item and its first kStages - 1 tiles
      for (int i = 0; i < kStages - 1; ++i) walk.issue(sm, a);
    const int tid = threadIdx.x % 128, t = tid % 4;
    const int T = a.T, causal = a.causal;
    const int D = a.D, pairs = a.pairs;
    sm90::Ring it, st;
    for (;; it.next<2>()) {
      sm90::mbar_wait(sm.item_full(it.slot), it.phase);
      const int w = sm.work()[it.slot];
      if (w < 0) break;
      const int bh = w / a.n, k0 = item_rows<true>(w, a.n);
      const int b = bh / a.H, h = bh % a.H;
      const int kc = k0 + cw * 64;  // this warpgroup's first key
      const int key[2] = {kc + (tid / 32) * 16 + (tid % 32) / 4,
                          kc + (tid / 32) * 16 + (tid % 32) / 4 + 8};
      const uint32_t ks = sm.item(it.slot, 0) + cw * 64 * 128;
      const uint32_t vs = sm.item(it.slot, 1) + cw * 64 * 128;
      float dk[DP / 2], dv[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
      int first, count;
      tile_range<true>(k0, T, causal, first, count);
      for (int j = first; j < first + count; ++j) {
        // the tile kStages - 1 ahead, maybe the next item's
        if (walker) walk.issue(sm, a);
        sm90::mbar_wait(sm.tile_full(st.slot), st.phase);
        const uint32_t qs = sm.tile(st.slot, 0), dos = sm.tile(st.slot, 1);
        const float* ls = sm.stats(st.slot, 0);
        const float* dl = sm.stats(st.slot, 1);
        const int q0 = j * kTileRows;
        const bool last = j == first + count - 1;
        // a tile whose queries all precede this warpgroup's keys adds
        // nothing (warpgroup 1's first under causal masking)
        if (causal && q0 + kTileRows - 1 < kc) {
          if (last) sm90::mbar_arrive(sm.item_empty(it.slot));
          sm90::mbar_arrive(sm.tile_empty(st.slot));
          st.next<kStages>();
          continue;
        }
        float s[32], dp[32];  // s^T = K Q^T, dp^T = V dO^T
        scores<E, DP>(s, dp, ks, qs, vs, dos);
        if (last) sm90::mbar_arrive(sm.item_empty(it.slot));
        // p^T in place of s^T, ds^T in place of dp^T; query q0 + col
        const bool edge = (causal && q0 < kc + 63) || q0 + kTileRows > T ||
                          kc + 64 > T;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i / 4) + 2 * t + (i & 1);
          float p = sm90::ex2(fmaf(s[i], a.scale2, -ls[col] * sm90::kLog2e));
          if (edge && !visible(q0 + col, key[(i >> 1) & 1], T, causal))
            p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl[col]) * a.scale;
        }
        uint32_t pa[4][4], sa[4][4];
        to_a<E>(s, pa);
        to_a<E>(dp, sa);
        // dV += p^T dO and dK += ds^T Q: the streamed tiles read MN-major
        uint64_t ddo[4], dq[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ddo[c] = sm90::pinned(sm90::desc_mn<kTileRows>(dos, c));
          dq[c] = sm90::pinned(sm90::desc_mn<kTileRows>(qs, c));
        }
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c) product<E, DP>(dv, pa[c], ddo[c]);
#pragma unroll
        for (int c = 0; c < 4; ++c) product<E, DP>(dk, sa[c], dq[c]);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::mbar_arrive(sm.tile_empty(st.slot));
        st.next<kStages>();
      }
      store_rows<E, DP>(dk, static_cast<E*>(a.d0) + b * a.s0.b + h * a.s0.h,
                        a.s0.t, key, T, D, pairs);
      store_rows<E, DP>(dv, static_cast<E*>(a.d1) + b * a.s1.b + h * a.s1.h,
                        a.s1.t, key, T, D, pairs);
    }
  }
}

// dQ, bf16/f16: persistent blocks of three warpgroups (the loads' walk,
// then two consumers of 64 query rows each).
template <typename E, int DP>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ TmaArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const Smem<DP> sm(smem_tiles);
  sm.init();
  if (threadIdx.x < 128) {  // the producer
    sm90::regs_down<kProducerRegs>();
    if (threadIdx.x < 32) {
      Walk<false, DP> walk;
      while (!walk.done) walk.issue(sm, a);
    }
  } else {  // the consumers
    sm90::regs_up<kConsumerRegs>();
    const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int tid = threadIdx.x % 128, t = tid % 4;
    const int T = a.T, causal = a.causal;
    const int D = a.D, pairs = a.pairs;
    sm90::Ring it, st;
    for (;; it.next<2>()) {
      sm90::mbar_wait(sm.item_full(it.slot), it.phase);
      const int w = sm.work()[it.slot];
      if (w < 0) break;
      const int bh = w / a.n, q0 = item_rows<false>(w, a.n);
      const int b = bh / a.H, h = bh % a.H;
      const int qc = q0 + cw * 64;  // this warpgroup's first row
      const int row[2] = {qc + (tid / 32) * 16 + (tid % 32) / 4,
                          qc + (tid / 32) * 16 + (tid % 32) / 4 + 8};
      float lse[2], dl[2];  // lse in log2 units
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long i = (long long)bh * T + row[r];
        lse[r] = row[r] < T ? a.lse[i] * sm90::kLog2e : 0.f;
        dl[r] = row[r] < T ? a.delta[i] : 0.f;
      }
      const uint32_t qs = sm.item(it.slot, 0) + cw * 64 * 128;
      const uint32_t dos = sm.item(it.slot, 1) + cw * 64 * 128;
      float dq[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
      int first, count;
      tile_range<false>(q0, T, causal, first, count);
      for (int j = first; j < first + count; ++j) {
        const int k0 = j * kTileRows;
        const bool last = j == first + count - 1;
        sm90::mbar_wait(sm.tile_full(st.slot), st.phase);
        // a tile whose keys all follow this warpgroup's rows adds nothing
        // (warpgroup 0's last under causal masking)
        if (causal && k0 > qc + 63) {
          if (last) sm90::mbar_arrive(sm.item_empty(it.slot));
          sm90::mbar_arrive(sm.tile_empty(st.slot));
          st.next<kStages>();
          continue;
        }
        const uint32_t ks = sm.tile(st.slot, 0), vs = sm.tile(st.slot, 1);
        float s[32], dp[32];  // s = Q K^T, dp = dO V^T
        scores<E, DP>(s, dp, qs, ks, dos, vs);
        if (last) sm90::mbar_arrive(sm.item_empty(it.slot));
        // ds in place of s; column k0 + col
        const bool edge = (causal && k0 + kTileRows - 1 > qc) ||
                          k0 + kTileRows > T || qc + 64 > T;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          float p = sm90::ex2(fmaf(s[i], a.scale2, -lse[r]));
          if (edge && !visible(row[r], key, T, causal)) p = 0.f;
          s[i] = p * (dp[i] - dl[r]) * a.scale;
        }
        uint32_t sa[4][4];
        to_a<E>(s, sa);
        // dQ += ds K: the K tile read MN-major
        uint64_t dk[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dk[c] = sm90::pinned(sm90::desc_mn<kTileRows>(ks, c));
        sm90::fence_regs(dq);
        sm90::wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c) product<E, DP>(dq, sa[c], dk[c]);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        sm90::mbar_arrive(sm.tile_empty(st.slot));
        st.next<kStages>();
      }
      store_rows<E, DP>(dq, static_cast<E*>(a.d0) + b * a.s0.b + h * a.s0.h,
                        a.s0.t, row, T, D, pairs);
    }
  }
}

// float32 dQ with FFMA.  Thread (r = tid / 4, u = tid % 4) owns query
// row r of the block, keys u, u + 4, ... of each tile and dQ columns u,
// u + 4, ...; a row's ds passes through shared memory to its 4 lanes.
template <int DP>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32(BwdArgs a) {
  constexpr int SQ = DP + 1;   // conflict-free row walks
  constexpr int SP = kBK + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kBQ * SQ;
  float* Ks = dOs + kBQ * SQ;
  float* Vs = Ks + kBK * SQ;
  float* Ps = Vs + kBK * SQ;

  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int iq = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int T = a.T, D = a.D, q0 = iq * kBQ, row = q0 + r;
  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  load_tile<float, DP, SQ, 256>(Qs, qb, a.sq.t, q0, T, D, a.vec);
  load_tile<float, DP, SQ, 256>(dOs, dob, a.sdo.t, q0, T, D, a.vec);
  const long long ri = (long long)bh * T + row;
  const float lse = row < T ? a.lse[ri] : 0.f;
  const float dl = row < T ? a.delta[ri] : 0.f;
  float acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;
  const int nkt = (T + kBK - 1) / kBK;
  const int ntiles = a.causal ? min(iq + 1, nkt) : nkt;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();
    load_tile<float, DP, SQ, 256>(Ks, kb, a.sk.t, k0, T, D, a.vec);
    load_tile<float, DP, SQ, 256>(Vs, vb, a.sv.t, k0, T, D, a.vec);
    __syncthreads();
    const float* qr = Qs + r * SQ;
    const float* dr = dOs + r * SQ;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int key = u + 4 * i;
      const float* kr = Ks + key * SQ;
      const float* vr = Vs + key * SQ;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dr[d], vr[d], dp);
      }
      const float p = visible(row, k0 + key, T, a.causal)
                          ? expf(s * a.scale - lse)
                          : 0.f;
      Ps[r * SP + key] = p * (dp - dl) * a.scale;
    }
    __syncwarp();  // the row's ds comes from its 4 lanes
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int d = u + 4 * i;
      float y = 0.f;
#pragma unroll 16
      for (int key = 0; key < kBK; ++key)
        y = fmaf(Ps[r * SP + key], Ks[key * SQ + d], y);
      acc[i] += y;
    }
  }

  if (row >= T) return;
  float* orow = static_cast<float*>(a.d0) + b * a.s0.b + h * a.s0.h +
                row * a.s0.t;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    const int d = u + 4 * i;
    if (d < D) orow[d] = acc[i];
  }
}

// float32 dK and dV of one q head with FFMA.  Thread (r = tid / 4, u =
// tid % 4) owns key row r of the block, queries u, u + 4, ... of each
// 64-query tile and dK/dV columns u, u + 4, ....
template <int DP>
__global__ void __launch_bounds__(256) flash_bwd_dkv_f32(BwdArgs a) {
  constexpr int SQ = DP + 1;
  constexpr int SP = kBQ + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kBK * SQ;
  float* Qs = Vs + kBK * SQ;
  float* dOs = Qs + kBQ * SQ;
  float* Ps = dOs + kBQ * SQ;
  float* Ds = Ps + kBK * SP;
  float* Ls = Ds + kBK * SP;  // [lse, delta] of the query tile

  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int jk = blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int T = a.T, D = a.D, k0 = jk * kBK, key = k0 + r;
  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  load_tile<float, DP, SQ, 256>(Ks, kb, a.sk.t, k0, T, D, a.vec);
  load_tile<float, DP, SQ, 256>(Vs, vb, a.sv.t, k0, T, D, a.vec);
  float dk[DP / 4], dv[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) dk[i] = dv[i] = 0.f;
  const int nqt = (T + kBQ - 1) / kBQ;
  const int i0 = a.causal ? k0 / kBQ : 0;

  for (int i = i0; i < nqt; ++i) {
    const int q0 = i * kBQ;
    __syncthreads();
    load_tile<float, DP, SQ, 256>(Qs, qb, a.sq.t, q0, T, D, a.vec);
    load_tile<float, DP, SQ, 256>(dOs, dob, a.sdo.t, q0, T, D, a.vec);
    if (threadIdx.x < 2 * kBQ) {
      const int q = q0 + (threadIdx.x & (kBQ - 1));
      const float* src = threadIdx.x < kBQ ? a.lse : a.delta;
      Ls[threadIdx.x] = q < T ? src[(long long)bh * T + q] : 0.f;
    }
    __syncthreads();
    const float* kr = Ks + r * SQ;
    const float* vr = Vs + r * SQ;
#pragma unroll
    for (int x = 0; x < kBQ / 4; ++x) {
      const int qi = u + 4 * x;
      const float* qr = Qs + qi * SQ;
      const float* dr = dOs + qi * SQ;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) {
        s = fmaf(kr[d], qr[d], s);
        dp = fmaf(vr[d], dr[d], dp);
      }
      const float p = visible(q0 + qi, key, T, a.causal)
                          ? expf(s * a.scale - Ls[qi])
                          : 0.f;
      Ps[r * SP + qi] = p;
      Ds[r * SP + qi] = p * (dp - Ls[kBQ + qi]) * a.scale;
    }
    __syncwarp();  // the key row's p and ds come from its 4 lanes
#pragma unroll
    for (int x = 0; x < DP / 4; ++x) {
      const int d = u + 4 * x;
      float yv = 0.f, yk = 0.f;
#pragma unroll 16
      for (int qi = 0; qi < kBQ; ++qi) {
        yv = fmaf(Ps[r * SP + qi], dOs[qi * SQ + d], yv);
        yk = fmaf(Ds[r * SP + qi], Qs[qi * SQ + d], yk);
      }
      dv[x] += yv;
      dk[x] += yk;
    }
  }

  if (key >= T) return;
  float* krow = static_cast<float*>(a.d0) + b * a.s0.b + h * a.s0.h +
                key * a.s0.t;
  float* vrow = static_cast<float*>(a.d1) + b * a.s1.b + h * a.s1.h +
                key * a.s1.t;
#pragma unroll
  for (int x = 0; x < DP / 4; ++x) {
    const int d = u + 4 * x;
    if (d < D) {
      krow[d] = dk[x];
      vrow[d] = dv[x];
    }
  }
}

// -- the delta pass ------------------------------------------------------------

struct DeltaArgs {
  const void* dout;
  const void* o;
  float* delta;  // (B, H, T) contiguous
  Strides sd, so;
  long long rows;  // B H T
  int H, T, D, vec;
};

// Four elements in one 8- or 16-byte load
template <typename E> struct alignas(4 * sizeof(E)) Quad {
  E x[4];
};

// delta = rowsum(dO * O) in float32, one warp a row: each lane widens its
// columns (vec: 4 a load, lane l columns 4l.., 4l + 128..), the products
// summed in FFMA, then across the warp by __shfl_xor.
template <typename E>
__global__ void __launch_bounds__(256) flash_bwd_delta(DeltaArgs a) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= a.rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / a.T;
  const int t = static_cast<int>(row - bh * a.T);
  const long long b = bh / a.H, h = bh - b * a.H;
  const E* d = static_cast<const E*>(a.dout) + b * a.sd.b + h * a.sd.h +
               t * a.sd.t;
  const E* o = static_cast<const E*>(a.o) + b * a.so.b + h * a.so.h +
               t * a.so.t;
  float acc = 0.f;
  if (a.vec) {
    for (int c = 4 * lane; c < a.D; c += 128) {
      const Quad<E> x = *reinterpret_cast<const Quad<E>*>(d + c);
      const Quad<E> y = *reinterpret_cast<const Quad<E>*>(o + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc = fmaf(accl::to_float(x.x[e]), accl::to_float(y.x[e]), acc);
    }
  } else {
    for (int c = lane; c < a.D; c += 32)
      acc = fmaf(accl::to_float(d[c]), accl::to_float(o[c]), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) a.delta[row] = acc;
}

template <int DP>
int launch_dq_f32(dim3 grid, const BwdArgs& a, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (4 * kBK * (DP + 1) + kBQ * (kBK + 1));
  return launch(flash_bwd_dq_f32<DP>, grid, 256, smem, a, s);
}

template <int DP>
int launch_dkv_f32(dim3 grid, const BwdArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(float) *
                      (4 * kBK * (DP + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ);
  return launch(flash_bwd_dkv_f32<DP>, grid, 256, smem, a, s);
}

// The float32 kernels, by padded head dim; dkv picks the dK/dV kernel.
template <bool dkv>
int launch_f32(dim3 grid, const BwdArgs& a, cudaStream_t s) {
  switch (padded_dim(a.D)) {
    case 32: return dkv ? launch_dkv_f32<32>(grid, a, s)
                        : launch_dq_f32<32>(grid, a, s);
    case 64: return dkv ? launch_dkv_f32<64>(grid, a, s)
                        : launch_dq_f32<64>(grid, a, s);
    case 128: return dkv ? launch_dkv_f32<128>(grid, a, s)
                         : launch_dq_f32<128>(grid, a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E, int DP>
int launch_wgmma(bool dkv, dim3 grid, const TmaArgs& a, cudaStream_t s) {
  return dkv ? launch(flash_bwd_dkv_wgmma<E, DP>, grid, kConsumers,
                      Layout<DP>::kDynamic, a, s)
             : launch(flash_bwd_dq_wgmma<E, DP>, grid, sm90::kThreads,
                      Layout<DP>::kDynamic, a, s);
}

template <typename E>
int launch_16bit(bool dkv, int dp, dim3 grid, const TmaArgs& a,
                 cudaStream_t s) {
  return dp <= 64 ? launch_wgmma<E, 64>(dkv, grid, a, s)
                  : launch_wgmma<E, 128>(dkv, grid, a, s);
}

// The arguments both entry points share; strides = 3 (b, h, t) element
// strides of each of q, k, v, dout, then the outputs; tma the geometry of
// q, k, v and dout (16-bit only).
int run(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* d0,
        void* d1, const long long* strides, const long long* tma, int* sched,
        int B, int H, int Hkv, int T, int D, int dtype, int causal, int vec,
        float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || T <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides s0 = {strides[12], strides[13], strides[14]};
  const Strides s1 = dkv ? Strides{strides[15], strides[16], strides[17]}
                         : Strides{0, 0, 0};
  if (dtype == DT_F32) {
    const long long nblk = (T + kBQ - 1) / kBQ;  // kBQ == kBK
    if (nblk > 65535) return static_cast<int>(cudaErrorInvalidValue);
    BwdArgs a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.dout = dout;
    a.lse = lse;
    a.delta = delta;
    a.d0 = d0;
    a.d1 = d1;
    Strides* ss[4] = {&a.sq, &a.sk, &a.sv, &a.sdo};
    for (int i = 0; i < 4; ++i)
      *ss[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    a.s0 = s0;
    a.s1 = s1;
    a.H = H;
    a.Hkv = Hkv;
    a.T = T;
    a.D = D;
    a.causal = causal;
    a.vec = vec && D == padded_dim(D);  // the vector path reads whole rows
    a.scale = scale;
    const dim3 grid((unsigned)(B * H), (unsigned)nblk);
    return dkv ? launch_f32<true>(grid, a, s) : launch_f32<false>(grid, a, s);
  }
  if ((dtype != DT_BF16 && dtype != DT_F16) || !tma || !sched)
    return static_cast<int>(cudaErrorInvalidValue);
  TmaArgs a;
  a.sched = sched;
  // an item's tensors load in 128-row boxes, the streamed ones in 64-row
  // boxes: dK/dV streams Q and dO, dQ streams K and V
  CUtensorMap* maps[4] = {&a.q, &a.k, &a.v, &a.dout};
  const void* ptrs[4] = {q, k, v, dout};
  int dp = 64;
  for (int i = 0; i < 4; ++i) {
    const long long* g = tma + 9 * i;
    if (!sm90::standard_box(g) || g[0] < D || g[0] > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    const bool streamed = dkv ? (i == 0 || i == 3) : (i == 1 || i == 2);
    const int e = sm90::encode(maps[i], ptrs[i], g, dtype,
                               streamed ? kTileRows : kItemRows);
    if (e) return e;
    if (g[0] > 64) dp = 128;
  }
  a.lse = lse;
  a.delta = delta;
  a.d0 = d0;
  a.d1 = d1;
  a.s0 = s0;
  a.s1 = s1;
  a.H = H;
  a.Hkv = Hkv;
  a.T = T;
  a.D = D;
  a.causal = causal;
  a.pairs = reinterpret_cast<uintptr_t>(d0) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(d1) % 4 == 0 && D % 2 == 0 &&
            s0.b % 2 == 0 && s0.h % 2 == 0 && s0.t % 2 == 0 &&
            s1.b % 2 == 0 && s1.h % 2 == 0 && s1.t % 2 == 0;
  a.scale = scale;
  a.scale2 = scale * sm90::kLog2e;
  const long long n = (T + kItemRows - 1) / kItemRows;
  const long long items = (long long)B * H * n;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.n = static_cast<int>(n);
  a.items = static_cast<int>(items);
  const dim3 grid(sm90::persistent_grid(items));
  return dtype == DT_BF16 ? launch_16bit<__nv_bfloat16>(dkv, dp, grid, a, s)
                          : launch_16bit<__half>(dkv, dp, grid, a, s);
}

}  // namespace

// dQ (B, H, T, D) from q (B, H, T, D), k and v (B, Hkv, T, D), dout like
// q, lse and delta (B, H, T) float32 contiguous; strides = 15 element
// strides (b, h, t) of q, k, v, dout, dq.  float32: every operand's head
// dim contiguous, tma and sched null, T < 64 * 65536.  bfloat16 / float16:
// tma = the geometry of q, k, v and dout (9 values each,
// ops/cuda/attention.py::_tma_geometry), whose maps may hold a head dim
// padded with zeros past D, and sched two int32 work counters, zero,
// which the launch leaves zero (one pair per stream).  D <= 128.  Returns
// 0 or a cudaError_t (after the launch, cudaGetLastError()).
extern "C" int accl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq,
                                 const long long* strides,
                                 const long long* tma, int* sched, int B,
                                 int H, int Hkv, int T, int D, int dtype,
                                 int causal, int vec, float scale,
                                 void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, nullptr, strides, tma,
             sched, B, H, Hkv, T, D, dtype, causal, vec, scale, stream);
}

// dK and dV PER Q HEAD, each (B, H, T, D) (the caller sums each group of
// H / Hkv heads); strides = 18: q, k, v, dout, dk, dv.  Otherwise as
// accl_flash_bwd_dq.
extern "C" int accl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  const long long* strides,
                                  const long long* tma, int* sched, int B,
                                  int H, int Hkv, int T, int D, int dtype,
                                  int causal, int vec, float scale,
                                  void* stream) {
  return run(true, q, k, v, dout, lse, delta, dk, dv, strides, tma, sched, B,
             H, Hkv, T, D, dtype, causal, vec, scale, stream);
}

// delta (B, H, T) float32 contiguous = rowsum(dout * o) from dout and o
// (B, H, T, D) of one dtype (float32, bfloat16 or float16), each with its
// head dim contiguous; strides = 6 element strides (b, h, t) of dout and
// o; vec: D % 4 == 0 and both operands' bases and strides on 4 elements.
extern "C" int accl_flash_bwd_delta(const void* dout, const void* o,
                                    float* delta, const long long* strides,
                                    int B, int H, int T, int D, int dtype,
                                    int vec, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DeltaArgs a;
  a.dout = dout;
  a.o = o;
  a.delta = delta;
  a.sd = {strides[0], strides[1], strides[2]};
  a.so = {strides[3], strides[4], strides[5]};
  a.rows = (long long)B * H * T;
  a.H = H;
  a.T = T;
  a.D = D;
  a.vec = vec;
  const long long blocks = (a.rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (dtype) {
    case DT_F32: return launch(flash_bwd_delta<float>, grid, 256, 0, a, s);
    case DT_BF16:
      return launch(flash_bwd_delta<__nv_bfloat16>, grid, 256, 0, a, s);
    case DT_F16: return launch(flash_bwd_delta<__half>, grid, 256, 0, a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of a block of the 16-bit kernels for head
// dims up to dp (for the build report).
extern "C" int accl_flash_bwd_smem(int dp) {
  return dp <= 64 ? Layout<64>::kDynamic : Layout<128>::kDynamic;
}
