// Row 16: single-device flash-attention forward, causal or full, with
// grouped-query K/V and an optional per-row logsumexp.
//
// Replaces accl_tpu/ops/pallas/attention.py::_flash_kernel (:293;
// pallas_call at :431 in _flash_fwd_impl :396; entry flash_attention
// :656).  What it computes, exactly as there: scores in float32 scaled by
// 1/sqrt(D) of the logical head dim; masked scores (keys at or past T,
// and, when causal, keys after the query) set to -1e30; the online-softmax
// state (m, l, acc) in float32; probabilities rounded to the operand dtype
// before P @ V; out = acc / max(l, 1e-30) in the operand dtype and
// lse = m + log(max(l, 1e-30)).  q head h reads kv head h / (H / Hkv);
// K/V are never expanded.
//
// Bound on the H100: at the serving shapes (T 128 and 1024, D 128) the
// causal product is 2 T^2 D operations per head against 8 T D bytes, so
// at T = 1024 operations and bytes bound it about equally (0.035 ms and
// 0.040 ms for 8 x 16 heads); the training shape's 68.8 GFLOP take 0.070
// ms at 989 TFLOP/s against 0.080 ms for its bytes.  What held the first
// port (mma.sync m16n8k16 tiles of 64 x 64 issued by the warps that also
// copied with cp.async, 122 TFLOP/s) back, and what the design does:
//  * only wgmma reaches the tensor cores' rate: Q K^T and P V are wgmma
//    m64n128k16 on 128-key tiles (the shared fold core, flash_sm90.cuh),
//    P passing from the score accumulators to the A operand in registers;
//  * copies compete with the products: one producer warp keeps the K/V
//    stage ring full with TMA (the operand's own 4-D strides, so the
//    transformer's transposed head views need no copy), and the consumer
//    warpgroups only fold;
//  * short sequences pay a block's start-up per query tile: the kernel is
//    persistent (one block per SM), a block's next tile loads while it
//    stores this one, and its work items, head by head, keep each head's
//    K/V in L2 (ordered across heads, every item reread its K/V from HBM);
//  * the softmax competes with the products for issue slots: scale and
//    log2(e) fold into one FFMA before one EX2 per score.
// Causal items stop at the diagonal tile, whose mask (and the ragged last
// tile's) is the only one applied; the heaviest items of each head come
// first and blocks draw items from a shared counter, so the light ones
// fill in at the end.
//
// float32 operands never go through the tensor cores (no TF32): a
// separate kernel folds with FFMA, 4 threads per query row.
#include "flash.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, T) contiguous, or null
  Strides sq, sk, sv, so;
  int H, Hkv, T, D, causal, vec;
  float scale;
};

// The 16-bit kernel's arguments: the three operands' tensor maps (by
// value: a __grid_constant__ parameter), the output's element strides.
struct TmaArgs {
  CUtensorMap q, k, v;
  void* o;
  float* lse;  // (B, H, T) contiguous, or null
  Strides so;
  int* sched;  // the work counters (sm90::next_item), zero at launch
  int H, Hkv, T, D, causal, pairs, nq, items;
  float scale2;  // scale * log2(e)
};

// Persistent: one block per SM draws work items (sm90::next_item) from
// the B H nq (batch-head, 128-row query tile) items, item w the batch-head
// w / nq and its query tile nq - 1 - w % nq: the blocks in flight at once
// share a few heads' K/V, which stay in L2 (ordered by query tile across
// all heads, every item reread its K/V from HBM), and each head's heaviest
// causal tiles come first.  Warpgroup 0 loads each item's Q and its K/V
// tiles (kv head h / (H / Hkv)) ahead into the Q and stage rings, across
// items; warpgroups 1 and 2 fold rows 0-63 and 64-127 of the item's tile,
// and store it while the next item's tiles load.  A causal item stops at
// its diagonal tile; the mask is applied only there and on the ragged last
// tile.
template <typename E, int DP>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ TmaArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const sm90::Smem<DP> sm(smem);
  sm.init();
  const int T = a.T;
  const int nkt = (T + sm90::kBN - 1) / sm90::kBN;

  if (threadIdx.x < 128) {  // the producer
    sm90::regs_down<sm90::kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::Ring qr, kv;
      for (int w; (w = sm90::next_item(a.sched, a.items)) >= 0;) {
        const int bh = w / a.nq, iq = a.nq - 1 - w % a.nq;
        const int b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
        const int ntiles = a.causal ? min(iq + 1, nkt) : nkt;
        sm.load_q(qr, &a.q, w, iq * sm90::kBM, h, b);
        for (int j = 0; j < ntiles; ++j)
          sm.load_kv(kv, &a.k, &a.v, j * sm90::kBN, kvh, b, nullptr);
      }
      sm.end_items(qr);
    }
  } else {  // the consumers
    sm90::regs_up<sm90::kConsumerRegs>();
    // the consumer warpgroup, warp-uniform (shuffled from lane 0) so that
    // its shared addresses and wgmma descriptors live in uniform registers
    const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int tid = threadIdx.x % 128;
    const int causal = a.causal;
    sm90::Ring qr, kv;
    for (int w; (w = sm.wait_item(qr)) >= 0; qr.next<2>()) {
      const int bh = w / a.nq, iq = a.nq - 1 - w % a.nq;
      const int b = bh / a.H, h = bh % a.H;
      const int ntiles = causal ? min(iq + 1, nkt) : nkt;
      sm90::Fold<E, DP> f;
      f.init(iq * sm90::kBM + cw * 64 + (tid / 32) * 16 + (tid % 32) / 4);
      sm90::consume(
          sm, f, kv, qr, cw, a.scale2,
          [=](int j, int, int& k0, bool& edge, int& kind) {
            k0 = j * sm90::kBN;
            edge = (causal && j == iq) || k0 + sm90::kBN > T;
            kind = 0;
            return j == ntiles - 1;
          },
          [=](int, int row, int key) {
            return key >= T || (causal && row < key);
          });
      f.store(static_cast<E*>(a.o) + b * a.so.b + h * a.so.h, a.so.t, T,
              a.D, a.pairs, a.lse ? a.lse + (long long)bh * T : nullptr);
    }
  }
}

// float32: the same fold with FFMA.  Thread (r = tid / 4, u = tid % 4)
// owns query row r of the block, keys u, u + 4, ... of each tile and
// output columns u, u + 4, ...; the 4 threads of a row are neighbouring
// lanes and combine their row max and sum by shuffles.
template <int DP>
__global__ void __launch_bounds__(256) flash_fwd_f32(Args a) {
  constexpr int SQ = DP + 1;   // Q and K rows: conflict-free column walks
  constexpr int SP = kBK + 1;  // probability rows
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * SQ;
  float* Vs = Ks + kBK * SQ;
  float* Ps = Vs + kBK * DP;

  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int iq = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int T = a.T, D = a.D, q0 = iq * kBQ, row = q0 + r;
  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  load_tile<float, DP, SQ, 256>(Qs, qb, a.sq.t, q0, T, D, a.vec);
  float acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;
  const int nkt = (T + kBK - 1) / kBK;
  const int ntiles = a.causal ? min(iq + 1, nkt) : nkt;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();
    load_tile<float, DP, SQ, 256>(Ks, kb, a.sk.t, k0, T, D, a.vec);
    load_tile<float, DP, DP, 256>(Vs, vb, a.sv.t, k0, T, D, a.vec);
    __syncthreads();

    const bool edge = (a.causal && j == iq) || k0 + kBK > T;
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
      if (edge && (k0 + key >= T || (a.causal && row < k0 + key))) x = kNeg;
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
  float* orow = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h +
                row * a.so.t;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    const int d = u + 4 * i;
    if (d < D) orow[d] = acc[i] / den;
  }
  if (a.lse && u == 0) a.lse[(long long)bh * T + row] = m + logf(den);
}

template <int DP>
int launch_f32(dim3 grid, const Args& a, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBK) * (DP + 1) + kBK * DP + kBQ * (kBK + 1));
  return launch(flash_fwd_f32<DP>, grid, 256, smem, a, s);
}

template <typename E, int DP>
int launch_wgmma(dim3 grid, const TmaArgs& a, cudaStream_t s) {
  return launch(flash_fwd_wgmma<E, DP>, grid, sm90::kThreads,
                sm90::Layout<DP>::kDynamic, a, s);
}

template <typename E>
int launch_16bit(int dp, dim3 grid, const TmaArgs& a, cudaStream_t s) {
  return dp <= 64 ? launch_wgmma<E, 64>(grid, a, s)
                  : launch_wgmma<E, 128>(grid, a, s);
}

}  // namespace

// q (B, H, T, D), k and v (B, Hkv, T, D), o like q; strides = 12 element
// strides (b, h, t) of q, k, v, o.  float32: each operand's head dim
// contiguous, tma null.  bfloat16 / float16: tma = the geometry of q, k
// and v (9 values each, ops/cuda/attention.py::_tma_geometry), whose maps
// may hold a head dim padded with zeros past D, and sched two int32 work
// counters, zero, which the launch leaves zero (one pair per stream: two
// launches at once must not share them).  lse: (B, H, T) float32 or null.  D <= 128; float32 T < 64 * 65536, 16-bit T < 128 * 65536.
// Returns 0 or a cudaError_t (after the launch, cudaGetLastError()).
extern "C" int accl_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    const long long* strides,
                                    const long long* tma, int* sched, int B,
                                    int H,
                                    int Hkv, int T, int D, int dtype,
                                    int causal, int vec, float scale,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || T <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    const long long nq = (T + kBQ - 1) / kBQ;
    if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    a.lse = lse;
    Strides* ss[4] = {&a.sq, &a.sk, &a.sv, &a.so};
    for (int i = 0; i < 4; ++i) *ss[i] = {strides[3 * i], strides[3 * i + 1],
                                          strides[3 * i + 2]};
    a.H = H;
    a.Hkv = Hkv;
    a.T = T;
    a.D = D;
    const int dp = padded_dim(D);
    a.causal = causal;
    a.vec = vec && D == dp;  // the vector path reads whole padded rows
    a.scale = scale;
    const dim3 grid((unsigned)(B * H), (unsigned)nq);
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
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  TmaArgs a;
  a.sched = sched;
  CUtensorMap* maps[3] = {&a.q, &a.k, &a.v};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* g = tma + 9 * i;
    if (!sm90::standard_box(g) || g[0] < D || g[0] > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    const int e = sm90::encode(maps[i], ptrs[i], g, dtype);
    if (e) return e;
  }
  a.o = o;
  a.lse = lse;
  a.so = {strides[9], strides[10], strides[11]};
  a.H = H;
  a.Hkv = Hkv;
  a.T = T;
  a.D = D;
  a.causal = causal;
  a.pairs = reinterpret_cast<uintptr_t>(o) % 4 == 0 && D % 2 == 0 &&
            a.so.b % 2 == 0 && a.so.h % 2 == 0 && a.so.t % 2 == 0;
  a.scale2 = scale * sm90::kLog2e;
  a.nq = static_cast<int>(nq);
  const long long items = (long long)B * H * nq;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.items = static_cast<int>(items);
  const int dp = tma[0] > 64 || tma[9] > 64 || tma[18] > 64 ? 128 : 64;
  const dim3 grid(sm90::persistent_grid(items));
  return dtype == DT_BF16 ? launch_16bit<__nv_bfloat16>(dp, grid, a, s)
                          : launch_16bit<__half>(dp, grid, a, s);
}
