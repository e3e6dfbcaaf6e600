// Rows 17 and 18: the single-device flash-attention backward, dQ and
// dK/dV, causal or full, with grouped-query K/V.
//
// Replaces accl_tpu/ops/pallas/attention.py::_flash_bwd_dq_kernel (:451)
// and _flash_bwd_dkv_kernel (:503) (pallas_calls at :605 and :617 in
// _flash_bwd_impl :562; the custom_vjp of flash_attention :635-653).
// What they compute, exactly as there, from the forward's per-row
// logsumexp lse and delta = rowsum(dO * O) (both (B, H, T) float32,
// computed outside the kernels):
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
// (every output written by one block, no atomics) and the wrapper sums
// each group of H / Hkv heads in float32 afterwards, as the TPU form
// does (_flash_bwd_impl :627-631).
//
// Bound on the H100: at the training shape (8, 32, 1024, 128) bf16
// causal, dQ does 3 and dK/dV 4 products of 2 D operations over the
// T (T + 1) / 2 visible pairs: 103 and 138 GFLOP, 0.104 and 0.139 ms at
// 989 TFLOP/s, just above their byte bounds (0.101 and 0.120 ms).  The
// design is the forward's (attention.cu): 4 warps, mma.sync m16n8k16
// (bf16 or f16 in, f32 accumulate), scores and probabilities in
// registers, accumulators passed as A operands without shared memory,
// ldmatrix(.trans) fragment loads from padded shared rows, cp.async
// double buffering of the tiles the block folds.
//  * dQ: one block owns 64 query rows of one (b, h), warp w rows
//    16w..16w+15, and folds the 64-key K/V tiles of kv head h / G up to
//    the diagonal tile when causal.  Q and dO stay in shared memory and
//    their fragments are reloaded per tile, which keeps the warp's
//    registers to dQ (64 x D f32 across the block) plus s and dp.
//  * dK/dV: one block owns 64 keys of one (b, h), warp w keys
//    16w..16w+15, and folds 32-query tiles from the first one that sees
//    its keys (floor(k0 / 32) when causal).  Everything is computed
//    transposed (s^T = K Q^T, dp^T = V dO^T), so p^T and ds^T are the A
//    operands of dV and dK directly.  Two f32 accumulators of 16 x 128
//    per warp take 128 registers a thread; the 32-query tile keeps s^T
//    and dp^T at 16 registers each (a 64-query tile would double them).
// Not yet used: wgmma, TMA, warp specialisation.
//
// float32 operands never go through the tensor cores (no TF32): separate
// kernels fold with FFMA, 4 threads per query row (dQ) or key row (dK/dV).
#include "flash.cuh"

namespace {

using namespace flash;

constexpr int kBQ2 = 32;  // query rows per tile of the mma dK/dV fold

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

// dQ, bf16/f16.  Block: batch-head blockIdx.x, query block gridDim.y - 1
// - blockIdx.y (the heaviest causal blocks first).
template <typename E, int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma(BwdArgs a) {
  constexpr int SD = DP + 8;  // padded row: ldmatrix rows hit 32 banks
  constexpr int TILE = kBK * SD;
  extern __shared__ __align__(16) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem);
  E* dOs = Qs + TILE;
  E* buf = dOs + TILE;  // [2][K tile, V tile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row, matrix
  const int iq = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int T = a.T, D = a.D, q0 = iq * kBQ;
  const E* qb = static_cast<const E*>(a.q) + b * a.sq.b + h * a.sq.h;
  const E* dob = static_cast<const E*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const E* kb = static_cast<const E*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const E* vb = static_cast<const E*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int nkt = (T + kBK - 1) / kBK;
  const int ntiles = a.causal ? min(iq + 1, nkt) : nkt;

  tile_async<E, DP, SD>(buf, kb, a.sk.t, 0, T, D, a.vec);
  tile_async<E, DP, SD>(buf + TILE, vb, a.sv.t, 0, T, D, a.vec);
  cp_async_commit();
  load_tile<E, DP, SD, 128>(Qs, qb, a.sq.t, q0, T, D, a.vec);
  load_tile<E, DP, SD, 128>(dOs, dob, a.sdo.t, q0, T, D, a.vec);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (long long)bh * T + row[r];
    lse[r] = row[r] < T ? a.lse[i] : 0.f;
    dl[r] = row[r] < T ? a.delta[i] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    if (j + 1 < ntiles) {
      E* nxt = buf + ((j + 1) & 1) * 2 * TILE;
      tile_async<E, DP, SD>(nxt, kb, a.sk.t, k0 + kBK, T, D, a.vec);
      tile_async<E, DP, SD>(nxt + TILE, vb, a.sv.t, k0 + kBK, T, D, a.vec);
      cp_async_commit();
      cp_async_wait<1>();  // tile j has landed, tile j + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* Ks = buf + (j & 1) * 2 * TILE;
    const E* Vs = Ks + TILE;

    // s = Q K^T and dp = dO V^T over this warp's 16 rows x 64 keys
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qa[4], da[4];
      const int ra = (warp * 16 + lr + (lm & 1) * 8) * SD + kk * 16 +
                     (lm >> 1) * 8;
      ldsm4(qa, Qs + ra);
      ldsm4(da, dOs + ra);
#pragma unroll
      for (int n = 0; n < kBK / 8; n += 2) {  // key tiles n and n + 1
        const int rb = (n * 8 + lr + (lm >> 1) * 8) * SD + kk * 16 +
                       (lm & 1) * 8;
        uint32_t f[4];
        ldsm4(f, Ks + rb);
        mma<E>(s[n], qa, f[0], f[1]);
        mma<E>(s[n + 1], qa, f[2], f[3]);
        ldsm4(f, Vs + rb);
        mma<E>(dp[n], da, f[0], f[1]);
        mma<E>(dp[n + 1], da, f[2], f[3]);
      }
    }
    // ds = p (dp - delta) scale, in place of s
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + n * 8 + 2 * t + (e & 1);
        const float p = visible(row[r], key, T, a.causal)
                            ? expf(s[n][e] * a.scale - lse[r])
                            : 0.f;
        s[n][e] = p * (dp[n][e] - dl[r]) * a.scale;
      }
    }
    // dQ += ds K: ds rounded to K's dtype is the A fragment of keys
    // 16c..16c+15; K read with .trans as the B operand
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      const uint32_t pa[4] = {
          pack<E>(s[2 * c][0], s[2 * c][1]),
          pack<E>(s[2 * c][2], s[2 * c][3]),
          pack<E>(s[2 * c + 1][0], s[2 * c + 1][1]),
          pack<E>(s[2 * c + 1][2], s[2 * c + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {  // head-dim tiles n and n + 1
        uint32_t kf[4];
        ldsm4_t(kf, Ks + (c * 16 + lr + (lm & 1) * 8) * SD + n * 8 +
                        (lm >> 1) * 8);
        mma<E>(acc[n], pa, kf[0], kf[1]);
        mma<E>(acc[n + 1], pa, kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  E* ob = static_cast<E*>(a.d0) + b * a.s0.b + h * a.s0.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    E* orow = ob + row[r] * a.s0.t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D) orow[c] = accl::from_float<E>(acc[n][2 * r]);
      if (c + 1 < D) orow[c + 1] = accl::from_float<E>(acc[n][2 * r + 1]);
    }
  }
}

// dK and dV of one q head, bf16/f16.  Block: batch-head blockIdx.x (q
// head h), key block blockIdx.y (the heaviest causal blocks first).
template <typename E, int DP>
__global__ void __launch_bounds__(128) flash_bwd_dkv_mma(BwdArgs a) {
  constexpr int SD = DP + 8;
  constexpr int KT = kBK * SD;   // a K or V tile
  constexpr int QT = kBQ2 * SD;  // a Q or dO tile
  extern __shared__ __align__(16) unsigned char smem[];
  E* Ks = reinterpret_cast<E*>(smem);
  E* Vs = Ks + KT;
  E* buf = Vs + KT;  // [2][Q tile, dO tile]
  float* stats = reinterpret_cast<float*>(buf + 4 * QT);  // [2][lse, delta]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int jk = blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int T = a.T, D = a.D, k0 = jk * kBK;
  const E* qb = static_cast<const E*>(a.q) + b * a.sq.b + h * a.sq.h;
  const E* dob = static_cast<const E*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const E* kb = static_cast<const E*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const E* vb = static_cast<const E*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const float* lseb = a.lse + (long long)bh * T;
  const float* dlb = a.delta + (long long)bh * T;
  const int nqt = (T + kBQ2 - 1) / kBQ2;
  const int i0 = a.causal ? k0 / kBQ2 : 0;  // k0 < T, so i0 < nqt

  // query tile i (rows i * 32 ..) with its lse and delta into buffer s
  auto stage = [&](int i, int s) {
    E* qs = buf + s * 2 * QT;
    tile_async<E, DP, SD, kBQ2>(qs, qb, a.sq.t, i * kBQ2, T, D, a.vec);
    tile_async<E, DP, SD, kBQ2>(qs + QT, dob, a.sdo.t, i * kBQ2, T, D,
                                a.vec);
    if (threadIdx.x < 2 * kBQ2) {
      const int r = threadIdx.x & (kBQ2 - 1), q = i * kBQ2 + r;
      const float* src = threadIdx.x < kBQ2 ? lseb : dlb;
      stats[s * 2 * kBQ2 + threadIdx.x] = q < T ? src[q] : 0.f;
    }
  };
  tile_async<E, DP, SD>(Ks, kb, a.sk.t, k0, T, D, a.vec);
  tile_async<E, DP, SD>(Vs, vb, a.sv.t, k0, T, D, a.vec);
  stage(i0, 0);
  cp_async_commit();

  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = i0; i < nqt; ++i) {
    const int j = i - i0, q0 = i * kBQ2;
    if (i + 1 < nqt) {
      stage(i + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* Qs = buf + (j & 1) * 2 * QT;
    const E* dOs = Qs + QT;
    const float* lse = stats + (j & 1) * 2 * kBQ2;
    const float* dl = lse + kBQ2;

    // s^T = K Q^T and dp^T = V dO^T over this warp's 16 keys x 32 queries
    float s[kBQ2 / 8][4], dp[kBQ2 / 8][4];
#pragma unroll
    for (int n = 0; n < kBQ2 / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int ra = (warp * 16 + lr + (lm & 1) * 8) * SD + kk * 16 +
                     (lm >> 1) * 8;
      ldsm4(ka, Ks + ra);
      ldsm4(va, Vs + ra);
#pragma unroll
      for (int n = 0; n < kBQ2 / 8; n += 2) {  // query tiles n and n + 1
        const int rb = (n * 8 + lr + (lm >> 1) * 8) * SD + kk * 16 +
                       (lm & 1) * 8;
        uint32_t f[4];
        ldsm4(f, Qs + rb);
        mma<E>(s[n], ka, f[0], f[1]);
        mma<E>(s[n + 1], ka, f[2], f[3]);
        ldsm4(f, dOs + rb);
        mma<E>(dp[n], va, f[0], f[1]);
        mma<E>(dp[n + 1], va, f[2], f[3]);
      }
    }
    // p^T in place of s^T, ds^T in place of dp^T
#pragma unroll
    for (int n = 0; n < kBQ2 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qi = n * 8 + 2 * t + (e & 1);
        const float p = visible(q0 + qi, key[r], T, a.causal)
                            ? expf(s[n][e] * a.scale - lse[qi])
                            : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dl[qi]) * a.scale;
      }
    }
    // dV += p^T dO and dK += ds^T Q: the rounded accumulators of query
    // tiles 2c and 2c + 1 are the A fragments of queries 16c..16c+15
#pragma unroll
    for (int c = 0; c < kBQ2 / 16; ++c) {
      const uint32_t pa[4] = {
          pack<E>(s[2 * c][0], s[2 * c][1]),
          pack<E>(s[2 * c][2], s[2 * c][3]),
          pack<E>(s[2 * c + 1][0], s[2 * c + 1][1]),
          pack<E>(s[2 * c + 1][2], s[2 * c + 1][3]),
      };
      const uint32_t sa[4] = {
          pack<E>(dp[2 * c][0], dp[2 * c][1]),
          pack<E>(dp[2 * c][2], dp[2 * c][3]),
          pack<E>(dp[2 * c + 1][0], dp[2 * c + 1][1]),
          pack<E>(dp[2 * c + 1][2], dp[2 * c + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {  // head-dim tiles n and n + 1
        const int rb = (c * 16 + lr + (lm & 1) * 8) * SD + n * 8 +
                       (lm >> 1) * 8;
        uint32_t f[4];
        ldsm4_t(f, dOs + rb);
        mma<E>(dv[n], pa, f[0], f[1]);
        mma<E>(dv[n + 1], pa, f[2], f[3]);
        ldsm4_t(f, Qs + rb);
        mma<E>(dk[n], sa, f[0], f[1]);
        mma<E>(dk[n + 1], sa, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  E* kout = static_cast<E*>(a.d0) + b * a.s0.b + h * a.s0.h;
  E* vout = static_cast<E*>(a.d1) + b * a.s1.b + h * a.s1.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= T) continue;
    E* krow = kout + key[r] * a.s0.t;
    E* vrow = vout + key[r] * a.s1.t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int c = n * 8 + 2 * t + x;
        if (c < D) {
          krow[c] = accl::from_float<E>(dk[n][2 * r + x]);
          vrow[c] = accl::from_float<E>(dv[n][2 * r + x]);
        }
      }
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

template <typename E, int DP>
int launch_dq_mma(dim3 grid, const BwdArgs& a, cudaStream_t s) {
  return launch(flash_bwd_dq_mma<E, DP>, grid, 128,
                6 * kBK * (DP + 8) * sizeof(E), a, s);
}

template <typename E, int DP>
int launch_dkv_mma(dim3 grid, const BwdArgs& a, cudaStream_t s) {
  const size_t smem = (2 * kBK + 4 * kBQ2) * (DP + 8) * sizeof(E) +
                      4 * kBQ2 * sizeof(float);
  return launch(flash_bwd_dkv_mma<E, DP>, grid, 128, smem, a, s);
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

// Dispatch on dtype and padded head dim; dkv picks the dK/dV kernels.
template <bool dkv>
int launch_bwd(int dtype, dim3 grid, const BwdArgs& a, cudaStream_t s) {
#define ACCL_BWD_DP(DP)                                                  \
  case DP:                                                               \
    switch (dtype) {                                                     \
      case DT_BF16:                                                      \
        return dkv ? launch_dkv_mma<__nv_bfloat16, DP>(grid, a, s)       \
                   : launch_dq_mma<__nv_bfloat16, DP>(grid, a, s);       \
      case DT_F16:                                                       \
        return dkv ? launch_dkv_mma<__half, DP>(grid, a, s)              \
                   : launch_dq_mma<__half, DP>(grid, a, s);              \
      case DT_F32:                                                       \
        return dkv ? launch_dkv_f32<DP>(grid, a, s)                      \
                   : launch_dq_f32<DP>(grid, a, s);                      \
    }                                                                    \
    break;
  switch (padded_dim(a.D)) {
    ACCL_BWD_DP(32)
    ACCL_BWD_DP(64)
    ACCL_BWD_DP(128)
  }
#undef ACCL_BWD_DP
  return static_cast<int>(cudaErrorInvalidValue);
}

// The arguments both entry points share; strides = 3 (b, h, t) element
// strides of each of q, k, v, dout, then the outputs.
int run(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* d0,
        void* d1, const long long* strides, int B, int H, int Hkv, int T,
        int D, int dtype, int causal, int vec, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || T <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
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
  Strides* ss[6] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.s0, &a.s1};
  for (int i = 0; i < (dkv ? 6 : 5); ++i)
    *ss[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (!dkv) a.s1 = {0, 0, 0};
  a.H = H;
  a.Hkv = Hkv;
  a.T = T;
  a.D = D;
  a.causal = causal;
  a.vec = vec && D == padded_dim(D);  // the vector path reads whole rows
  a.scale = scale;
  const dim3 grid((unsigned)(B * H), (unsigned)nblk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dkv ? launch_bwd<true>(dtype, grid, a, s)
             : launch_bwd<false>(dtype, grid, a, s);
}

}  // namespace

// dQ (B, H, T, D) from q (B, H, T, D), k and v (B, Hkv, T, D), dout like
// q, lse and delta (B, H, T) float32 contiguous; every tensor's head dim
// contiguous; strides = 15 element strides (b, h, t) of q, k, v, dout,
// dq.  D <= 128; T < 64 * 65536.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int accl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq,
                                 const long long* strides, int B, int H,
                                 int Hkv, int T, int D, int dtype, int causal,
                                 int vec, float scale, void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, nullptr, strides, B, H,
             Hkv, T, D, dtype, causal, vec, scale, stream);
}

// dK and dV PER Q HEAD, each (B, H, T, D) (the caller sums each group of
// H / Hkv heads); strides = 18: q, k, v, dout, dk, dv.  Otherwise as
// accl_flash_bwd_dq.
extern "C" int accl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  const long long* strides, int B, int H,
                                  int Hkv, int T, int D, int dtype,
                                  int causal, int vec, float scale,
                                  void* stream) {
  return run(true, q, k, v, dout, lse, delta, dk, dv, strides, B, H, Hkv, T,
             D, dtype, causal, vec, scale, stream);
}
