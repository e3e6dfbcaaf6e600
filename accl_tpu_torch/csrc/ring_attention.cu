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
// allocation through the pointer table, so no slot and no ack exist.
// The table is what peer pointers across NVLink fill later (ROADMAP B14).
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
// 0.278 ms at 989 TFLOP/s, against 0.080 ms for the bytes.  The design is
// row 16's (csrc/attention.cu): one block of 4 warps per (rank, batch-
// head, 64-row query tile) keeps its (o, m, l) in registers across every
// hop; Q K^T and P V go through mma.sync m16n8k16 (bf16 / f16 in, f32
// accumulate) with the probabilities passed from the score accumulators
// to the A operand in registers; the K/V tiles of the walk over (hop,
// tile) are double-buffered in padded shared memory (cp.async copies the
// next tile, whichever rank it belongs to, while this one folds).  The
// heaviest blocks are scheduled first: the last query tiles of the last
// ranks for contiguous causal shards, the last query tiles for striped.
// Not yet used: wgmma, TMA, warp specialisation.
//
// float32 operands never go through the tensor cores (no TF32, the TPU
// kernel's _mxu_precision rule): a separate kernel folds with FFMA, 4
// threads per query row, as row 16's does.
#include "flash.cuh"

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

// the rank and query tile of this block, heaviest first (blockIdx.y 0)
__device__ __forceinline__ void block_task(const Args& a, int& me, int& iq) {
  const int y = blockIdx.y;
  if (a.causal && !a.striped) {  // rank me folds me full hops + its own
    me = a.P - 1 - y / a.nq;
    iq = a.nq - 1 - y % a.nq;
  } else {  // every rank alike: the query tile decides
    iq = a.nq - 1 - y / a.P;
    me = y % a.P;
  }
}

__device__ __forceinline__ int hop_kind(const Args& a, int me, int origin) {
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

__device__ __forceinline__ void enter_hop(const Args& a, int me, int iq,
                                          int nkt, Walk& w) {
  w.j = 0;
  for (; w.s < a.P; ++w.s) {
    w.origin = accl::ring_mod(me - w.s, a.P);
    w.kind = hop_kind(a, me, w.origin);
    w.ntiles = w.kind == HOP_SKIP ? 0 : w.kind == HOP_FULL ? nkt : iq + 1;
    if (w.ntiles) return;
  }
}

// the step after w; w.s == P past the last tile
__device__ __forceinline__ Walk advance(const Args& a, int me, int iq,
                                        int nkt, Walk w) {
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

template <typename E, int DP>
__global__ void __launch_bounds__(128) ring_attention_mma(Args a) {
  constexpr int SD = DP + 8;  // padded row: ldmatrix rows hit 32 banks
  constexpr int TILE = kBK * SD;
  extern __shared__ __align__(16) unsigned char smem[];
  E* buf = reinterpret_cast<E*>(smem);  // [2][K tile, V tile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row, matrix
  int me, iq;
  block_task(a, me, iq);
  const int T = a.T, D = a.D, q0 = iq * kBQ;
  const long long head = (long long)blockIdx.x * T * D;  // b * H + h
  const int nkt = (T + kBK - 1) / kBK;

  Walk w;
  w.s = 0;
  enter_hop(a, me, iq, nkt, w);  // the own hop: never skipped
  const E* kb = static_cast<const E*>(a.k[w.origin]) + head;
  const E* vb = static_cast<const E*>(a.v[w.origin]) + head;
  tile_async<E, DP, SD>(buf, kb, D, 0, T, D, a.vec);
  tile_async<E, DP, SD>(buf + TILE, vb, D, 0, T, D, a.vec);
  cp_async_commit();
  // Q stages through buffer 1's K tile into A fragments kept for the walk
  const E* qb = static_cast<const E*>(a.q[me]) + head;
  load_tile<E, DP, SD, 128>(buf + 2 * TILE, qb, D, q0, T, D, a.vec);
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldsm4(qf[kk], buf + 2 * TILE + (warp * 16 + lr + (lm & 1) * 8) * SD +
                      kk * 16 + (lm >> 1) * 8);
  __syncthreads();  // Q read by every warp before buffer 1 is refilled

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int it = 0;; ++it) {
    const Walk nx = advance(a, me, iq, nkt, w);
    const bool more = nx.s < a.P;
    if (more) {
      E* nbuf = buf + ((it + 1) & 1) * 2 * TILE;
      const E* nk = static_cast<const E*>(a.k[nx.origin]) + head;
      const E* nv = static_cast<const E*>(a.v[nx.origin]) + head;
      tile_async<E, DP, SD>(nbuf, nk, D, nx.j * kBK, T, D, a.vec);
      tile_async<E, DP, SD>(nbuf + TILE, nv, D, nx.j * kBK, T, D, a.vec);
      cp_async_commit();
      cp_async_wait<1>();  // this tile has landed, the next may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* Ks = buf + (it & 1) * 2 * TILE;
    const E* Vs = Ks + TILE;
    const int k0 = w.j * kBK;

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBK / 8; n += 2) {  // key tiles n and n + 1
        uint32_t kf[4];
        ldsm4(kf, Ks + (n * 8 + lr + (lm >> 1) * 8) * SD + kk * 16 +
                      (lm & 1) * 8);
        mma<E>(s[n], qf[kk], kf[0], kf[1]);
        mma<E>(s[n + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, mask (only the diagonal tile of a causal hop and the ragged
    // last tile)
    const bool edge = (w.kind >= HOP_TRI && w.j == iq) || k0 + kBK > T;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale;
        if (edge && masked(w.kind, row[e >> 1], k0 + n * 8 + 2 * t + (e & 1),
                           T))
          x = kNeg;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: the score accumulators of key tiles 2c and 2c + 1 are
    // the A fragment of keys 16c..16c+15 (rounded to the operand dtype)
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
        uint32_t vf[4];
        ldsm4_t(vf, Vs + (c * 16 + lr + (lm & 1) * 8) * SD + n * 8 +
                        (lm >> 1) * 8);
        mma<E>(acc[n], pa, vf[0], vf[1]);
        mma<E>(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if (!more) break;
    w = nx;
  }

  // epilogue: rows past T are never written
  E* ob = static_cast<E*>(a.o[me]) + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    const float den = fmaxf(l[r], 1e-30f);
    E* orow = ob + (long long)row[r] * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D) orow[c] = accl::from_float<E>(acc[n][2 * r] / den);
      if (c + 1 < D) orow[c + 1] = accl::from_float<E>(acc[n][2 * r + 1] / den);
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
  block_task(a, me, iq);
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

template <typename E, int DP>
int launch_mma(dim3 grid, const Args& a, cudaStream_t s) {
  return launch(ring_attention_mma<E, DP>, grid, 128,
                4 * kBK * (DP + 8) * sizeof(E), a, s);
}

template <int DP>
int launch_f32(dim3 grid, const Args& a, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBK) * (DP + 1) + kBK * DP + kBQ * (kBK + 1));
  return launch(ring_attention_f32<DP>, grid, 256, smem, a, s);
}

template <typename E>
int launch_dtype(int dp, dim3 grid, const Args& a, cudaStream_t s) {
  switch (dp) {
    case 32: return launch_mma<E, 32>(grid, a, s);
    case 64: return launch_mma<E, 64>(grid, a, s);
    case 128: return launch_mma<E, 128>(grid, a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q[r], k[r], v[r], o[r]: rank r's (B, H, T, D) tensors, contiguous, all
// ranks one shape and dtype.  D <= 128; P * ceil(T / 64) <= 65535.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int accl_ring_attention(const void* const* q, const void* const* k,
                                   const void* const* v, void* const* o,
                                   int P, int B, int H, int T, int D,
                                   int dtype, int causal, int striped,
                                   int vec, float scale, void* stream) {
  if (P < 1 || P > accl::kMaxRanks || B <= 0 || H <= 0 || T <= 0 || D <= 0 ||
      D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nq = (T + kBQ - 1) / kBQ;
  if (nq * P > 65535 || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_BF16: return launch_dtype<__nv_bfloat16>(dp, grid, a, s);
    case DT_F16: return launch_dtype<__half>(dp, grid, a, s);
    case DT_F32:
      switch (dp) {
        case 32: return launch_f32<32>(grid, a, s);
        case 64: return launch_f32<64>(grid, a, s);
        case 128: return launch_f32<128>(grid, a, s);
      }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
