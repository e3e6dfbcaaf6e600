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
// 0.040 ms for 8 x 16 heads).  The design keeps every score and
// probability in registers: one block of 4 warps owns 64 query rows, each
// warp 16 of them; Q K^T and P V go through mma.sync m16n8k16 (bf16 or
// f16 in, f32 accumulate), the probabilities pass from the score
// accumulators to the A operand without touching shared memory, and K/V
// tiles of 64 keys are double-buffered in padded shared memory (cp.async
// copies of the next tile overlap the fold of this one; ldmatrix
// fragment loads without bank conflicts).  Causal blocks stop at the
// diagonal tile and the heaviest query blocks are scheduled first.  Not
// yet used: wgmma, TMA, warp specialisation.
//
// float32 operands never go through the tensor cores (no TF32): a
// separate kernel folds with FFMA, 4 threads per query row.
#include "flash.cuh"

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

// Per block: batch-head blockIdx.x, query block (gridDim.y - 1 -
// blockIdx.y).  Warp w owns rows 16w..16w+15 of the block; in the mma
// fragments lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 and
// columns 2t, 2t + 1 of each 8-wide tile.  K/V tiles are double-buffered:
// the copy of tile j + 1 runs while tile j is folded.
template <typename E, int DP>
__global__ void __launch_bounds__(128) flash_fwd_mma(Args a) {
  constexpr int SD = DP + 8;  // padded row: ldmatrix rows hit 32 banks
  constexpr int TILE = kBK * SD;
  extern __shared__ __align__(16) unsigned char smem[];
  E* buf = reinterpret_cast<E*>(smem);  // [2][K tile, V tile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row, matrix
  const int iq = gridDim.y - 1 - blockIdx.y;  // heaviest causal blocks first
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int T = a.T, D = a.D, q0 = iq * kBQ;
  const E* qb = static_cast<const E*>(a.q) + b * a.sq.b + h * a.sq.h;
  const E* kb = static_cast<const E*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const E* vb = static_cast<const E*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int nkt = (T + kBK - 1) / kBK;
  const int ntiles = a.causal ? min(iq + 1, nkt) : nkt;

  // tile 0 into buffer 0 while Q stages through buffer 1's K tile into A
  // fragments kept for the whole fold
  tile_async<E, DP, SD>(buf, kb, a.sk.t, 0, T, D, a.vec);
  tile_async<E, DP, SD>(buf + TILE, vb, a.sv.t, 0, T, D, a.vec);
  cp_async_commit();
  load_tile<E, DP, SD, 128>(buf + 2 * TILE, qb, a.sq.t, q0, T, D, a.vec);
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

    // scale, mask (only the diagonal tile and the ragged last tile)
    const bool edge = (a.causal && j == iq) || k0 + kBK > T;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          if (key >= T || (a.causal && row[e >> 1] < key)) x = kNeg;
        }
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
  }

  // epilogue: rows past T are never written
  E* ob = static_cast<E*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    const float den = fmaxf(l[r], 1e-30f);
    E* orow = ob + row[r] * a.so.t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D) orow[c] = accl::from_float<E>(acc[n][2 * r] / den);
      if (c + 1 < D) orow[c + 1] = accl::from_float<E>(acc[n][2 * r + 1] / den);
    }
    if (a.lse && t == 0) a.lse[(long long)bh * T + row[r]] = m[r] + logf(den);
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

template <typename E, int DP>
int launch_mma(dim3 grid, const Args& a, cudaStream_t s) {
  return launch(flash_fwd_mma<E, DP>, grid, 128,
                4 * kBK * (DP + 8) * sizeof(E), a, s);
}

template <int DP>
int launch_f32(dim3 grid, const Args& a, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBK) * (DP + 1) + kBK * DP + kBQ * (kBK + 1));
  return launch(flash_fwd_f32<DP>, grid, 256, smem, a, s);
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

// q (B, H, T, D), k and v (B, Hkv, T, D), o like q, each with its head
// dim contiguous; strides = 12 element strides (b, h, t) of q, k, v, o.
// lse: (B, H, T) float32 or null.  D <= 128; T < 64 * 65536.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int accl_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    const long long* strides, int B, int H,
                                    int Hkv, int T, int D, int dtype,
                                    int causal, int vec, float scale,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || T <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
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
