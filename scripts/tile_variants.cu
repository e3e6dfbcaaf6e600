// Access-pattern variants of the streaming tile core's byte-bound
// kernels (K3's root-only gather and all-rank allgather, K4's float32
// combine, row 11's scatter, row 13's float32 put with + c), of row 14's
// sequencer and of row 7's int8 quantize, timed beside the port's kernels
// by scripts/tile_variants.py.  None of them is on a path of the port:
// they record what the port's designs were chosen over.
//
//  * parent: the port's first design, one 16-byte access a thread an
//    iteration in a grid-stride loop over at most 132 x 8 blocks;
//  * tile<U>: one tile a warp of U 512-byte chunks (lane l at bytes
//    [16 l, 16 l + 16) of each), every load of the tile before any store;
//    U = 4 is the port's (64 bytes of a stream in flight a lane);
//  * bulk<STAGES>: the gather as Hopper's 1-D bulk copy (cp.async.bulk):
//    one elected thread a block moves `chunk`-byte pieces global ->
//    shared memory (completing on an mbarrier) -> global, STAGES pieces
//    in flight, a persistent grid of blocks_per_sm blocks on each SM;
//  * combine_blockstride<U>: PyTorch's elementwise shape, U 16-byte
//    accesses a thread spaced one block apart, one block per U x threads
//    vectors;
//  * seq_parent: row 14's first design on a window of float32 slots
//    (allreduce, or any op through the same fold): one column a thread in
//    a grid-stride loop, every access a null-checked 4-byte one, the
//    slots one after another in every thread, a cooperative grid capped
//    at the co-resident blocks and a memset of its barrier word a window;
//    tv_sequencer runs the port's sequencer (csrc/cmdring.cu, included
//    below) at other tile shapes (U chunks at P <= 4);
//  * quantize_parent: row 7's first design: one warp a segment up to 8192
//    elements (a grid of at most 132 x 16 blocks), one block of 256
//    threads above (at most 132 x 8), each reading its segment twice;
//    tv_quantize_cluster holds the segment of row 7's cluster path in
//    registers instead of the port's shared memory (a persistent
//    cluster, the next segment loaded into a second register set first,
//    or one cluster a segment), at several cluster sizes and elements a
//    thread, and tv_quantize_persistent runs the port's shared-memory
//    holding with persistent clusters of two stages.
#include <cooperative_groups.h>

#include <cstddef>
#include <cstring>
#include <type_traits>

#include "../accl_tpu_torch/csrc/common.cuh"
#include "../accl_tpu_torch/csrc/wire.cuh"

// the port's kernels, to launch them at shapes it does not instantiate
// (without the port's entry points, which would build every instance)
#define ACCL_KERNELS_ONLY
namespace port_seq {
#include "../accl_tpu_torch/csrc/cmdring.cu"
}  // namespace port_seq
namespace port_comp {
#include "../accl_tpu_torch/csrc/compression.cu"
namespace {
constexpr int kRegThreads = 512;

// The register holding of row 7's cluster path, as the port first had it:
// each cluster of CS CTAs (the launch's cluster dimension)
// walks segments c, c + clusters, ...; CTA r of it, thread x of T, word
// j holds elements r T EPT + j T V + x V .. + V of the segment it holds
// (each word of the CTA warp-contiguous), in one of two register sets:
// the next segment's loads are issued into the other before this one is
// reduced.  Per segment each CTA reduces its part (shuffles, then its
// warps' maxima in shared memory), the cluster combines the CS parts
// through distributed shared memory, and every thread quantizes its
// registers.  part[] alternates between segments, so one cluster barrier
// a segment orders every remote read before the next write of it.
template <typename S, int CS, int EPT>
struct ClusterSeg {
  using TS = typename S::T;
  static constexpr int V = 16 / sizeof(TS);
  static constexpr int W = EPT / V;  // 16-byte words a thread

  static __device__ __forceinline__ void load(float (&v)[W][V],
                                              const RowPtrs& t, long long seg,
                                              long long n, long long L,
                                              long long nseg, int r) {
    const int row = (int)(seg / nseg);
    const long long lo = (seg - (long long)row * nseg) * L;
    const long long lim = lo + L < n ? lo + L : n;  // elements that are read
    const TS* x = static_cast<const TS*>(t.in[row]);
    const long long base =
        lo + (long long)r * blockDim.x * EPT + threadIdx.x * V;
#pragma unroll
    for (int j = 0; j < W; ++j)
      load_run<S, V>(v[j], x, base + (long long)j * blockDim.x * V, lim);
  }
};

template <typename S, int CS, int EPT>
__device__ __forceinline__ void quantize_held(
    const float (&v)[ClusterSeg<S, CS, EPT>::W][ClusterSeg<S, CS, EPT>::V],
    const RowPtrs& t, long long seg, long long L, long long nseg,
    long long out_len, int8_t* values, float* scales, int r, float* warp_max,
    float* part, float* scale_sm) {
  using C = ClusterSeg<S, CS, EPT>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < C::W; ++j)
#pragma unroll
    for (int k = 0; k < C::V; ++k) amax = max_nan(amax, fabsf(v[j][k]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = max_nan(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float m = lane < (int)blockDim.x / 32 ? warp_max[lane] : 0.0f;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)  // T <= 512: 16 warps
      m = max_nan(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    if (lane == 0) *part = m;
  }
  cluster.sync();  // every CTA's part of this segment is written
  if (warp == 0) {
    float m = lane < CS ? *cluster.map_shared_rank(part, lane) : 0.0f;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)  // CS <= 8
      m = max_nan(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    if (lane == 0) *scale_sm = segment_scale(m);
  }
  __syncthreads();
  const float scale = *scale_sm;
  const int row = (int)(seg / nseg);
  const long long s = seg - (long long)row * nseg;
  const long long lo = s * L;
  if (r == 0 && threadIdx.x == 0) scales[(long long)row * nseg + s] = scale;
  const uint32_t seed = t.seed[row];
  int8_t* q = values + (long long)row * out_len;
  const long long end = lo + L < out_len ? lo + L : out_len;
  const long long base =
      lo + (long long)r * blockDim.x * EPT + threadIdx.x * C::V;
#pragma unroll
  for (int j = 0; j < C::W; ++j) {
    const long long i = base + (long long)j * blockDim.x * C::V;
    alignas(C::V) int8_t out[C::V];
#pragma unroll
    for (int k = 0; k < C::V; ++k)
      out[k] = quantize_one(v[j][k], scale, (uint32_t)(i + k), seed);
    store_run<C::V>(q, i, out, end);
  }
}

template <typename S, int CS, int EPT>
__global__ void __launch_bounds__(kRegThreads)
    quantize_regs_kernel(const __grid_constant__ RowPtrs t, long long n,
                            long long L, long long nseg, long long out_len,
                            int8_t* values, float* scales, long long total) {
  using C = ClusterSeg<S, CS, EPT>;
  __shared__ float warp_max[kRegThreads / 32];
  __shared__ float part[2];  // this CTA's absmax, read by the cluster
  __shared__ float scale_sm[2];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long long stride = gridDim.x / CS;  // clusters
  long long seg = blockIdx.x / CS;
  float a[C::W][C::V], b[C::W][C::V];
  if (seg < total) C::load(a, t, seg, n, L, nseg, r);
  while (seg < total) {  // a holds seg; b takes the next
    long long next = seg + stride;
    if (next < total) C::load(b, t, next, n, L, nseg, r);
    quantize_held<S, CS, EPT>(a, t, seg, L, nseg, out_len, values, scales, r,
                              warp_max, &part[0], &scale_sm[0]);
    seg = next;
    if (seg >= total) break;
    next = seg + stride;
    if (next < total) C::load(a, t, next, n, L, nseg, r);
    quantize_held<S, CS, EPT>(b, t, seg, L, nseg, out_len, values, scales, r,
                              warp_max, &part[1], &scale_sm[1]);
    seg = next;
  }
  cluster.sync();  // no CTA leaves while another reads its part
}

// A persistent grid: as many clusters as fit on the card at once
// (cudaOccupancyMaxActiveClusters, asked once a block size), at most one
// a segment; `persistent` 0 gives every segment its own cluster.
template <typename S, int CS, int EPT>
int quantize_regs(const RowPtrs& t, long long total, int threads,
                     long long n, long long L, long long nseg,
                     long long out_len, int8_t* values, float* scales,
                     cudaStream_t s, bool persistent = true) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;  // CTAs r = 0..CS-1 of a cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int fit[kRegThreads / 32 + 1] = {};  // clusters, by warps
  long long clusters = total;
  if (persistent) {
    int& f = fit[threads / 32];
    if (f == 0) {
      cfg.gridDim = dim3(CS);
      int num = 0;
      const cudaError_t rc = cudaOccupancyMaxActiveClusters(
          &num, quantize_regs_kernel<S, CS, EPT>, &cfg);
      if (rc != cudaSuccess || num < 1) return static_cast<int>(
          rc != cudaSuccess ? rc : cudaErrorInvalidConfiguration);
      f = num;
    }
    if (clusters > f) clusters = f;
  }
  if (clusters * CS > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cfg.gridDim = dim3((unsigned)(clusters * CS));
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, quantize_regs_kernel<S, CS, EPT>, t, n, L, nseg, out_len,
      values, scales, total);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Row 7's shared-memory holding with persistent clusters: each cluster
// walks segments c, c + clusters, ..., its CTAs holding two segments'
// parts, the next one's cp.async.bulk under way while the current one is
// reduced and stored (part[] and the stages alternate, so one cluster
// barrier and one block barrier a segment order every read before the
// next write).
template <typename S, int CS>
__global__ void __launch_bounds__(kClusterThreads)
    quantize_pipelined_kernel(const __grid_constant__ RowPtrs t, long long n,
                            long long L, long long nseg, long long out_len,
                            int8_t* values, float* scales, int per,
                            long long total) {
  using TS = typename S::T;
  constexpr int V = 16 / sizeof(TS);
  extern __shared__ __align__(128) unsigned char raw[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float warp_max[kClusterThreads / 32];
  __shared__ float part[2];  // this CTA's absmax, read by the whole cluster
  __shared__ float scale_sm;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long long stride = gridDim.x / CS;  // clusters
  // stage i: its part at raw + i per elements, its mbarrier at bar0 + 8 i
  TS* const stage0 = reinterpret_cast<TS*>(raw);
  const uint32_t bar0 = smem_addr(&bars[0]);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  long long seg = blockIdx.x / CS;
  if (seg < total) Held<S>(t, seg, n, L, nseg, r, per).fill(stage0, bar0, per);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int words = per / V;
  for (int k = 0; seg < total; ++k, seg += stride) {
    const int st = k & 1;
    if (seg + stride < total)  // the next segment, into the other stage
      Held<S>(t, seg + stride, n, L, nseg, r, per)
          .fill(stage0 + (st ^ 1) * per, bar0 + 8 * (st ^ 1), per);
    wait_stage(bar0 + 8 * st, (uint32_t)(k >> 1) & 1u);
    const TS* held = stage0 + st * per;
    float amax = 0.0f;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      float v[V];
      load_vec<S, V>(v, held + w * V);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = max_nan(amax, fabsf(v[j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = max_nan(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
    if (lane == 0) warp_max[warp] = amax;
    __syncthreads();
    if (warp == 0) {
      float m = lane < (int)blockDim.x / 32 ? warp_max[lane] : 0.0f;
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)  // 256 threads: 8 warps
        m = max_nan(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
      if (lane == 0) part[st] = m;
    }
    cluster.sync();  // every CTA's part of this segment is written
    if (warp == 0) {
      float m = lane < CS ? *cluster.map_shared_rank(&part[st], lane) : 0.0f;
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)  // CS <= 8
        m = max_nan(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
      if (lane == 0) scale_sm = segment_scale(m);
    }
    __syncthreads();
    const float scale = scale_sm;
    const Held<S> h(t, seg, n, L, nseg, r, per);
    if (r == 0 && threadIdx.x == 0)
      scales[(long long)h.row * nseg + h.s] = scale;
    const uint32_t seed = t.seed[h.row];
    int8_t* q = values + (long long)h.row * out_len;
    const long long end = h.lo + L < out_len ? h.lo + L : out_len;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      float v[V];
      load_vec<S, V>(v, held + w * V);
      const long long i = h.first + (long long)w * V;
      alignas(V) int8_t out[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        out[j] = quantize_one(v[j], scale, (uint32_t)(i + j), seed);
      store_run<V>(q, i, out, end);
    }
    __syncthreads();  // the stage is read before it is filled again
  }
  cluster.sync();  // no CTA leaves while another reads its part
}

// As many clusters as fit on the card at once
// (cudaOccupancyMaxActiveClusters, asked once a part size), each holding
// two stages.
template <typename S, int CS>
int quantize_pipelined(const RowPtrs& t, long long total, int threads,
                     long long n, long long L, long long nseg,
                     long long out_len, int8_t* values, float* scales,
                     cudaStream_t s, bool persistent = false) {
  const int per = (int)(((L + CS - 1) / CS + 7) / 8 * 8);
  if (per > kHeld) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (persistent ? 2 : 1) * per * (int)sizeof(typename S::T);
  static int set_smem = 0;  // the attribute, set once (its largest need)
  if (set_smem < smem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        quantize_pipelined_kernel<S, CS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * kHeld * (int)sizeof(typename S::T));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    set_smem = 2 * kHeld * (int)sizeof(typename S::T);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;  // CTAs r = 0..CS-1 of a cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int fit = 0, fit_smem = -1;  // clusters that fit, at fit_smem
  if (persistent && fit_smem != smem) {
    cfg.gridDim = dim3(CS);
    int num = 0;
    const cudaError_t rc = cudaOccupancyMaxActiveClusters(
        &num, quantize_pipelined_kernel<S, CS>, &cfg);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (num < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fit = num;
    fit_smem = smem;
  }
  const long long clusters = persistent && fit < total ? fit : total;
  cfg.gridDim = dim3((unsigned)(clusters * CS));
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, quantize_pipelined_kernel<S, CS>, t, n, L, nseg, out_len, values,
      scales, per, total);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace port_comp

namespace {

using accl::RankIn;
using accl::RankOut;
using accl::RankPtrs;

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void gather_parent(const __grid_constant__ RankIn r, uint4* out,
                              long long nvec) {
  const uint4* src = static_cast<const uint4*>(r.in[blockIdx.y]);
  uint4* dst = out + blockIdx.y * nvec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += stride)
    dst[i] = src[i];
}

template <int U>
__global__ void gather_tile(const __grid_constant__ RankIn r, uint4* out,
                            long long nvec) {
  const uint4* src = static_cast<const uint4*>(r.in[blockIdx.y]);
  uint4* dst = out + blockIdx.y * nvec;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if ((w + 1) * 32 * U > nvec) return;
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = src[(w * U + u) * 32 + lane];
#pragma unroll
  for (int u = 0; u < U; ++u) dst[(w * U + u) * 32 + lane] = v[u];
}

template <int STAGES>
__global__ void __launch_bounds__(32)
    gather_bulk(const __grid_constant__ RankIn r, char* out, int P,
                long long nbytes, int chunk) {
  extern __shared__ __align__(128) char stage[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  if (threadIdx.x != 0) return;
  const long long per_rank = (nbytes + chunk - 1) / chunk;
  const long long total = per_rank * P;
  if ((long long)blockIdx.x >= total) return;
  const long long mine = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  for (int s = 0; s < STAGES; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        smem(&bars[s])));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  auto piece = [&](long long i, int& q, long long& off, int& bytes) {
    const long long c = blockIdx.x + i * gridDim.x;
    q = (int)(c / per_rank);
    off = (c - q * per_rank) * chunk;
    bytes = nbytes - off < chunk ? (int)(nbytes - off) : chunk;
  };
  auto load = [&](long long i) {
    int q, bytes;
    long long off;
    piece(i, q, off, bytes);
    const int s = (int)(i % STAGES);
    const uint32_t bar = smem(&bars[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem(stage + (size_t)s * chunk)),
        "l"(static_cast<const char*>(r.in[q]) + off), "r"(bytes), "r"(bar)
        : "memory");
  };
  for (long long i = 0; i < STAGES && i < mine; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % STAGES);
    const uint32_t bar = smem(&bars[s]);
    const uint32_t parity = (uint32_t)((i / STAGES) & 1);
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    int q, bytes;
    long long off;
    piece(i, q, off, bytes);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(out + q * nbytes + off),
                 "r"(smem(stage + (size_t)s * chunk)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (i >= 1 && i - 1 + STAGES < mine) {  // the last piece's stage is read
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(i - 1 + STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void combine_parent(const float4* a, const float4* b, float4* c,
                               long long nvec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += stride)
    c[i] = add4(a[i], b[i]);
}

template <int U>
__global__ void combine_tile(const float4* a, const float4* b, float4* c,
                             long long nvec) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if ((w + 1) * 32 * U > nvec) return;
  float4 va[U], vb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) va[u] = a[(w * U + u) * 32 + lane];
#pragma unroll
  for (int u = 0; u < U; ++u) vb[u] = b[(w * U + u) * 32 + lane];
#pragma unroll
  for (int u = 0; u < U; ++u) c[(w * U + u) * 32 + lane] = add4(va[u], vb[u]);
}

template <int U>
__global__ void combine_blockstride(const float4* a, const float4* b,
                                    float4* c, long long nvec) {
  const long long base = (long long)blockIdx.x * blockDim.x * U + threadIdx.x;
  float4 va[U], vb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + u * blockDim.x;
    if (i < nvec) {
      va[u] = a[i];
      vb[u] = b[i];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + u * blockDim.x;
    if (i < nvec) c[i] = add4(va[u], vb[u]);
  }
}

__global__ void allgather_parent(const __grid_constant__ RankPtrs t, int P,
                                 long long nvec) {
  const uint4* src = static_cast<const uint4*>(t.in[blockIdx.y]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const uint4 v = src[i];
    for (int r = 0; r < P; ++r)
      static_cast<uint4*>(t.out[r])[blockIdx.y * nvec + i] = v;
  }
}

template <int U>
__global__ void allgather_tile(const __grid_constant__ RankPtrs t, int P,
                               long long nvec) {
  const uint4* src = static_cast<const uint4*>(t.in[blockIdx.y]);
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if ((w + 1) * 32 * U > nvec) return;
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = src[(w * U + u) * 32 + lane];
  for (int r = 0; r < P; ++r) {
    uint4* dst = static_cast<uint4*>(t.out[r]) + blockIdx.y * nvec;
#pragma unroll
    for (int u = 0; u < U; ++u) dst[(w * U + u) * 32 + lane] = v[u];
  }
}

// row 11: block q of the root's operand into out[q]
__global__ void scatter_parent(const uint4* src,
                               const __grid_constant__ RankOut t,
                               long long nvec) {
  const uint4* from = src + blockIdx.y * nvec;
  uint4* dst = static_cast<uint4*>(t.out[blockIdx.y]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += stride)
    dst[i] = from[i];
}

template <int U>
__global__ void scatter_tile(const uint4* src,
                             const __grid_constant__ RankOut t,
                             long long nvec) {
  const uint4* from = src + blockIdx.y * nvec;
  uint4* dst = static_cast<uint4*>(t.out[blockIdx.y]);
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if ((w + 1) * 32 * U > nvec) return;
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = from[(w * U + u) * 32 + lane];
#pragma unroll
  for (int u = 0; u < U; ++u) dst[(w * U + u) * 32 + lane] = v[u];
}

// row 13: out[(r + distance) % P] = in[r] + c, float32
__device__ __forceinline__ float4 addc(float4 a, float c) {
  return make_float4(__fadd_rn(a.x, c), __fadd_rn(a.y, c), __fadd_rn(a.z, c),
                     __fadd_rn(a.w, c));
}

__global__ void put_parent(RankPtrs t, int P, int distance, long long nvec,
                           float c) {
  const int r = blockIdx.y;
  const float4* in = static_cast<const float4*>(t.in[r]);
  float4* out = static_cast<float4*>(t.out[(r + distance) % P]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += stride)
    out[i] = addc(in[i], c);
}

template <int U>
__global__ void put_tile(const __grid_constant__ RankPtrs t, int P,
                         int distance, long long nvec, float c) {
  const int r = blockIdx.y;
  const float4* in = static_cast<const float4*>(t.in[r]);
  float4* out = static_cast<float4*>(t.out[(r + distance) % P]);
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if ((w + 1) * 32 * U > nvec) return;
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = in[(w * U + u) * 32 + lane];
#pragma unroll
  for (int u = 0; u < U; ++u) out[(w * U + u) * 32 + lane] = addc(v[u], c);
}

// row 14, the parent's pattern (float32): per slot, the rank-order fold
// of every rank's element c into every rank's result c
struct SeqWindow {
  const float* in[512];
  float* out[512];
  long long n[64];
  int fop[64];
  int n_slots, P;
};

__device__ __forceinline__ float seq_ld(const float* p, long long e) {
  return p ? p[e] : 0.0f;
}

__global__ void __launch_bounds__(256)
    seq_parent(const __grid_constant__ SeqWindow w) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int s = 0; s < w.n_slots; ++s) {
    const float* const* in = w.in + s * w.P;
    float* const* out = w.out + s * w.P;
    for (long long c = tid; c < w.n[s]; c += stride) {
      float acc = seq_ld(in[0], c);
      for (int j = 1; j < w.P; ++j)
        acc = accl::Arith<float>::apply(w.fop[s], acc, seq_ld(in[j], c));
      for (int me = 0; me < w.P; ++me)
        if (out[me]) out[me][c] = acc;
    }
  }
}

// row 7, the parent's pattern: G threads a segment (a warp or a block),
// absmax in a first read, the quantized values from a second
template <int G>
__global__ void quantize_parent(const __grid_constant__ port_comp::RowPtrs t,
                                long long n, long long L, long long nseg,
                                long long out_len, int8_t* values,
                                float* scales, int R) {
  __shared__ float smem[8];
  const int groups = blockDim.x / G;
  const int lane = threadIdx.x % G;
  for (long long g = (long long)blockIdx.x * groups + threadIdx.x / G;
       g < (long long)R * nseg; g += (long long)gridDim.x * groups) {
    const int row = (int)(g / nseg);
    const long long lo = (g % nseg) * L;
    const float* x = static_cast<const float*>(t.in[row]) + lo;
    int8_t* q = values + (long long)row * out_len + lo;
    float amax = 0.0f;
    for (long long k = (long long)lane * 4; k < L; k += (long long)G * 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + k);
      amax = accl::max_nan(amax, accl::max_nan(
          accl::max_nan(fabsf(v.x), fabsf(v.y)),
          accl::max_nan(fabsf(v.z), fabsf(v.w))));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = accl::max_nan(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, off));
    if (G > 32) {
      __syncthreads();
      if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = amax;
      __syncthreads();
      amax = smem[0];
      for (int w = 1; w < G / 32; ++w) amax = accl::max_nan(amax, smem[w]);
    }
    const float scale = port_comp::segment_scale(amax);
    if (lane == 0) scales[g] = scale;
    const uint32_t seed = t.seed[row];
    for (long long k = (long long)lane * 4; k < L; k += (long long)G * 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + k);
      const float f[4] = {v.x, v.y, v.z, v.w};
      alignas(4) int8_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = port_comp::quantize_one(f[j], scale, (uint32_t)(lo + k + j),
                                       seed);
      *reinterpret_cast<uint32_t*>(q + k) =
          *reinterpret_cast<const uint32_t*>(o);
    }
  }
}

// one tile a warp, 256 threads a block
inline unsigned tile_grid(long long nvec, int U) {
  return (unsigned)((nvec / (32LL * U) + 7) / 8);
}

inline int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each entry launches one variant on `stream` and returns
// cudaGetLastError(); sizes are whole tiles of every U (nbytes / n a
// multiple of 8 KiB), as the script's shapes are.

extern "C" int tv_gather(const void* const* in, void* out, int P,
                         long long nbytes, int variant, void* stream) {
  RankIn t = {};
  for (int i = 0; i < P; ++i) t.in[i] = in[i];
  const long long nvec = nbytes / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* o = static_cast<uint4*>(out);
  switch (variant) {
    case 0:
      gather_parent<<<dim3((accl::grid_for(nvec, 256) + P - 1) / P, P), 256,
                      0, s>>>(t, o, nvec);
      break;
    case 1: gather_tile<1><<<dim3(tile_grid(nvec, 1), P), 256, 0, s>>>(t, o, nvec); break;
    case 2: gather_tile<2><<<dim3(tile_grid(nvec, 2), P), 256, 0, s>>>(t, o, nvec); break;
    case 4: gather_tile<4><<<dim3(tile_grid(nvec, 4), P), 256, 0, s>>>(t, o, nvec); break;
    case 8: gather_tile<8><<<dim3(tile_grid(nvec, 8), P), 256, 0, s>>>(t, o, nvec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return done();
}

extern "C" int tv_gather_bulk(const void* const* in, void* out, int P,
                              long long nbytes, int chunk, int stages,
                              int blocks_per_sm, void* stream) {
  RankIn t = {};
  for (int i = 0; i < P; ++i) t.in[i] = in[i];
  const long long pieces = (nbytes + chunk - 1) / chunk * P;
  long long grid = 132LL * blocks_per_sm;
  if (grid > pieces) grid = pieces;
  const int bytes = chunk * stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* o = static_cast<char*>(out);
  cudaError_t e = cudaErrorInvalidValue;
  if (stages == 2) {
    e = cudaFuncSetAttribute(gather_bulk<2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess)
      gather_bulk<2><<<(unsigned)grid, 32, bytes, s>>>(t, o, P, nbytes, chunk);
  } else if (stages == 4) {
    e = cudaFuncSetAttribute(gather_bulk<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess)
      gather_bulk<4><<<(unsigned)grid, 32, bytes, s>>>(t, o, P, nbytes, chunk);
  } else if (stages == 8) {
    e = cudaFuncSetAttribute(gather_bulk<8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess)
      gather_bulk<8><<<(unsigned)grid, 32, bytes, s>>>(t, o, P, nbytes, chunk);
  }
  return e == cudaSuccess ? done() : static_cast<int>(e);
}

extern "C" int tv_combine(const void* a, const void* b, void* c,
                          long long n, int variant, void* stream) {
  const long long nvec = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x = static_cast<const float4*>(a);
  const float4* y = static_cast<const float4*>(b);
  float4* z = static_cast<float4*>(c);
  switch (variant) {
    case 0: combine_parent<<<accl::grid_for(nvec, 256), 256, 0, s>>>(x, y, z, nvec); break;
    case 1: combine_tile<1><<<tile_grid(nvec, 1), 256, 0, s>>>(x, y, z, nvec); break;
    case 2: combine_tile<2><<<tile_grid(nvec, 2), 256, 0, s>>>(x, y, z, nvec); break;
    case 4: combine_tile<4><<<tile_grid(nvec, 4), 256, 0, s>>>(x, y, z, nvec); break;
    case 8: combine_tile<8><<<tile_grid(nvec, 8), 256, 0, s>>>(x, y, z, nvec); break;
    case 101:  // PyTorch's shape: 128 threads, one vector each
      combine_blockstride<1><<<(unsigned)((nvec + 127) / 128), 128, 0, s>>>(x, y, z, nvec);
      break;
    case 104:
      combine_blockstride<4><<<(unsigned)((nvec + 511) / 512), 128, 0, s>>>(x, y, z, nvec);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return done();
}

extern "C" int tv_allgather(const void* const* in, void* const* out, int P,
                            long long nbytes, int variant, void* stream) {
  RankPtrs t = {};
  for (int i = 0; i < P; ++i) {
    t.in[i] = in[i];
    t.out[i] = out[i];
  }
  const long long nvec = nbytes / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      allgather_parent<<<dim3((accl::grid_for(nvec, 256) + P - 1) / P, P),
                         256, 0, s>>>(t, P, nvec);
      break;
    case 1: allgather_tile<1><<<dim3(tile_grid(nvec, 1), P), 256, 0, s>>>(t, P, nvec); break;
    case 2: allgather_tile<2><<<dim3(tile_grid(nvec, 2), P), 256, 0, s>>>(t, P, nvec); break;
    case 4: allgather_tile<4><<<dim3(tile_grid(nvec, 4), P), 256, 0, s>>>(t, P, nvec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return done();
}

extern "C" int tv_scatter(const void* src, void* const* out, int P,
                          long long nbytes, int variant, void* stream) {
  RankOut t = {};
  for (int i = 0; i < P; ++i) t.out[i] = out[i];
  const long long nvec = nbytes / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* x = static_cast<const uint4*>(src);
  switch (variant) {
    case 0:  // the parent's grid: 132 x 8 blocks shared by the P rows
      scatter_parent<<<dim3((accl::grid_for(nvec, 256) + P - 1) / P, P), 256,
                       0, s>>>(x, t, nvec);
      break;
    case 1: scatter_tile<1><<<dim3(tile_grid(nvec, 1), P), 256, 0, s>>>(x, t, nvec); break;
    case 2: scatter_tile<2><<<dim3(tile_grid(nvec, 2), P), 256, 0, s>>>(x, t, nvec); break;
    case 4: scatter_tile<4><<<dim3(tile_grid(nvec, 4), P), 256, 0, s>>>(x, t, nvec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return done();
}

// n float32 elements a rank, a multiple of 4 x 32 x 4
extern "C" int tv_put(const void* const* in, void* const* out, int P,
                      int distance, long long n, float c, int variant,
                      void* stream) {
  RankPtrs t = {};
  for (int i = 0; i < P; ++i) {
    t.in[i] = in[i];
    t.out[i] = out[i];
  }
  const long long nvec = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: {  // the parent's grid: 132 x 8 blocks shared by the P rows
      int x = accl::grid_for((nvec + 4) * P, 256) / P;
      const long long need = (nvec + 4 + 255) / 256;
      if (x > need) x = static_cast<int>(need);
      if (x < 1) x = 1;
      put_parent<<<dim3(x, P), 256, 0, s>>>(t, P, distance, nvec, c);
      break;
    }
    case 1: put_tile<1><<<dim3(tile_grid(nvec, 1), P), 256, 0, s>>>(t, P, distance, nvec, c); break;
    case 2: put_tile<2><<<dim3(tile_grid(nvec, 2), P), 256, 0, s>>>(t, P, distance, nvec, c); break;
    case 4: put_tile<4><<<dim3(tile_grid(nvec, 4), P), 256, 0, s>>>(t, P, distance, nvec, c); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return done();
}

// row 14's first design on `n_slots` float32 slots of P ranks (in / out:
// n_slots * P pointers, slot-major; n: columns a slot; fop: SUM 0, MAX 1)
extern "C" int tv_sequencer_parent(const void* const* in,
                                   void* const* out, const long long* n,
                                   const int* fop, int n_slots, int P,
                                   void* sync, void* stream) {
  if (n_slots < 1 || n_slots > 64 || n_slots * P > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  static SeqWindow w;
  memset(&w, 0, sizeof(w));
  long long cols = 1;
  for (int i = 0; i < n_slots * P; ++i) {
    w.in[i] = static_cast<const float*>(in[i]);
    w.out[i] = static_cast<float*>(out[i]);
  }
  for (int i = 0; i < n_slots; ++i) {
    w.n[i] = n[i];
    w.fop[i] = fop[i];
    if (n[i] > cols) cols = n[i];
  }
  w.n_slots = n_slots;
  w.P = P;
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seq_parent, 256,
                                                  0);
    max_blocks = per_sm * sms;
  }
  long long blocks = (cols + 255) / 256;
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(sync, 0, sizeof(unsigned), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  void* args[] = {&w};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(seq_parent),
                                   dim3((unsigned)blocks), dim3(256), args, 0,
                                   s);
  return rc != cudaSuccess ? static_cast<int>(rc) : done();
}

// the port's sequencer on a descriptor of float32 slots at P <= 4 with no
// barrier, at U chunks a tile (the port's: U = 4)
extern "C" int tv_sequencer(const void* desc, int* status, int U,
                            void* stream) {
  port_seq::Window w;
  memcpy(&w, desc, sizeof(w));
  if (w.P > 4 || w.dtype != DT_F32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (U) {
    case 1: return port_seq::launch<float, 4, 1>(w, status, nullptr, s);
    case 2: return port_seq::launch<float, 4, 2>(w, status, nullptr, s);
    case 4: return port_seq::launch<float, 4, 4>(w, status, nullptr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// row 7's first design (float32, aligned whole segments): one warp a
// segment up to 8192 elements, one block of 256 threads above
extern "C" int tv_quantize_parent(const void* const* in,
                                  const uint32_t* seeds, int R, long long n,
                                  long long L, long long nseg,
                                  long long out_len, void* values,
                                  void* scales, void* stream) {
  const port_comp::RowPtrs t = port_comp::rows(in, nullptr, seeds, R);
  const long long total = (long long)R * nseg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* v = static_cast<int8_t*>(values);
  float* sc = static_cast<float*>(scales);
  if (L <= 8192) {
    const long long blocks = (total + 7) / 8;
    quantize_parent<32><<<blocks > 132 * 16 ? 132 * 16 : (int)blocks, 256, 0,
                          s>>>(t, n, L, nseg, out_len, v, sc, R);
  } else {
    quantize_parent<256><<<total > 132 * 8 ? 132 * 8 : (int)total, 256, 0,
                           s>>>(t, n, L, nseg, out_len, v, sc, R);
  }
  return done();
}

// row 7's cluster path holding the segment in registers (float32): a
// cluster of `cs` CTAs of `threads` threads, `ept` elements a thread
// (cs x threads x ept >= L), persistent or one cluster a segment
extern "C" int tv_quantize_cluster(const void* const* in,
                                   const uint32_t* seeds, int R, long long n,
                                   long long L, long long nseg,
                                   long long out_len, void* values,
                                   void* scales, int cs, int ept,
                                   int threads, int persistent,
                                   void* stream) {
  const port_comp::RowPtrs t = port_comp::rows(in, nullptr, seeds, R);
  const long long total = (long long)R * nseg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* v = static_cast<int8_t*>(values);
  float* sc = static_cast<float*>(scales);
  if ((long long)cs * threads * ept < L)
    return static_cast<int>(cudaErrorInvalidValue);
#define TV_CLUSTER(C, E)                                                    \
  if (cs == C && ept == E)                                                  \
    return port_comp::quantize_regs<port_comp::F32, C, E>(                  \
        t, total, threads, n, L, nseg, out_len, v, sc, s, persistent != 0);
  TV_CLUSTER(4, 32)
  TV_CLUSTER(8, 16)
  TV_CLUSTER(8, 32)
#undef TV_CLUSTER
  return static_cast<int>(cudaErrorInvalidValue);
}


// the port's shared-memory holding with persistent clusters of two
// stages (float32, the port's cluster of 8 CTAs)
extern "C" int tv_quantize_persistent(const void* const* in,
                                      const uint32_t* seeds, int R,
                                      long long n, long long L,
                                      long long nseg, long long out_len,
                                      void* values, void* scales,
                                      void* stream) {
  const port_comp::RowPtrs t = port_comp::rows(in, nullptr, seeds, R);
  return port_comp::quantize_pipelined<port_comp::F32, 8>(
      t, (long long)R * nseg, 256, n, L, nseg, out_len,
      static_cast<int8_t*>(values), static_cast<float*>(scales),
      static_cast<cudaStream_t>(stream), true);
}
