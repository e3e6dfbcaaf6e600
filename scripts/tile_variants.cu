// Access-pattern variants of the streaming tile core's three byte-bound
// kernels (K3's root-only gather and all-rank allgather, K4's float32
// combine), timed beside the port's kernels by scripts/tile_variants.py.
// None of them is on a path of the port: they record what the tile core
// was chosen over.
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
//    vectors.
#include "../accl_tpu_torch/csrc/common.cuh"

namespace {

struct RankIn {
  const void* in[accl::kMaxRanks];
};

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

struct RankPtrs {
  const void* in[accl::kMaxRanks];
  void* out[accl::kMaxRanks];
};

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
