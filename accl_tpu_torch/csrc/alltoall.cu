// Row 12: the all-to-all block transpose over P ranks that share one
// device: rank r's output block p is rank p's input block r, one launch.
//
// Replaces accl_tpu/ops/pallas/alltoall.py::_kernel (:38, pallas_call at
// :123, entry alltoall :82), the transpose under
// models/ulysses_attention.py's use_pallas_alltoall form.  On the TPU each
// rank's kernel first signals and waits on a global barrier (every peer's
// output must exist before a one-sided write lands), copies its own block
// locally and then keeps P - 1 remote DMAs in flight, block p of its
// operand into slot `me` of rank p's output.  With every rank's operand
// and output in one memory the remote write is a store through the
// pointer table: no barrier and no semaphore are needed, and the kernel
// is the copy alone.  The TPU wrapper pads each block to (rows, 128)
// lanes for Mosaic's DMA tiling; the result does not depend on it, so
// nothing is padded here.  Peer stores and the barrier come back with
// several cards (ROADMAP B1 / B14).
//
// The result is a copy of the operand's bits, whatever its dtype, so it
// equals the plain version (and JAX) bit for bit: elements move as
// unsigned words of their width.
//
// Bound on the H100: bytes.  It reads P * P * m elements and writes as
// many (m the block) with no arithmetic, so its least time is
// 2 * P * n * itemsize / 3.35 TB/s for n elements a rank.  The design
// moves only those bytes: blockIdx.y is one (source rank, block) pair and
// the x dimension splits that pair's block into chunks, sized so the
// whole grid fills the card; 16-byte loads and stores when every pointer
// and the block's byte length are 16-byte aligned, element accesses
// otherwise.
#include "common.cuh"

namespace {

using accl::RankPtrs;

// pair = blockIdx.y: source rank p = pair / P, its block r = pair % P,
// stored as block p of rank r's output
template <typename T>
__global__ void alltoall_kernel(RankPtrs t, int P, long long m, int vec) {
  const int pair = blockIdx.y;
  const int p = pair / P, r = pair % P;
  const T* src = static_cast<const T*>(t.in[p]) + (long long)r * m;
  T* dst = static_cast<T*>(t.out[r]) + (long long)p * m;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (vec) {  // m * sizeof(T) is a multiple of 16: no tail
    const long long nvec = m * (long long)sizeof(T) / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < nvec; i += stride) d[i] = s[i];
    return;
  }
  for (long long i = tid; i < m; i += stride) dst[i] = src[i];
}

template <typename T>
int launch(const RankPtrs& t, int P, long long m, int vec,
           cudaStream_t stream) {
  const int pairs = P * P;
  const long long items = vec ? m * (long long)sizeof(T) / 16 : m;
  int x = accl::grid_for(items * pairs, accl::kThreads) / pairs;
  const long long need = (items + accl::kThreads - 1) / accl::kThreads;
  if (x > need) x = static_cast<int>(need);
  if (x < 1) x = 1;
  alltoall_kernel<T><<<dim3(x, pairs), accl::kThreads, 0, stream>>>(
      t, P, m, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in[r] / out[r]: rank r's operand and output, each P * m elements of
// `itemsize` bytes; vec: every pointer and m * itemsize are multiples of
// 16 bytes.  P * P <= 65535.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int accl_alltoall(const void* const* in, void* const* out, int P,
                             long long m, int itemsize, int vec,
                             void* stream) {
  if (P < 1 || P > accl::kMaxRanks || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs t = accl::table(in, out, P, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return launch<uint8_t>(t, P, m, vec, s);
    case 2: return launch<uint16_t>(t, P, m, vec, s);
    case 4: return launch<uint32_t>(t, P, m, vec, s);
    case 8: return launch<uint64_t>(t, P, m, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
