// The fold core of the 16-bit attention kernels for Hopper (sm_90a): the
// forwards of row 16 (csrc/attention.cu, flash attention) and row 15
// (csrc/ring_attention.cu, ring attention over P ranks), and the pieces
// the backward's dQ and dK/dV kernels (rows 17 and 18,
// csrc/attention_bwd.cu) build on: mbarriers, TMA tile loads, wgmma
// descriptors and products, register rebalancing, the work counter and
// the tensor maps.  What the forwards fold is the TPU kernels' online
// softmax (accl_tpu/ops/pallas/attention.py::_fold :77 and _flash_kernel
// :293) in float32 over 16-bit operands.
//
// A persistent block of three warpgroups on each SM folds work items of
// 128 query rows (next_item):
//  * warpgroup 0, the producer, drops to kProducerRegs registers, and one
//    of its threads loads each item's Q into a ring of two Q buffers and
//    keeps a ring of kStages K and V stages full with TMA loads
//    (cp.async.bulk.tensor) that complete on "full" mbarriers; the
//    consumers hand a buffer back with an arrive on its "empty" mbarrier;
//  * warpgroups 1 and 2, the consumers, rise to kConsumerRegs registers
//    and own 64 of the item's rows each.  For each tile of kBN keys a
//    consumer forms S = Q K^T with wgmma m64n128k16 (Q and K read from
//    shared memory through matrix descriptors), runs the online softmax
//    on the accumulators in registers (scale * log2(e) folded into the
//    FFMA before each EX2), rounds P to the operand dtype in the register
//    layout of wgmma's A operand, and adds P V with wgmma reading A from
//    registers and V, stored (key, d), as the transposed B operand.
//
// Every tile in shared memory is a block of rows (128 here; the
// backward also streams 64-row tiles) of 128-byte swizzle atoms: a row
// of DP 16-bit columns is DP / 64 atoms, each 64-column block of a tile
// stored whole ([rows][64], 128 bytes a row, 1024-byte aligned), as TMA's
// 128-byte swizzle writes a box of 64 columns.  TMA zero-fills rows at or
// past T (each map keeps T as a real boundary) and columns at or past D.
//
// Accumulator layout (wgmma m64nN, f32): lane (g = lane / 4, t = lane % 4)
// of warp w of the warpgroup holds rows 16w + g and 16w + g + 8, columns
// 8i + 2t and 8i + 2t + 1 of each 8-column chunk i: d[4i + 0..1] on row
// 16w + g, d[4i + 2..3] on row 16w + g + 8.  Two neighbouring chunks,
// rounded and packed, are the A operand of one k16 step of P V.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: the driver is reached at run time)
#include <type_traits>

#include "flash.cuh"  // flash::pack, the rounding of P shared with the backward

namespace sm90 {

constexpr int kBM = 128;             // query rows per block
constexpr int kBN = 128;             // keys per K/V tile
constexpr int kAtom = 64;            // 16-bit columns per 128-byte swizzle row
constexpr int kStages = 2;
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;   // 40 + 2 x 232 = 3 x 168, the launch's
constexpr float kNeg = -1e30f;       // JAX's mask value and m's start
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The shared memory of a block, in bytes from a 1024-aligned base: two Q
// buffers (a block folds one work item while the next one's Q loads),
// kStages K tiles, kStages V tiles, then the mbarriers (a "full" and an
// "empty" one per buffer), the per-stage records and the work item in
// each Q buffer.
template <int DP>
struct Layout {
  static constexpr int kTile = kBM * DP * 2;  // 128 rows of DP 16-bit columns
  static constexpr int kQ = 0;                 // Q[2]
  static constexpr int kK = 2 * kTile;         // K[kStages]
  static constexpr int kV = kK + kStages * kTile;  // V[kStages]
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kRecs = kBars + 8 * 2 * (2 + 2 * kStages);
  static constexpr int kItems = kRecs + 16 * kStages;  // each Q buffer's item
  static constexpr int kBytes = kItems + 4 * 2;
  static constexpr int kDynamic = kBytes + 1024;  // room to align the base
  static_assert(kDynamic <= 232448, "over the 227 KB a block may use");
};

// What the producer tells the consumers about the tile in a stage (row 15:
// the hop's mask kind and the tile's first key; whether it is the last).
struct Record {
  int kind, k0, last, pad;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete.  A phase that never
// completes (a lost arrival) traps after about 2^35 cycles, so a fault
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// -- TMA ---------------------------------------------------------------------

// One box of a 4-D map (D, T, H, B) at (c0, c1, c2, c3) into shared memory
// at dst; the copy counts its bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A tile of ROWS rows of DP columns: DP / 64 boxes of (64 columns, ROWS
// rows; the map's box), each into its own block of ROWS x 128 bytes.
template <int DP, int ROWS = kBM>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int h,
                                         int b) {
#pragma unroll
  for (int c = 0; c < DP / kAtom; ++c)
    tma_load(dst + c * ROWS * 128, map, bar, c * kAtom, row0, h, b);
}

// -- warpgroup MMA -----------------------------------------------------------

// Matrix descriptor of a 128-byte-swizzled operand at shared address addr:
// lbo / sbo the leading / stride byte offsets, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// K-major (Q as A, K as B) in a tile of ROWS rows: 8-row groups 1024
// bytes apart; the leading offset is unused.  Step k16 of a row is 32
// bytes into its atom, and the atoms of a row are ROWS x 128 bytes apart.
template <int ROWS = kBM>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * ROWS * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major (V as the transposed B of P V) in a tile of ROWS rows:
// 64-column atoms ROWS x 128 bytes apart (leading), 8-row groups 1024
// bytes apart (stride).  Step k16 is 16 rows, 2048 bytes.
template <int ROWS = kBM>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, ROWS * 128, 1024);
}

// v, computed here: the compiler may not sink its computation past this
// point (into a run of wgmmas)
__device__ __forceinline__ uint64_t pinned(uint64_t v) {
  asm volatile("" : "+l"(v));
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers written by wgmma are read only after its wait: each register
// gets a new definition here, after the wait, that the compiler cannot
// hoist above it (and, before a wgmma, every earlier write is done).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A (smem, K-major) * B (smem, K-major), m64n128k16, f32
// accumulate; accumulate == 0 overwrites d
template <typename E>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  if constexpr (std::is_same<E, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d (+)= A (smem, K-major) * B (smem, K-major), m64n64k16, f32
// accumulate; accumulate == 0 overwrites d
template <typename E>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (std::is_same<E, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d += A (registers) * B (smem, MN-major: transposed), m64n128k16, f32
// accumulate
template <typename E>
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (std::is_same<E, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// d += A (registers) * B (smem, MN-major: transposed), m64n64k16, f32
// accumulate
template <typename E>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  if constexpr (std::is_same<E, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// -- register rebalancing ------------------------------------------------------

template <int R> __device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- the pipeline --------------------------------------------------------------

// A position in a ring of N buffers: the slot and the parity of the phase
// its mbarriers are in.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  template <int N> __device__ __forceinline__ void next() {
    if (++slot == N) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The block's buffers and mbarriers (Layout<DP>) from the aligned base.
template <int DP>
struct Smem {
  using L = Layout<DP>;
  uint32_t base;
  Record* recs;
  int* items;
  __device__ __forceinline__ explicit Smem(unsigned char* raw)
      : base((smem_addr(raw) + 1023u) & ~1023u),
        recs(reinterpret_cast<Record*>(raw + (base - smem_addr(raw)) +
                                       L::kRecs)),
        items(reinterpret_cast<int*>(raw + (base - smem_addr(raw)) +
                                     L::kItems)) {}
  __device__ __forceinline__ uint32_t q(int i) const {
    return base + L::kQ + i * L::kTile;
  }
  __device__ __forceinline__ uint32_t k(int s) const {
    return base + L::kK + s * L::kTile;
  }
  __device__ __forceinline__ uint32_t v(int s) const {
    return base + L::kV + s * L::kTile;
  }
  __device__ __forceinline__ uint32_t bar(int i) const {
    return base + L::kBars + 8 * i;
  }
  __device__ __forceinline__ uint32_t q_full(int i) const { return bar(i); }
  __device__ __forceinline__ uint32_t q_empty(int i) const {
    return bar(2 + i);
  }
  __device__ __forceinline__ uint32_t k_full(int s) const {
    return bar(4 + s);
  }
  __device__ __forceinline__ uint32_t k_empty(int s) const {
    return bar(4 + kStages + s);
  }
  __device__ __forceinline__ uint32_t v_full(int s) const {
    return bar(4 + 2 * kStages + s);
  }
  __device__ __forceinline__ uint32_t v_empty(int s) const {
    return bar(4 + 3 * kStages + s);
  }

  // Every buffer's full barrier takes one arrival (the producer's, with
  // the TMA bytes), its empty barrier one from each consumer thread.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2; ++i) {
        mbar_init(q_full(i), 1);
        mbar_init(q_empty(i), kThreads - 128);
      }
      for (int s = 0; s < kStages; ++s) {
        mbar_init(k_full(s), 1);
        mbar_init(k_empty(s), kThreads - 128);
        mbar_init(v_full(s), 1);
        mbar_init(v_empty(s), kThreads - 128);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The producer's loads.  Q of work item w into Q buffer qr, w recorded
  // beside it:
  __device__ __forceinline__ void load_q(Ring& qr, const CUtensorMap* map,
                                         int w, int row0, int h,
                                         int b) const {
    mbar_wait(q_empty(qr.slot), qr.phase ^ 1);
    items[qr.slot] = w;
    mbar_expect_tx(q_full(qr.slot), L::kTile);
    tma_tile<DP>(q(qr.slot), map, q_full(qr.slot), row0, h, b);
    qr.next<2>();
  }
  // No work is left: item -1 in Q buffer qr, its full barrier completed
  // without bytes.
  __device__ __forceinline__ void end_items(Ring& qr) const {
    mbar_wait(q_empty(qr.slot), qr.phase ^ 1);
    items[qr.slot] = -1;
    mbar_arrive(q_full(qr.slot));
  }
  // The consumers: the work item of Q buffer qr, once its Q has landed;
  // -1 at the end.
  __device__ __forceinline__ int wait_item(const Ring& qr) const {
    mbar_wait(q_full(qr.slot), qr.phase);
    return items[qr.slot];
  }
  // A K tile and its V tile into stage kv, the stage's record (rec not
  // null) written before the K tile's full barrier is armed:
  __device__ __forceinline__ void load_kv(Ring& kv, const CUtensorMap* km,
                                          const CUtensorMap* vm, int row0,
                                          int h, int b,
                                          const Record* rec) const {
    mbar_wait(k_empty(kv.slot), kv.phase ^ 1);
    if (rec) recs[kv.slot] = *rec;
    mbar_expect_tx(k_full(kv.slot), L::kTile);
    tma_tile<DP>(k(kv.slot), km, k_full(kv.slot), row0, h, b);
    mbar_wait(v_empty(kv.slot), kv.phase ^ 1);
    mbar_expect_tx(v_full(kv.slot), L::kTile);
    tma_tile<DP>(v(kv.slot), vm, v_full(kv.slot), row0, h, b);
    kv.next<kStages>();
  }
};

// -- the fold ----------------------------------------------------------------

// 2^x in one MUFU.EX2 (relative error about 2^-22; 2^-inf = 0, 2^0 = 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One consumer thread's share of the online softmax over its warpgroup's
// 64 query rows: o (the m64nDP accumulator), m (log2 units) and l for rows
// row[0] and row[1].  l is this lane's partial sum; the 4 lanes of a row
// combine theirs in store().
//
// Per tile: S = Q K^T (one commit group, waited), the softmax of S in
// registers, o rescaled, then o += P V (one commit group, waited).  The
// two consumer warpgroups of a block interleave on the SM, one's softmax
// beside the other's products.  Every input of a commit group's wgmmas is
// defined before its wgmma.fence and no branch lies inside it; else ptxas
// serialises every wgmma of the kernel (C7513).  (A P V left in flight
// across the next tile's softmax needs its descriptors and the next S's
// in distinct uniform registers at once, more than ptxas finds: it
// serialises; with Q's A fragments held in registers instead, fewer
// descriptors but 32 more registers a thread, it spills as well.)
template <typename E, int DP>
struct Fold {
  float o[DP / 2];
  float m[2], l[2];
  int row[2];

  __device__ __forceinline__ void init(int row0) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
    row[0] = row0;
    row[1] = row0 + 8;
  }

  // s = Q K^T from the warpgroup's Q rows at qs and the K tile at ks
  __device__ __forceinline__ void scores(float (&s)[64], uint32_t qs,
                                         uint32_t ks) {
    uint64_t dq[DP / 16], dk[DP / 16];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      dq[kk] = pinned(desc_k(qs, kk));
      dk[kk] = pinned(desc_k(ks, kk));
    }
    wgmma_fence();  // s was last read by ordinary code
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss128<E>(s, dq[kk], dk[kk], kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  }

  // The online softmax of one tile's scores s (keys from k0), as the TPU
  // kernel's, in log2 units: masked scores -1e30 (masked(row, key) is
  // asked only when edge, a diagonal or ragged tile); the row max over the
  // raw scores, m_new = max(m, max * scale log2(e)); p = 2^(s scale log2(e)
  // - m_new) in one FFMA and one EX2; l = l alpha + sum(p) of the unrounded
  // p; o rescaled by alpha = 2^(m - m_new).  Returns P rounded to the
  // operand dtype and packed as the A operand of keys 16c..16c+15 (chunks
  // 2c and 2c + 1).
  template <typename Masked>
  __device__ __forceinline__ void softmax(float (&s)[64], int k0, bool edge,
                                          float scale2, Masked masked,
                                          uint32_t (&pa)[kBN / 16][4]) {
    const int t = threadIdx.x & 3;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge && masked(row[e >> 1], k0 + 8 * i + 2 * t + (e & 1)))
          s[4 * i + e] = kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * scale2);
      alpha[r] = ex2(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float p = ex2(fmaf(s[i], scale2, -m[(i >> 1) & 1]));
      s[i] = p;
      sum[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      pa[c][0] = flash::pack<E>(s[8 * c + 0], s[8 * c + 1]);
      pa[c][1] = flash::pack<E>(s[8 * c + 2], s[8 * c + 3]);
      pa[c][2] = flash::pack<E>(s[8 * c + 4], s[8 * c + 5]);
      pa[c][3] = flash::pack<E>(s[8 * c + 6], s[8 * c + 7]);
    }
  }

  // o += P V for P in pa and the V tile at vs
  __device__ __forceinline__ void values(const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t vs) {
    uint64_t dv[kBN / 16];
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) dv[c] = pinned(desc_mn(vs, c));
    fence_regs(o);
    wgmma_fence();  // o and pa were last written by ordinary code
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      if constexpr (DP == 128)
        wgmma_rs128<E>(o, pa[c], dv[c]);
      else
        wgmma_rs64<E>(o, pa[c], dv[c]);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  // out = o / max(l, 1e-30) (as o times its reciprocal) in the operand
  // dtype at ob (row stride st), columns below D, rows below T; lse
  // (natural log, per row of the head) when not null.  pairs: two
  // neighbouring columns in one 4-byte store.
  __device__ __forceinline__ void store(E* ob, long long st, int T, int D,
                                        bool pairs, float* lse) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float den = fmaxf(lr, 1e-30f), inv = 1.f / den;
      if (row[r] >= T) continue;
      E* orow = ob + row[r] * st;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = 8 * n + 2 * t;
        const float lo = o[4 * n + 2 * r] * inv;
        const float hi = o[4 * n + 2 * r + 1] * inv;
        if (pairs) {
          if (c < D)
            *reinterpret_cast<uint32_t*>(orow + c) = flash::pack<E>(lo, hi);
        } else {
          if (c < D) orow[c] = accl::from_float<E>(lo);
          if (c + 1 < D) orow[c + 1] = accl::from_float<E>(hi);
        }
      }
      if (lse && t == 0) lse[row[r]] = m[r] * kLn2 + logf(den);
    }
  }
};

// One consumer warpgroup's fold of one work item: the tiles from `next`
// (next(j, stage, k0, edge, kind) fills in tile j's first key, whether it
// is an edge tile and its mask kind, and returns whether it is the last)
// folded against Q buffer qr (loaded: wait_item), each tile's stage from
// kv; the K tile and Q's buffer (after the last tile) are released when S
// is complete, the V tile when P V is.  masked(kind, row, key) decides
// the masked scores of edge tiles.  (Storing the previous item's output
// while the first tile's S computes keeps two accumulators live, and
// ptxas spills.)
template <typename E, int DP, typename Next, typename Masked>
__device__ __forceinline__ void consume(const Smem<DP>& sm, Fold<E, DP>& f,
                                        Ring& kv, const Ring& qr, int cw,
                                        float scale2, Next next,
                                        Masked masked) {
  const uint32_t qs = sm.q(qr.slot) + cw * 64 * 128;  // this warpgroup's rows
  for (int j = 0;; ++j) {
    mbar_wait(sm.k_full(kv.slot), kv.phase);
    int k0, kind;
    bool edge;
    const bool last = next(j, kv.slot, k0, edge, kind);
    float s[64];
    f.scores(s, qs, sm.k(kv.slot));
    mbar_arrive(sm.k_empty(kv.slot));
    if (last) mbar_arrive(sm.q_empty(qr.slot));
    uint32_t pa[kBN / 16][4];
    f.softmax(s, k0, edge, scale2,
              [=](int row, int key) { return masked(kind, row, key); }, pa);
    mbar_wait(sm.v_full(kv.slot), kv.phase);
    f.values(pa, sm.v(kv.slot));
    mbar_arrive(sm.v_empty(kv.slot));
    kv.next<kStages>();
    if (last) break;
  }
}

// The launch's next work item, from the counter sched[0] that every
// block's producer draws on (items come heaviest first within each head,
// so a block that drew a heavy item draws again later, and the light ones
// fill in at the end); -1 when none is left.  A block then signs off in
// sched[1], and the last to do so zeroes both for the next launch on the
// stream.
__device__ __forceinline__ int next_item(int* sched, int items) {
  const int w = atomicAdd(sched, 1);
  if (w < items) return w;
  if (atomicAdd(sched + 1, 1) == static_cast<int>(gridDim.x) - 1) {
    atomicExch(sched, 0);
    atomicExch(sched + 1, 0);
  }
  return -1;
}

// Blocks of a persistent launch: one per SM of the current device, no
// more than there are work items.  The SM counts are read once a device.
inline int persistent_grid(long long items) {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = sms[dev & 63];
  if (n <= 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                       dev) != cudaSuccess)
    n = 132;
  return static_cast<int>(items < n ? items : n);
}

}  // namespace sm90

// -- host ----------------------------------------------------------------------

// The dynamic shared memory of a block of the kernels for head dims up to
// dp (for the build report).
extern "C" int accl_wgmma_smem(int dp) {
  return dp <= 64 ? sm90::Layout<64>::kDynamic : sm90::Layout<128>::kDynamic;
}

// Tensor maps:

#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled

namespace sm90 {

// cuTensorMapEncodeTiled, looked up in the driver at run time, so the
// library links no libcuda; null when the driver lacks it.
inline PFN_cuTensorMapEncodeTiled encoder() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Encode the 4-D map of a 16-bit (B, H, T, D) operand at base from its
// geometry g, 9 values from ops/cuda/attention.py::_tma_geometry: dims
// (D, T, H, B), the byte strides of T, H and B, the box (columns, rows),
// the box's rows replaced by `rows` when it is not 0 (the backward's
// 64-row tiles).  128-byte swizzle; out-of-bounds elements read as zero.
// Returns 0 or a cudaError_t.
inline int encode(CUtensorMap* map, const void* base, const long long* g,
                  int dtype, int rows = 0) {
  const PFN_cuTensorMapEncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1],
                              (cuuint64_t)g[2], (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5],
                                 (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)g[7],
                             (cuuint32_t)(rows ? rows : g[8]), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      dtype == DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The box every map of these kernels takes: 64 columns (one swizzle row)
// by 128 rows.
inline bool standard_box(const long long* g) {
  return g[7] == kAtom && g[8] == kBM;
}

}  // namespace sm90
