// Device functions for the tensor-core flash attention kernels: tiles of a
// 16-bit type T in shared memory, the asynchronous copies that fill them,
// and the matrix products over them. flash_attention_fwd.cu (K3a) and
// flash_attention_bwd.cu (K3b, K3c) are built on these; LaunchShape and
// launch_in, at the end, serve the launchers of all three sources.
//
// Types. T is __nv_bfloat16 or __half: both are 2 bytes, so the layout,
// the copies and the descriptors are the same, and only two things take
// the type: pack2<T> rounds two float32 values to T, and the wgmma
// instructions name it (f32.bf16.bf16 or f32.f16.f16, float32 accumulators
// either way).
//
// Panels and tiles. The head size is kPanels whole panels of 64 columns
// (kPanels = 1, 2 or 4: head size 64, 128 or 256; the sliced and cluster
// kernels of larger heads take the count at run time). A panel's row is 128
// bytes of T, and a panel of 64 rows, 8 KB, is stored [row][64] with the
// 128-byte swizzle: the 16-byte chunk c of row r lies at chunk c ^ (r & 7).
// Panels start at multiples of 1024 bytes, which makes that the layout
// wgmma's descriptors call B128 (and what TMA's 128-byte swizzle would
// write). A tile is 64 rows of the whole head: its kPanels panels one after
// the other, panel p holding columns 64 p .. 64 p + 63. A taller operand is
// tiles one after the other. One layout serves both ways an operand is
// read:
//   along h (K-major)    x . y^T, the reduction runs over a row's values,
//                        panel by panel
//   along rows (MN-major) p . y, the reduction runs over the tile's 64
//                        rows, one panel of output columns at a time
//
// Copies. stage_rows fills a tile with cp.async.cg, 16 bytes a thread, eight
// neighbouring threads to one row of a panel (coalesced in device memory,
// conflict free in shared memory). A row past the operand's end is filled
// with zeros by a source size of 0, so the ragged edge needs no padded
// operand. stage_panel fills one panel the same way from an operand whose
// row stride is known only at run time (the sliced and cluster kernels).
// K3a's short kernel fills whole heads by TMA instead (tma_load_head: the
// copy engine writes the same swizzled layout, completion on an mbarrier).
//
// Products. Both product functions are one call per warpgroup and leave or
// take a [64 x 64] float32 accumulator spread over its 128 threads in the
// layout of wgmma.m64n64k16 (which four mma.m16n8k16 tiles share): warp w of
// the group holds rows 16 w .. 16 w + 15, and a thread (g = lane / 4,
// t = lane % 4) holds acc[4 j + 0, 1] = (row g, columns 8 j + 2 t, + 1) and
// acc[4 j + 2, 3] = (row g + 8, same columns), j = 0 .. 7. Packed to T two
// by two, the accumulator of 16 columns is the A operand of the next
// product in registers (pack_a_fragments), so probabilities never go
// through shared memory. The layout depends only on a thread's place in
// its warpgroup, so two warpgroups that cover the same rows can hand each
// other fragments through shared memory, thread by thread.
//   product_nt   acc = X . Y^T, both tiles read from shared memory through
//                descriptors with the B128 layout: four wgmma a panel, one
//                per 16 values of h (product_nt_panel: one panel of the
//                chain, which the sliced kernels call panel by panel)
//   product_tn   acc += A . Y, A in registers, Y one panel read along its
//                rows with the descriptor's transpose bit: four wgmma, one
//                per 16 rows; a head of two panels takes one call and one
//                accumulator a panel
// wgmma is asynchronous: products_begin() fences the registers before the
// first product of a batch, products_end() commits and waits, and
// keep_registers() pins operands and accumulators until then, so the
// compiler neither reads an accumulator early nor reuses an A register
// while the tensor cores still read it.
//
// store_accumulator sends an accumulator (one panel of columns) to device
// memory through a panel in shared memory, as coalesced 16-byte stores
// (store_panel: the same for a row stride known at run time).
//
// Clusters. ClusterSum adds up an accumulator over the blocks of a
// thread-block cluster through distributed shared memory, each sum taken
// once, in rank order, so that every block holds the same bits of it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace flash_tiles {

constexpr int kPanelCols = 64;                 // head columns a panel
constexpr int kRowBytes = kPanelCols * 2;      // 128: a panel's row of T
constexpr int kTileRows = 64;
constexpr int kPanelBytes = kTileRows * kRowBytes;  // 8192
constexpr float kLog2e = 1.4426950408889634f;
// the score of a masked pair: -0.7 * float32 max, rounded from double as
// the JAX package's _MASK_VALUE; a row that no key reaches keeps it as m
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);

// a thread's place in its block: warpgroup, warp of the group, and the
// (g, t) = (lane / 4, lane % 4) of the fragment layout below
struct Lanes {
  int tid, lane, group, warp_in_group, g, t;
  __device__ Lanes()
      : tid(threadIdx.x), lane(threadIdx.x & 31), group(threadIdx.x >> 7),
        warp_in_group((threadIdx.x >> 5) & 3), g((threadIdx.x & 31) >> 2),
        t(threadIdx.x & 3) {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// dynamic shared memory from the next multiple of 1024 bytes
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// byte offset of 16-byte chunk `chunk` of row `row` from a panel's start
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return (uint32_t)(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
}

// bytes of a tile of 64 rows of a head of kPanels panels
template <int kPanels>
__host__ __device__ constexpr int tile_bytes() {
  return kPanels * kPanelBytes;
}

// ---------------------------------------------------------------------------
// the softmax's exponent
// ---------------------------------------------------------------------------

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// log2 of the softmax denominator folded into the row's exponent offset:
// exp(s - m) / l = exp2(s log2 e - (m log2 e + log2 l)). A row with l == 0
// has every element masked and only needs a finite-or-infinite, non-NaN
// offset.
__device__ __forceinline__ float exponent_offset(float m, float l) {
  const float m2 = m * kLog2e;
  return l == 0.f ? m2 : m2 + __log2f(l);
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes of which the first `bytes` (16 or 0) come from src, the rest zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's groups are in flight, and
// make what has landed visible to the tensor cores' reads of shared memory
// (wgmma reads through the asynchronous proxy)
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [row0, row0 + kRows) of a [rows, 64 kPanels] array of T into the
// operand at shared address `tile`; rows past the end become zeros. A
// thread copies chunk tid % 8 of each panel of rows tid / 8 + i * kThreads
// / 8: that step is a multiple of eight rows that divides 64, so its
// swizzled chunk stays where it is from copy to copy, a row never leaves
// its tile, and the addresses are one base plus constants.
template <int kRows, int kThreads, int kPanels, typename T>
__device__ __forceinline__ void stage_rows(uint32_t tile, const T* src,
                                           int row0, int rows, int tid) {
  constexpr int kCopies = kRows * 8 / kThreads, kRowStep = kThreads / 8;
  constexpr int kHd = kPanels * kPanelCols, kTile = tile_bytes<kPanels>();
  static_assert(kThreads % 64 == 0 && (kRows * 8) % kThreads == 0 &&
                    kTileRows % kRowStep == 0, "");
  const int r = tid >> 3, c = tid & 7;
  const uint32_t dst = tile + swizzled(r, c);
  const T* from = src + (size_t)(row0 + r) * kHd + c * 8;
  // where copy i of panel p lands, from dst
  auto at = [](int i, int p) {
    const int dr = i * kRowStep;
    return (uint32_t)((dr / kTileRows) * kTile +
                      p * kPanelBytes + (dr % kTileRows) * kRowBytes);
  };
  if (row0 + kRows <= rows) {
#pragma unroll
    for (int i = 0; i < kCopies; ++i)
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        cp_async_16(dst + at(i, p),
                    from + i * kRowStep * kHd + p * kPanelCols);
  } else {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const bool inside = row0 + r + i * kRowStep < rows;
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        cp_async_16(dst + at(i, p),
                    inside ? from + i * kRowStep * kHd + p * kPanelCols : src,
                    inside ? 16 : 0);
    }
  }
}

// rows [row0, row0 + 64) of one panel of a [rows, stride] array of T (`src`
// at the panel's first column) into the panel at shared address `panel`;
// rows past the end become zeros. kThreads threads, each chunk tid % 8 of
// rows tid / 8 + i * kThreads / 8, as stage_rows.
template <int kThreads, typename T>
__device__ __forceinline__ void stage_panel(uint32_t panel, const T* src,
                                            int row0, int rows, int stride,
                                            int tid) {
  constexpr int kRowStep = kThreads / 8;
  static_assert(kThreads % 64 == 0 && kTileRows % kRowStep == 0, "");
  const int r = tid >> 3, c = tid & 7;
#pragma unroll
  for (int i = 0; i < kTileRows / kRowStep; ++i) {
    const int row = r + i * kRowStep;
    const bool inside = row0 + row < rows;
    cp_async_16(panel + swizzled(row, c),
                inside ? src + (size_t)(row0 + row) * stride + c * 8 : src,
                inside ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// tensor-memory copies and their barriers (K3a's short kernel)
// ---------------------------------------------------------------------------

// A TMA copy of a box of rows of a [heads, rows, 64] array of T, described
// by a tensor map with the 128-byte swizzle, lands in the panel layout
// above when its destination is 1024-byte aligned, and completes on an
// mbarrier in shared memory that counts its bytes.

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// the inits visible to the other threads and to the copy engine (before
// the block's barrier)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive, and add `bytes` to what the current phase waits for
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// this thread's reads and writes of shared memory ordered before later
// copies into it by the copy engine (the asynchronous proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the box at rows 0.. of head `head` of the array `map` describes, to
// shared address `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_head(uint32_t dst, const void* map,
                                              int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(head)
      : "memory");
}

// ---------------------------------------------------------------------------
// the key mask
// ---------------------------------------------------------------------------

// The end of the keys a block of kThreads threads visits: `k_end`, cut to
// one past the last key the batch item's mask keeps (trailing padding),
// or k_end itself without a mask. `flags` holds a word a warp; a barrier.
template <int kThreads>
__device__ __forceinline__ int kept_key_end(const float* mask_row, int k_end,
                                            int tid, int* flags) {
  if (!mask_row) return k_end;
  int last = -1;
  for (int col = tid; col < k_end; col += kThreads)
    if (mask_row[col] > 0.f) last = col;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((tid & 31) == 0) flags[tid >> 5] = last;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) last = max(last, flags[w]);
  return last + 1;
}

// Whether key `col` takes part, into `dst` in shared memory: the mask's
// value by an asynchronous copy (0 past tk), or without a mask 1 inside
// the sequence.
__device__ __forceinline__ void stage_key_flag(float* dst,
                                               const float* mask_row,
                                               int col, int tk) {
  if (mask_row)
    cp_async_4(smem_u32(dst), mask_row + (col < tk ? col : 0),
               col < tk ? 4 : 0);
  else
    *dst = col < tk ? 1.f : 0.f;
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

// two float32 values rounded to T (to nearest, ties to even), lo in the low
// half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    static_assert(std::is_same_v<T, __nv_bfloat16>, "bf16 or f16");
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// a [64 x 64] accumulator, rounded to T, as the A operand of a product
// over its 64 columns: a[ks] covers columns 16 ks .. 16 ks + 15
template <typename T>
__device__ __forceinline__ void pack_a_fragments(const float (&acc)[32],
                                                 uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pack2<T>(acc[8 * ks + 0], acc[8 * ks + 1]);
    a[ks][1] = pack2<T>(acc[8 * ks + 2], acc[8 * ks + 3]);
    a[ks][2] = pack2<T>(acc[8 * ks + 4], acc[8 * ks + 5]);
    a[ks][3] = pack2<T>(acc[8 * ks + 6], acc[8 * ks + 7]);
  }
}

__device__ __forceinline__ void keep_registers(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

__device__ __forceinline__ void keep_registers(float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

__device__ __forceinline__ void keep_registers(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

#define FLASH_TILES_ACC(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define FLASH_TILES_ACC_LIST                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// wgmma with both operands in shared memory (%32, %33 the descriptors, %34
// nonzero to add to the accumulator), and with A in registers (%32-%35)
// and B transposed (%36; %37 nonzero to add), on operands of type TYPE
#define FLASH_TILES_WGMMA_SS(TYPE)                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "             \
  FLASH_TILES_ACC_LIST ", %32, %33, p, 1, 1, 0, 0;\n}\n"
#define FLASH_TILES_WGMMA_RS(TYPE)                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "             \
  FLASH_TILES_ACC_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

// ---------------------------------------------------------------------------
// products on wgmma (one call per warpgroup, by all its 128 threads)
// ---------------------------------------------------------------------------

// descriptor of a swizzled operand at shared address `addr`: start address,
// leading offset (not read for one 64-wide swizzled tile), 1024 bytes from
// one group of eight rows to the next, layout B128
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void products_begin() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void products_end() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// acc (+)= X . Y^T over one panel of h: X the warpgroup's 64 rows of the
// panel at `x_panel`, Y the 64 rows of the panel at `y_panel`, read along
// h. `add` is 4 times the panel's place in the chain: the first product of
// the chain (add 0, its first 16 values) overwrites acc, the others add.
template <typename T>
__device__ __forceinline__ void product_nt_panel(float (&acc)[32],
                                                 uint32_t x_panel,
                                                 uint32_t y_panel, int add) {
  const uint64_t dx = descriptor(x_panel), dy = descriptor(y_panel);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    // 16 values of h further on: 32 bytes, 2 in the descriptor's units
    if constexpr (std::is_same_v<T, __half>)
      asm volatile(FLASH_TILES_WGMMA_SS("f16")
                   : FLASH_TILES_ACC(acc)
                   : "l"(dx + 2 * ks), "l"(dy + 2 * ks), "r"(add + ks));
    else
      asm volatile(FLASH_TILES_WGMMA_SS("bf16")
                   : FLASH_TILES_ACC(acc)
                   : "l"(dx + 2 * ks), "l"(dy + 2 * ks), "r"(add + ks));
  }
}

// acc = X . Y^T: X the warpgroup's 64 rows at `x_tile`, Y the 64 rows at
// `y_tile`, both tiles of kPanels panels of T read along h
template <typename T, int kPanels>
__device__ __forceinline__ void product_nt(float (&acc)[32], uint32_t x_tile,
                                           uint32_t y_tile) {
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
    product_nt_panel<T>(acc, x_tile + p * kPanelBytes,
                        y_tile + p * kPanelBytes, 4 * p);
}

// acc = X . Y^T over one panel of h for the first 8 rows of Y only: the
// [64 x 8] corner of product_nt's accumulator, the same sums (a key tile
// that holds at most 8 keys). A thread holds (row g, columns 2 t, 2 t + 1)
// and (row g + 8, the same columns): acc[0..3] of the wide layout.
template <typename T>
__device__ __forceinline__ void product_nt_n8(float (&acc)[4],
                                              uint32_t x_panel,
                                              uint32_t y_panel) {
  const uint64_t dx = descriptor(x_panel), dy = descriptor(y_panel);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (std::is_same_v<T, __half>)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 "
          "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
          : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
          : "l"(dx + 2 * ks), "l"(dy + 2 * ks), "r"(ks));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
          : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
          : "l"(dx + 2 * ks), "l"(dy + 2 * ks), "r"(ks));
  }
}

// acc += A . Y: A [64 x 64] of T in registers (pack_a_fragments<T>), Y the
// 64 rows of one panel at `y_tile` read along its rows (transposed); with
// kSteps < 4 only A's first 16 kSteps columns and Y's first 16 kSteps rows
// (the rest of A zeros: their products add nothing)
template <typename T, int kSteps = 4>
__device__ __forceinline__ void product_tn(float (&acc)[32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t y_tile) {
  const uint64_t dy = descriptor(y_tile);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    // 16 rows further on: 2048 bytes, 128 in the descriptor's units
    if constexpr (std::is_same_v<T, __half>)
      asm volatile(FLASH_TILES_WGMMA_RS("f16")
                   : FLASH_TILES_ACC(acc)
                   : "r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]),
                     "r"(a[ks][3]), "l"(dy + 128 * ks), "r"(1));
    else
      asm volatile(FLASH_TILES_WGMMA_RS("bf16")
                   : FLASH_TILES_ACC(acc)
                   : "r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]),
                     "r"(a[ks][3]), "l"(dy + 128 * ks), "r"(1));
  }
}

// ---------------------------------------------------------------------------
// epilogue
// ---------------------------------------------------------------------------

// A warpgroup's [64 x 64] accumulator times `mul` to rows [row0, row0 + 64)
// and 64 columns of a [rows, stride] array of T (`dst` points at the first
// column of the panel), by way of a panel in shared memory that only this
// warpgroup uses (`tile`, a generic pointer): fragments hold pairs of
// values, a panel's rows are 128 contiguous bytes, so the panel turns 16
// scattered 4-byte stores a thread into 4 coalesced 16-byte ones. The
// swizzle keeps both the fragment stores and the row reads free of bank
// conflicts. `barrier` is a named barrier of the warpgroup's own (1 .. 15).
template <typename T>
__device__ __forceinline__ void store_panel(T* dst, uint8_t* tile,
                                            const float (&acc)[32], float mul,
                                            int row0, int rows, int stride,
                                            int barrier,
                                            int thread_in_group) {
  const int lane = thread_in_group & 31, g = lane >> 2, t = lane & 3;
  const int row_a = (thread_in_group >> 5) * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + swizzled(row_a + 8 * half, j) +
                                   4 * t) =
          pack2<T>(acc[4 * j + 2 * half] * mul,
                   acc[4 * j + 2 * half + 1] * mul);
  asm volatile("bar.sync %0, 128;\n" ::"r"(barrier) : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (thread_in_group >> 3) + 16 * i, c = thread_in_group & 7;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swizzled(r, c));
  }
}

// store_panel into a [rows, kHd] array
template <int kHd, typename T>
__device__ __forceinline__ void store_accumulator(
    T* dst, uint8_t* tile, const float (&acc)[32], float mul, int row0,
    int rows, int barrier, int thread_in_group) {
  store_panel(dst, tile, acc, mul, row0, rows, kHd, barrier, thread_in_group);
}

// zeros to rows [row0, row0 + 64) of a [rows, kHd] array of T, by one
// warpgroup
template <int kHd, typename T>
__device__ __forceinline__ void store_zero_rows(T* dst, int row0, int rows,
                                                int thread_in_group) {
  constexpr int kChunks = kHd / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int r = (thread_in_group + 128 * i) / kChunks,
              c = (thread_in_group + 128 * i) % kChunks;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * kHd + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// zeros to rows [row0, row0 + 64) of one panel of a [rows, stride] array of
// T (`dst` at the panel's first column), by one warpgroup
template <typename T>
__device__ __forceinline__ void store_zero_panel(T* dst, int row0, int rows,
                                                 int stride,
                                                 int thread_in_group) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (thread_in_group >> 3) + 16 * i, c = thread_in_group & 7;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * stride + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// the sliced kernels' ring (head sizes above 256)
// ---------------------------------------------------------------------------

// A slot holds four panels: the operands of the score products for one or
// two panels of h, or the panels of the second products' operand that a
// block's slice of output columns reads. Two slots take turns (K3b's
// cluster kernel's ring has slots of the same size).
constexpr int kSlotPanels = 4;
constexpr int kSlotBytes = kSlotPanels * kPanelBytes;  // 32 KB
constexpr int kSlots = 2;

// ---------------------------------------------------------------------------
// thread-block clusters (K3b above head size 256)
// ---------------------------------------------------------------------------

// the portable cluster size: the most blocks a cluster launches with
// without an opt-in
constexpr int kMaxCluster = 8;
// ClusterSum's buffer: a block's terms (and, from three blocks on, its
// sums), 16 bytes a thread a unit: 32 KB for 256 threads
constexpr int kExchangeBytes = 32 * 1024;

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// the cluster's barrier, split: arrive releases this thread's earlier
// reads and writes of shared memory to the cluster, wait returns once every
// thread of every block of the cluster has arrived and acquires theirs
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes at shared address `addr` of the cluster's block `rank`
__device__ __forceinline__ float4 load_remote(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_shared(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 operator+(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// Sums over the n blocks of a thread-block cluster of a warpgroup's [64 x
// 64] float32 accumulator, which each of a block's kThreads threads holds
// as 8 units of four values (unit u is values 4u .. 4u + 3). Every block
// ends with the same bits: each sum is taken once, in rank order 0 .. n -
// 1, and there are no atomics. Each thread stores its terms into the
// block's buffer, [unit][thread], and reads the same slots of other blocks'
// buffers through distributed shared memory, 16 bytes a load, kBatch loads
// in flight. Two blocks read each other's terms. From three on, unit u
// belongs to block u % n: its owner reads the others' terms of it, sums
// them and leaves the sum in its buffer, and each block reads the sums of
// the units it does not own from their owners, so every block reads and
// serves the same bytes. The general form gives two blocks the same bits
// and reads the same bytes, but meets the cluster's barrier once more a
// call: on an H100 it ran K3b at [16, 512, 512] bf16 in 162.0 us against
// the two-block branch's 137.2 (causal 98.6 against 83.8), in turns
// (compare_flash_builds.py against a build without the branch). add() meets the cluster's barrier once (twice
// from three blocks on) and arrives once more after its reads; the next
// call, or finish(), waits there before the buffer is written again or the
// block ends, so no block writes or leaves a buffer another still reads.
// Every block of the cluster calls init() before the first add(), so no
// block reads one that has not started, and finish() before it ends.
template <int kThreads>
struct ClusterSum {
  static constexpr int kUnits = 8;
  static constexpr int kBatch = 2;  // loads in flight a thread
  uint32_t slots;  // this thread's slot of unit 0 in the buffer
  int n, rank;
  bool pending = false;  // add()'s reads may still run in other blocks

  __device__ ClusterSum(uint32_t buffer, int n_, int rank_, int tid)
      : slots(buffer + tid * 16), n(n_), rank(rank_) {}

  __device__ void init() const {
    cluster_arrive();
    cluster_wait();
  }

  __device__ void finish() const {
    if (!pending) cluster_arrive();
    cluster_wait();
  }

  __device__ static float4 get(const float (&a)[32], int u) {
    return make_float4(a[4 * u], a[4 * u + 1], a[4 * u + 2], a[4 * u + 3]);
  }

  __device__ static void put(float (&a)[32], int u, float4 v) {
    a[4 * u] = v.x;
    a[4 * u + 1] = v.y;
    a[4 * u + 2] = v.z;
    a[4 * u + 3] = v.w;
  }

  __device__ uint32_t at(int u) const { return slots + u * kThreads * 16; }

  // a becomes its sum over the cluster
  __device__ void add(float (&a)[32]) {
    if (pending) cluster_wait();
#pragma unroll
    for (int u = 0; u < kUnits; ++u) store_shared(at(u), get(a, u));
    cluster_arrive();
    cluster_wait();
    if (n == 2) {  // each reads the other's terms
#pragma unroll
      for (int u0 = 0; u0 < kUnits; u0 += kBatch) {
        float4 other[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          other[j] = load_remote(at(u0 + j), 1 - rank);
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const float4 own = get(a, u0 + j);
          put(a, u0 + j, rank == 0 ? own + other[j] : other[j] + own);
        }
      }
    } else {
      // the owner's units: the others' terms kBatch blocks at a time, added
      // in rank order
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        if (u % n != rank) continue;
        const float4 own = get(a, u);
        float4 sum = own;
#pragma unroll
        for (int r0 = 0; r0 < kMaxCluster; r0 += kBatch) {
          float4 terms[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
            if (r0 + j < n && r0 + j != rank)
              terms[j] = load_remote(at(u), r0 + j);
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (r0 + j >= n) continue;
            const float4 term = r0 + j == rank ? own : terms[j];
            sum = r0 + j == 0 ? term : sum + term;
          }
        }
        put(a, u, sum);
        store_shared(at(u), sum);
      }
      cluster_arrive();
      cluster_wait();
      // the other units' sums, from their owners
#pragma unroll
      for (int u0 = 0; u0 < kUnits; u0 += kBatch) {
        float4 sums[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if ((u0 + j) % n != rank)
            sums[j] = load_remote(at(u0 + j), (u0 + j) % n);
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if ((u0 + j) % n != rank) put(a, u0 + j, sums[j]);
      }
    }
    cluster_arrive();  // this block's reads are done
    pending = true;
  }
};

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Let kKernel use `bytes` of dynamic shared memory: set once for each
// device, on the first launch there, not before every launch.
template <auto kKernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool known = device < kMaxDevices;
  if (known && allowed[device].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && known)
    allowed[device].store(true, std::memory_order_release);
  return err;
}

// A launch's shape: threads a block, dynamic shared memory a block, the
// rows of the sequence a block owns, the slices of the head (blocks along
// z), and the blocks a cluster (along z; 1: no cluster). Each kernel family
// has one function that gives it, which both its launcher and
// flash_launch_shape call.
struct LaunchShape {
  int threads;
  size_t smem;
  int rows, slices;
  int cluster = 1;

  dim3 grid(int bn, int t) const {
    return dim3(bn, (t + rows - 1) / rows, slices);
  }
};

// Launch kKernel in `shape` over bn heads of t rows.
template <auto kKernel, class... Args>
cudaError_t launch_in(const LaunchShape& shape, int bn, int t,
                      cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem<kKernel>(shape.smem);
  if (err != cudaSuccess) return err;
  kKernel<<<shape.grid(bn, t), shape.threads, shape.smem, stream>>>(args...);
  return cudaGetLastError();
}

// kKernel's launch configuration in `shape`, clusters of shape.cluster
// blocks along z; `attr` holds the cluster attribute the config points at
struct ClusterConfig {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];

  ClusterConfig(const LaunchShape& shape, dim3 grid, cudaStream_t stream) {
    config.gridDim = grid;
    config.blockDim = dim3(shape.threads);
    config.dynamicSmemBytes = shape.smem;
    config.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = shape.cluster;
    config.attrs = attr;
    config.numAttrs = 1;
  }
};

// launch_in for a kernel that runs in clusters: a cluster the card cannot
// place is refused here, with the launch's error
template <auto kKernel, class... Args>
cudaError_t launch_cluster_in(const LaunchShape& shape, int bn, int t,
                              cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem<kKernel>(shape.smem);
  if (err != cudaSuccess) return err;
  const ClusterConfig c(shape, shape.grid(bn, t), stream);
  return cudaLaunchKernelEx(&c.config, kKernel, args...);
}

// how many blocks of kKernel in `shape` the current card holds at once
// (its SMs times the blocks an SM holds), or -1 on an error; asked once for
// each device
template <auto kKernel>
int resident_blocks(const LaunchShape& shape) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> known[kMaxDevices];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (device < kMaxDevices) {
    const int blocks = known[device].load(std::memory_order_acquire);
    if (blocks > 0) return blocks;
  }
  int sms = 0, per_sm = 0;
  if (allow_smem<kKernel>(shape.smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kKernel, shape.threads, shape.smem) != cudaSuccess)
    return -1;
  if (device < kMaxDevices && sms * per_sm > 0)
    known[device].store(sms * per_sm, std::memory_order_release);
  return sms * per_sm;
}

// how many clusters of kKernel in `shape` the card can hold at once (0:
// it cannot place one), or -1 on an error
template <auto kKernel>
int max_active_clusters(const LaunchShape& shape) {
  if (allow_smem<kKernel>(shape.smem) != cudaSuccess) return -1;
  const ClusterConfig c(shape, dim3(1, 1, shape.cluster), 0);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, (const void*)kKernel,
                                     &c.config) != cudaSuccess)
    return -1;
  return clusters;
}

}  // namespace flash_tiles
