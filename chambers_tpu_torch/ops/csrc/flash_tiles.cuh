// Device functions for the tensor-core flash attention kernels: bf16 tiles
// in shared memory, the asynchronous copies that fill them, and the matrix
// products over them. flash_attention_fwd.cu (K3a) and
// flash_attention_bwd.cu (K3b, K3c) are built on these; allow_smem, at the
// end, serves the launchers of all three sources.
//
// Tiles. Head size is 64, so a row of q, k, v or do is 128 bytes of bf16. A
// tile is 64 rows, 8 KB, stored [row][h] with the 128-byte swizzle: the
// 16-byte chunk c of row r lies at chunk c ^ (r & 7). Tiles start at
// multiples of 1024 bytes, which makes that the layout wgmma's descriptors
// call B128 (and what TMA's 128-byte swizzle would write). A taller operand
// is tiles one after the other. One layout serves both ways an operand is
// read:
//   along h (K-major)    x . y^T, the reduction runs over a row's 64 values
//   along rows (MN-major) p . y, the reduction runs over the tile's 64 rows
//
// Copies. stage_rows fills a tile with cp.async.cg, 16 bytes a thread, eight
// neighbouring threads to one row (coalesced in device memory, conflict free
// in shared memory). A row past the operand's end is filled with zeros by a
// source size of 0, so the ragged edge needs no padded operand.
//
// Products. Both product functions are one call per warpgroup and leave or
// take a [64 x 64] float32 accumulator spread over its 128 threads in the
// layout of wgmma.m64n64k16 (which four mma.m16n8k16 tiles share): warp w of
// the group holds rows 16 w .. 16 w + 15, and a thread (g = lane / 4,
// t = lane % 4) holds acc[4 j + 0, 1] = (row g, columns 8 j + 2 t, + 1) and
// acc[4 j + 2, 3] = (row g + 8, same columns), j = 0 .. 7. Packed to bf16
// two by two, the accumulator of 16 columns is the A operand of the next
// product in registers (pack_a_fragments), so probabilities never go
// through shared memory.
//   product_nt   acc = X . Y^T, both tiles read from shared memory through
//                descriptors with the B128 layout: four wgmma, one per 16
//                values of h
//   product_tn   acc += A . Y, A in registers, Y read along its rows with
//                the descriptor's transpose bit: four wgmma, one per 16 rows
// wgmma is asynchronous: products_begin() fences the registers before the
// first product of a batch, products_end() commits and waits, and
// keep_registers() pins operands and accumulators until then, so the
// compiler neither reads an accumulator early nor reuses an A register
// while the tensor cores still read it.
//
// store_accumulator sends an accumulator to device memory through a tile
// in shared memory, as coalesced 16-byte stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash_tiles {

constexpr int kHead = 64;                      // head size
constexpr int kRowBytes = kHead * 2;           // 128
constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * kRowBytes;  // 8192
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

// byte offset of 16-byte chunk `chunk` of row `row` from the operand's start
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return (uint32_t)(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
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

// rows [row0, row0 + kRows) of a [rows, 64] bf16 array into the operand at
// shared address `tile`; rows past the end become zeros. A thread copies
// chunk tid % 8 of rows tid / 8 + i * kThreads / 8: that step is a multiple
// of eight rows, so its swizzled chunk stays where it is from copy to copy
// and the addresses are one base plus constants.
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(uint32_t tile,
                                           const __nv_bfloat16* src, int row0,
                                           int rows, int tid) {
  static_assert(kThreads % 64 == 0 && (kRows * 8) % kThreads == 0, "");
  constexpr int kCopies = kRows * 8 / kThreads, kRowStep = kThreads / 8;
  const int r = tid >> 3, c = tid & 7;
  const uint32_t dst = tile + swizzled(r, c);
  const __nv_bfloat16* from = src + (size_t)(row0 + r) * kHead + c * 8;
  if (row0 + kRows <= rows) {
#pragma unroll
    for (int i = 0; i < kCopies; ++i)
      cp_async_16(dst + i * kRowStep * kRowBytes, from + i * kRowStep * kHead);
  } else {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const bool inside = row0 + r + i * kRowStep < rows;
      cp_async_16(dst + i * kRowStep * kRowBytes,
                  inside ? from + i * kRowStep * kHead : src, inside ? 16 : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a [64 x 64] accumulator, rounded to bf16, as the A operand of a product
// over its 64 columns: a[ks] covers columns 16 ks .. 16 ks + 15
__device__ __forceinline__ void pack_a_fragments(const float (&acc)[32],
                                                 uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pack_bf16(acc[8 * ks + 0], acc[8 * ks + 1]);
    a[ks][1] = pack_bf16(acc[8 * ks + 2], acc[8 * ks + 3]);
    a[ks][2] = pack_bf16(acc[8 * ks + 4], acc[8 * ks + 5]);
    a[ks][3] = pack_bf16(acc[8 * ks + 6], acc[8 * ks + 7]);
  }
}

__device__ __forceinline__ void keep_registers(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(x[i])::"memory");
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

// acc = X . Y^T: X the warpgroup's 64 rows at `x_tile`, Y the 64 rows at
// `y_tile`, both read along h
__device__ __forceinline__ void product_nt(float (&acc)[32], uint32_t x_tile,
                                           uint32_t y_tile) {
  const uint64_t dx = descriptor(x_tile), dy = descriptor(y_tile);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    // 16 values of h further on: 32 bytes, 2 in the descriptor's units
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        FLASH_TILES_ACC_LIST ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FLASH_TILES_ACC(acc)
        : "l"(dx + 2 * ks), "l"(dy + 2 * ks), "r"(ks));
  }
}

// acc += A . Y: A [64 x 64] in registers (pack_a_fragments), Y the 64 rows
// at `y_tile` read along its rows (transposed)
__device__ __forceinline__ void product_tn(float (&acc)[32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t y_tile) {
  const uint64_t dy = descriptor(y_tile);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    // 16 rows further on: 2048 bytes, 128 in the descriptor's units
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        FLASH_TILES_ACC_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FLASH_TILES_ACC(acc)
        : "r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]), "r"(a[ks][3]),
          "l"(dy + 128 * ks), "r"(1));
  }
}

// ---------------------------------------------------------------------------
// epilogue
// ---------------------------------------------------------------------------

// A warpgroup's [64 x 64] accumulator times `mul` to rows [row0, row0 + 64)
// of a [rows, 64] bf16 array, by way of a tile in shared memory that only
// this warpgroup uses (`tile`, a generic pointer): fragments hold pairs of
// values, rows of the output are 128 contiguous bytes, so the tile turns 16
// scattered 4-byte stores a thread into 4 coalesced 16-byte ones. The
// swizzle keeps both the fragment stores and the row reads free of bank
// conflicts. `barrier` is a named barrier of the warpgroup's own (1 .. 15).
__device__ __forceinline__ void store_accumulator(
    __nv_bfloat16* dst, uint8_t* tile, const float (&acc)[32], float mul,
    int row0, int rows, int barrier, int thread_in_group) {
  const int lane = thread_in_group & 31, g = lane >> 2, t = lane & 3;
  const int row_a = (thread_in_group >> 5) * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + swizzled(row_a + 8 * half, j) +
                                   4 * t) =
          pack_bf16(acc[4 * j + 2 * half] * mul,
                    acc[4 * j + 2 * half + 1] * mul);
  asm volatile("bar.sync %0, 128;\n" ::"r"(barrier) : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (thread_in_group >> 3) + 16 * i, c = thread_in_group & 7;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * kHead + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swizzled(r, c));
  }
}

// zeros to rows [row0, row0 + 64) of a [rows, 64] bf16 array, by one
// warpgroup
__device__ __forceinline__ void store_zero_rows(__nv_bfloat16* dst, int row0,
                                                int rows,
                                                int thread_in_group) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (thread_in_group >> 3) + 16 * i, c = thread_in_group & 7;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * kHead + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

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

}  // namespace flash_tiles
