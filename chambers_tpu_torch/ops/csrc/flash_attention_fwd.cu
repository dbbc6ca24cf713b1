// The flash attention forward kernel for bf16 and float16 operands, on the
// H100's tensor cores. Third source of the flash_attention library;
// flash_attention.cu holds the C interface, which sends bfloat16 and
// float16 here and float32 to its own FMA kernels.
//
// Replaces the Pallas TPU kernel of chambers_tpu/ops/flash_attention.py:
//   flash_fwd_tc_kernel      <- _flash_forward / _flash_fwd_kernel  (K3a)
//   flash_fwd_short_kernel   the same, at head size 64 over 64 to 256
//                            queries and 1 to 256 keys (ViT lengths)
//   flash_fwd_narrow_kernel  the same, at head size 32 (32-column tiles)
//   flash_fwd_wide_kernel    the same, at head sizes above 256 up to 1152
//   flash_fwd_sliced_kernel  the same, at head sizes above 1152
// and computes what flash_attention.cu's note says it computes: per query
// tile over all key tiles s = q k^T scale with float32 accumulation, a
// running float32 max m, p = exp(s - m) zeroed where masked, l = sum p from
// the unrounded p, p rounded to the operand type before p v, o = acc / l
// once at the end; the [b, tk] key mask shared by a batch item's heads, the
// causal diagonal at the sequence end, exact zeros in o and l and m at the
// mask value for a row with no valid key, any tq and tk, head size 64, 128
// or 256 (one, two or four panels, a template parameter), 32 in the narrow
// kernel and, in the wide and sliced kernels, any multiple of 64 above 256
// (the wrapper pads other sizes). The operand type T (__nv_bfloat16 or __half) is the other
// template parameter: it changes the rounding of p and the output and the
// wgmma instruction's type, nothing else. Returns o (of T) and l, m
// (float32, natural units) for the backward kernels.
//
// Bound: at [128, 512, 64] the forward is two products of
// 128 x 512 x 512 x 64 multiply-adds, 8.6 GFLOP, 8.7 us at the tensor
// cores' 989 TFLOP/s in bf16, and moves q, k, v, o, l, m and the mask,
// 34 MB, 10.2 us at 3.35 TB/s: the two are level. So the products run on
// the tensor cores, the operands arrive while they run, and the softmax
// between the two products has to stay short.
//
// Design (flash_tiles.cuh has the tile layout and the product functions).
// * A block is one warpgroup owning 64 query rows (kGroups). Its Q tile
//   (8 KB a panel) is copied to shared memory once; K and V pass in tiles
//   of 64 rows (16 KB a step a panel) through a ring of kStages = 2 stages
//   filled with
//   cp.async one step ahead of the products, with one __syncthreads a step
//   (after it the step's tile is visible to all and the other stage has
//   been read by all).
// * At head size 128 or 256 the score product runs over all panels (eight
//   or sixteen k16 steps) into one accumulator, and O is two or four
//   [64 x 64] accumulators, one a panel, each fed the same P by its own four
//   wgmma; the rescale, the final division and the epilogue loop over them.
// * Each warpgroup computes S = Q K^T for its 64 rows against the passing
//   64 keys with wgmma (both operands in shared memory), runs the online
//   softmax on the accumulator fragments in registers, rounds p to T and
//   feeds it straight back as the A operand of O += P V, V read along its
//   rows through the descriptor's transpose bit. P never touches shared
//   memory. The row max comes from the thread's 16 values of the row and
//   the 4 lanes of its quad (two shuffles); the rescale factor
//   exp2((m_old - m_new) log2 e) multiplies the O accumulator and the
//   thread's part of l, which the quad sums once at the end; p is one
//   multiply-add and one ex2.approx an element, scale log2 e folded in.
// * Tiles where every pair takes part (all keys kept by the mask, the tile
//   clear of the causal diagonal and of the ragged edge: block-uniform
//   tests) take the plain loop. Other tiles first set masked scores to
//   -inf by a select; exp2 of -inf is 0, so masked elements give exact
//   zeros without a test in the exponent loop. The mask value itself
//   never enters an exponent: -0.7 FLT_MAX times log2 e overflows to -inf,
//   so a row whose max is still the mask value (no valid key so far) takes
//   an offset of 0 instead, and its p, l and o stay exact zeros while m
//   keeps the mask value.
// * Work the mask rules out is not done: the key loop ends at the last key
//   the batch item's mask keeps (trailing padding), tiles with no kept key
//   and, per warpgroup, tiles wholly above the causal diagonal are
//   skipped, and a block that no key reaches writes zeros and reads
//   nothing.
// * o = acc / l leaves through the warpgroup's own Q tile as 16-byte
//   stores; l and m are written once per row. No atomics: results repeat
//   bit for bit.
//
// Occupancy, as built (registers from nvcc's -Xptxas -v report, which
// chip_smoke.py prints): one warpgroup a block (128 threads). Head size 64:
// 106 registers, 42 KB of shared memory: four blocks an SM by registers
// (__launch_bounds__ caps them at 128) and by shared memory; at
// [128, 512, 64] 1024 blocks fill 528 slots in 1.94 rounds. Head size
// 128: O doubles to 64 registers a thread and the tiles to 16 KB a row
// block, 82 KB of shared memory: two blocks an SM by shared memory, and
// __launch_bounds__ lets the registers grow past 128: 139, no spills.
// Head size 256: one warpgroup still holds O, four panels of 32 float32
// registers a thread, 128 of them beside the score tile's 32 and P's 16,
// under the 255 a thread that one block an SM allows (__launch_bounds__
// with 1): no need to split the panels across warpgroups, as K3b must.
// Its tiles take 32 KB a row block, 162 KB of shared memory with the two
// stages: one block an SM.
//
// ViT lengths: flash_fwd_short_kernel. At DeiT-B/16's [1536, 198, 64] the
// design above launched 6144 blocks, a head's four row blocks some 1536
// blocks apart: between them the K and V of every head (78 MB, more than
// the 50 MB L2) streamed past, so each head's K and V came from device
// memory four times, and each block paid a pipeline fill and drain for
// four key steps. Launched with a head's row blocks next to each other the
// same kernel ran in 96.4 us against 139.7 (PERF.md section 6): the
// re-reads cost 43 us, the per-step costs the rest. So here a block holds
// whole heads, one at a time, and walks them persistently (as many blocks
// as the card holds, one an SM; heads blockIdx.x, + gridDim.x, ...):
// * A buffer holds one head's Q (all tq <= 256 rows), K and V (all tk <=
//   256 keys), 32 KB each, in the panel layout flash_tiles.cuh describes,
//   and its 256 key flags (the mask row, or 1 inside the sequence; 0 past
//   it). Two buffers, 195 KB. Q, K and V arrive by TMA (cuTensorMapEncode-
//   Tiled maps of the [bn, t, 64] operands, 128-byte swizzle, boxes of
//   whole 64-row tiles; rows past t arrive as zeros), completing on the
//   buffer's `full` mbarrier: each byte crosses from device memory once.
// * Four warpgroups each own 64 query rows of every head (those past tq
//   sit out). A group waits on the head's `full` barrier, then runs its key
//   tiles out of the resident buffer, in K3a's order and with K3a's
//   arithmetic (product_nt, softmax_tile, product_tn, the same skip rules:
//   each warp finds the last kept key below the group's diagonal and counts
//   a tile's valid keys with two ballots, from the flags), so o, l and m
//   are the bits the design above gives. No copy and no block barrier
//   between key steps. O leaves through the group's own panel of Q, l and
//   m once a row.
// * The sequence's ragged end (a last tile of at most 8 keys: 6 at 198, 5
//   at 197) takes an m64n8 score product, softmax_tile_n8 over those 8
//   columns and one k16 step of P V: the other 56 columns' exponents are
//   exact zeros that add nothing to l, so the bits are the whole tile's.
// * No producer warp: when a group is done with a buffer it fences its
//   shared-memory accesses against the copy engine and counts itself in;
//   the last group of the head refills the buffer with the head two on
//   (its first warp writes the flags and issues the copies), so the next
//   head's copies run while this head's products do.
// 512 threads, 118 registers, one block an SM.
//
// What binds it, as measured on an H100 (compare_flash_builds.py,
// PERF.md section 6): at [1536, 198, 64] bf16 81 us against the whole-tile
// design's 141.6 and SDPA's 88.4; the bytes bound is 47.2 us. With the
// copies only (no products, no softmax) the same pipeline took 55.6 us,
// and with the products and the softmax but no copies after the first two
// heads as long as the whole: the four warpgroups' chains of score
// product, softmax and P V bind it, not device memory. What each part of
// the design is worth, each measured in turns against the design without
// it: with a producer warp instead of the last group's refill (544
// threads, 96 registers a thread) and neither of the next two, 95.1 us;
// the ragged end narrowed (with P V beside the next score product) 88.0;
// P V in a batch of its own after the softmax 81.4 against 88.1 (beside
// the next score product P crossed a branch ptxas cannot prove uniform
// over the warpgroup, and ptxas then waited after every wgmma, warning
// C7520). Tried, and slower: a
// producer warpgroup giving its registers to the consumers by setmaxnreg
// (a block of 640 threads starts at 96 a thread; four groups at 120 need
// more than the producer frees: it hung), Q in registers as the score
// product's A operand (92.2 against 88.1), and the two pairs of groups
// taking turns on the tensor cores by named barriers (93.4 against 89.4).
//
// Head size 32: flash_fwd_narrow_kernel. Padded to 64, K3a did every
// product twice over (half of each operand zeros), copied and held tiles
// twice their size, and the wrapper padded q, k and v and cut o on every
// call. This kernel is the whole-tile design's body (fwd_tile_rows) at
// panels 0, on flash_tiles.cuh's 32-column panels (64-byte rows, the
// 64-byte swizzle, wgmma's B64 descriptors): the score product takes two
// k16 steps (product_nt_panel<T, kNarrowCols>), P V is an m64n32 product
// into 16 float32 registers a thread, and o leaves straight from the
// fragments (store_fragments). Otherwise it is the design above: one
// warpgroup over 64 query rows a block, K and V passing in 64-key tiles of
// 4 KB each through a ring of three stages (stages(0)), one __syncthreads
// a step, K3a's order and arithmetic per tile (softmax_tile, the same skip
// rules), so o, l and m are the padded call's bits: the zero columns only
// added exact zeros to every float32 sum. 80 registers, no spills, 30 KB
// of shared memory: six blocks an SM (blocks_per_sm(0)).
// As measured on an H100 (compare_flash_builds.py --only narrow against
// 247356c, in turns, one call; PERF.md section 6): at [256, 512, 32] bf16
// with the ragged key mask 39.3 us against the padded call's 57.6 (causal
// 29.4 against 42.7), at [1536, 198, 32] 74.6 against 81.0; float16 39.4
// and 74.3. In the call before it, against the same kernel written out on
// its own (before it shared this body): 39.1 against 39.1, 74.2 against
// 74.3, the same bits. The bytes bound is
// 9.12 us; each of a head's row blocks reads the head's K and V again from
// L2, and each block's chain of waits (copy, score product, softmax, P V)
// binds, as in K3b's and K3c's narrow kernels. Tried, and slower: a block
// holding a head's K and V whole (up to 512 keys, copied once) with two
// warpgroups walking the head's row tiles, no copy and no block barrier
// between key steps (the short kernel's recipe at 32 columns): 45.7 us
// against 41.3 at [256, 512, 32] and 81.5 against 74.8 at [1536, 198, 32],
// its groups' serial chains bind; four stages at five blocks an SM 41.0;
// three at seven blocks an SM spill (72 registers) and take twice as long.
//
// Head sizes above 256: flash_fwd_wide_kernel, and above 1152
// flash_fwd_sliced_kernel. The whole-tile design stages
// whole tile rows, which at 256 already take 162 KB of the 227 KB a block
// may have; at 512 one 64-row tile of Q is 64 KB. In the sliced kernel
// (first), a block owns 64 query rows and one slice of kSlicePanels = 4
// panels (256 columns) of O, picked
// by blockIdx.z; the head size is a run-time argument, and one
// instantiation per type serves every multiple of 64. A key step passes
// through a ring of two 32 KB slots as items: the score product's
// operands, Q's and K's panels two at a time, accumulated over the whole
// padded head into one S with wgmma (the chain's first product
// overwrites), then the slice's panels of V, which P, rounded to T,
// multiplies. One item is copied while the one before it is multiplied,
// with one barrier an item. The softmax (softmax_tile, shared with the
// kernel above), the mask rules and the work they rule out are the
// design's above, so the results follow the same semantics; slice 0 writes
// l and m, and O leaves through the first slot once the ring is done. The
// cost: every slice computes S and the softmax again, h / 256 times (at
// 512 the tensor cores do 1.5 times the function's work, at 1024 2.5
// times), and Q's panels are copied again at every key step (from L2).
// 66 KB of shared memory and 236 registers, no spills (O is four panels,
// as at 256): two blocks an SM. ptxas injects a warpgroup.arrive before
// five of its wgmma batches (warning C7519), which run under run-time
// conditions (the slice's panel count, an odd last panel of the head).
// At [16, 512, 512] bf16 with the ragged key mask it took 56.0 us (PERF.md
// section 6), its causal time the same: the call is one wave (256 blocks
// on 132 SMs x 2), and each block moves 160 KB through L2 a key step (Q's
// and K's panels, the slice's V), 320 KB an SM, 5.9 TB/s over the call.
//
// The wide kernel holds a 64-row tile of Q in shared memory for the whole
// call and computes each (row tile, key tile) score product once a block:
// a block is kWideGroups = 2 warpgroups over 64 query rows and a slice of
// kWideSlicePanels = 8 panels (512 columns) of O, four panels a group
// (128 float32 registers of O a thread; one slice up to h 512, two at
// 1024, so there S is computed twice, not four times). K's panels pass two
// at a time as 16 KB items through a ring of kWideSlots = 4 slots (three
// items in flight, one __syncthreads an item); group g multiplies panel
// 2j + g of item j into its own partial S, so each group's chain of k16
// products is half the head; the two partial tiles are swapped thread by
// thread through 16 KB of shared memory and added (S = the even panels'
// sum + the odd panels', the same bits in both groups), and both groups
// run softmax_tile on it, so each holds P and rescales its own panels of
// O. Then V's items: item m carries panel m of each group's share. The
// score sums differ from the sliced kernel's single chain in their last
// bits; the results are held to the plain versions at the card tests'
// tolerances (compare_flash_builds.py --only wide reports the largest
// difference). Shared memory: Q's panels, 64 KB of ring, 16 KB for the
// swap: up to 18 panels (h 1152) fit; 235 registers, no spills, no fences
// injected: one block an SM. As measured on an H100 (compare_flash_builds.py
// against 247356c's sliced kernel, in turns, one call; PERF.md section 6):
// [16, 512, 512] 46.6 us against 54.9 (causal 47.0 against 55.5),
// [16, 512, 1024] 123.4 against 171.9 (causal 113.2 against 156.8);
// float16 46.5 against 54.7 and [16, 512, 1088] 175.2 against 251.8 in
// earlier calls. Its
// copies alone (no products) took 32.5 us at h 512 and its products
// without copies 36.5 (both measured on the one-group form below): the L2
// traffic of 128 KB a key step an SM and the items' chains of waits bind
// together. Tried, and slower: one group computing S over the whole head
// in the sliced kernel's order (the sliced kernel's bits) and handing P
// and the row maxima to the other through shared memory, 52.7 us at 512,
// 149.8 at 1024, 217.1 at 1088; six or eight ring slots level (47.1,
// 46.2 against 47.2).
//
// What holds it back, as measured on an H100 (PERF.md section 6): at
// [128, 512, 64] with the key mask it runs at a third of the bound above
// and in two thirds of F.scaled_dot_product_attention's time. Neither the
// tensor cores nor the exponent bind: with both products or the ex2 taken
// out, most of the time stays, and it grows with the number of key tiles:
// each step's barrier, copies and softmax arithmetic, run by four warps a
// scheduler, too few to hide their latencies; the prologue and epilogue
// of the two rounds of blocks take the smaller share. Tried, and slower or
// level: two or four warpgroups a block sharing the passing tiles, three
// stages with three blocks an SM, five blocks an SM, Q held in registers
// as the A operand of Q K^T, the next tile's Q K^T issued before this
// tile's softmax, two warpgroups taking turns on the tensor cores with the
// last tile's P V issued beside this tile's Q K^T, and the mask read while
// the first copies are in flight.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

using namespace flash_tiles;

// warpgroups a block, blocks an SM the compiler fits the registers to, and
// stages of the ring of passing tiles, by head panels (0: head size 32,
// 32-column tiles)
constexpr int kGroups = 1;
constexpr int blocks_per_sm(int panels) {
  return panels == 0 ? 6 : panels == 1 ? 4 : panels == 2 ? 2 : 1;
}
__host__ __device__ constexpr int stages(int panels) {
  return panels == 0 ? 3 : 2;
}

// a 64-row tile of the head: kPanels panels, or one narrow panel at 0
template <int kPanels>
__host__ __device__ constexpr int fwd_tile_bytes() {
  return kPanels == 0 ? kNarrowTileBytes : tile_bytes<kPanels>();
}

// Q's tiles, the ring (K's and V's tiles and the keys' flags a stage), the
// warps' words of kept_key_end
template <int kPanels>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + kGroups * fwd_tile_bytes<kPanels>() +
         stages(kPanels) * (2 * fwd_tile_bytes<kPanels>() + kTileRows * 4) +
         4 * kGroups * 4;
}

// rows [row0, row0 + kRows) of the operand at `src` into the tile at
// shared address `tile`, in kPanels panels or one narrow panel at 0
template <int kRows, int kThreads, int kPanels, typename T>
__device__ __forceinline__ void stage_tile(uint32_t tile, const T* src,
                                           int row0, int rows, int tid) {
  if constexpr (kPanels == 0)
    stage_narrow_rows<kRows, kThreads>(tile, src, row0, rows, tid);
  else
    stage_rows<kRows, kThreads, kPanels>(tile, src, row0, rows, tid);
}

// One key tile of the online softmax, on a warpgroup's score accumulator
// `s` (its 64 rows against the tile's 64 keys), in place: unless
// `unmasked`, the scores of masked pairs (a key whose `valid` flag is off,
// or past the row's `last_col`) become -inf; then the new row max, the
// rescale of l and of the kAcc O accumulators (kN = 32 values a thread for
// 64 columns, 16 for the narrow kernel's 32), p = exp2(s scale log2 e -
// offset) summed into l, and p rounded to T as the A operand `p` of P V.
template <typename T, int kAcc, int kN>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&acc)[kAcc][kN], float (&m_run)[2],
    float (&l_part)[2], uint32_t (&p)[4][4], const float* valid,
    bool unmasked, int k0, const int (&last_col)[2], int t, float scale,
    float scale2) {
  if (!unmasked) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 key_ok =
          *reinterpret_cast<const float2*>(valid + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t + e;
        const bool col_ok = (e ? key_ok.y : key_ok.x) > 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          s[i] = col_ok && col <= last_col[r] ? s[i] : -INFINITY;
        }
      }
    }
  }

  // the online softmax, by row: new max, rescale of l and the
  // accumulator, and the row's exponent offset
  float offset2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = s[2 * r];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx * scale);
    const float alpha = exp2_fast((m_run[r] - m_new) * kLog2e);
    m_run[r] = m_new;
    offset2[r] = m_new == kMaskValue ? 0.f : m_new * kLog2e;
    l_part[r] *= alpha;
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) {
        acc[a][4 * j + 2 * r] *= alpha;
        acc[a][4 * j + 2 * r + 1] *= alpha;
      }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_fast(fmaf(s[i], scale2, -offset2[r]));
    l_part[r] += s[i];
  }
  pack_a_fragments<T>(s, p);
}

// softmax_tile on a key tile that holds at most 8 keys (the sequence's
// ragged end), whose scores are the [64 x 8] corner `s` of the tile's
// (product_nt_n8): every other score of the tile is masked, so its max is
// the corner's, its exponents are exact zeros that add nothing to l, and
// its probabilities round to zeros in `p`. The same bits as softmax_tile
// on the whole tile, with an eighth of its exponents.
template <typename T>
__device__ __forceinline__ void softmax_tile_n8(
    float (&s)[4], float (&acc)[1][32], float (&m_run)[2],
    float (&l_part)[2], uint32_t (&p)[4][4], const float* valid, int k0,
    const int (&last_col)[2], int t, float scale, float scale2) {
  const float2 key_ok = *reinterpret_cast<const float2*>(valid + 2 * t);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = k0 + 2 * t + e;
    const bool col_ok = (e ? key_ok.y : key_ok.x) > 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      s[2 * r + e] = col_ok && col <= last_col[r] ? s[2 * r + e] : -INFINITY;
  }
  float offset2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = s[2 * r];
    mx = fmaxf(mx, fmaxf(s[2 * r], s[2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx * scale);
    const float alpha = exp2_fast((m_run[r] - m_new) * kLog2e);
    m_run[r] = m_new;
    offset2[r] = m_new == kMaskValue ? 0.f : m_new * kLog2e;
    l_part[r] *= alpha;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[0][4 * j + 2 * r] *= alpha;
      acc[0][4 * j + 2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_fast(fmaf(s[i], scale2, -offset2[r]));
    l_part[r] += s[i];
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[ks][i] = 0u;
  p[0][0] = pack2<T>(s[0], s[1]);
  p[0][1] = pack2<T>(s[2], s[3]);
}

// K3a's whole-tile design (the note at the top), at kPanels panels of 64
// columns or, at 0, one narrow panel of 32 (O one [64 x 32] accumulator)
template <typename T, int kPanels>
__device__ __forceinline__ void fwd_tile_rows(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ kv_mask,
    T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out,
    int tq, int tk, int n_heads, float scale, int causal) {
  constexpr bool kNarrow = kPanels == 0;
  constexpr int kThreads = 128 * kGroups, kOwned = kTileRows * kGroups;
  constexpr int kHd = kNarrow ? kNarrowCols : kPanels * kPanelCols;
  constexpr int kAccs = kNarrow ? 1 : kPanels, kN = kNarrow ? 16 : 32;
  constexpr int kTile = fwd_tile_bytes<kPanels>(), kStageBytes = 2 * kTile,
                kStages = stages(kPanels);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t ring = q_s + kGroups * kTile;
  float* valid_s = reinterpret_cast<float*>(smem + kGroups * kTile +
                                            kStages * kStageBytes);
  int* flags_s = reinterpret_cast<int*>(valid_s + kStages * kTileRows);

  const Lanes at;
  // the thread's warpgroup, and its place in it (with one group a block,
  // known to be 0 and the thread's index)
  const int group = kGroups == 1 ? 0 : at.group;
  const int in_group = kGroups == 1 ? at.tid : at.tid & 127;
  const int bn = blockIdx.x, q0 = blockIdx.y * kOwned;
  const T* kb = k + (size_t)bn * tk * kHd;
  const T* vb = v + (size_t)bn * tk * kHd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;
  const int group_row0 = q0 + group * kTileRows;
  // the thread's two rows: g and g + 8 of its warp's 16
  const int row_a = group_row0 + at.warp_in_group * 16 + at.g;

  // keys past the last row's diagonal take no part, nor keys past the last
  // one the mask keeps (trailing padding)
  const int k_end = kept_key_end<kThreads>(
      mask_row, causal ? min(tk, q0 + kOwned + offset) : tk, at.tid,
      flags_s);
  const int steps = (max(k_end, 0) + kTileRows - 1) / kTileRows;
  float* l_rows = l_out + (size_t)bn * tq;
  float* m_rows = m_out + (size_t)bn * tq;
  T* o_rows = o + (size_t)bn * tq * kHd;

  if (steps == 0) {  // no key reaches the block: zeros, nothing read
    store_zero_rows<kHd>(o_rows, group_row0, tq, in_group);
    const int row = group_row0 + in_group;
    if (in_group < kTileRows && row < tq) {
      l_rows[row] = 0.f;
      m_rows[row] = kMaskValue;
    }
    return;
  }

  stage_tile<kOwned, kThreads, kPanels>(q_s, q + (size_t)bn * tq * kHd, q0,
                                        tq, at.tid);

  auto stage_step = [&](int step) {
    if (step < steps) {
      const int stage = step % kStages, k0 = step * kTileRows;
      const uint32_t k_s = ring + stage * kStageBytes;
      stage_tile<kTileRows, kThreads, kPanels>(k_s, kb, k0, tk, at.tid);
      stage_tile<kTileRows, kThreads, kPanels>(k_s + kTile, vb, k0, tk,
                                               at.tid);
      if (at.tid < kTileRows)  // which keys of the tile take part
        stage_key_flag(valid_s + stage * kTileRows + at.tid, mask_row,
                       k0 + at.tid, tk);
    }
    cp_async_commit();  // an empty group keeps the count of groups in step
  };

  for (int step = 0; step < kStages - 1; ++step) stage_step(step);

  const float scale2 = scale * kLog2e;
  // the last key each of the thread's rows may see
  int last_col[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    last_col[r] = causal ? row_a + 8 * r + offset : tk;

  // O: one [64 x 64] accumulator a panel, or one [64 x 32]
  float acc[kAccs][kN], m_run[2] = {kMaskValue, kMaskValue},
                        l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kAccs; ++p)
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[p][i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    // the barrier also counts the tile's valid keys, each thread reading
    // back the one flag it copied itself
    const int stage = step % kStages, k0 = step * kTileRows;
    const float* valid = valid_s + stage * kTileRows;
    const int n_valid =
        __syncthreads_count(at.tid < kTileRows && valid[at.tid] > 0.f);
    stage_step(step + kStages - 1);

    // by warpgroup: no valid key in the tile, or the tile wholly above the
    // diagonal of the group's last row (with one group a block, k_end has
    // already stopped before such a tile)
    if (n_valid == 0 ||
        (kGroups > 1 && causal && k0 > group_row0 + kTileRows - 1 + offset))
      continue;
    const uint32_t k_s = ring + stage * kStageBytes;
    const uint32_t v_s = k_s + kTile;

    float s[32];
    products_begin();
    if constexpr (kNarrow)
      product_nt_panel<T, kNarrowCols>(s, q_s, k_s, 0);
    else
      product_nt<T, kPanels>(s, q_s + group * kTile, k_s);
    products_end();
    keep_registers(s);

    // not every pair of the tile takes part: masked scores become -inf
    const bool unmasked =
        n_valid == kTileRows &&
        (!causal || k0 + kTileRows - 1 <= group_row0 + offset);
    uint32_t p[4][4];
    softmax_tile<T>(s, acc, m_run, l_part, p, valid, unmasked, k0, last_col,
                    at.t, scale, scale2);

    products_begin();
#pragma unroll
    for (int panel = 0; panel < kAccs; ++panel)
      product_tn<T>(acc[panel], p, v_s + panel * kPanelBytes);
    products_end();
    keep_registers(p);
#pragma unroll
    for (int panel = 0; panel < kAccs; ++panel) keep_registers(acc[panel]);
  }

  // l over the quad, o = acc / l (a row with l == 0 has acc == 0)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l == 0.f ? 1.f : 1.f / l;
    const int row = row_a + 8 * r;
    if (at.t == 0 && row < tq) {
      l_rows[row] = l;
      m_rows[row] = m_run[r];
    }
  }
  // the group's own Q tile is read no more: panel p of O leaves through
  // panel p of it; a narrow O leaves straight from the fragments
#pragma unroll
  for (int p = 0; p < kAccs; ++p) {
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[p][i] *= inv[(i >> 1) & 1];
    if constexpr (kNarrow)
      store_fragments(o_rows, acc[p], 1.f, group_row0, tq, in_group);
    else
      store_accumulator<kHd>(o_rows + p * kPanelCols,
                             smem + group * kTile + p * kPanelBytes,
                             acc[p], 1.f, group_row0, tq, 1 + group,
                             in_group);
  }
}

// K3a at head size 64, 128 or 256
template <typename T, int kPanels>
__global__ void __launch_bounds__(128 * kGroups, blocks_per_sm(kPanels))
    flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ kv_mask,
                        T* __restrict__ o,
                        float* __restrict__ l_out, float* __restrict__ m_out,
                        int tq, int tk, int n_heads, float scale,
                        int causal) {
  fwd_tile_rows<T, kPanels>(q, k, v, kv_mask, o, l_out, m_out, tq, tk,
                            n_heads, scale, causal);
}

// K3a at head size 32: the same design on 32-column tiles
template <typename T>
__global__ void __launch_bounds__(128 * kGroups, blocks_per_sm(0))
    flash_fwd_narrow_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ kv_mask,
                            T* __restrict__ o, float* __restrict__ l_out,
                            float* __restrict__ m_out, int tq, int tk,
                            int n_heads, float scale, int causal) {
  fwd_tile_rows<T, 0>(q, k, v, kv_mask, o, l_out, m_out, tq, tk, n_heads,
                      scale, causal);
}

// ---------------------------------------------------------------------------
// ViT lengths: the short kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kShortRows = 256;  // the most queries or keys a head has
constexpr int kShortGroups = kShortRows / kTileRows;  // warpgroups
constexpr int kShortThreads = 128 * kShortGroups;
constexpr int kHeadBytes = kShortRows * kRowBytes;  // Q, K or V: 32 KB
// a buffer: one head's Q, K and V, then its key flags
constexpr int kBufferBytes = 3 * kHeadBytes + kShortRows * 4;

__host__ __device__ constexpr size_t short_smem_bytes() {
  // two buffers, their two mbarriers and the two counts of groups done
  return 1024 + 2 * kBufferBytes + 2 * 8 + 2 * 4;
}

// K3a at head size 64 when a head's queries (at least a tile's) and keys
// fit in a buffer whole; nothing else takes it
bool takes_short(int panels, int tq, int tk) {
  return panels == 1 && tq >= kTileRows && tq <= kShortRows && tk >= 1 &&
         tk <= kShortRows;
}

// Whether each key of a head takes part, one warp's share: the mask's
// value (the batch item's row), or without a mask 1 inside the sequence;
// 0 past tk.
__device__ __forceinline__ void read_key_flags(
    float (&keep)[kShortRows / 32], const float* kv_mask, int head,
    int n_heads, int tk, int lane) {
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(head / n_heads) * tk : nullptr;
#pragma unroll
  for (int i = 0; i < kShortRows / 32; ++i) {
    const int col = lane + 32 * i;
    keep[i] = col < tk ? (mask_row ? mask_row[col] : 1.f) : 0.f;
  }
}

// One warp fills the buffer at `buf` with a head: its key flags (`keep`,
// read_key_flags), then its Q, K and V by TMA. All 32 lanes arrive on the
// buffer's barrier `full` (lane 0 with the copies' bytes), so the phase
// completes once the flags are written and the copies have landed.
__device__ __forceinline__ void load_head(
    uint8_t* buf, uint32_t full, const float (&keep)[kShortRows / 32],
    const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, int head, uint32_t bytes, int lane) {
  float* flags = reinterpret_cast<float*>(buf + 3 * kHeadBytes);
#pragma unroll
  for (int i = 0; i < kShortRows / 32; ++i) flags[lane + 32 * i] = keep[i];
  if (lane == 0) {
    mbar_arrive_expect(full, bytes);
    const uint32_t dst = smem_u32(buf);
    tma_load_head(dst, q_map, head, full);
    tma_load_head(dst + kHeadBytes, k_map, head, full);
    tma_load_head(dst + 2 * kHeadBytes, v_map, head, full);
  } else {
    mbar_arrive(full);
  }
}

// A tile's score product s = Q K^T, over the whole tile or (4 registers)
// its first 8 keys, then P V once the softmax has made P: each one batch
// of straight-line products for the tensor cores, so that they run back to
// back (ptxas waits after each wgmma that a register operand reaches
// across a branch it cannot prove warpgroup-uniform: P V issued with the
// next tile's score product ran 5% slower than this, serialised)
template <typename T, int kS>
__device__ __forceinline__ void short_scores(float (&s)[kS], uint32_t q_s,
                                             uint32_t k_tile) {
  products_begin();
  if constexpr (kS == 4)
    product_nt_n8<T>(s, q_s, k_tile);
  else
    product_nt<T, 1>(s, q_s, k_tile);
  products_end();
  keep_registers(s);
}

template <typename T, int kSteps>
__device__ __forceinline__ void short_pv(float (&acc)[32],
                                         uint32_t (&p)[4][4],
                                         uint32_t v_tile) {
  products_begin();
  product_tn<T, kSteps>(acc, p, v_tile);
  products_end();
  keep_registers(p);
  keep_registers(acc);
}

template <typename T>
__global__ void __launch_bounds__(kShortThreads, 1)
    flash_fwd_short_kernel(__grid_constant__ const CUtensorMap q_map,
                           __grid_constant__ const CUtensorMap k_map,
                           __grid_constant__ const CUtensorMap v_map,
                           const float* __restrict__ kv_mask,
                           T* __restrict__ o, float* __restrict__ l_out,
                           float* __restrict__ m_out, int bn, int tq, int tk,
                           int n_heads, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  // full[b]: buffer b holds its head (a warp's arrivals and the copies'
  // bytes); done[b]: the groups that have finished with it
  const uint32_t full0 = smem_u32(smem + 2 * kBufferBytes);
  int* done = reinterpret_cast<int*>(smem + 2 * kBufferBytes + 2 * 8);
  const int groups = (tq + kTileRows - 1) / kTileRows;  // with query rows
  const uint32_t bytes =
      (groups + 2 * ((tk + kTileRows - 1) / kTileRows)) * kPanelBytes;
  const Lanes at;
  if (at.tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(full0 + 8 * b, 32);
      done[b] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (at.tid < 32) {  // the block's first two heads
    for (int b = 0; b < 2; ++b) {
      const int head = blockIdx.x + b * gridDim.x;
      if (head >= bn) break;
      float keep[kShortRows / 32];
      read_key_flags(keep, kv_mask, head, n_heads, tk, at.lane);
      load_head(smem + b * kBufferBytes, full0 + 8 * b, keep, &q_map, &k_map,
                &v_map, head, bytes, at.lane);
    }
  }
  if (at.group >= groups) return;  // no query rows for this warpgroup

  // a consumer warpgroup: its 64 query rows of every head, the key tiles
  // in K3a's order out of the resident buffer
  const int in_group = at.tid & 127;
  const int group_row0 = at.group * kTileRows;
  const int row_a = group_row0 + at.warp_in_group * 16 + at.g;
  const int offset = tk - tq;
  const float scale2 = scale * kLog2e;
  int last_col[2];  // the last key each of the thread's rows may see
#pragma unroll
  for (int r = 0; r < 2; ++r)
    last_col[r] = causal ? row_a + 8 * r + offset : tk;
  // keys past the last row's diagonal take no part
  const int k_limit =
      causal ? min(tk, group_row0 + kTileRows + offset) : tk;

  for (int head = blockIdx.x, j = 0; head < bn; head += gridDim.x, ++j) {
    const int b = j & 1;
    uint8_t* buf = smem + b * kBufferBytes;
    const uint32_t q_s = smem_u32(buf) + at.group * kPanelBytes;
    const uint32_t k_s = smem_u32(buf) + kHeadBytes;
    const uint32_t v_s = k_s + kHeadBytes;
    const float* flags = reinterpret_cast<const float*>(buf + 3 * kHeadBytes);
    float* l_rows = l_out + (size_t)head * tq;
    float* m_rows = m_out + (size_t)head * tq;
    T* o_rows = o + (size_t)head * tq * kPanelCols;
    mbar_wait(full0 + 8 * b, (j >> 1) & 1);

    // nor keys past the last one the mask keeps (trailing padding): each
    // warp finds the same end on its own
    int last = -1;
    for (int col = at.lane; col < k_limit; col += 32)
      if (flags[col] > 0.f) last = col;
    last = __reduce_max_sync(0xffffffffu, last);
    const int steps = (last + kTileRows) / kTileRows;

    if (steps == 0) {  // no key reaches the group: zeros
      store_zero_rows<kPanelCols>(o_rows, group_row0, tq, in_group);
      const int row = group_row0 + in_group;
      if (in_group < kTileRows && row < tq) {
        l_rows[row] = 0.f;
        m_rows[row] = kMaskValue;
      }
    } else {
      float acc[1][32], m_run[2] = {kMaskValue, kMaskValue},
                        l_part[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[0][i] = 0.f;
      for (int step = 0; step < steps; ++step) {
        const int k0 = step * kTileRows;
        const float* valid = flags + k0;
        const int n_valid =
            __popc(__ballot_sync(0xffffffffu, valid[at.lane] > 0.f)) +
            __popc(__ballot_sync(0xffffffffu, valid[32 + at.lane] > 0.f));
        // no valid key in the tile, or the tile wholly above the diagonal
        // of the group's last row
        if (n_valid == 0 ||
            (causal && k0 > group_row0 + kTileRows - 1 + offset))
          continue;

        const uint32_t k_tile = k_s + step * kPanelBytes;
        const uint32_t v_tile = v_s + step * kPanelBytes;
        uint32_t p[4][4];
        if (tk - k0 <= 8) {
          // the sequence's ragged end: at most 8 keys, an [64 x 8] score
          // product and one k16 step of P V
          float s[4];
          short_scores<T>(s, q_s, k_tile);
          softmax_tile_n8<T>(s, acc, m_run, l_part, p, valid, k0, last_col,
                             at.t, scale, scale2);
          short_pv<T, 1>(acc[0], p, v_tile);
        } else {
          float s[32];
          short_scores<T>(s, q_s, k_tile);
          const bool unmasked =
              n_valid == kTileRows &&
              (!causal || k0 + kTileRows - 1 <= group_row0 + offset);
          softmax_tile<T>(s, acc, m_run, l_part, p, valid, unmasked, k0,
                          last_col, at.t, scale, scale2);
          short_pv<T, 4>(acc[0], p, v_tile);
        }
      }

      // l over the quad, o = acc / l (a row with l == 0 has acc == 0)
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_part[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = l == 0.f ? 1.f : 1.f / l;
        const int row = row_a + 8 * r;
        if (at.t == 0 && row < tq) {
          l_rows[row] = l;
          m_rows[row] = m_run[r];
        }
      }
      // the group's panel of Q is read no more: O leaves through it
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[0][i] *= inv[(i >> 1) & 1];
      store_accumulator<kPanelCols>(o_rows, buf + at.group * kPanelBytes,
                                    acc[0], 1.f, group_row0, tq,
                                    1 + at.group, in_group);
    }
    // done with the buffer: the last group to finish it fills it with the
    // head two on (its first warp)
    fence_async_shared();  // this thread's accesses before the copies
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + at.group) : "memory");
    const int next = head + 2 * gridDim.x;
    if (at.warp_in_group == 0) {
      int last = 0;
      if (at.lane == 0) {
        __threadfence_block();
        last = atomicAdd(done + b, 1) == groups - 1;
        if (last) done[b] = 0;
        __threadfence_block();
      }
      if (__shfl_sync(0xffffffffu, last, 0) && next < bn) {
        float keep[kShortRows / 32];
        read_key_flags(keep, kv_mask, next, n_heads, tk, at.lane);
        load_head(buf, full0 + 8 * b, keep, &q_map, &k_map, &v_map, next,
                  bytes, at.lane);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// head sizes above 256: the sliced kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kSlicePanels = 4;  // panels of O a block: 256 columns

__host__ __device__ constexpr size_t sliced_smem_bytes() {
  return 1024 + kSlots * (kSlotBytes + kTileRows * 4) + 4 * 4;
}

// Head sizes above 256 where Q's 64-row tile fits in shared memory beside
// the ring: the wide kernel (see the note at the top). A block is
// kWideGroups warpgroups over 64 query rows and one slice of
// kWideSlicePanels panels of O, kSlicePanels of them a group; K's and V's
// panels pass by two at a time through a ring of kWideSlots items.
constexpr int kWideGroups = 2;
constexpr int kWideThreads = 128 * kWideGroups;
constexpr int kWideSlicePanels = kWideGroups * kSlicePanels;  // 512 columns
constexpr int kWideSlots = 4;
constexpr int kWideSlotBytes = 2 * kPanelBytes;
constexpr size_t kBlockSmem = 232448;  // the most a block may have (sm_90)

// Q's panels, the ring, two steps' key flags, the partial score tile the
// groups swap, the warps' words of kept_key_end
__host__ __device__ constexpr size_t wide_smem_bytes(int panels) {
  return 1024 + (size_t)panels * kPanelBytes + kWideSlots * kWideSlotBytes +
         2 * kTileRows * 4 + 32 * 128 * 4 + kWideThreads / 32 * 4;
}

// K3a above 4 panels on the wide kernel (else the sliced kernel)
bool takes_wide(int panels) {
  return panels > 4 && wide_smem_bytes(panels) <= kBlockSmem;
}

LaunchShape wide_shape(int panels) {
  return {kWideThreads, wide_smem_bytes(panels), kTileRows,
          (panels + kWideSlicePanels - 1) / kWideSlicePanels};
}

// K3a's launch at `panels` panels: the narrow kernel at 0 (head size 32),
// the whole-tile kernel at 1, 2 or 4, the wide or the sliced kernel above 4
LaunchShape fwd_shape(int panels) {
  if (takes_wide(panels)) return wide_shape(panels);
  if (panels > 4)
    return {128, sliced_smem_bytes(), kTileRows,
            (panels + kSlicePanels - 1) / kSlicePanels};
  return {128 * kGroups,
          panels == 0   ? smem_bytes<0>()
          : panels == 1 ? smem_bytes<1>()
          : panels == 2 ? smem_bytes<2>()
                        : smem_bytes<4>(),
          kGroups * kTileRows, 1};
}

template <typename T>
__global__ void __launch_bounds__(128, 1)
    flash_fwd_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ kv_mask,
                            T* __restrict__ o, float* __restrict__ l_out,
                            float* __restrict__ m_out, int tq, int tk,
                            int hd, int n_heads, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);
  float* valid_s = reinterpret_cast<float*>(smem + kSlots * kSlotBytes);
  int* flags_s = reinterpret_cast<int*>(valid_s + kSlots * kTileRows);

  const Lanes at;
  const int panels = hd / kPanelCols;
  const int panel0 = blockIdx.z * kSlicePanels;
  const int own = min(kSlicePanels, panels - panel0);  // the slice's panels
  const int bn = blockIdx.x, q0 = blockIdx.y * kTileRows;
  const T* qb = q + (size_t)bn * tq * hd;
  const T* kb = k + (size_t)bn * tk * hd;
  const T* vb = v + (size_t)bn * tk * hd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;
  // the thread's two rows: g and g + 8 of its warp's 16
  const int row_a = q0 + at.warp_in_group * 16 + at.g;

  // keys past the last row's diagonal take no part, nor keys past the last
  // one the mask keeps (trailing padding)
  const int k_end = kept_key_end<128>(
      mask_row, causal ? min(tk, q0 + kTileRows + offset) : tk, at.tid,
      flags_s);
  const int steps = (max(k_end, 0) + kTileRows - 1) / kTileRows;
  float* l_rows = l_out + (size_t)bn * tq;
  float* m_rows = m_out + (size_t)bn * tq;
  T* o_cols = o + (size_t)bn * tq * hd + panel0 * kPanelCols;

  if (steps == 0) {  // no key reaches the block: zeros, nothing read
    for (int p = 0; p < own; ++p)
      store_zero_panel(o_cols + p * kPanelCols, q0, tq, hd, at.tid);
    const int row = q0 + at.tid;
    if (blockIdx.z == 0 && at.tid < kTileRows && row < tq) {
      l_rows[row] = 0.f;
      m_rows[row] = kMaskValue;
    }
    return;
  }

  // A key step is `items` items through the ring: the score product's
  // operands, Q's and K's panels two at a time, then the slice's panels of
  // V. The first item of a step also copies the tile's key flags.
  const int score_items = (panels + 1) / 2, items = score_items + 1;
  const int total = steps * items;
  auto stage_item = [&](int i) {
    if (i < total) {
      const int step = i / items, j = i - step * items;
      const int k0 = step * kTileRows;
      const uint32_t slot = ring + (i % kSlots) * kSlotBytes;
      if (j < score_items) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 2 * j + e;
          if (p < panels) {
            stage_panel<128>(slot + e * kPanelBytes, qb + p * kPanelCols, q0,
                             tq, hd, at.tid);
            stage_panel<128>(slot + (2 + e) * kPanelBytes,
                             kb + p * kPanelCols, k0, tk, hd, at.tid);
          }
        }
        if (j == 0 && at.tid < kTileRows)  // which keys take part
          stage_key_flag(valid_s + (step % 2) * kTileRows + at.tid, mask_row,
                         k0 + at.tid, tk);
      } else {
#pragma unroll
        for (int p = 0; p < kSlicePanels; ++p)
          if (p < own)
            stage_panel<128>(slot + p * kPanelBytes,
                             vb + (panel0 + p) * kPanelCols, k0, tk, hd,
                             at.tid);
      }
    }
    cp_async_commit();  // an empty group keeps the count of groups in step
  };

  stage_item(0);
  const float scale2 = scale * kLog2e;
  int last_col[2];  // the last key each of the thread's rows may see
#pragma unroll
  for (int r = 0; r < 2; ++r)
    last_col[r] = causal ? row_a + 8 * r + offset : tk;

  // S over the whole head, O one [64 x 64] accumulator a panel of the slice
  float s[32], acc[kSlicePanels][32], m_run[2] = {kMaskValue, kMaskValue},
                                      l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kSlicePanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  uint32_t p_frag[4][4];
  int n_valid = 0;

  for (int i = 0; i < total; ++i) {
    const int step = i / items, j = i - step * items;
    const int k0 = step * kTileRows;
    const float* valid = valid_s + (step % 2) * kTileRows;
    // one item in flight: wait for it, then one barrier (the item visible
    // to all, the other slot read by all), which at a step's first item
    // also counts the tile's valid keys
    cp_async_wait<0>();
    if (j == 0)
      n_valid = __syncthreads_count(at.tid < kTileRows && valid[at.tid] > 0.f);
    else
      __syncthreads();
    stage_item(i + 1);
    if (n_valid == 0) continue;  // no valid key in the step's tile
    const uint32_t slot = ring + (i % kSlots) * kSlotBytes;

    if (j < score_items) {
      products_begin();
      product_nt_panel<T>(s, slot, slot + 2 * kPanelBytes, 8 * j);
      if (2 * j + 1 < panels)
        product_nt_panel<T>(s, slot + kPanelBytes, slot + 3 * kPanelBytes,
                            8 * j + 4);
      products_end();
      keep_registers(s);
      if (j == score_items - 1) {  // S is whole: the softmax
        const bool unmasked =
            n_valid == kTileRows &&
            (!causal || k0 + kTileRows - 1 <= q0 + offset);
        softmax_tile<T>(s, acc, m_run, l_part, p_frag, valid, unmasked, k0,
                        last_col, at.t, scale, scale2);
      }
    } else {
      products_begin();
#pragma unroll
      for (int p = 0; p < kSlicePanels; ++p)
        if (p < own) product_tn<T>(acc[p], p_frag, slot + p * kPanelBytes);
      products_end();
      keep_registers(p_frag);
#pragma unroll
      for (int p = 0; p < kSlicePanels; ++p) keep_registers(acc[p]);
    }
  }

  // l over the quad, o = acc / l (a row with l == 0 has acc == 0)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l == 0.f ? 1.f : 1.f / l;
    const int row = row_a + 8 * r;
    if (blockIdx.z == 0 && at.t == 0 && row < tq) {
      l_rows[row] = l;
      m_rows[row] = m_run[r];
    }
  }
  // the ring is read no more: panel p of the slice leaves through panel p
  // of the first slot
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kSlicePanels; ++p) {
    if (p < own) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= inv[(i >> 1) & 1];
      store_panel(o_cols + p * kPanelCols, smem + p * kPanelBytes, acc[p],
                  1.f, q0, tq, hd, 1, at.tid);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ kv_mask,
                          T* __restrict__ o, float* __restrict__ l_out,
                          float* __restrict__ m_out, int tq, int tk, int hd,
                          int n_heads, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int panels = hd / kPanelCols;
  const uint32_t q_s = smem_u32(smem);
  const uint32_t ring = q_s + panels * kPanelBytes;
  float* valid_s = reinterpret_cast<float*>(
      smem + panels * kPanelBytes + kWideSlots * kWideSlotBytes);
  // the partial score tile the groups swap, [value][thread of the group]
  float* swap_s = valid_s + 2 * kTileRows;
  int* flags_s = reinterpret_cast<int*>(swap_s + 32 * 128);

  const Lanes at;
  const int in_group = at.tid & 127;
  const int panel0 = blockIdx.z * kWideSlicePanels;
  const int slice = min(kWideSlicePanels, panels - panel0);
  // the group's panels of O: kSlicePanels from panel0 + kSlicePanels group
  const int own = max(0, min(kSlicePanels, slice - at.group * kSlicePanels));
  const int bn = blockIdx.x, q0 = blockIdx.y * kTileRows;
  const T* qb = q + (size_t)bn * tq * hd;
  const T* kb = k + (size_t)bn * tk * hd;
  const T* vb = v + (size_t)bn * tk * hd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;
  // the thread's two rows: g and g + 8 of its warp's 16
  const int row_a = q0 + at.warp_in_group * 16 + at.g;

  // keys past the last row's diagonal take no part, nor keys past the last
  // one the mask keeps (trailing padding)
  const int k_end = kept_key_end<kWideThreads>(
      mask_row, causal ? min(tk, q0 + kTileRows + offset) : tk, at.tid,
      flags_s);
  const int steps = (max(k_end, 0) + kTileRows - 1) / kTileRows;
  float* l_rows = l_out + (size_t)bn * tq;
  float* m_rows = m_out + (size_t)bn * tq;
  T* o_cols = o + (size_t)bn * tq * hd + panel0 * kPanelCols;

  if (steps == 0) {  // no key reaches the block: zeros, nothing read
    for (int p = at.group; p < slice; p += kWideGroups)
      store_zero_panel(o_cols + p * kPanelCols, q0, tq, hd, in_group);
    const int row = q0 + at.tid;
    if (blockIdx.z == 0 && at.tid < kTileRows && row < tq) {
      l_rows[row] = 0.f;
      m_rows[row] = kMaskValue;
    }
    return;
  }

  // Q's panels, once, with the first item
  for (int p = 0; p < panels; ++p)
    stage_panel<kWideThreads>(q_s + p * kPanelBytes, qb + p * kPanelCols,
                              q0, tq, hd, at.tid);

  // A key step is `items` items through the ring: K's panels two at a
  // time (group g multiplies the item's panel g), then V's, panel m of each
  // group's share in item m. The first item of a step also copies the
  // tile's key flags.
  const int score_items = (panels + 1) / 2;
  const int v_items = min(kSlicePanels, slice);  // group 0's share, the most
  const int items = score_items + v_items, total = steps * items;
  auto stage_item = [&](int i) {
    if (i < total) {
      const int step = i / items, j = i - step * items;
      const int k0 = step * kTileRows;
      const uint32_t slot = ring + (i % kWideSlots) * kWideSlotBytes;
      if (j < score_items) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (2 * j + e < panels)
            stage_panel<kWideThreads>(slot + e * kPanelBytes,
                                      kb + (2 * j + e) * kPanelCols, k0, tk,
                                      hd, at.tid);
        if (j == 0 && at.tid < kTileRows)  // which keys take part
          stage_key_flag(valid_s + (step % 2) * kTileRows + at.tid, mask_row,
                         k0 + at.tid, tk);
      } else {
        const int m = j - score_items;
#pragma unroll
        for (int e = 0; e < kWideGroups; ++e)
          if (e * kSlicePanels + m < slice)
            stage_panel<kWideThreads>(
                slot + e * kPanelBytes,
                vb + (panel0 + e * kSlicePanels + m) * kPanelCols, k0, tk,
                hd, at.tid);
      }
    }
    cp_async_commit();  // an empty group keeps the count of groups in step
  };
  for (int i = 0; i < kWideSlots - 1; ++i) stage_item(i);

  const float scale2 = scale * kLog2e;
  int last_col[2];  // the last key each of the thread's rows may see
#pragma unroll
  for (int r = 0; r < 2; ++r)
    last_col[r] = causal ? row_a + 8 * r + offset : tk;

  // S (group 0 over the even panels of the head, group 1 over the odd
  // ones, then the sum), O one [64 x 64] accumulator a panel of the group's
  // share
  float s[32], acc[kSlicePanels][32], m_run[2] = {kMaskValue, kMaskValue},
                                      l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kSlicePanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  uint32_t p_frag[4][4];

  // the next item: wait for it, then one barrier (the item visible to all,
  // the slot the next copy fills read by all), which at a step's first
  // item also counts the tile's valid keys
  int item = 0, n_valid = 0;
  auto next_item = [&](bool first) {
    cp_async_wait<kWideSlots - 2>();
    if (first)
      n_valid = __syncthreads_count(
          at.tid < kTileRows &&
          valid_s[((item / items) % 2) * kTileRows + at.tid] > 0.f);
    else
      __syncthreads();
    stage_item(item + kWideSlots - 1);
    return ring + (item++ % kWideSlots) * kWideSlotBytes;
  };

  for (int step = 0; step < steps; ++step) {
    const int k0 = step * kTileRows;
    const float* valid = valid_s + (step % 2) * kTileRows;
    for (int j = 0; j < score_items; ++j) {
      const uint32_t slot = next_item(j == 0);
      const int p = 2 * j + at.group;  // the group's panel of the item
      if (n_valid == 0 || p >= panels) continue;
      products_begin();
      product_nt_panel<T>(s, q_s + p * kPanelBytes,
                          slot + at.group * kPanelBytes, 4 * j);
      products_end();
      keep_registers(s);
    }
    if (n_valid != 0) {
      // S = the even panels' sum + the odd panels': the groups swap their
      // partial tiles thread by thread through one buffer (group 1's in,
      // then group 0's in its place), and each adds the two
      float* swap = swap_s + in_group;
      if (at.group == 1)
#pragma unroll
        for (int i = 0; i < 32; ++i) swap[128 * i] = s[i];
      __syncthreads();
      if (at.group == 0)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float odd = swap[128 * i];
          swap[128 * i] = s[i];
          s[i] += odd;
        }
      __syncthreads();
      if (at.group == 1)
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] += swap[128 * i];
      // S is whole: the softmax, the same in both groups
      const bool unmasked =
          n_valid == kTileRows &&
          (!causal || k0 + kTileRows - 1 <= q0 + offset);
      softmax_tile<T>(s, acc, m_run, l_part, p_frag, valid, unmasked, k0,
                      last_col, at.t, scale, scale2);
    }
#pragma unroll
    for (int m = 0; m < kSlicePanels; ++m) {
      if (m >= v_items) break;
      const uint32_t slot = next_item(false);
      if (n_valid == 0) continue;
      if (m < own) {
        products_begin();
        product_tn<T>(acc[m], p_frag, slot + at.group * kPanelBytes);
        products_end();
        keep_registers(p_frag);
        keep_registers(acc[m]);
      }
    }
  }
  cp_async_wait<0>();

  // l over the quad, o = acc / l (a row with l == 0 has acc == 0); group
  // 0 of the first slice writes l and m
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l == 0.f ? 1.f : 1.f / l;
    const int row = row_a + 8 * r;
    if (blockIdx.z == 0 && at.group == 0 && at.t == 0 && row < tq) {
      l_rows[row] = l;
      m_rows[row] = m_run[r];
    }
  }
  __syncthreads();  // Q and the ring are read no more
  // panel a of the group's share leaves through panel (4 group + a) of
  // shared memory
#pragma unroll
  for (int a = 0; a < kSlicePanels; ++a) {
    if (a < own) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= inv[(i >> 1) & 1];
      const int p = at.group * kSlicePanels + a;
      store_panel(o_cols + p * kPanelCols, smem + p * kPanelBytes, acc[a],
                  1.f, q0, tq, hd, 1 + at.group, in_group);
    }
  }
}

// the whole-tile kernel at kPanels panels (0: the narrow kernel)
template <typename T, int kPanels>
constexpr auto tile_kernel() {
  if constexpr (kPanels == 0)
    return flash_fwd_narrow_kernel<T>;
  else
    return flash_fwd_tc_kernel<T, kPanels>;
}

template <typename T, int kPanels>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* o, void* l, void* m, int bn,
                   int tq, int tk, int n_heads, float scale, int causal,
                   cudaStream_t stream) {
  return launch_in<tile_kernel<T, kPanels>()>(
      fwd_shape(kPanels), bn, tq, stream, (const T*)q, (const T*)k,
      (const T*)v, (const float*)kv_mask, (T*)o, (float*)l, (float*)m, tq,
      tk, n_heads, scale, causal);
}

template <typename T>
cudaError_t launch_sliced(int hd, const void* q, const void* k,
                          const void* v, const void* kv_mask, void* o,
                          void* l, void* m, int bn, int tq, int tk,
                          int n_heads, float scale, int causal,
                          cudaStream_t stream) {
  return launch_in<flash_fwd_sliced_kernel<T>>(
      fwd_shape(hd / kPanelCols), bn, tq, stream, (const T*)q, (const T*)k,
      (const T*)v, (const float*)kv_mask, (T*)o, (float*)l, (float*)m, tq,
      tk, hd, n_heads, scale, causal);
}

// the wide kernel's shared memory depends on the head size: it is allowed
// the most a block may have once, before its first launch or query
template <typename T>
cudaError_t launch_wide(int hd, const void* q, const void* k, const void* v,
                        const void* kv_mask, void* o, void* l, void* m,
                        int bn, int tq, int tk, int n_heads, float scale,
                        int causal, cudaStream_t stream) {
  const cudaError_t err = allow_smem<flash_fwd_wide_kernel<T>>(kBlockSmem);
  if (err != cudaSuccess) return err;
  return launch_in<flash_fwd_wide_kernel<T>>(
      wide_shape(hd / kPanelCols), bn, tq, stream, (const T*)q, (const T*)k,
      (const T*)v, (const float*)kv_mask, (T*)o, (float*)l, (float*)m, tq,
      tk, hd, n_heads, scale, causal);
}

LaunchShape short_shape() {
  return {kShortThreads, short_smem_bytes(), kShortRows, 1};
}

// the short kernel, persistent: as many blocks as the card holds, each
// walking the heads blockIdx.x, + gridDim.x, ...
template <typename T>
cudaError_t launch_short(const void* q, const void* k, const void* v,
                         const void* kv_mask, void* o, void* l, void* m,
                         int bn, int tq, int tk, int n_heads, float scale,
                         int causal, cudaStream_t stream) {
  // a copy brings whole tiles: rows past the sequence arrive as zeros
  const auto box_rows = [](int t) {
    return (t + kTileRows - 1) / kTileRows * kTileRows;
  };
  CUtensorMap maps[3];
  cudaError_t err = head_map<T>(&maps[0], q, bn, tq, box_rows(tq));
  if (err == cudaSuccess)
    err = head_map<T>(&maps[1], k, bn, tk, box_rows(tk));
  if (err == cudaSuccess)
    err = head_map<T>(&maps[2], v, bn, tk, box_rows(tk));
  if (err != cudaSuccess) return err;
  const LaunchShape shape = short_shape();
  const int blocks = resident_blocks<flash_fwd_short_kernel<T>>(shape);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  flash_fwd_short_kernel<T><<<bn < blocks ? bn : blocks, shape.threads,
                              shape.smem, stream>>>(
      maps[0], maps[1], maps[2], (const float*)kv_mask, (T*)o, (float*)l,
      (float*)m, bn, tq, tk, n_heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_panels(int panels, const void* q, const void* k,
                          const void* v, const void* kv_mask, void* o,
                          void* l, void* m, int bn, int tq, int tk,
                          int n_heads, float scale, int causal,
                          cudaStream_t stream) {
  if (takes_short(panels, tq, tk))
    return launch_short<T>(q, k, v, kv_mask, o, l, m, bn, tq, tk, n_heads,
                           scale, causal, stream);
  if (panels == 0)
    return launch<T, 0>(q, k, v, kv_mask, o, l, m, bn, tq, tk, n_heads,
                        scale, causal, stream);
  if (panels == 1)
    return launch<T, 1>(q, k, v, kv_mask, o, l, m, bn, tq, tk, n_heads,
                        scale, causal, stream);
  if (panels == 2)
    return launch<T, 2>(q, k, v, kv_mask, o, l, m, bn, tq, tk, n_heads,
                        scale, causal, stream);
  if (panels == 4)
    return launch<T, 4>(q, k, v, kv_mask, o, l, m, bn, tq, tk, n_heads,
                        scale, causal, stream);
  if (takes_wide(panels))
    return launch_wide<T>(panels * kPanelCols, q, k, v, kv_mask, o, l, m,
                          bn, tq, tk, n_heads, scale, causal, stream);
  if (panels > 4)
    return launch_sliced<T>(panels * kPanelCols, q, k, v, kv_mask, o, l, m,
                            bn, tq, tk, n_heads, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// f16: float16 operands (else bfloat16); panels: the head size over 64, 0
// (head size 32, the narrow kernel), 1, 2, 4 or any count above 4 (the
// wide kernel, or the sliced kernel where Q's tile does not fit)
cudaError_t flash_fwd_tc(int f16, int panels, const void* q, const void* k,
                         const void* v, const void* kv_mask, void* o, void* l,
                         void* m, int bn, int tq, int tk, int n_heads,
                         float scale, int causal, cudaStream_t stream) {
  if (f16)
    return launch_panels<__half>(panels, q, k, v, kv_mask, o, l, m, bn, tq,
                                 tk, n_heads, scale, causal, stream);
  return launch_panels<__nv_bfloat16>(panels, q, k, v, kv_mask, o, l, m, bn,
                                      tq, tk, n_heads, scale, causal, stream);
}

// K3a's kernel for a call at `panels` panels and these lengths (0 the
// whole-tile kernel, 1 the short kernel, 2 the sliced kernel, 3 the narrow
// kernel, 4 the wide kernel), its launch shape, and the blocks of it the
// current card holds at once (or -1)
int flash_fwd_tc_kernel_of(int panels, int tq, int tk) {
  return takes_short(panels, tq, tk) ? 1
         : takes_wide(panels)        ? 4
         : panels > 4                ? 2
         : panels == 0               ? 3
                                     : 0;
}

flash_tiles::LaunchShape flash_fwd_tc_shape(int panels, int tq, int tk) {
  return takes_short(panels, tq, tk) ? short_shape() : fwd_shape(panels);
}

int flash_fwd_tc_resident(int f16, int panels, int tq, int tk) {
  using flash_tiles::resident_blocks;
  const flash_tiles::LaunchShape shape = flash_fwd_tc_shape(panels, tq, tk);
  // one block an SM at every wide size: allowed the most shared memory
  // first, as its launcher allows it
  if (takes_wide(panels) &&
      (flash_tiles::allow_smem<flash_fwd_wide_kernel<__nv_bfloat16>>(
           kBlockSmem) != cudaSuccess ||
       flash_tiles::allow_smem<flash_fwd_wide_kernel<__half>>(kBlockSmem) !=
           cudaSuccess))
    return -1;
  switch (flash_fwd_tc_kernel_of(panels, tq, tk) * 2 + (f16 ? 1 : 0)) {
    case 2:
      return resident_blocks<flash_fwd_short_kernel<__nv_bfloat16>>(shape);
    case 3:
      return resident_blocks<flash_fwd_short_kernel<__half>>(shape);
    case 4:
      return resident_blocks<flash_fwd_sliced_kernel<__nv_bfloat16>>(shape);
    case 5:
      return resident_blocks<flash_fwd_sliced_kernel<__half>>(shape);
    case 6:
      return resident_blocks<flash_fwd_narrow_kernel<__nv_bfloat16>>(shape);
    case 7:
      return resident_blocks<flash_fwd_narrow_kernel<__half>>(shape);
    case 8:
      return resident_blocks<flash_fwd_wide_kernel<__nv_bfloat16>>(shape);
    case 9:
      return resident_blocks<flash_fwd_wide_kernel<__half>>(shape);
  }
  if (panels == 1)
    return f16 ? resident_blocks<flash_fwd_tc_kernel<__half, 1>>(shape)
               : resident_blocks<flash_fwd_tc_kernel<__nv_bfloat16, 1>>(shape);
  if (panels == 2)
    return f16 ? resident_blocks<flash_fwd_tc_kernel<__half, 2>>(shape)
               : resident_blocks<flash_fwd_tc_kernel<__nv_bfloat16, 2>>(shape);
  return f16 ? resident_blocks<flash_fwd_tc_kernel<__half, 4>>(shape)
             : resident_blocks<flash_fwd_tc_kernel<__nv_bfloat16, 4>>(shape);
}
