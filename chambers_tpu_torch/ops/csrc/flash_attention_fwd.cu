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
//   flash_fwd_cluster_kernel the same, at head sizes above 256
// and computes what flash_attention.cu's note says it computes: per query
// tile over all key tiles s = q k^T scale with float32 accumulation, a
// running float32 max m, p = exp(s - m) zeroed where masked, l = sum p from
// the unrounded p, p rounded to the operand type before p v, o = acc / l
// once at the end; the [b, tk] key mask shared by a batch item's heads, the
// causal diagonal at the sequence end, exact zeros in o and l and m at the
// mask value for a row with no valid key, any tq and tk, head size 64, 128
// or 256 (one, two or four panels, a template parameter), 32 in the narrow
// kernel and, in the cluster kernel, any multiple of 64 above 256 (the
// wrapper pads other sizes). The operand type T (__nv_bfloat16 or __half) is the other
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
// Head sizes above 256: flash_fwd_cluster_kernel. The whole-tile design
// stages whole tile rows, which at 256 already take 162 KB of the 227 KB
// a block may have; at 512 one 64-row tile of Q is 64 KB, and a 64-row
// tile's O in float32 (16 KB a panel, 304 KB at h 1216) outgrows one
// SM's register file above 512. So a row tile's output columns are
// spread over the blocks of a thread-block cluster, and each score
// product is computed once a cluster:
// * A block has two consumer warpgroups over 64 query rows and owns at
//   most kBlockPanels = 8 panels of O and of Q (Q's resident), half of
//   them, rounded up, to group 0: 128 float32 registers of O a thread.
//   The blocks over the same 64 rows form a cluster along z
//   (fwd_cluster_split: as few blocks as hold the head's panels, the
//   panels balanced over them, at h 1216 7 + 6 + 6; one block up to h 512;
//   above h 4096 several clusters along z, each computing S over the whole
//   head: a block also computes the terms of the panels its rank owns in
//   the other clusters, their Q and K panels an item each). The head size
//   is a run-time argument: one instantiation per type.
// * A third warpgroup gives its registers up (setmaxnreg: 24 a thread, the
//   consumers 240) and its first warp is the producer: it keeps TMA loads
//   (tensor maps of [bn, t, h] whose box is one 64-row panel, the 128-byte
//   swizzle) in flight into a ring of kClusterSlots = 6 items of two
//   panels on mbarriers, full and empty, kClusterSlots items ahead of the
//   consumers, and writes each key step's flags and count of valid keys
//   beside its first item. The consumers never meet a block barrier for a
//   copy.
// * Key step s: the K items (group g multiplies its resident panels 2j +
//   g with item j's, all of the group's panels in one batch of wgmma, a
//   panel past the block's the panel of zeros, so each group's batch is
//   straight-line code of four panels); the block's partial S (each
//   group's half summed with the other's through 16 KB of shared memory,
//   group 0's terms first); each group writes its half of the block's sum
//   to the block's exchange buffer and lanes 0 .. n - 1 signal the cluster's
//   n blocks' `ready` mbarriers (release at the cluster's scope, one lane a
//   block, all at once). Then, while the other blocks catch up, P_{s-1} V
//   over the step before's V items (each group's four panels of O in one
//   batch); then the wait on `ready` (acquire at the cluster's scope), the
//   sum of the n blocks' halves in rank order through distributed shared
//   memory (two ranks' loads in flight), the halves swapped back, and the
//   softmax (softmax_tile) on the same S bits in every group of every
//   block. The two exchange buffers take turns; a block signals an
//   exchange only after reading the one before, so waiting on one
//   exchange's `ready` also tells that the buffer the next one overwrites
//   has been read by every block. One cluster barrier at the start (every
//   block's mbarriers set up) and one at the end (no block leaves while
//   another reads its buffer).
// * The mask rules and the work they rule out are the whole-tile
//   design's, and depend on the rows and keys alone, the same in every
//   block of a cluster, so the blocks take part in the same exchanges;
//   block 0 of the first cluster writes l and m, and each group's O leaves
//   through Q's panels.
// The score sums are new bits (a cluster of one block, up to h 512, gives
// the bits of flash_fwd_wide_kernel, named below, whose order it keeps);
// they are held to the plain versions at the card tests' tolerances. 384
// threads (ptxas reports the 168 registers a thread of the launch; the
// consumers run at 240), no spills, no fences injected; 219 KB of shared
// memory: one block an SM.
// As measured on an NVIDIA H100 80GB HBM3 at 700 W (compare_flash_builds.py
// --only cluster and --only wide against 4fe19bb, each in turns in one
// call; PERF.md section 6), bf16 with the ragged key mask: [16, 512, 1216]
// 159.2 us against the sliced kernel's 282.8 and SDPA's 212.5 (causal
// 117.5 against 206.4; float16 159.7), [16, 512, 1536] 164.6 against
// 365.3 (SDPA 255.2), [16, 512, 2112] 327.1 against 801.4 (SDPA 348.2),
// [16, 512, 512] 36.3 against the wide kernel's 46.6 with its bits,
// [16, 512, 1024] 78.6 against 123.2. What binds it (ablations: copies of
// csrc with one edit each, compare_flash_builds.py --turns): the
// consumers' chain. At 1216 its products without copies took 147.7 us of
// 158.1, the copies alone 92.0; without any exchange it took 122.5, with
// the block's swaps 128.4, with the signalling 135.4, with the remote
// loads 158.9; at 2112 (clusters of five) 210.0, 215.7, 224.5 and 322.7.
// Replaced or tried, and slower, each in turns against the design before
// it: flash_fwd_sliced_kernel (a block one warpgroup and 256 columns of
// O, every slice computing S again, 282.8 us at 1216);
// flash_fwd_wide_kernel (two warpgroups over 512 columns of O with
// Q's tile resident, S computed once a slice, cp.async by all threads
// with a __syncthreads an item: 46.6 us at 512, 123.2 at 1024, 181.6 at
// 1152; the cluster kernel took 36.3, 78.6 and 155.7); the first cluster
// form (no producer: the wide kernel's ring and a cluster barrier an
// exchange) 230.3 us at 1216, its ring alone 168.6, the same with the
// blocks launched head-major or six ring slots level (227.3, 227.0);
// with the producer, `free` mbarriers beside `ready` and one thread
// signalling the n blocks in turn 203.4; that with P V under the exchange
// 200.7; with each group's products batched 197.5 (then 159.2 with the
// signalling above).
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
// head sizes above 256: the cluster kernel (see the note at the top)
// ---------------------------------------------------------------------------

// The cluster kernel's block: kClusterGroups consumer warpgroups over 64
// query rows and at most kBlockPanels panels of O (and of Q, resident),
// kGroupPanels of them a group, and a warpgroup whose first warp is the
// producer; its ring's items are two panels each
constexpr int kClusterGroups = 2;
constexpr int kGroupPanels = 4;  // 256 columns of O: 128 registers a thread
constexpr int kBlockPanels = kClusterGroups * kGroupPanels;  // 512 columns
constexpr int kConsumerThreads = 128 * kClusterGroups;
constexpr int kClusterThreads = kConsumerThreads + 128;
constexpr int kItemBytes = 2 * kPanelBytes;
constexpr int kClusterSlots = 6;  // the ring's items

// How the cluster kernel cuts a head of `panels` panels: `clusters`
// chunks of the head along z, as few as clusters of the portable size
// allow, each chunk balanced over its cluster's `blocks` blocks, as few as
// hold kBlockPanels panels a block (h 512: one block; h 1216: one cluster
// of 7 + 6 + 6)
struct FwdClusterSplit {
  int blocks, clusters;
};

__host__ __device__ constexpr FwdClusterSplit fwd_cluster_split(int panels) {
  constexpr int most = kMaxCluster * kBlockPanels;  // 64 a cluster
  const int clusters = (panels + most - 1) / most;
  const int widest = (panels + clusters - 1) / clusters;
  return {(widest + kBlockPanels - 1) / kBlockPanels, clusters};
}

// A block's [64 x 64] float32 score tile in shared memory, 8 units of four
// values a thread of a warpgroup, [unit][thread]: 16 KB
constexpr int kScoreTileBytes = 8 * kUnitBytes;
// the consumers' named barrier (store_panel's are 1 and 2)
constexpr int kConsumerBarrier = 3;

// Q's own panels, a panel of zeros, the ring, the two exchange buffers,
// the groups' swap buffer, the steps' key flags and counts of valid keys,
// the barriers (each slot's full and empty, Q's, each exchange buffer's
// ready), the warps' words of kept_key_end
__host__ __device__ constexpr size_t cluster_smem_bytes() {
  return 1024 + (kBlockPanels + 1) * kPanelBytes +
         kClusterSlots * kItemBytes + 3 * kScoreTileBytes +
         kClusterSlots * (kTileRows + 1) * 4 + (2 * kClusterSlots + 3) * 8 +
         kClusterThreads / 32 * 4;
}

LaunchShape cluster_shape(int panels) {
  const FwdClusterSplit split = fwd_cluster_split(panels);
  return {kClusterThreads, cluster_smem_bytes(), kTileRows,
          split.blocks * split.clusters, split.blocks};
}

// K3a's launch at `panels` panels: the narrow kernel at 0 (head size 32),
// the whole-tile kernel at 1, 2 or 4, the cluster kernel above 4
LaunchShape fwd_shape(int panels) {
  if (panels > 4) return cluster_shape(panels);
  return {128 * kGroups,
          panels == 0   ? smem_bytes<0>()
          : panels == 1 ? smem_bytes<1>()
          : panels == 2 ? smem_bytes<2>()
                        : smem_bytes<4>(),
          kGroups * kTileRows, 1};
}

// The cluster kernel's score tile, summed over the cluster in four parts,
// each called by both warpgroups between barriers. Warpgroup g of every
// block takes half g of the tile: units 4g .. 4g + 3, the fragment's
// values 16g .. 16g + 15. `swap` and `xbuf` are the thread's slot of unit 0
// in the block's swap buffer and in this step's exchange buffer.
// 1. the group's terms of the other half, to the swap buffer
template <int kHalf>
__device__ __forceinline__ void scores_hand_over(const float (&s)[32],
                                                 uint32_t swap) {
#pragma unroll
  for (int u = 4 * (1 - kHalf); u < 4 * (2 - kHalf); ++u)
    store_shared(swap + u * kUnitBytes, unit_of(s, u));
}

// 2. after a barrier: the block's sum of half kHalf, warpgroup 0's terms
// first, into s and the exchange buffer
template <int kHalf>
__device__ __forceinline__ void scores_block_sum(float (&s)[32],
                                                 uint32_t swap,
                                                 uint32_t xbuf) {
#pragma unroll
  for (int u = 4 * kHalf; u < 4 * kHalf + 4; ++u) {
    const float4 other = load_shared(swap + u * kUnitBytes);
    const float4 own = unit_of(s, u);
    const float4 sum = kHalf == 0 ? own + other : other + own;
    set_unit(s, u, sum);
    store_shared(xbuf + u * kUnitBytes, sum);
  }
}

// 3. once every block's sums are in: the cluster's sum of half kHalf, the
// blocks' sums added in rank order 0 .. n - 1 (each block's own from its
// registers, the others' through distributed shared memory, two ranks'
// eight loads in flight at once), into s and the swap buffer
template <int kHalf>
__device__ __forceinline__ void scores_cluster_sum(float (&s)[32],
                                                   uint32_t swap,
                                                   uint32_t xbuf, int n,
                                                   int rank) {
  float4 sum[4];
  for (int r0 = 0; r0 < n; r0 += 2) {
    float4 term[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        term[e][u] =
            r0 + e == rank || r0 + e >= n
                ? unit_of(s, 4 * kHalf + u)
                : load_remote(xbuf + (4 * kHalf + u) * kUnitBytes, r0 + e);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r0 + e < n) sum[u] = r0 + e == 0 ? term[e][u] : sum[u] + term[e][u];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    set_unit(s, 4 * kHalf + u, sum[u]);
    store_shared(swap + (4 * kHalf + u) * kUnitBytes, sum[u]);
  }
}

// 4. after a barrier: the other group's half of the sum
template <int kHalf>
__device__ __forceinline__ void scores_take_over(float (&s)[32],
                                                 uint32_t swap) {
#pragma unroll
  for (int u = 4 * (1 - kHalf); u < 4 * (2 - kHalf); ++u)
    set_unit(s, u, load_shared(swap + u * kUnitBytes));
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1)
    flash_fwd_cluster_kernel(__grid_constant__ const CUtensorMap q_map,
                             __grid_constant__ const CUtensorMap k_map,
                             __grid_constant__ const CUtensorMap v_map,
                             const float* __restrict__ kv_mask,
                             T* __restrict__ o, float* __restrict__ l_out,
                             float* __restrict__ m_out, int tq, int tk,
                             int hd, int n_heads, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  // Q's panels and a panel of zeros, the score and P V products' stand-in
  // for a panel a group does not have
  constexpr int kQBytes = (kBlockPanels + 1) * kPanelBytes;
  constexpr int kRingBytes = kClusterSlots * kItemBytes;
  const uint32_t q_s = smem_u32(smem);
  const uint32_t zeros = q_s + kBlockPanels * kPanelBytes;
  const uint32_t ring = q_s + kQBytes;
  const uint32_t xchg = ring + kRingBytes;  // two exchange buffers
  const uint32_t swap_s = xchg + 2 * kScoreTileBytes;
  // the key flags of the last kClusterSlots steps ([step][key]), written
  // with a step's first item: a step is at least six items (a block owns
  // at least five panels), so the producer, at most kClusterSlots items
  // ahead, never overwrites a step's flags before its softmax
  float* step_flags =
      reinterpret_cast<float*>(smem + kQBytes + kRingBytes +
                               3 * kScoreTileBytes);
  const uint32_t full0 = smem_u32(step_flags + kClusterSlots * kTileRows);
  const uint32_t empty0 = full0 + 8 * kClusterSlots;
  const uint32_t q_full = empty0 + 8 * kClusterSlots;
  const uint32_t ready0 = q_full + 8;
  // and their counts of valid keys
  int* step_valid = reinterpret_cast<int*>(smem + (ready0 + 16 - q_s));
  int* words = step_valid + kClusterSlots;

  const Lanes at;
  const int group = at.group, in_group = at.tid & 127;
  const int n = cluster_blocks(), rank = cluster_rank();
  const int chunks = gridDim.z / n, chunk = blockIdx.z / n;
  const int panels = hd / kPanelCols;
  const Span mine = cluster_panels(panels, chunks, chunk, n, rank);
  const int own = mine.count;
  // group 0's panels of O are the first half0 of the block's, group 1's
  // the rest
  const int half0 = (own + 1) / 2;
  const int group_own = group ? own - half0 : half0;
  // the block's parts of the other chunks: the panels the blocks of the
  // same rank own in the other clusters, whose score terms this block
  // computes for its own cluster
  int n_extra = 0;
  for (int c = 0; c < chunks; ++c)
    if (c != chunk) n_extra += cluster_panels(panels, chunks, c, n, rank).count;
  const int bn = blockIdx.x, q0 = blockIdx.y * kTileRows;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;
  // a consumer thread's two rows: g and g + 8 of its warp's 16
  const int row_a = q0 + at.warp_in_group * 16 + at.g;

  // keys past the last row's diagonal take no part, nor keys past the last
  // one the mask keeps (trailing padding); the same in every block of the
  // cluster, as is every skip below, so the blocks take part in the same
  // exchanges
  const int k_end = kept_key_end<kClusterThreads>(
      mask_row, causal ? min(tk, q0 + kTileRows + offset) : tk, at.tid,
      words);
  const int steps = (max(k_end, 0) + kTileRows - 1) / kTileRows;
  float* l_rows = l_out + (size_t)bn * tq;
  float* m_rows = m_out + (size_t)bn * tq;
  T* o_cols = o + (size_t)bn * tq * hd + mine.first * kPanelCols;

  if (steps == 0) {  // no key reaches the block: zeros, nothing read
    for (int p = group; p < own && group < kClusterGroups; p += kClusterGroups)
      store_zero_panel(o_cols + p * kPanelCols, q0, tq, hd, in_group);
    const int row = q0 + at.tid;
    if (blockIdx.z == 0 && at.tid < kTileRows && row < tq) {
      l_rows[row] = 0.f;
      m_rows[row] = kMaskValue;
    }
    return;
  }

  // A key step's score items pass through the ring, then the step
  // before's V items: one panel each of Q and K of the block's parts of
  // the other chunks, then its own panels of K two at a time (group g
  // multiplies the item's panel g); V's panel m of each group's share in
  // V's item m. A step's first item also brings the tile's key flags and
  // the count of its valid keys.
  const int score_items = (own + 1) / 2, v_items = half0;
  if (at.tid == 0) {
    for (int slot = 0; slot < kClusterSlots; ++slot) {
      mbar_init(full0 + 8 * slot, 32);            // the producer's lanes
      mbar_init(empty0 + 8 * slot, kConsumerThreads);  // the consumers
    }
    mbar_init(q_full, 1);
    for (int b = 0; b < 2; ++b)
      mbar_init(ready0 + 8 * b, n);  // a thread of each block
    mbar_init_fence();
  }
  __syncthreads();
  // every block's barriers are set up before any block arrives on them
  cluster_arrive();
  cluster_wait();

  if (group == kClusterGroups) {
    // the producer: its warpgroup gives its registers up, and its first
    // warp fills the ring kClusterSlots items ahead of the consumers
    producer_registers();
    if (at.warp_in_group == 0) {
      const int lane = at.lane;
      if (lane == 0) {  // Q's own panels, once
        mbar_arrive_expect(q_full, own * kPanelBytes);
        for (int p = 0; p < own; ++p)
          tma_load_head(q_s + p * kPanelBytes, &q_map, bn, q_full, q0,
                        (mine.first + p) * kPanelCols);
      }
      // item i of the ring: item j of a step's score items or V's item m
      // of the step before
      int i = 0;
      auto fill = [&](int step, int j, bool score) {
        const int slot = i % kClusterSlots, use = i / kClusterSlots;
        ++i;
        if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
        const int k0 = step * kTileRows;
        if (score && j == 0) {  // which keys of the step's tile take part
          float* flags = step_flags + (step % kClusterSlots) * kTileRows;
          int count = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + lane + 32 * e;
            const float f = key >= tk ? 0.f : mask_row ? mask_row[key] : 1.f;
            flags[lane + 32 * e] = f;
            count += __popc(__ballot_sync(0xffffffffu, f > 0.f));
          }
          if (lane == 0) step_valid[step % kClusterSlots] = count;
        }
        const uint32_t full = full0 + 8 * slot;
        if (lane != 0) {
          mbar_arrive(full);
          return;
        }
        const uint32_t dst = ring + slot * kItemBytes;
        if (score && j < n_extra) {  // Q's and K's panel of another chunk
          int e = j, col = 0;
          for (int c = 0; c < chunks; ++c) {
            if (c == chunk) continue;
            const Span part = cluster_panels(panels, chunks, c, n, rank);
            if (e < part.count) {
              col = (part.first + e) * kPanelCols;
              break;
            }
            e -= part.count;
          }
          mbar_arrive_expect(full, 2 * kPanelBytes);
          tma_load_head(dst, &q_map, bn, full, q0, col);
          tma_load_head(dst + kPanelBytes, &k_map, bn, full, k0, col);
          return;
        }
        // the item's panels of the block's: K's p and p + 1, or V's m and
        // half0 + m
        const int m = score ? 2 * (j - n_extra) : j;
        const int second = score ? m + 1 : half0 + m;
        const bool two = second < own;
        const CUtensorMap* map = score ? &k_map : &v_map;
        mbar_arrive_expect(full, (two ? 2 : 1) * kPanelBytes);
        tma_load_head(dst, map, bn, full, k0, (mine.first + m) * kPanelCols);
        if (two)
          tma_load_head(dst + kPanelBytes, map, bn, full, k0,
                        (mine.first + second) * kPanelCols);
      };
      for (int step = 0; step <= steps; ++step) {
        if (step < steps)
          for (int j = 0; j < n_extra + score_items; ++j) fill(step, j, true);
        if (step > 0)
          for (int m = 0; m < v_items; ++m) fill(step - 1, m, false);
      }
      __syncwarp();
    }
    // the producer's warpgroup leaves with the consumers (below)
    cluster_arrive();
    cluster_wait();
    return;
  }

  consumer_registers();
  const float scale2 = scale * kLog2e;
  int last_col[2];  // the last key each of the thread's rows may see
#pragma unroll
  for (int r = 0; r < 2; ++r)
    last_col[r] = causal ? row_a + 8 * r + offset : tk;

  // S (each group's terms over its panels, then the sums), O one [64 x 64]
  // accumulator a panel of the group's share
  float s[32], acc[kGroupPanels][32], m_run[2] = {kMaskValue, kMaskValue},
                                      l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kGroupPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  uint32_t p_frag[4][4];
  const uint32_t swap = swap_s + in_group * 16;
  auto consumers_sync = [] {
    asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier),
                 "n"(kConsumerThreads)
                 : "memory");
  };

  for (int i = in_group + 128 * group; i < kPanelBytes / 16;
       i += kConsumerThreads)
    store_shared(zeros + 16 * i, make_float4(0.f, 0.f, 0.f, 0.f));
  fence_async_shared();  // visible to the tensor cores' reads
  consumers_sync();
  mbar_wait(q_full, 0);
  int item = 0, exchanges = 0;
  // the next item's slot, once it has arrived
  auto next_item = [&]() {
    const int slot = item % kClusterSlots;
    mbar_wait(full0 + 8 * slot, (item / kClusterSlots) & 1);
    __syncwarp();  // converged for the warpgroup's products
    ++item;
    return slot;
  };
  auto release = [&](int slot) { mbar_arrive(empty0 + 8 * slot); };

  // Step s: the score items and the block's sums of S_s; then, while the
  // other blocks of the cluster catch up, P_{s-1} V over the step before's
  // V items; then the cluster's sums and the softmax of S_s
  int n_valid_before = 0;
  for (int step = 0; step <= steps; ++step) {
    const int k0 = step * kTileRows;
    const float* valid = step_flags + (step % kClusterSlots) * kTileRows;
    int n_valid = 0, b = 0, use = 0;
    uint32_t xbuf = 0;
    if (step < steps) {
      // the chain of the group's score products: its panels of the other
      // chunks, an item each, then its own, all four in one batch (a panel
      // past the block's, p >= own, is the panel of zeros: it adds zeros)
      int chain = 0;
      for (int j = 0; j < n_extra; ++j) {
        const int slot = next_item();
        if (j == 0) n_valid = step_valid[step % kClusterSlots];
        const uint32_t at_slot = ring + slot * kItemBytes;
        if (n_valid != 0 && (j & 1) == group) {
          products_begin();
          product_nt_panel<T>(s, at_slot, at_slot + kPanelBytes, 4 * chain);
          products_end();
          keep_registers(s);
          ++chain;
        }
        release(slot);
      }
      int slots[kGroupPanels] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < kGroupPanels; ++j)
        if (j < score_items) slots[j] = next_item();
      if (n_extra == 0) n_valid = step_valid[step % kClusterSlots];
      if (n_valid != 0) {
        products_begin();
#pragma unroll
        for (int j = 0; j < kGroupPanels; ++j) {
          const int p = 2 * j + group;
          product_nt_panel<T>(
              s, p < own ? q_s + p * kPanelBytes : zeros,
              p < own ? ring + slots[j] * kItemBytes + group * kPanelBytes
                      : zeros,
              4 * (chain + j));
        }
        products_end();
        keep_registers(s);
      }
#pragma unroll
      for (int j = 0; j < kGroupPanels; ++j)
        if (j < score_items) release(slots[j]);
      if (n_valid != 0) {
        // S summed over the block's groups and the cluster's blocks, the
        // same bits in every group of every block. Exchange buffer b takes
        // every other exchange, and ready[b] counts the blocks whose sums
        // are in their buffer b. A block signals an exchange only after
        // reading the one before it, so the wait on ready for one exchange
        // also tells that every block has read the buffer the next
        // exchange overwrites.
        b = exchanges & 1;
        use = exchanges >> 1;
        ++exchanges;
        xbuf = xchg + b * kScoreTileBytes + in_group * 16;
        if (group == 0)
          scores_hand_over<0>(s, swap);
        else
          scores_hand_over<1>(s, swap);
        consumers_sync();
        if (group == 0)
          scores_block_sum<0>(s, swap, xbuf);
        else
          scores_block_sum<1>(s, swap, xbuf);
        consumers_sync();
        if (n > 1 && at.tid < n) mbar_arrive_remote(ready0 + 8 * b, at.tid);
      }
    }
    if (step > 0) {  // P_{s-1} V, the group's four panels in one batch
      int slots[kGroupPanels] = {0, 0, 0, 0};
#pragma unroll
      for (int m = 0; m < kGroupPanels; ++m)
        if (m < v_items) slots[m] = next_item();
      if (n_valid_before != 0) {
        products_begin();
#pragma unroll
        for (int m = 0; m < kGroupPanels; ++m)
          product_tn<T>(acc[m], p_frag,
                        m < group_own ? ring + slots[m] * kItemBytes +
                                            group * kPanelBytes
                                      : zeros);
        products_end();
        keep_registers(p_frag);
#pragma unroll
        for (int m = 0; m < kGroupPanels; ++m) keep_registers(acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kGroupPanels; ++m)
        if (m < v_items) release(slots[m]);
    }
    if (n_valid != 0) {
      if (n > 1) mbar_wait_cluster(ready0 + 8 * b, use & 1);
      if (group == 0)
        scores_cluster_sum<0>(s, swap, xbuf, n, rank);
      else
        scores_cluster_sum<1>(s, swap, xbuf, n, rank);
      consumers_sync();
      if (group == 0)
        scores_take_over<0>(s, swap);
      else
        scores_take_over<1>(s, swap);
      // S is whole: the softmax, the same in both groups
      const bool unmasked =
          n_valid == kTileRows &&
          (!causal || k0 + kTileRows - 1 <= q0 + offset);
      softmax_tile<T>(s, acc, m_run, l_part, p_frag, valid, unmasked, k0,
                      last_col, at.t, scale, scale2);
    }
    n_valid_before = n_valid;
  }
  // no block leaves while another may still read its exchange buffers or
  // arrive on its barriers
  cluster_arrive();
  cluster_wait();

  // l over the quad, o = acc / l (a row with l == 0 has acc == 0); group
  // 0 of the first block writes l and m
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l == 0.f ? 1.f : 1.f / l;
    const int row = row_a + 8 * r;
    if (blockIdx.z == 0 && group == 0 && at.t == 0 && row < tq) {
      l_rows[row] = l;
      m_rows[row] = m_run[r];
    }
  }
  // Q's panels are read no more (the cluster's barrier above): panel a of
  // the group's share leaves through panel (half0 group + a) of them
#pragma unroll
  for (int a = 0; a < kGroupPanels; ++a) {
    if (a < group_own) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= inv[(i >> 1) & 1];
      const int p = (group ? half0 : 0) + a;
      store_panel(o_cols + p * kPanelCols, smem + p * kPanelBytes, acc[a],
                  1.f, q0, tq, hd, 1 + group, in_group);
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

// the cluster kernel: clusters of blocks along z over each chunk of the
// head (launch_cluster_in; a cluster the card cannot place is refused
// there)
template <typename T>
cudaError_t launch_cluster(int hd, const void* q, const void* k,
                           const void* v, const void* kv_mask, void* o,
                           void* l, void* m, int bn, int tq, int tk,
                           int n_heads, float scale, int causal,
                           cudaStream_t stream) {
  // tensor maps of Q, K and V whose boxes are one panel of 64 rows
  CUtensorMap maps[3];
  cudaError_t err = head_map<T>(&maps[0], q, bn, tq, kTileRows, hd);
  if (err == cudaSuccess) err = head_map<T>(&maps[1], k, bn, tk, kTileRows, hd);
  if (err == cudaSuccess) err = head_map<T>(&maps[2], v, bn, tk, kTileRows, hd);
  if (err != cudaSuccess) return err;
  return launch_cluster_in<flash_fwd_cluster_kernel<T>>(
      cluster_shape(hd / kPanelCols), bn, tq, stream, maps[0], maps[1],
      maps[2], (const float*)kv_mask, (T*)o, (float*)l, (float*)m, tq, tk, hd,
      n_heads, scale, causal);
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
  if (panels > 4)
    return launch_cluster<T>(panels * kPanelCols, q, k, v, kv_mask, o, l, m,
                             bn, tq, tk, n_heads, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// f16: float16 operands (else bfloat16); panels: the head size over 64, 0
// (head size 32, the narrow kernel), 1, 2, 4 or any count above 4 (the
// cluster kernel)
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
// whole-tile kernel, 1 the short kernel, 2 the narrow kernel, 3 the
// cluster kernel), its launch shape, the blocks of it the current card
// holds at once (or -1), and the clusters (0 without)
int flash_fwd_tc_kernel_of(int panels, int tq, int tk) {
  return takes_short(panels, tq, tk) ? 1
         : panels > 4                ? 3
         : panels == 0               ? 2
                                     : 0;
}

flash_tiles::LaunchShape flash_fwd_tc_shape(int panels, int tq, int tk) {
  return takes_short(panels, tq, tk) ? short_shape() : fwd_shape(panels);
}

int flash_fwd_tc_resident(int f16, int panels, int tq, int tk) {
  using flash_tiles::resident_blocks;
  const flash_tiles::LaunchShape shape = flash_fwd_tc_shape(panels, tq, tk);
  switch (flash_fwd_tc_kernel_of(panels, tq, tk) * 2 + (f16 ? 1 : 0)) {
    case 2:
      return resident_blocks<flash_fwd_short_kernel<__nv_bfloat16>>(shape);
    case 3:
      return resident_blocks<flash_fwd_short_kernel<__half>>(shape);
    case 4:
      return resident_blocks<flash_fwd_narrow_kernel<__nv_bfloat16>>(shape);
    case 5:
      return resident_blocks<flash_fwd_narrow_kernel<__half>>(shape);
    case 6:
      return resident_blocks<flash_fwd_cluster_kernel<__nv_bfloat16>>(shape);
    case 7:
      return resident_blocks<flash_fwd_cluster_kernel<__half>>(shape);
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

// how many clusters of K3a's cluster kernel at `panels` panels (above 4) of
// float16 (f16 nonzero) or bfloat16 the card holds at once
int flash_fwd_tc_max_clusters(int f16, int panels) {
  const LaunchShape shape = cluster_shape(panels);
  return f16 ? max_active_clusters<flash_fwd_cluster_kernel<__half>>(shape)
             : max_active_clusters<flash_fwd_cluster_kernel<__nv_bfloat16>>(
                   shape);
}
