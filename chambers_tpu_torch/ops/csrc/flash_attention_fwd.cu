// The flash attention forward kernel for bf16 operands, on the H100's
// tensor cores. Third source of the flash_attention library;
// flash_attention.cu holds the C interface, which sends bfloat16 here and
// float32 to its own FMA kernel.
//
// Replaces the Pallas TPU kernel of chambers_tpu/ops/flash_attention.py:
//   flash_fwd_tc_kernel  <- _flash_forward / _flash_fwd_kernel  (K3a)
// and computes what flash_attention.cu's note says it computes: per query
// tile over all key tiles s = q k^T scale with float32 accumulation, a
// running float32 max m, p = exp(s - m) zeroed where masked, l = sum p from
// the unrounded p, p rounded to bf16 before p v, o = acc / l once at the
// end; the [b, tk] key mask shared by a batch item's heads, the causal
// diagonal at the sequence end, exact zeros in o and l and m at the mask
// value for a row with no valid key, any tq and tk, head size 64. Returns
// o (bf16) and l, m (float32, natural units) for the backward kernels.
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
//   (8 KB) is copied to shared memory once; K and V pass in tiles of 64
//   rows (16 KB a step) through a ring of kStages = 2 stages filled with
//   cp.async one step ahead of the products, with one __syncthreads a step
//   (after it the step's tile is visible to all and the other stage has
//   been read by all).
// * Each warpgroup computes S = Q K^T for its 64 rows against the passing
//   64 keys with wgmma (both operands in shared memory), runs the online
//   softmax on the accumulator fragments in registers, rounds p to bf16 and
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
// chip_smoke.py prints): one warpgroup a block (128 threads), 106
// registers, 42 KB of shared memory: four blocks an SM by registers
// (__launch_bounds__ caps them at 128) and by shared memory; at
// [128, 512, 64] 1024 blocks fill 528 slots in 1.94 rounds.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash_tiles;

// warpgroups a block, and blocks an SM the compiler fits the registers to
constexpr int kGroups = 1, kBlocks = 4;
constexpr int kStages = 2;                    // ring of passing tiles
constexpr int kStageBytes = 2 * kTileBytes;   // K and V: 16 KB
constexpr size_t kSmem = 1024 + kGroups * kTileBytes +
                         kStages * (kStageBytes + kTileRows * 4) +
                         4 * kGroups * 4;

__global__ void __launch_bounds__(128 * kGroups, kBlocks)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ kv_mask,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ l_out, float* __restrict__ m_out,
                        int tq, int tk, int n_heads, float scale,
                        int causal) {
  constexpr int kThreads = 128 * kGroups, kOwned = kTileRows * kGroups;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t ring = q_s + kGroups * kTileBytes;
  float* valid_s = reinterpret_cast<float*>(smem + kGroups * kTileBytes +
                                            kStages * kStageBytes);
  int* flags_s = reinterpret_cast<int*>(valid_s + kStages * kTileRows);

  const Lanes at;
  const int in_group = at.tid & 127;
  const int bn = blockIdx.x, q0 = blockIdx.y * kOwned;
  const __nv_bfloat16* kb = k + (size_t)bn * tk * kHead;
  const __nv_bfloat16* vb = v + (size_t)bn * tk * kHead;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;
  const int group_row0 = q0 + at.group * kTileRows;
  // the thread's two rows: g and g + 8 of its warp's 16
  const int row_a = group_row0 + at.warp_in_group * 16 + at.g;

  // keys past the last row's diagonal take no part, nor keys past the last
  // one the mask keeps (trailing padding)
  int k_end = causal ? min(tk, q0 + kOwned + offset) : tk;
  if (mask_row) {
    int last = -1;
    for (int col = at.tid; col < k_end; col += kThreads)
      if (mask_row[col] > 0.f) last = col;
    last = __reduce_max_sync(0xffffffffu, last);
    if (at.lane == 0) flags_s[at.tid >> 5] = last;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < 4 * kGroups; ++w) last = max(last, flags_s[w]);
    k_end = last + 1;
  }
  const int steps = (max(k_end, 0) + kTileRows - 1) / kTileRows;
  float* l_rows = l_out + (size_t)bn * tq;
  float* m_rows = m_out + (size_t)bn * tq;
  __nv_bfloat16* o_rows = o + (size_t)bn * tq * kHead;

  if (steps == 0) {  // no key reaches the block: zeros, nothing read
    store_zero_rows(o_rows, group_row0, tq, in_group);
    const int row = group_row0 + in_group;
    if (in_group < kTileRows && row < tq) {
      l_rows[row] = 0.f;
      m_rows[row] = kMaskValue;
    }
    return;
  }

  stage_rows<kOwned, kThreads>(q_s, q + (size_t)bn * tq * kHead, q0, tq,
                               at.tid);

  auto stage_step = [&](int step) {
    if (step < steps) {
      const int stage = step % kStages, k0 = step * kTileRows;
      const uint32_t k_s = ring + stage * kStageBytes;
      stage_rows<kTileRows, kThreads>(k_s, kb, k0, tk, at.tid);
      stage_rows<kTileRows, kThreads>(k_s + kTileBytes, vb, k0, tk, at.tid);
      if (at.tid < kTileRows) {  // which keys of the tile take part
        const int col = k0 + at.tid;
        float* dst = valid_s + stage * kTileRows + at.tid;
        if (mask_row)
          cp_async_4(smem_u32(dst), mask_row + (col < tk ? col : 0),
                     col < tk ? 4 : 0);
        else
          *dst = col < tk ? 1.f : 0.f;
      }
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

  float acc[32], m_run[2] = {kMaskValue, kMaskValue}, l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

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
    // diagonal of the group's last row
    if (n_valid == 0 ||
        (causal && k0 > group_row0 + kTileRows - 1 + offset))
      continue;
    const uint32_t k_s = ring + stage * kStageBytes;
    const uint32_t v_s = k_s + kTileBytes;

    float s[32];
    products_begin();
    product_nt(s, q_s + at.group * kTileBytes, k_s);
    products_end();
    keep_registers(s);

    // not every pair of the tile takes part: masked scores become -inf
    const bool unmasked =
        n_valid == kTileRows &&
        (!causal || k0 + kTileRows - 1 <= group_row0 + offset);
    if (!unmasked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 key_ok =
            *reinterpret_cast<const float2*>(valid + 8 * j + 2 * at.t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * at.t + e;
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
      for (int j = 0; j < 8; ++j) {
        acc[4 * j + 2 * r] *= alpha;
        acc[4 * j + 2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_fast(fmaf(s[i], scale2, -offset2[r]));
      l_part[r] += s[i];
    }
    uint32_t p[4][4];
    pack_a_fragments(s, p);

    products_begin();
    product_tn(acc, p, v_s);
    products_end();
    keep_registers(p);
    keep_registers(acc);
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
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= inv[(i >> 1) & 1];
  // the group's own Q tile is read no more
  store_accumulator(o_rows, smem + at.group * kTileBytes, acc, 1.f,
                    group_row0, tq, 1 + at.group, in_group);
}

}  // namespace

cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           const void* kv_mask, void* o, void* l, void* m,
                           int bn, int tq, int tk, int n_heads, float scale,
                           int causal, cudaStream_t stream) {
  const cudaError_t err = allow_smem<flash_fwd_tc_kernel>(kSmem);
  if (err != cudaSuccess) return err;
  constexpr int kOwned = kGroups * kTileRows;
  flash_fwd_tc_kernel<<<dim3(bn, (tq + kOwned - 1) / kOwned), 128 * kGroups,
                        kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)kv_mask, (__nv_bfloat16*)o,
      (float*)l, (float*)m, tq, tk, n_heads, scale, causal);
  return cudaGetLastError();
}
