// The flash attention backward kernels for bf16 operands, on the H100's
// tensor cores. Second source of the flash_attention library;
// flash_attention.cu holds the C interface, which sends bfloat16 here and
// float32 to its own FMA kernels.
//
// Replaces the Pallas TPU kernels of chambers_tpu/ops/flash_attention.py:
//   flash_bwd_dkv_tc_kernel  <- _flash_backward / _flash_bwd_dkv_kernel  (K3b)
//   flash_bwd_dq_tc_kernel   <- _flash_backward / _flash_bwd_dq_kernel   (K3c)
// and computes what flash_attention.cu's note says they compute: per key
// tile over all query tiles p = exp(s - m) / l, dv += p^T do,
// ds = p (do v^T - di), dk += ds^T q scale; per query tile over all key
// tiles dq += ds k scale; the [b, tk] key mask shared by a batch item's
// heads, the causal diagonal at the sequence end, exact zeros for a row or a
// batch item with no valid key, any tq and tk, head size 64 or 128 (one or
// two panels, a template parameter; the wrapper pads other sizes).
//
// Bound: operations. At [128, 512, 64] dK/dV is four products of
// 128 x 512 x 512 x 64 multiply-adds, 17.2 GFLOP, 17.4 us at the tensor
// cores' 989 TFLOP/s in bf16; dQ is three, 12.9 GFLOP, 13.0 us; either
// moves about 50 MB, 15 us at 3.35 TB/s. So the products have to run on the
// tensor cores and the operands have to arrive while they run.
//
// Design (flash_tiles.cuh has the tile layout and the product functions).
// * A block is one warpgroup (K3b) or two (K3c), each owning 64 rows: keys
//   in K3b, queries in K3c. Its own operands (K and V, or Q and dO: 16 KB a
//   warpgroup a panel) are copied to shared memory once; the other side
//   passes by in tiles of 64 rows (16 KB a step a panel) through a ring of
//   three stages filled with cp.async, two steps ahead of the products.
//   Each step has one
//   __syncthreads: after it the step's tiles are visible to all and the
//   stage that the copy started next overwrites has been read by all.
// * At head size 128 the score and do . v^T products run over both panels
//   (eight k16 steps each), and dQ, dK and dV are two [64 x 64]
//   accumulators each, one a panel, each fed the same P or dS by its own
//   four wgmma; the epilogues loop over the panels.
// * Each warpgroup computes its 64 rows against the passing 64 with wgmma:
//   the score tile and the do . v^T tile with both operands in shared
//   memory, then p and ds on the accumulator fragments in registers,
//   rounded to bf16 and fed straight back as the A operand of the second
//   products, whose other operand (dO, Q or K) is the same shared tile read
//   along its rows. P and dS never touch shared memory. K3b computes the
//   transposed score tile (keys by queries) so that p^T and ds^T are those
//   A operands; the row statistics then run along the fragment's columns
//   and come from a small shared array that travels with the passing tile
//   (64 threads load m, l, di two steps ahead and store the folded values
//   at the end of a step). In K3c they are per row and live in registers.
// * exp(s scale - m) / l is exp2(s (scale log2 e) - (m log2 e + log2 l)):
//   one multiply-add and one ex2.approx per element, the denominator folded
//   into the row's offset. With hd = 64 the kernels execute about as many
//   other operations as the tensor cores have work, so the inner loop is
//   kept to five operations an element (fma, ex2, subtract, multiply,
//   half a pack) on tiles where every pair takes part, which a step learns
//   from block-uniform tests: all of the tile's keys kept by the mask, the
//   tile clear of the causal diagonal and of the ragged edge. Other tiles
//   take a second loop that zeroes masked elements by a select, never by a
//   product, so a row whose m is the mask value (m log2 e overflows to
//   -inf, the exponent to +inf) still gives exact zeros.
// * Work that the mask rules out is not done: K3c ends its loop at the last
//   key the mask keeps (trailing padding) and skips tiles with no kept key;
//   a K3b block none of whose keys is kept writes zeros and reads nothing;
//   under the causal mask tiles wholly above the diagonal are skipped per
//   block, and in K3c per warpgroup within a block's tile.
// * Accumulators (dk and dv, or dq) stay in registers over the whole loop
//   and leave through the warpgroup's own operand tile, which turns the
//   fragments' 4-byte pieces into coalesced 16-byte stores. Each output is
//   written once by one block and there are no atomics, so results repeat
//   from run to run.
// * Loads (row statistics, the mask) are started before the copies: a load
//   queued behind 64 KB of cp.async returns after them.
// * Differs from the float32 kernels in one rounding: p and ds are rounded
//   to bf16 before the second products, because a bf16 tensor-core product
//   takes bf16 on both sides (flash_backward_plain states the same).
//
// Occupancy, as built (registers from nvcc's -Xptxas -v report, which
// chip_smoke.py prints):
//   K3b  one warpgroup a block (128 threads), 168 registers, 67 KB of
//        shared memory: three blocks an SM by registers (65,536 / 128 / 168
//        = 3.05) and by shared memory (227 KB / 67). Two warpgroups sharing
//        the passing tiles need 198 registers, one block an SM, and were
//        slower; held to 128 registers they spill.
//   K3c  two warpgroups a block (256 threads), 128 registers, 83 KB: two
//        blocks an SM by both. One warpgroup a block, three an SM, was
//        level with it.
//   Head size 128: K3b keeps one warpgroup a block, its dK and dV now 128
//   float32 registers a thread, 131 KB of shared memory: one block an SM,
//   and __launch_bounds__ lets the registers grow to 255: 246, no spills.
//   The other way to hold the accumulators, two warpgroups sharing the
//   block's 64 keys and splitting the head's panels, would compute the
//   score and do . v^T tiles twice (the tensor cores' work 1.5 times over)
//   and the softmax twice. K3c keeps two warpgroups, 163 KB: one block an
//   SM, 166 registers, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash_tiles;

// warpgroups a block, and blocks an SM the compiler fits the registers to,
// by head panels
constexpr int kDkvGroups = 1;
constexpr int kDqGroups = 2;
constexpr int dkv_blocks(int panels) { return panels == 1 ? 3 : 1; }
constexpr int dq_blocks(int panels) { return panels == 1 ? 2 : 1; }
constexpr int kStages = 3;                    // ring of passing tiles
constexpr int kRowsBytes = 2 * kTileRows * 4; // per-row floats of a stage

// a block of `groups` warpgroups owns groups * 64 rows of two operands; a
// stage holds two tiles
template <int kPanels>
__host__ __device__ constexpr size_t smem_bytes(int groups) {
  return 1024 + groups * 2 * tile_bytes<kPanels>() +
         kStages * (2 * tile_bytes<kPanels>() + kRowsBytes) + 64;
}

struct RowStats {
  float m, l, di;
};

// K3c: dq for the block's query rows over all key tiles
template <int kPanels>
__global__ void __launch_bounds__(128 * kDqGroups, dq_blocks(kPanels))
    flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ l,
                           const float* __restrict__ m,
                           const float* __restrict__ di,
                           const float* __restrict__ kv_mask,
                           __nv_bfloat16* __restrict__ dq, int tq, int tk,
                           int n_heads, float scale, int causal) {
  constexpr int kGroups = kDqGroups, kThreads = 128 * kGroups,
                kOwned = kTileRows * kGroups;
  constexpr int kHd = kPanels * kPanelCols, kTile = tile_bytes<kPanels>(),
                kStageBytes = 2 * kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + kGroups * kTile;
  const uint32_t ring = q_s + 2 * kGroups * kTile;
  float* valid_s = reinterpret_cast<float*>(smem + 2 * kGroups * kTile +
                                            kStages * kStageBytes);
  int* flags_s = reinterpret_cast<int*>(valid_s + kStages * 2 * kTileRows);

  const Lanes at;
  const int bn = blockIdx.x, q0 = blockIdx.y * kOwned;
  const __nv_bfloat16* kb = k + (size_t)bn * tk * kHd;
  const __nv_bfloat16* vb = v + (size_t)bn * tk * kHd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  // The thread's two rows, g and g + 8 of its warp's 16, and their
  // statistics: loaded before any copy is started, because a load queued
  // behind the copies returns after them.
  const int group_row0 = q0 + at.group * kTileRows;
  const int row_a = group_row0 + at.warp_in_group * 16 + at.g;
  RowStats stats[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const size_t i = (size_t)bn * tq + (row < tq ? row : 0);
    stats[r].m = m[i];
    stats[r].l = l[i];
    stats[r].di = di[i];
  }

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
  stage_rows<kOwned, kThreads, kPanels>(q_s, q + (size_t)bn * tq * kHd, q0,
                                        tq, at.tid);
  stage_rows<kOwned, kThreads, kPanels>(do_s, dout + (size_t)bn * tq * kHd,
                                        q0, tq, at.tid);

  auto stage_step = [&](int step) {
    if (step < steps) {
      const int stage = step % kStages, k0 = step * kTileRows;
      const uint32_t k_s = ring + stage * kStageBytes;
      stage_rows<kTileRows, kThreads, kPanels>(k_s, kb, k0, tk, at.tid);
      stage_rows<kTileRows, kThreads, kPanels>(k_s + kTile, vb, k0, tk,
                                               at.tid);
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

  stage_step(0);
  stage_step(1);

  const float lse2[2] = {exponent_offset(stats[0].m, stats[0].l),
                         exponent_offset(stats[1].m, stats[1].l)};
  const float di_r[2] = {stats[0].di, stats[1].di};
  const float scale2 = scale * kLog2e;
  const bool rows_inside = group_row0 + kTileRows <= tq;

  // dQ: one [64 x 64] accumulator a panel
  float acc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

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
    const uint32_t v_s = k_s + kTile;

    float s[32], dp[32];
    products_begin();
    product_nt<kPanels>(s, q_s + at.group * kTile, k_s);
    product_nt<kPanels>(dp, do_s + at.group * kTile, v_s);
    products_end();
    keep_registers(s);
    keep_registers(dp);

    // every pair of the tile takes part: no test per element
    const bool unmasked =
        n_valid == kTileRows && rows_inside &&
        (!causal || k0 + kTileRows - 1 <= group_row0 + offset);
    if (unmasked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_fast(fmaf(s[i], scale2, -lse2[r])) * (dp[i] - di_r[r]);
      }
    } else {
      // the last key each of the thread's rows may see
      int last_col[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        last_col[r] = row >= tq ? -1 : causal ? row + offset : tk;
      }
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
            const float p = exp2_fast(fmaf(s[i], scale2, -lse2[r]));
            s[i] = col_ok && col <= last_col[r] ? p * (dp[i] - di_r[r]) : 0.f;
          }
        }
      }
    }
    uint32_t ds[4][4];
    pack_a_fragments(s, ds);

    products_begin();
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      product_tn(acc[p], ds, k_s + p * kPanelBytes);
    products_end();
    keep_registers(ds);
#pragma unroll
    for (int p = 0; p < kPanels; ++p) keep_registers(acc[p]);
  }

  if (steps == 0) {  // the copies of Q and dO have met no barrier yet
    cp_async_wait<0>();
    __syncthreads();
  }
  // the group's own Q tile is read no more: panel p of dQ leaves through
  // panel p of it
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
    store_accumulator<kHd>(dq + (size_t)bn * tq * kHd + p * kPanelCols,
                           smem + at.group * kTile + p * kPanelBytes, acc[p],
                           scale, group_row0, tq, 1 + at.group, at.tid & 127);
}

// K3b: dk, dv for the block's 64 keys over all query tiles
template <int kPanels>
__global__ void __launch_bounds__(128 * kDkvGroups, dkv_blocks(kPanels))
    flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ l,
                            const float* __restrict__ m,
                            const float* __restrict__ di,
                            const float* __restrict__ kv_mask,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int tq, int tk,
                            int n_heads, float scale, int causal) {
  static_assert(kDkvGroups == 1, "one warpgroup owns the block's keys");
  constexpr int kThreads = 128;
  constexpr int kHd = kPanels * kPanelCols, kTile = tile_bytes<kPanels>(),
                kStageBytes = 2 * kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t k_s = smem_u32(smem);
  const uint32_t v_s = k_s + kTile;
  const uint32_t ring = k_s + 2 * kTile;
  // [stage][exponent offset, di][query of the tile]
  float* rows_s = reinterpret_cast<float*>(smem + 2 * kTile +
                                           kStages * kStageBytes);
  int* flags_s = reinterpret_cast<int*>(rows_s + kStages * 2 * kTileRows);

  const Lanes at;
  const int bn = blockIdx.x, k0 = blockIdx.y * kTileRows;
  const __nv_bfloat16* qb = q + (size_t)bn * tq * kHd;
  const __nv_bfloat16* dob = dout + (size_t)bn * tq * kHd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  // under the causal mask only query rows with row + offset >= k0 reach
  // this block's keys
  const int first = causal && k0 - offset > 0 ? (k0 - offset) / kTileRows : 0;
  const int steps = (tq + kTileRows - 1) / kTileRows - first;

  auto stage_step = [&](int step) {
    if (step < steps) {
      const int stage = step % kStages, q0 = (first + step) * kTileRows;
      const uint32_t q_s = ring + stage * kStageBytes;
      stage_rows<kTileRows, kThreads, kPanels>(q_s, qb, q0, tq, at.tid);
      stage_rows<kTileRows, kThreads, kPanels>(q_s + kTile, dob, q0, tq,
                                               at.tid);
    }
    cp_async_commit();
  };

  // The per-row statistics of a passing tile, read by 64 threads two steps
  // ahead (load_rows), turned into the exponent offset and di, and put in
  // the stage's array at the end of the step (store_rows): the products in
  // between hide the loads.
  auto load_rows = [&](int step) {
    RowStats r = {0.f, 0.f, 0.f};
    const int row = (first + step) * kTileRows + at.tid;
    if (at.tid < kTileRows && step < steps && row < tq) {
      const size_t i = (size_t)bn * tq + row;
      r.m = m[i];
      r.l = l[i];
      r.di = di[i];
    }
    return r;
  };
  auto store_rows = [&](int step, const RowStats& r) {
    if (at.tid < kTileRows && step < steps) {
      float* dst = rows_s + (step % kStages) * 2 * kTileRows + at.tid;
      dst[0] = exponent_offset(r.m, r.l);
      dst[kTileRows] = r.di;
    }
  };

  const RowStats rows0 = load_rows(0), rows1 = load_rows(1);

  // the thread's two keys: g and g + 8 of its warp's 16
  const int key_a = k0 + at.warp_in_group * 16 + at.g;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    key_ok[r] = key < tk && (mask_row == nullptr || mask_row[key] > 0.f);
  }
  // does any of the block's keys take part, do all
  {
    const bool any = __any_sync(0xffffffffu, key_ok[0] || key_ok[1]);
    const bool all = __all_sync(0xffffffffu, key_ok[0] && key_ok[1]);
    if (at.lane == 0) flags_s[at.tid >> 5] = (any ? 1 : 0) | (all ? 2 : 0);
  }
  __syncthreads();
  int keys_any = 0, keys_all = 2;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    keys_any |= flags_s[w] & 1;
    keys_all &= flags_s[w] & 2;
  }
  if (!keys_any) {  // no key of the block takes part: zeros, nothing read
    store_zero_rows<kHd>(dv + (size_t)bn * tk * kHd, k0, tk, at.tid);
    store_zero_rows<kHd>(dk + (size_t)bn * tk * kHd, k0, tk, at.tid);
    return;
  }

  stage_rows<kTileRows, kThreads, kPanels>(k_s, k + (size_t)bn * tk * kHd,
                                           k0, tk, at.tid);
  stage_rows<kTileRows, kThreads, kPanels>(v_s, v + (size_t)bn * tk * kHd,
                                           k0, tk, at.tid);
  stage_step(0);
  stage_step(1);
  store_rows(0, rows0);
  store_rows(1, rows1);
  const float scale2 = scale * kLog2e;

  // dK and dV: one [64 x 64] accumulator a panel each
  float dk_acc[kPanels][32], dv_acc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const RowStats ahead = load_rows(step + kStages - 1);
    stage_step(step + kStages - 1);

    const int stage = step % kStages, q0 = (first + step) * kTileRows;
    // a tile whose last row does not reach the block's first key is skipped
    if (!(causal && k0 > q0 + kTileRows - 1 + offset)) {
      const uint32_t q_s = ring + stage * kStageBytes;
      const uint32_t do_s = q_s + kTile;
      const float* lse2_s = rows_s + stage * 2 * kTileRows;
      const float* di_s = lse2_s + kTileRows;

      float st[32], dpt[32];  // [key][query]
      products_begin();
      product_nt<kPanels>(st, k_s, q_s);
      product_nt<kPanels>(dpt, v_s, do_s);
      products_end();
      keep_registers(st);
      keep_registers(dpt);

      // every pair of the tile takes part: no test per element
      const bool unmasked =
          keys_all && q0 + kTileRows <= tq &&
          (!causal || k0 + kTileRows - 1 <= q0 + offset);
      if (unmasked) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 lse2 =
              *reinterpret_cast<const float2*>(lse2_s + 8 * j + 2 * at.t);
          const float2 di_r =
              *reinterpret_cast<const float2*>(di_s + 8 * j + 2 * at.t);
#pragma unroll
          for (int i = 4 * j; i < 4 * j + 4; ++i) {
            const float p =
                exp2_fast(fmaf(st[i], scale2, i & 1 ? -lse2.y : -lse2.x));
            st[i] = p;
            dpt[i] = p * (dpt[i] - (i & 1 ? di_r.y : di_r.x));  // ds
          }
        }
      } else {
        // the first query row each of the thread's keys is seen by
        int first_row[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          first_row[r] = !key_ok[r] ? tq : causal ? key_a + 8 * r - offset : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 lse2 =
              *reinterpret_cast<const float2*>(lse2_s + 8 * j + 2 * at.t);
          const float2 di_r =
              *reinterpret_cast<const float2*>(di_s + 8 * j + 2 * at.t);
#pragma unroll
          for (int i = 4 * j; i < 4 * j + 4; ++i) {
            const int row = q0 + 8 * j + 2 * at.t + (i & 1);
            const bool ok = row < tq && row >= first_row[(i >> 1) & 1];
            const float p =
                exp2_fast(fmaf(st[i], scale2, i & 1 ? -lse2.y : -lse2.x));
            st[i] = ok ? p : 0.f;
            dpt[i] = ok ? p * (dpt[i] - (i & 1 ? di_r.y : di_r.x)) : 0.f;
          }
        }
      }
      uint32_t pt[4][4], dst[4][4];
      pack_a_fragments(st, pt);
      pack_a_fragments(dpt, dst);

      products_begin();
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        product_tn(dv_acc[p], pt, do_s + p * kPanelBytes);
        product_tn(dk_acc[p], dst, q_s + p * kPanelBytes);
      }
      products_end();
      keep_registers(pt);
      keep_registers(dst);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        keep_registers(dv_acc[p]);
        keep_registers(dk_acc[p]);
      }
    }
    store_rows(step + kStages - 1, ahead);
  }

  if (steps == 0) {  // the copies of K and V have met no barrier yet
    cp_async_wait<0>();
    __syncthreads();
  }
  // the block's own K and V tiles are read no more: panel p of dV leaves
  // through panel p of K, and of dK through panel p of V
#pragma unroll
  for (int p = 0; p < kPanels; ++p) {
    store_accumulator<kHd>(dv + (size_t)bn * tk * kHd + p * kPanelCols,
                           smem + p * kPanelBytes, dv_acc[p], 1.f, k0, tk, 1,
                           at.tid);
    store_accumulator<kHd>(dk + (size_t)bn * tk * kHd + p * kPanelCols,
                           smem + kTile + p * kPanelBytes, dk_acc[p], scale,
                           k0, tk, 1, at.tid);
  }
}

// The two products of the tiling alone, for a test on the card: x [128, 64]
// and y [64, 64] bf16 give nt = x . y^T and tn = bf16(nt) . y, float32
// [128, 64] each, through the same copies, fragments and product functions
// as the kernels above.
__global__ void __launch_bounds__(256, 1)
    flash_tile_products_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ y,
                               float* __restrict__ nt,
                               float* __restrict__ tn) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t x_s = smem_u32(smem), y_s = x_s + 2 * kPanelBytes;
  const Lanes at;
  stage_rows<2 * kTileRows, 256, 1>(x_s, x, 0, 2 * kTileRows, at.tid);
  stage_rows<kTileRows, 256, 1>(y_s, y, 0, kTileRows, at.tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float first[32], second[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) second[i] = 0.f;
  products_begin();
  product_nt<1>(first, x_s + at.group * kPanelBytes, y_s);
  products_end();
  keep_registers(first);
  uint32_t a[4][4];
  pack_a_fragments(first, a);
  products_begin();
  product_tn(second, a, y_s);
  products_end();
  keep_registers(a);
  keep_registers(second);

  const int row_a = at.group * kTileRows + at.warp_in_group * 16 + at.g;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = row_a + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * at.t + (i & 1);
    nt[row * kPanelCols + col] = first[i];
    tn[row * kPanelCols + col] = second[i];
  }
}

inline dim3 owned_tiles(int bn, int t, int groups) {
  const int owned = groups * kTileRows;
  return dim3(bn, (t + owned - 1) / owned);
}

template <int kPanels>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* l, const void* m,
                       const void* di, const void* kv_mask, void* dk,
                       void* dv, int bn, int tq, int tk, int n_heads,
                       float scale, int causal, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<kPanels>(kDkvGroups);
  const cudaError_t err =
      allow_smem<flash_bwd_dkv_tc_kernel<kPanels>>(kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tc_kernel<kPanels>
      <<<owned_tiles(bn, tk, kDkvGroups), 128 * kDkvGroups, kSmem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
          (const float*)l, (const float*)m, (const float*)di,
          (const float*)kv_mask, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, tq,
          tk, n_heads, scale, causal);
  return cudaGetLastError();
}

template <int kPanels>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* l, const void* m,
                      const void* di, const void* kv_mask, void* dq, int bn,
                      int tq, int tk, int n_heads, float scale, int causal,
                      cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<kPanels>(kDqGroups);
  const cudaError_t err = allow_smem<flash_bwd_dq_tc_kernel<kPanels>>(kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<kPanels>
      <<<owned_tiles(bn, tq, kDqGroups), 128 * kDqGroups, kSmem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
          (const float*)l, (const float*)m, (const float*)di,
          (const float*)kv_mask, (__nv_bfloat16*)dq, tq, tk, n_heads, scale,
          causal);
  return cudaGetLastError();
}

}  // namespace

// panels: the head size over 64, 1 or 2
cudaError_t flash_bwd_dkv_bf16(int panels, const void* q, const void* k,
                               const void* v, const void* dout, const void* l,
                               const void* m, const void* di,
                               const void* kv_mask, void* dk, void* dv,
                               int bn, int tq, int tk, int n_heads,
                               float scale, int causal, cudaStream_t stream) {
  if (panels == 1)
    return launch_dkv<1>(q, k, v, dout, l, m, di, kv_mask, dk, dv, bn, tq,
                         tk, n_heads, scale, causal, stream);
  if (panels == 2)
    return launch_dkv<2>(q, k, v, dout, l, m, di, kv_mask, dk, dv, bn, tq,
                         tk, n_heads, scale, causal, stream);
  return cudaErrorInvalidValue;
}

cudaError_t flash_bwd_dq_bf16(int panels, const void* q, const void* k,
                              const void* v, const void* dout, const void* l,
                              const void* m, const void* di,
                              const void* kv_mask, void* dq, int bn, int tq,
                              int tk, int n_heads, float scale, int causal,
                              cudaStream_t stream) {
  if (panels == 1)
    return launch_dq<1>(q, k, v, dout, l, m, di, kv_mask, dq, bn, tq, tk,
                        n_heads, scale, causal, stream);
  if (panels == 2)
    return launch_dq<2>(q, k, v, dout, l, m, di, kv_mask, dq, bn, tq, tk,
                        n_heads, scale, causal, stream);
  return cudaErrorInvalidValue;
}

// x [128, 64], y [64, 64] bf16 -> nt, tn [128, 64] float32
extern "C" int flash_tile_products(const void* x, const void* y, void* nt,
                                   void* tn, void* stream) {
  const cudaError_t err =
      allow_smem<flash_tile_products_kernel>(smem_bytes<1>(2));
  if (err != cudaSuccess) return (int)err;
  flash_tile_products_kernel<<<1, 256, smem_bytes<1>(2),
                               (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)y, (float*)nt,
      (float*)tn);
  return (int)cudaGetLastError();
}

