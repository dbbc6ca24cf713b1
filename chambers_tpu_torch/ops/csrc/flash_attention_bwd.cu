// The flash attention backward kernels for bf16 and float16 operands, on
// the H100's tensor cores. Second source of the flash_attention library;
// flash_attention.cu holds the C interface, which sends bfloat16 and
// float16 here and float32 to its own FMA kernels.
//
// Replaces the Pallas TPU kernels of chambers_tpu/ops/flash_attention.py:
//   flash_bwd_dkv_tc_kernel  <- _flash_backward / _flash_bwd_dkv_kernel  (K3b)
//   flash_bwd_dq_tc_kernel   <- _flash_backward / _flash_bwd_dq_kernel   (K3c)
// and, at head size 32, flash_bwd_dkv_narrow_kernel and
// flash_bwd_dq_narrow_kernel, at head sizes 128 and 256 for K3b
// flash_bwd_dkv_producer_kernel, at head sizes above 256,
// flash_bwd_dkv_cluster_kernel and flash_bwd_dq_cluster_kernel, and for K3b
// at head size 64 over at most 256 queries and 129 to 256 keys (ViT
// lengths) flash_bwd_dkv_short_kernel,
// and computes what flash_attention.cu's note says they compute: per key
// tile over all query tiles p = exp(s - m) / l, dv += p^T do,
// ds = p (do v^T - di), dk += ds^T q scale; per query tile over all key
// tiles dq += ds k scale; the [b, tk] key mask shared by a batch item's
// heads, the causal diagonal at the sequence end, exact zeros for a row or a
// batch item with no valid key, any tq and tk, head size 64, 128 or 256
// (one, two or four panels, a template parameter), 32 in the narrow
// kernels and, in the kernels above 256, any multiple of 64 (the wrapper
// pads other sizes).
// The operand type T (__nv_bfloat16 or __half) is the other template
// parameter: it sets the rounding of p, ds and the outputs and
// the wgmma instruction's type, nothing else.
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
//   rounded to T and fed straight back as the A operand of the second
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
//   to T before the second products, because a 16-bit tensor-core product
//   takes the same type on both sides (flash_backward_plain states the
//   same).
// * Head size 256 (four panels). K3b cannot hold dK and dV in one
//   warpgroup: 256 float32 registers a thread for them alone. So K3b runs
//   the producer kernel there (the section at the end of this note): two
//   warpgroups over the same 64 keys, each accumulating two panels of dK
//   and two of dV. K3c at 256 keeps one warpgroup a block: its dQ is four
//   panels, 128 registers, beside S, dP and dS (80), and two warpgroups on
//   different rows would need 128 KB for their own Q and dO tiles before
//   any passing tile. It has two stages, not three, in shared memory
//   (194 KB).
// * Head sizes above 256. The whole-tile design runs out of room there (at
//   256 K3b already takes 210 KB of shared memory and 255 registers; at 512
//   dK and dV for 64 keys are 256 KB of float32, an SM's whole register
//   file), so the head's output columns are split over blocks along z, each
//   owning 64 rows (query rows in K3c, keys in K3b) and one part of the
//   columns. The head size is a run-time argument: one instantiation per
//   type serves every multiple of 64.
//   K3c: the cluster kernel (flash_bwd_dq_cluster_kernel). A block has
//   two consumer warpgroups over 64 query rows and owns at most kDqOwn = 8
//   panels of dQ and of Q and dO (resident, 128 KB), half of them, rounded
//   up, to group 0 (128 float32 registers of dQ a thread); a third
//   warpgroup gives its registers up (setmaxnreg: 24 a thread, the
//   consumers 240) and its first warp is the producer, which keeps TMA
//   loads of K's and V's panels in flight into a ring of kDqSlots = 4
//   items of two panels on full and empty mbarriers and writes each key
//   step's flags beside its first item. The blocks over the same 64 rows
//   form a cluster along z (dq_cluster_split: as few blocks as hold the
//   head, the panels balanced over them; one block, no cluster, up to h
//   512; 7 + 6 + 6 at 1216; above h 4096 several clusters, each block
//   also computing the terms of the panels its rank owns in the others, as
//   K3a's cluster kernel does). Key step s: group 0 computes the block's
//   terms of S over its panels, K's items two panels at a time, group 1
//   those of dP over V's items; each writes its tile to the block's
//   exchange buffer, lanes 0 .. n - 1 signal the n blocks' `ready`
//   mbarriers, and each group sums both tiles over the cluster in rank
//   order (its own tile's term from its registers, the other group's
//   through this block's shared memory, the other blocks' through
//   distributed shared memory), so both groups of every block hold the
//   same bits of S and dP and compute the same ds (dq_scores); then each
//   signals the `free` mbarriers (the buffer may be written again once
//   every block has read it; a block alone alternates the two tiles
//   between its groups instead) and multiplies its panels of K, passed by
//   a second time, by the rounded ds. So each score product is computed
//   once a cluster; K passes twice a step and V once. 231 KB of shared
//   memory, 384 threads (ptxas reports the 168 registers a thread of the
//   launch), no spills: one block an SM.
//   As measured on an NVIDIA H100 80GB HBM3 at 700 W (compare_flash_builds.py
//   --only dq_cluster against 414d977's sliced kernel, in turns; PERF.md
//   section 6), bf16 with the ragged key mask: [16, 512, 512] 56.1 us
//   against 77.1 (causal 56.3 against 74.2; float16 56.2), [25, 512, 320]
//   81.9 against 92.8, [16, 512, 576] 115.3 against 140.1, [16, 512, 1024]
//   139.3 against 275.8, [16, 512, 1216] 302.8 against 477.0, [16, 512,
//   2112] 724.3 against 1402.0. Replaced: flash_bwd_dq_sliced_kernel (a
//   block one warpgroup and 4 panels of dQ, every slice computing S and dP
//   over the whole head again: 1.67 times the tensor work at 512). Tried,
//   and slower: blocks of 4 panels (two in a cluster at h 512, five at
//   1216), each group summing one tile over the cluster and the two
//   swapping the sums through the exchange buffer of the other parity
//   (two buffers, no free barrier): 78.9 us at 512 and 476.8 at 1216;
//   without the remote loads it took 62.8 and 188.1, without any exchange
//   49.5 and 146.8: distributed shared memory bound it, about 32 KB a
//   block a step at 512 and 128 KB at 1216, which the 8-panel blocks cut
//   to none and 64 KB.
//   K3b: the cluster kernel. A block is two warpgroups over the same 64 keys
//   and owns kDkvOwn = 4 panels each of dK and dV, two a warpgroup (as K3b
//   at 256). The blocks over the same 64 keys form a thread-block cluster
//   along z (cluster_split: n = ceil(panels / 4) blocks, at most the
//   portable 8; a wider head takes several clusters, each owning 4 n panels
//   of the output and each computing the score products over the whole
//   head once). A block keeps its own panels of K and V and passes the
//   other side's own panels through a ring of three 32 KB slots, one item
//   ahead (both of a step's items are read to its end). Warpgroup 0
//   computes the block's terms of S^T, warpgroup 1 those of dP^T, over its
//   own panels with wgmma, and ClusterSum (flash_tiles.cuh) adds up the
//   cluster's terms through distributed shared memory, each sum once and in
//   rank order, so every block holds the same bits of S^T and dP^T.
//   Warpgroup 1 hands dP^T over and warpgroup 0 hands p and ds back as at
//   256 (dkv_scores), and the second products run on the block's own
//   panels. So each (key tile, query tile) pair's products are computed
//   once a cluster, and each operand panel is copied once a step, by the
//   block that owns it. In a cluster of several chunks the block's parts
//   of the other chunks pass through the ring first, one panel of all four
//   operands an item. A part that runs past the head (h 320: blocks of four
//   panels and of one) is filled with zeros, so the panel counts are
//   compile-time constants; only the part inside the head is written.
//   Every skip (no kept key, above the causal diagonal) depends on the
//   block's keys alone, so the blocks of a cluster take the same ones and
//   meet at the same cluster barriers, and no block overwrites or leaves
//   its exchange buffer while another may still read it. 210 KB of shared
//   memory, 256 threads: one block an SM.
//   What bounds it, as measured on an H100 (PERF.md section 6): the
//   exchange, not the products. Distributed shared memory moved a small
//   fraction of what L2 gives an SM in every form tried, and every step
//   waits for it: 16-byte loads of every block's terms (kept for clusters
//   of two, 15% faster there than the general form), then of a
//   reduce-scatter's share (kept from three blocks on, two loads in flight
//   a thread: more took more registers, spilled, and ran slower), 8-byte
//   st.async pushes counted by the owner's mbarrier, bulk copies between
//   the blocks, plain remote stores. Its own panels went from two (one
//   warpgroup, clusters of up to 8) to four (two warpgroups), which halved
//   the terms it exchanges for the same work.
//
// ViT lengths: flash_bwd_dkv_short_kernel. At DeiT-B/16's [1536, 198, 64]
// the whole-tile design launches 6144 blocks of 64 keys, a head's four key
// blocks some 1536 blocks apart: between them the Q and dO of every head
// (78 MB, more than the 50 MB L2) stream past, so each key block reads its
// head's Q and dO from device memory again; each block pays a ring fill
// and drain for four query steps, and the ragged ends (6 of 64 keys, 6 of
// 64 queries) cost whole tiles. Launched with a head's key blocks next to
// each other the same kernel ran 133.0 us against 172.7 (PERF.md section
// 6): the re-reads cost 40 us. So here a block walks whole heads
// persistently (one block an SM; heads blockIdx.x, + gridDim.x, ...):
// * Two query buffers each hold a head's Q and dO (all tq <= 256 rows, 32
//   KB each, the panel layout flash_tiles.cuh describes), filled by TMA
//   (head_map, 128-byte swizzle, rows past tq as zeros) on an mbarrier;
//   each byte crosses from device memory once. The last group done with
//   a buffer refills it with the head two on.
// * Three warpgroups each own one key tile (64 keys) of every head, its K
//   and V in a slot of their own (8 KB each, by TMA on the slot's
//   mbarrier), refilled with the next head's tile as soon as the group is
//   done with it; dK and dV (64 float32 registers a thread) leave straight
//   from the fragments (store_fragments), so no slot waits for an epilogue.
//   A group runs K3b's arithmetic on its tile out of the resident buffers:
//   per query tile S^T and dP^T with wgmma, p and ds (dkv_scores), rounded
//   to T, into dV and dK, the query tiles in order, so dK and dV are the
//   bits of flash_bwd_dkv_tc_kernel.
// * The rows' exponent offsets and di go per query into an array of the
//   group's own once a head: each thread copies its two rows of m, l and
//   di (and of the key mask) by 4-byte cp.async a head ahead, then folds
//   them. (A one-dimensional TMA copy of the rows, from a start that is
//   not 16-byte aligned, raised "illegal instruction".)
// * The query side's ragged end (at most 8 rows: 6 at 198, 5 at 197) takes
//   an m64n8 S^T and dP^T and one k16 step of each second product.
// * The key side's ragged end: a fourth key tile (tk above 192) goes to
//   warpgroup j % 3 for the block's j-th head, after its own tile. When it
//   holds 8 keys or fewer (6 at 198) its products run transposed, queries
//   by keys (dkv_short_tail): S and dP as m64n8 products, p and ds rounded
//   into two key-major panels of shared memory, then dV^T += dO^T P and
//   dK^T += Q^T dS (product_t8, both operands in shared memory): an eighth
//   of a tile's products, the same sums in the same order, and the same
//   bits.
// 384 threads, 168 registers, no spills, 220 KB of shared memory: one
// block an SM.
//
// What binds it, as measured on an H100 (compare_flash_builds.py and
// scratch ablations, PERF.md section 6): at [1536, 198, 64] bf16 122.5 us
// against the whole-tile kernel's 170.1 and SDPA's whole backward 333.4;
// the bytes bound is 70.8 us. Without copies after the first heads it
// takes 118.0 us, without S^T and dP^T 107.0, without the second products
// 112.6, without p and ds 108.6, with the copies alone 92.4: the three
// warpgroups' chains of products and scores bind it, not device memory.
// Handing the fourth tile to nobody made it slower (128.8 us): the turns
// keep the groups out of step, so one's products overlap another's
// scores. Tried, and slower: four warpgroups a block (a key tile each,
// S^T and dP^T in halves of 32 queries to fit 128 registers; 147.3 us,
// 36 bytes spilled), dV's product issued while ds is computed and p
// while dP^T runs (175.2 against 122.8, 44 bytes spilled), the query
// side's ragged end in the last full step's batches (144.7 against 122.9,
// 56 bytes spilled): at 168 registers every extra live value spills.
//
// Head size 32: flash_bwd_dkv_narrow_kernel and flash_bwd_dq_narrow_kernel,
// for bfloat16 and float16 (float32 keeps its FMA kernels at 64). Padded to
// 64, K3b and K3c did every product twice over (half of each operand
// zeros), copied and held tiles twice their size, and the wrapper padded
// dO and cut dQ, dK and dV after each call. The narrow kernels work on
// 32-column panels (flash_tiles.cuh: 64-byte rows, the 64-byte swizzle,
// wgmma's B64 descriptors): S^T (or S) and dP^T (or dP) take two k16
// steps, dV^T += P^T dO, dK^T += dS^T Q and dQ += dS K are m64n32 products
// with 16 float32 registers a thread each. Otherwise they are K3b's and
// K3c's whole-tile kernels: a block is one warpgroup over 64 rows of its
// own (keys in K3b, query rows in K3c), the other side passing by in
// tiles of 64 rows (4 KB an operand) through a ring of four stages filled
// by cp.async three steps ahead, one __syncthreads a step, in K3b's or
// K3c's order per tile (the tiles of the other side in order, the same
// exponent offsets, p and ds rounded to T before the second products), so
// dK, dV and dQ are the bits of the padded call's first 32 columns: the
// padded columns only added exact zeros to every float32 sum. dK, dV and
// dQ leave straight from the fragments.
// At this head size the tensor work per score halves and the exponents do
// not: over [256, 512, 32] with the ragged key mask the bytes (14.3 us for
// K3b, 11.8 for K3c), the products (13.1 and 9.9 us) and the SFU's exp2,
// one a kept score at 16 a clock an SM (12.1 us at 1980 MHz), are close.
// The exponents of one warpgroup run under the products of the others: the
// registers are fit to four blocks an SM (128 and 106 registers, 44 KB of
// shared memory), and the SM's schedulers interleave them.
// As measured on an H100 (compare_flash_builds.py --narrow, in turns
// against the padded call; PERF.md section 6): K3b 53.6 us against 86.7,
// K3c 43.1 against 64.2. Alone (scratch builds) the copies took 32.1 and
// 25.3 us, the copies with the products and no exponents 41.2 and 28.9,
// with the exponents and no products 30.8 and 25.4: each part alone is
// near the copies' time, and the warpgroups' chains of products and
// exponents (wait for S^T and dP^T, exponents, wait for the second
// products) bound the whole. Tried, and slower: two warpgroups a block,
// each over its own 64 rows, taking turns on the tensor cores on named
// barriers (each issues its products and passes the turn before it waits,
// so one's exponents run under the other's products), at one block an SM
// (K3b 91.3-92.3 us, 163 registers; K3c 49.3) or two (K3b 62.7 at 128
// registers); the same two warpgroups without turns (K3b 85.5 at one block
// an SM, 58.5 at two; K3c 47.9); the next tile's score products issued
// before this tile's exponents in each warpgroup (K3b 74.6 us at 171
// registers, K3c 58.9 at 219: two blocks an SM); each step in two halves
// of 32 rows, the second half's score products and the first half's second
// products each running under the other half's exponents (K3b 56.2 us
// against 53.8 in the same call, K3c 45.6 against 43.2; the same bits);
// five ring stages (level); dQ's product left in flight across the next
// step's copies (45.8 us: ptxas serialised the wgmma, C7515); one
// warpgroup a block at three blocks an SM (K3b 63.3 us).
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
//   K3b at ViT lengths (the short kernel) three warpgroups a block (384
//        threads), 168 registers (65,536 / 384 = 170), no spills, 220 KB
//        of shared memory: one block an SM, 132 resident.
//   Head size 32 (the narrow kernels): one warpgroup a block, K3b 128
//        registers, K3c 106, no spills, 44 KB of shared memory: four blocks
//        an SM.
//   Head sizes 128 and 256: K3b's producer kernel (below), 384 threads,
//   the consumers at 240 registers, no spills, 195 KB of shared memory at
//   128 and 226 KB at 256: one block an SM. K3c at 128 keeps two
//   warpgroups, 163 KB: one block an SM, 166 registers, no spills.
//
// Head sizes 128 and 256: flash_bwd_dkv_producer_kernel<T, kPanels>. At
// 128 the whole-tile K3b held a
// block's 64 keys' dK and dV in one warpgroup's registers (128 of its 246
// a thread), 131 KB of shared memory: one warpgroup an SM, and nothing
// filled the gaps in its chain (stage wait, S^T and dP^T, exponents, the
// dV and dK products): 56.1 us at [64, 512, 128], where the h 64 kernel
// does the same operations at three blocks an SM in 46.7. Here a block
// owns 128 keys in two consumer warpgroups of 64 keys each, each keeping
// its own dK and dV in registers, and a third warpgroup gives its
// registers up (setmaxnreg: 24 a thread, the consumers 240) so that its
// first warp is the producer: it copies the block's K and V tiles once and
// the passing Q and dO tiles by TMA (tensor maps of [bn, t, 128] whose box
// is one 64-row panel) into a ring of four stages (Pair<2>) on full and
// empty mbarriers, with each tile's exponent offsets and di beside them.
// So the two groups share each stage's Q and dO (half the bytes a key) and
// their two chains interleave on the SM. Each group runs K3b's arithmetic
// on its tile in the whole-tile kernel's order (the same products over the
// query tiles in the same order), so dK and dV are its bits. As measured
// on an NVIDIA H100 80GB HBM3 at 700 W (compare_flash_builds.py --only
// producer against 4fe19bb, in turns, one call; PERF.md section 6): at
// [64, 512, 128] bf16 with the ragged key mask 45.5 us against 55.6
// (causal 33.3 against 39.7; float16 45.5 against 55.9), every h 128 case
// bit-equal.
// At 256 (Pair<4>) a block owns 64 keys, its K and V tiles resident (64
// KB), the ring two stages of 64 query rows of Q and dO (64 KB each), and
// the two consumer warpgroups split the head's panels of dK and dV, two
// each, as the whole-tile kernel's two warpgroups did there: group 0
// computes S^T over the whole head, group 1 dP^T. Where the whole-tile
// kernel handed dP^T to group 0, which computed p and ds alone and handed
// them back (two barriers, the other group idle), here split_scores has
// each group compute p and ds for half of the tile's query columns: each
// hands the other the half of its tile the other needs, and the two then
// hand each other their halves of p and ds rounded to T, so both hold the
// same pt and dst with the whole-tile kernel's bits, every exponent
// computed once. As measured on an NVIDIA H100 80GB HBM3 at 700 W
// (compare_flash_builds.py --only producer256 against 414d977, in turns;
// PERF.md section 6): at [32, 512, 256] bf16 with the ragged key mask
// 54.8 us against 58.7 (causal 38.1 against 40.5; float16 54.9 against
// 59.0), every h 256 case bit-equal. Tried, and slower: both groups
// swapping whole tiles once a step and each computing every p and ds
// (59.4 us against 58.7; 48 bytes spilled), and that with the next step's
// score product in one batch with the step's second products (57.3 against
// the kept form's 54.6: two stages leave the next stage's copy too little
// time). Ablated (the swap form): without the swap 56.5 us, without the
// exponents 53.0, without the second products 46.3: the groups' chain of
// products, exchange and exponents binds it, not the copies.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash_tiles;

// warpgroups a block, and blocks an SM the compiler fits the registers to,
// by head panels: K3c's warpgroups own 64 query rows each (K3b's
// whole-tile kernel is one warpgroup)
__host__ __device__ constexpr int dq_groups(int panels) {
  return panels == 4 ? 1 : 2;
}
constexpr int dkv_blocks(int panels) { return panels == 1 ? 3 : 1; }
constexpr int dq_blocks(int panels) { return panels == 1 ? 2 : 1; }
// the ring of passing tiles
__host__ __device__ constexpr int stages(int panels) {
  return panels == 4 ? 2 : 3;
}
constexpr int kRowsBytes = 2 * kTileRows * 4; // per-row floats of a stage
// a [64 x 64] float32 tile handed between two warpgroups, 32 values a
// thread (K3b's cluster and producer kernels)
constexpr int kHandBytes = 128 * 32 * 4;

// a block owns `own` tiles of two operands (own = its warpgroups for K3c,
// 1 for K3b), and a stage holds two tiles
template <int kPanels>
__host__ __device__ constexpr size_t smem_bytes(int own) {
  return 1024 + own * 2 * tile_bytes<kPanels>() +
         stages(kPanels) * (2 * tile_bytes<kPanels>() + kRowsBytes) + 64;
}

struct RowStats {
  float m, l, di;
};

// K3c's ds = p (dp - di) on a warpgroup's score tile `s` (its 64 query rows
// against the tile's 64 keys k0 ..) in place, p = exp2(s scale log2 e -
// lse2) from the rows' exponent offsets; unless `unmasked`, zero where the
// pair takes no part: a row past tq, a key whose `valid` flag is off, a key
// past the row's diagonal.
__device__ __forceinline__ void dq_scores(float (&s)[32],
                                          const float (&dp)[32],
                                          const float (&lse2)[2],
                                          const float (&di_r)[2],
                                          float scale2, bool unmasked,
                                          const float* valid, int k0,
                                          int row_a, int tq, int tk,
                                          int causal, int offset, int t) {
  if (unmasked) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_fast(fmaf(s[i], scale2, -lse2[r])) * (dp[i] - di_r[r]);
    }
    return;
  }
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
        *reinterpret_cast<const float2*>(valid + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * t + e;
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

// K3b's p and ds on a warpgroup's transposed tile (its 64 keys, the
// thread's two from key_a, against the tile's 64 query rows q0 .., or its
// first 32 or 8: kN = 32, 16 or 4 values a thread) in place: st becomes p,
// dpt ds = p (dp - di), from the rows' exponent offsets and di in shared
// memory (`lse2_s`, `di_s`, from row q0); unless `unmasked`, zero where the
// pair takes no part: a row past tq or above the key's diagonal, a key the
// mask drops (`key_ok`).
template <int kN>
__device__ __forceinline__ void dkv_scores(float (&st)[kN], float (&dpt)[kN],
                                           const float* lse2_s,
                                           const float* di_s, float scale2,
                                           bool unmasked, int q0, int tq,
                                           const bool (&key_ok)[2],
                                           int key_a, int causal, int offset,
                                           int t) {
  constexpr int kCols = kN / 4;  // groups of 8 query columns
  if (unmasked) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float2 lse2 =
          *reinterpret_cast<const float2*>(lse2_s + 8 * j + 2 * t);
      const float2 di_r =
          *reinterpret_cast<const float2*>(di_s + 8 * j + 2 * t);
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; ++i) {
        const float p =
            exp2_fast(fmaf(st[i], scale2, i & 1 ? -lse2.y : -lse2.x));
        st[i] = p;
        dpt[i] = p * (dpt[i] - (i & 1 ? di_r.y : di_r.x));  // ds
      }
    }
    return;
  }
  // the first query row each of the thread's keys is seen by
  int first_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    first_row[r] = !key_ok[r] ? tq : causal ? key_a + 8 * r - offset : 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float2 lse2 =
        *reinterpret_cast<const float2*>(lse2_s + 8 * j + 2 * t);
    const float2 di_r =
        *reinterpret_cast<const float2*>(di_s + 8 * j + 2 * t);
#pragma unroll
    for (int i = 4 * j; i < 4 * j + 4; ++i) {
      const int row = q0 + 8 * j + 2 * t + (i & 1);
      const bool ok = row < tq && row >= first_row[(i >> 1) & 1];
      const float p =
          exp2_fast(fmaf(st[i], scale2, i & 1 ? -lse2.y : -lse2.x));
      st[i] = ok ? p : 0.f;
      dpt[i] = ok ? p * (dpt[i] - (i & 1 ? di_r.y : di_r.x)) : 0.f;
    }
  }
}

// K3b: whether each of the thread's two keys (key_a and key_a + 8) takes
// part, and whether any (`keys_any` nonzero) and all (`keys_all`) of the
// block's 64 keys do, from the first warpgroup's four warps; `flags` holds
// a word a warp; a barrier.
__device__ __forceinline__ void block_keys(bool (&key_ok)[2], int& keys_any,
                                           int& keys_all,
                                           const float* mask_row, int key_a,
                                           int tk, const Lanes& at,
                                           int* flags) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    key_ok[r] = key < tk && (mask_row == nullptr || mask_row[key] > 0.f);
  }
  const bool any = __any_sync(0xffffffffu, key_ok[0] || key_ok[1]);
  const bool all = __all_sync(0xffffffffu, key_ok[0] && key_ok[1]);
  if (at.lane == 0) flags[at.tid >> 5] = (any ? 1 : 0) | (all ? 2 : 0);
  __syncthreads();
  keys_any = 0;
  keys_all = 2;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    keys_any |= flags[w] & 1;
    keys_all &= flags[w] & 2;
  }
}

// the statistics of query row `row` of batch-head `bn`, zeros past tq
__device__ __forceinline__ RowStats row_stats(const float* m, const float* l,
                                              const float* di, int bn,
                                              int tq, int row) {
  RowStats r = {0.f, 0.f, 0.f};
  if (row < tq) {
    const size_t i = (size_t)bn * tq + row;
    r.m = m[i];
    r.l = l[i];
    r.di = di[i];
  }
  return r;
}

// K3c: dq for the block's query rows over all key tiles
template <typename T, int kPanels>
__global__ void __launch_bounds__(128 * dq_groups(kPanels), dq_blocks(kPanels))
    flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ l,
                           const float* __restrict__ m,
                           const float* __restrict__ di,
                           const float* __restrict__ kv_mask,
                           T* __restrict__ dq, int tq, int tk, int n_heads,
                           float scale, int causal) {
  constexpr int kGroups = dq_groups(kPanels), kThreads = 128 * kGroups,
                kOwned = kTileRows * kGroups, kStages = stages(kPanels);
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
  const T* kb = k + (size_t)bn * tk * kHd;
  const T* vb = v + (size_t)bn * tk * kHd;
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
  const int k_end = kept_key_end<kThreads>(
      mask_row, causal ? min(tk, q0 + kOwned + offset) : tk, at.tid,
      flags_s);
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
      if (at.tid < kTileRows)  // which keys of the tile take part
        stage_key_flag(valid_s + stage * kTileRows + at.tid, mask_row,
                       k0 + at.tid, tk);
    }
    cp_async_commit();  // an empty group keeps the count of groups in step
  };

  for (int step = 0; step < kStages - 1; ++step) stage_step(step);

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
    product_nt<T, kPanels>(s, q_s + at.group * kTile, k_s);
    product_nt<T, kPanels>(dp, do_s + at.group * kTile, v_s);
    products_end();
    keep_registers(s);
    keep_registers(dp);

    // every pair of the tile takes part: no test per element
    const bool unmasked =
        n_valid == kTileRows && rows_inside &&
        (!causal || k0 + kTileRows - 1 <= group_row0 + offset);
    dq_scores(s, dp, lse2, di_r, scale2, unmasked, valid, k0, row_a, tq, tk,
              causal, offset, at.t);
    uint32_t ds[4][4];
    pack_a_fragments<T>(s, ds);

    products_begin();
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      product_tn<T>(acc[p], ds, k_s + p * kPanelBytes);
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

// K3b: dk, dv for the block's 64 keys over all query tiles, one warpgroup
template <typename T, int kPanels>
__global__ void __launch_bounds__(128, dkv_blocks(kPanels))
    flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ l,
                            const float* __restrict__ m,
                            const float* __restrict__ di,
                            const float* __restrict__ kv_mask,
                            T* __restrict__ dk, T* __restrict__ dv, int tq,
                            int tk, int n_heads, float scale, int causal) {
  constexpr int kThreads = 128, kStages = stages(kPanels);
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
  const T* qb = q + (size_t)bn * tq * kHd;
  const T* dob = dout + (size_t)bn * tq * kHd;
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

  // The per-row statistics of a passing tile, read by 64 threads kStages - 1
  // steps ahead (load_rows), turned into the exponent offset and di, put in
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
  int keys_any, keys_all;
  block_keys(key_ok, keys_any, keys_all, mask_row, key_a, tk, at, flags_s);
  if (!keys_any) {  // no key of the block takes part: zeros, nothing read
    store_zero_rows<kHd>(dv + (size_t)bn * tk * kHd, k0, tk, at.tid);
    store_zero_rows<kHd>(dk + (size_t)bn * tk * kHd, k0, tk, at.tid);
    return;
  }

  stage_rows<kTileRows, kThreads, kPanels>(k_s, k + (size_t)bn * tk * kHd,
                                           k0, tk, at.tid);
  stage_rows<kTileRows, kThreads, kPanels>(v_s, v + (size_t)bn * tk * kHd,
                                           k0, tk, at.tid);
  for (int step = 0; step < kStages - 1; ++step) stage_step(step);
  store_rows(0, rows0);
  if (kStages > 2) store_rows(1, rows1);
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
      product_nt<T, kPanels>(st, k_s, q_s);
      product_nt<T, kPanels>(dpt, v_s, do_s);
      products_end();
      keep_registers(st);
      keep_registers(dpt);

      // every pair of the tile takes part: no test per element
      const bool unmasked =
          keys_all && q0 + kTileRows <= tq &&
          (!causal || k0 + kTileRows - 1 <= q0 + offset);
      dkv_scores(st, dpt, lse2_s, di_s, scale2, unmasked, q0, tq, key_ok,
                 key_a, causal, offset, at.t);
      uint32_t pt[4][4], dst[4][4];
      pack_a_fragments<T>(st, pt);
      pack_a_fragments<T>(dpt, dst);

      products_begin();
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        product_tn<T>(dv_acc[p], pt, do_s + p * kPanelBytes);
        product_tn<T>(dk_acc[p], dst, q_s + p * kPanelBytes);
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
                           smem + p * kPanelBytes, dv_acc[p], 1.f, k0, tk,
                           1, at.tid);
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
  product_nt<__nv_bfloat16, 1>(first, x_s + at.group * kPanelBytes, y_s);
  products_end();
  keep_registers(first);
  uint32_t a[4][4];
  pack_a_fragments<__nv_bfloat16>(first, a);
  products_begin();
  product_tn<__nv_bfloat16>(second, a, y_s);
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

// ---------------------------------------------------------------------------
// head sizes above 256: K3b's cluster kernel (see the note at the top)
// ---------------------------------------------------------------------------

// panels each of dK and dV a K3b block owns, 256 columns: two warpgroups
// of two panels each
constexpr int kDkvOwn = 4;
constexpr int kClusterSlots = 3;  // the ring's 32 KB slots

// How a head of `panels` panels is cut for K3b's blocks, which own kDkvOwn
// panels each: clusters of `blocks` blocks, `clusters` of them along z, as
// few as the portable cluster size allows; each cluster owns blocks *
// kDkvOwn panels (the last block's may run past the head).
struct ClusterSplit {
  int blocks, clusters;
};

__host__ __device__ constexpr ClusterSplit cluster_split(int panels) {
  constexpr int most = kMaxCluster * kDkvOwn;  // a cluster's panels at most
  const int clusters = (panels + most - 1) / most;
  return {(panels + clusters * kDkvOwn - 1) / (clusters * kDkvOwn), clusters};
}

// K3b's cluster kernel: its own panels of K and V, the ring, ClusterSum's
// buffer, the hand-over between its warpgroups, the row statistics for two
// steps, flags
__host__ __device__ constexpr size_t cluster_smem_bytes() {
  return 1024 + 2 * kDkvOwn * kPanelBytes + kClusterSlots * kSlotBytes +
         kExchangeBytes + kHandBytes + 2 * kRowsBytes + 64;
}

// A block's place: `n` blocks a cluster, this one `rank`; `chunks`
// clusters along z, this one `chunk`. Chunk g of the head is panels
// [g n kDkvOwn, (g + 1) n kDkvOwn), and the block's part of it starts at
// first(g); its output columns are its part of its own chunk.
struct ClusterPlace {
  int n, rank, chunks, chunk;
  __device__ ClusterPlace()
      : n(cluster_blocks()), rank(cluster_rank()),
        chunks(gridDim.z / cluster_blocks()),
        chunk(blockIdx.z / cluster_blocks()) {}
  __device__ int first(int g) const { return (g * n + rank) * kDkvOwn; }
  // the first column of the e-th panel of the block's parts of the other
  // chunks
  __device__ int other_col(int e) const {
    const int g = e / kDkvOwn;
    return (first(g < chunk ? g : g + 1) + e % kDkvOwn) * kPanelCols;
  }
};

// The panel from column `col` of rows [row0, row0 + 64) of a [rows, hd]
// array of T into `panel`, by kThreads threads; a panel past the head's
// end (col >= hd) becomes zeros.
template <int kThreads, typename T>
__device__ __forceinline__ void stage_head_panel(uint32_t panel, const T* src,
                                                 int col, int row0, int rows,
                                                 int hd, int tid) {
  const bool inside = col < hd;
  stage_panel<kThreads>(panel, inside ? src + col : src, row0,
                        inside ? rows : 0, hd, tid);
}

// K3b: dk, dv for the block's 64 keys and its kDkvOwn panels each of the
// head's columns, over all query tiles. Warpgroup 0 computes the block's
// terms of S^T, warpgroup 1 those of dP^T, over the block's part of the
// head; each sums its tile over the cluster, warpgroup 1 hands dP^T to
// warpgroup 0, which computes p and ds and hands them back rounded, and
// each warpgroup accumulates two of the block's panels of dK and dV.
template <typename T>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkv_cluster_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const T* __restrict__ dout,
                                 const float* __restrict__ l,
                                 const float* __restrict__ m,
                                 const float* __restrict__ di,
                                 const float* __restrict__ kv_mask,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 int tq, int tk, int hd, int n_heads,
                                 float scale, int causal) {
  constexpr int kOwnBytes = kDkvOwn * kPanelBytes;
  constexpr int kGroupPanels = kDkvOwn / 2;  // of dK and dV a warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t k_s = smem_u32(smem), v_s = k_s + kOwnBytes;
  const uint32_t ring = k_s + 2 * kOwnBytes;
  const uint32_t xbuf = ring + kClusterSlots * kSlotBytes;
  // the hand-over between the warpgroups: [value of the fragment][thread
  // of the warpgroup], 32 words a thread
  uint32_t* hand_s = reinterpret_cast<uint32_t*>(
      smem + 2 * kOwnBytes + kClusterSlots * kSlotBytes + kExchangeBytes);
  // [step % 2][exponent offset, di][query of the tile]
  float* rows_s = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(hand_s) + kHandBytes);
  int* flags_s = reinterpret_cast<int*>(rows_s + 2 * 2 * kTileRows);

  const Lanes at;
  const int group = at.group, in_group = at.tid & 127;
  const ClusterPlace place;
  const int panel0 = place.first(place.chunk);
  const int group_panel0 = panel0 + group * kGroupPanels;
  const int panels = hd / kPanelCols;
  const int bn = blockIdx.x, k0 = blockIdx.y * kTileRows;
  const T* qb = q + (size_t)bn * tq * hd;
  const T* dob = dout + (size_t)bn * tq * hd;
  const T* kb = k + (size_t)bn * tk * hd;
  const T* vb = v + (size_t)bn * tk * hd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  // under the causal mask only query rows with row + offset >= k0 reach
  // this block's keys; like every skip below, this depends on the keys
  // alone, the same in every block of the cluster
  const int first = causal && k0 - offset > 0 ? (k0 - offset) / kTileRows : 0;
  const int steps = (tq + kTileRows - 1) / kTileRows - first;

  // a passing tile's row statistics, read by 64 threads a step ahead into
  // registers and stored, folded, at the end of the step before
  auto load_rows = [&](int step) {
    return step < steps && at.tid < kTileRows
               ? row_stats(m, l, di, bn, tq,
                           (first + step) * kTileRows + at.tid)
               : RowStats{0.f, 0.f, 0.f};
  };
  auto store_rows = [&](int step, const RowStats& r) {
    if (at.tid < kTileRows && step < steps) {
      float* dst = rows_s + (step % 2) * 2 * kTileRows + at.tid;
      dst[0] = exponent_offset(r.m, r.l);
      dst[kTileRows] = r.di;
    }
  };
  const RowStats rows0 = load_rows(0);

  // the thread's two keys: g and g + 8 of its warp's 16 (the same in both
  // warpgroups)
  const int key_a = k0 + at.warp_in_group * 16 + at.g;
  bool key_ok[2];
  int keys_any, keys_all;
  block_keys(key_ok, keys_any, keys_all, mask_row, key_a, tk, at, flags_s);
  T* dk_cols = dk + (size_t)bn * tk * hd + group_panel0 * kPanelCols;
  T* dv_cols = dv + (size_t)bn * tk * hd + group_panel0 * kPanelCols;
  if (!keys_any) {  // no key takes part: zeros, nothing read
    for (int p = 0; p < kGroupPanels && group_panel0 + p < panels; ++p) {
      store_zero_panel(dv_cols + p * kPanelCols, k0, tk, hd, in_group);
      store_zero_panel(dk_cols + p * kPanelCols, k0, tk, hd, in_group);
    }
    return;
  }

#pragma unroll
  for (int p = 0; p < kDkvOwn; ++p) {
    const int col = (panel0 + p) * kPanelCols;
    stage_head_panel<256>(k_s + p * kPanelBytes, kb, col, k0, tk, hd, at.tid);
    stage_head_panel<256>(v_s + p * kPanelBytes, vb, col, k0, tk, hd, at.tid);
  }

  // A query step is `items` items through the ring: for each panel of the
  // block's parts of the other chunks, that panel of K, V, Q and dO; then
  // the block's own panels of Q, then of dO. Both of the last two are read
  // to the step's end, so the ring's next copy starts one item ahead.
  const int extras = (place.chunks - 1) * kDkvOwn, items = extras + 2;
  const int total = steps * items;
  auto stage_item = [&](int i) {
    if (i < total) {
      const int step = i / items, j = i - step * items;
      const int q0 = (first + step) * kTileRows;
      const uint32_t slot = ring + (i % kClusterSlots) * kSlotBytes;
      if (j < extras) {
        const int col = place.other_col(j);
        stage_head_panel<256>(slot, kb, col, k0, tk, hd, at.tid);
        stage_head_panel<256>(slot + kPanelBytes, vb, col, k0, tk, hd,
                              at.tid);
        stage_head_panel<256>(slot + 2 * kPanelBytes, qb, col, q0, tq, hd,
                              at.tid);
        stage_head_panel<256>(slot + 3 * kPanelBytes, dob, col, q0, tq, hd,
                              at.tid);
      } else {
        const T* src = j == extras ? qb : dob;
#pragma unroll
        for (int p = 0; p < kDkvOwn; ++p)
          stage_head_panel<256>(slot + p * kPanelBytes, src,
                                (panel0 + p) * kPanelCols, q0, tq, hd,
                                at.tid);
      }
    }
    cp_async_commit();
  };

  stage_item(0);  // with the own panels of K and V
  store_rows(0, rows0);  // read after the first barrier
  const float scale2 = scale * kLog2e;

  // dK and dV: one [64 x 64] accumulator a panel of the warpgroup's own
  float dk_acc[kGroupPanels][32], dv_acc[kGroupPanels][32];
#pragma unroll
  for (int p = 0; p < kGroupPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;
  ClusterSum<256> exchange(xbuf, place.n, place.rank, at.tid);
  exchange.init();

  // item i: wait for its copies, then start the next item's
  int i = 0;
  auto next_item = [&]() {
    cp_async_wait<0>();
    __syncthreads();
    stage_item(i + 1);
    return ring + (i++ % kClusterSlots) * kSlotBytes;
  };
  // the warpgroup's tile: K . Q^T (warpgroup 0) or V . dO^T (1), panel by
  // panel of operands at these offsets in a slot
  const uint32_t own_s = group ? v_s : k_s;
  const int extra_row = group * kPanelBytes, extra_col = (2 + group) * kPanelBytes;

  for (int step = 0; step < steps; ++step) {
    const int q0 = (first + step) * kTileRows;
    // the next step's statistics, stored at the end of this one
    const RowStats ahead = load_rows(step + 1);
    // a tile whose last row does not reach the block's first key is skipped
    const bool skip = causal && k0 > q0 + kTileRows - 1 + offset;
    float x[32];  // this block's terms of S^T or dP^T, then their sums
    for (int e = 0; e < extras; ++e) {
      const uint32_t slot = next_item();
      if (skip) continue;
      products_begin();
      product_nt_panel<T>(x, slot + extra_row, slot + extra_col, 4 * e);
      products_end();
      keep_registers(x);
    }
    // the own panels: warpgroup 0's S^T as soon as Q is in, while dO is
    // copied, then warpgroup 1's dP^T
    auto own_products = [&](uint32_t passing) {
      products_begin();
#pragma unroll
      for (int p = 0; p < kDkvOwn; ++p)
        product_nt_panel<T>(x, own_s + p * kPanelBytes,
                            passing + p * kPanelBytes, 4 * (extras + p));
      products_end();
      keep_registers(x);
    };
    const uint32_t q_slot = next_item();
    if (!skip && group == 0) own_products(q_slot);
    const uint32_t do_slot = next_item();
    if (!skip && group == 1) own_products(do_slot);
    if (!skip) {
      exchange.add(x);

      // warpgroup 1's dP^T to warpgroup 0, which turns S^T and dP^T into p
      // and ds and hands them back rounded to T
      if (group == 1) {
#pragma unroll
        for (int w = 0; w < 32; ++w)
          hand_s[w * 128 + in_group] = __float_as_uint(x[w]);
      }
      __syncthreads();
      uint32_t pt[4][4], dst[4][4];
      if (group == 0) {
        float dpt[32];
#pragma unroll
        for (int w = 0; w < 32; ++w)
          dpt[w] = __uint_as_float(hand_s[w * 128 + in_group]);
        const float* lse2_s = rows_s + (step % 2) * 2 * kTileRows;
        const bool unmasked = keys_all && q0 + kTileRows <= tq &&
                              (!causal || k0 + kTileRows - 1 <= q0 + offset);
        dkv_scores(x, dpt, lse2_s, lse2_s + kTileRows, scale2, unmasked, q0,
                   tq, key_ok, key_a, causal, offset, at.t);
        pack_a_fragments<T>(x, pt);
        pack_a_fragments<T>(dpt, dst);
#pragma unroll
        for (int w = 0; w < 16; ++w) {
          hand_s[w * 128 + in_group] = pt[w / 4][w % 4];
          hand_s[(16 + w) * 128 + in_group] = dst[w / 4][w % 4];
        }
      }
      __syncthreads();
      if (group == 1) {
#pragma unroll
        for (int w = 0; w < 16; ++w) {
          pt[w / 4][w % 4] = hand_s[w * 128 + in_group];
          dst[w / 4][w % 4] = hand_s[(16 + w) * 128 + in_group];
        }
      }

      products_begin();
#pragma unroll
      for (int p = 0; p < kGroupPanels; ++p) {
        const int panel = group * kGroupPanels + p;
        product_tn<T>(dv_acc[p], pt, do_slot + panel * kPanelBytes);
        product_tn<T>(dk_acc[p], dst, q_slot + panel * kPanelBytes);
      }
      products_end();
      keep_registers(pt);
      keep_registers(dst);
#pragma unroll
      for (int p = 0; p < kGroupPanels; ++p) {
        keep_registers(dv_acc[p]);
        keep_registers(dk_acc[p]);
      }
    }
    // read by the next step after at least one more barrier; this step's
    // are in the other half
    store_rows(step + 1, ahead);
  }

  // no block leaves before the cluster's exchanges are done; the ring and
  // the own K and V panels are read no more: panel p of dV leaves through
  // panel p of K, of dK through panel p of V, each warpgroup's own under
  // its own named barrier
  exchange.finish();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kGroupPanels; ++p)
    if (group_panel0 + p < panels) {
      const int panel = group * kGroupPanels + p;
      store_panel(dv_cols + p * kPanelCols, smem + panel * kPanelBytes,
                  dv_acc[p], 1.f, k0, tk, hd, 1 + group, in_group);
      store_panel(dk_cols + p * kPanelCols,
                  smem + kOwnBytes + panel * kPanelBytes, dk_acc[p], scale,
                  k0, tk, hd, 1 + group, in_group);
    }
}

// ---------------------------------------------------------------------------
// ViT lengths: K3b's short kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kShortRows = 256;  // the most queries or keys a head has
constexpr int kKeyTiles = kShortRows / kTileRows;  // K and V slots: 4
// warpgroups: one a key tile of the first three; the fourth tile's keys go
// to each in turn
constexpr int kShortGroups = 3;
constexpr int kShortThreads = 128 * kShortGroups;
constexpr int kHeadBytes = kShortRows * kRowBytes;  // Q, dO, K or V: 32 KB
constexpr int kStatBytes = kShortRows * 4;          // a float a row
// a query buffer: one head's Q and dO
constexpr int kQueryBytes = 2 * kHeadBytes;
// the transposed tail's p and ds, rounded: a panel of 8 key rows each
constexpr int kTailBytes = 2 * 1024;
// a group's rows: the next head's m, l, di and key flags as they arrive,
// then this head's exponent offsets, di and key flags
constexpr int kGroupRowsBytes = 7 * kStatBytes;

__host__ __device__ constexpr size_t dkv_short_smem_bytes() {
  // two query buffers, the K and V slots, the groups' tail panels and
  // rows, a word a warp, the barriers (two query buffers, four key slots)
  // and the two counts of groups done with a query buffer
  return 1024 + 2 * kQueryBytes + 2 * kHeadBytes +
         kShortGroups * (kTailBytes + kGroupRowsBytes) +
         4 * kShortGroups * 4 + (2 + kKeyTiles) * 8 + 2 * 4;
}

// K3b at head size 64 when a head's queries and keys fit in shared memory
// whole and its keys fill at least three key tiles (tk above 128), one for
// each warpgroup; nothing else takes it
bool takes_short_dkv(int panels, int tq, int tk) {
  return panels == 1 && tq >= 1 && tq <= kShortRows &&
         tk > 2 * kTileRows && tk <= kShortRows;
}

// One thread fills query buffer `buf` with a head's Q and dO (whole 64-row
// tiles, rows past tq as zeros), on the buffer's barrier `full`.
__device__ __forceinline__ void load_queries(uint32_t buf, uint32_t full,
                                             const CUtensorMap* q_map,
                                             const CUtensorMap* do_map,
                                             int head, uint32_t bytes) {
  mbar_arrive_expect(full, bytes);
  tma_load_head(buf, q_map, head, full);
  tma_load_head(buf + kHeadBytes, do_map, head, full);
}

// One thread fills key slot `tile` of K and V (`k_slot`, its V a head's
// bytes on) with that tile of a head, on the slot's barrier `full`.
__device__ __forceinline__ void load_keys(uint32_t k_slot, uint32_t full,
                                          const CUtensorMap* k_map,
                                          const CUtensorMap* v_map,
                                          int head, int tile) {
  mbar_arrive_expect(full, 2 * kPanelBytes);
  tma_load_head(k_slot, k_map, head, full, tile * kTileRows);
  tma_load_head(k_slot + kHeadBytes, v_map, head, full, tile * kTileRows);
}

// A thread's rows (`row` and `row` + 128) of a head's m, l and di, and of
// its batch item's key mask, into the group's `raw` rows ([m, l, di,
// mask][row]) by cp.async, zeros past tq (tk), one group of copies: the
// thread reads them back itself a head later.
__device__ __forceinline__ void stage_stats(float* raw, const float* m,
                                            const float* l, const float* di,
                                            const float* kv_mask, int head,
                                            int n_heads, int tq, int tk,
                                            int row) {
  const size_t first = (size_t)head * tq;
#pragma unroll
  for (int r = row; r < kShortRows; r += 128) {
    const bool inside = r < tq;
    const size_t at = first + (inside ? r : 0);
    cp_async_4(smem_u32(raw + r), m + at, inside ? 4 : 0);
    cp_async_4(smem_u32(raw + kShortRows + r), l + at, inside ? 4 : 0);
    cp_async_4(smem_u32(raw + 2 * kShortRows + r), di + at, inside ? 4 : 0);
    if (kv_mask)
      cp_async_4(smem_u32(raw + 3 * kShortRows + r),
                 kv_mask + (size_t)(head / n_heads) * tk + (r < tk ? r : 0),
                 r < tk ? 4 : 0);
  }
  cp_async_commit();
}

// One query step of K3b's arithmetic for a warpgroup's key tile: S^T and
// dP^T over the step's queries from row q0 (kN values a thread: 32 for 64
// queries and four k16 steps of the second products, 4 for the sequence's
// last 8 or fewer and one), then p and ds, rounded to T, into dV and dK.
// Each batch of products is straight-line code for the tensor cores.
template <typename T, int kN>
__device__ __forceinline__ void dkv_short_step(
    float (&dk_acc)[32], float (&dv_acc)[32], uint32_t k_s, uint32_t v_s,
    uint32_t q_s, uint32_t do_s, const float* lse2_s, const float* di_s,
    float scale2, bool unmasked, int q0, int tq, const bool (&key_ok)[2],
    int key_a, int causal, int offset, int t) {
  constexpr int kSteps = (kN + 7) / 8;
  float st[kN], dpt[kN];  // [key][query]
  const uint32_t q_rows = q_s + q0 * kRowBytes, do_rows = do_s + q0 * kRowBytes;
  products_begin();
  if constexpr (kN == 4) {
    product_nt_n8<T>(st, k_s, q_rows);
    product_nt_n8<T>(dpt, v_s, do_rows);
  } else {
    product_nt<T, 1>(st, k_s, q_rows);
    product_nt<T, 1>(dpt, v_s, do_rows);
  }
  products_end();
  keep_registers(st);
  keep_registers(dpt);
  dkv_scores(st, dpt, lse2_s + q0, di_s + q0, scale2, unmasked, q0, tq,
             key_ok, key_a, causal, offset, t);
  uint32_t pt[kSteps][4], dst[kSteps][4];
  pack_a_fragments<T>(st, pt);
  pack_a_fragments<T>(dpt, dst);
  products_begin();
  product_tn<T, kSteps>(dv_acc, pt, do_rows);
  product_tn<T, kSteps>(dk_acc, dst, q_rows);
  products_end();
  keep_registers(pt);
  keep_registers(dst);
  keep_registers(dv_acc);
  keep_registers(dk_acc);
}

// The short kernel's state that every tile of a head shares: the query
// buffer, the group's rows, the lengths and the mask rules.
struct ShortHead {
  uint32_t q_s, do_s;
  const float *lse2_s, *di_s, *flags;
  int tq, tk, q_tiles, causal, offset;
  float scale, scale2;
};

// A warpgroup's dK and dV for the 64 keys of the tile at `k0` (in slots
// `k_s`, `v_s`) over the head's query tiles, in K3b's order and with its
// arithmetic, into rows k0 .. of `dk_rows`, `dv_rows`. `words` holds a word
// a warp; a named barrier of the group's own (`bar_id`).
template <typename T>
__device__ __forceinline__ void dkv_short_tile(const ShortHead& h, int k0,
                                               uint32_t k_s, uint32_t v_s,
                                               T* dk_rows, T* dv_rows,
                                               int* words, int bar_id,
                                               const Lanes& at,
                                               int in_group) {
  // the thread's two keys (key_a and key_a + 8), and whether any and
  // whether all of the tile's take part
  const int key_a = k0 + at.warp_in_group * 16 + at.g;
  const bool key_ok[2] = {h.flags[key_a] > 0.f, h.flags[key_a + 8] > 0.f};
  const bool any = __any_sync(0xffffffffu, key_ok[0] || key_ok[1]);
  const bool all = __all_sync(0xffffffffu, key_ok[0] && key_ok[1]);
  if (at.lane == 0) words[at.warp_in_group] = (any ? 1 : 0) | (all ? 2 : 0);
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
  int keys_any = 0, keys_all = 2;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    keys_any |= words[w] & 1;
    keys_all &= words[w] & 2;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // words read
  // under the causal mask only query rows with row + offset >= k0 reach
  // the tile's keys
  const int first =
      h.causal && k0 - h.offset > 0 ? (k0 - h.offset) / kTileRows : 0;

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  for (int qt = keys_any ? first : h.q_tiles; qt < h.q_tiles; ++qt) {
    const int q0 = qt * kTileRows;
    // a tile whose last row does not reach the first key
    if (h.causal && k0 > q0 + kTileRows - 1 + h.offset) continue;
    if (h.tq - q0 <= 8) {
      // the sequence's ragged end: at most 8 queries, an [64 x 8] S^T and
      // dP^T and one k16 step of each second product
      dkv_short_step<T, 4>(dk_acc, dv_acc, k_s, v_s, h.q_s, h.do_s,
                           h.lse2_s, h.di_s, h.scale2, false, q0, h.tq,
                           key_ok, key_a, h.causal, h.offset, at.t);
    } else {
      // every pair of the tile takes part: no test per element
      const bool unmasked =
          keys_all && q0 + kTileRows <= h.tq &&
          (!h.causal || k0 + kTileRows - 1 <= q0 + h.offset);
      dkv_short_step<T, 32>(dk_acc, dv_acc, k_s, v_s, h.q_s, h.do_s,
                            h.lse2_s, h.di_s, h.scale2, unmasked, q0, h.tq,
                            key_ok, key_a, h.causal, h.offset, at.t);
    }
  }
  store_fragments(dv_rows, dv_acc, 1.f, k0, h.tk, in_group);
  store_fragments(dk_rows, dk_acc, h.scale, k0, h.tk, in_group);
}

// The transposed tail: a warpgroup's dK and dV for the at most 8 keys of
// the tile at `k0` (the sequence's ragged end), as [64 x 8] dV^T and dK^T
// over the head's query tiles. Per query tile S and dP (its 64 queries
// against the 8 keys, m64n8), p and ds from the rows' statistics, rounded
// to T into two key-major panels (`tail`, P then dS), then dV^T += dO^T P
// and dK^T += Q^T dS with both operands in shared memory: the same sums
// as the tile's, in the same order, on an eighth of the keys' products.
template <typename T>
__device__ __forceinline__ void dkv_short_tail(const ShortHead& h, int k0,
                                               uint32_t k_s, uint32_t v_s,
                                               uint8_t* tail, T* dk_rows,
                                               T* dv_rows, int bar_id,
                                               const Lanes& at) {
  // the thread's rows (queries, g and g + 8 of its warp's 16) and keys
  // (2 t, 2 t + 1 of the 8)
  const int row0 = at.warp_in_group * 16 + at.g;
  bool key_ok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) key_ok[e] = h.flags[k0 + 2 * at.t + e] > 0.f;
  const uint32_t p_panel = smem_u32(tail), ds_panel = p_panel + 1024;
  float dvt[4] = {0.f, 0.f, 0.f, 0.f}, dkt[4] = {0.f, 0.f, 0.f, 0.f};
  for (int qt = 0; qt < h.q_tiles; ++qt) {
    const int q0 = qt * kTileRows;
    if (h.causal && k0 > q0 + kTileRows - 1 + h.offset) continue;
    const uint32_t q_rows = h.q_s + q0 * kRowBytes;
    const uint32_t do_rows = h.do_s + q0 * kRowBytes;
    float s[4], dp[4];  // [query][key]
    products_begin();
    product_nt_n8<T>(s, q_rows, k_s);
    product_nt_n8<T>(dp, do_rows, v_s);
    products_end();
    keep_registers(s);
    keep_registers(dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i >> 1) & 1, e = i & 1;
      const int row = q0 + row0 + 8 * r, key = k0 + 2 * at.t + e;
      const bool ok = row < h.tq && key_ok[e] &&
                      (!h.causal || key <= row + h.offset);
      const float p = exp2_fast(fmaf(s[i], h.scale2, -h.lse2_s[row]));
      s[i] = ok ? p : 0.f;
      dp[i] = ok ? p * (dp[i] - h.di_s[row]) : 0.f;
    }
    // p and ds, rounded to T, to [key][query] panels: the B operands
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = row0 + 8 * ((i >> 1) & 1), key = 2 * at.t + (i & 1);
      const uint32_t at_c = swizzled(key, c >> 3) + (c & 7) * 2;
      *reinterpret_cast<T*>(tail + at_c) = to_type<T>(s[i]);
      *reinterpret_cast<T*>(tail + 1024 + at_c) = to_type<T>(dp[i]);
    }
    fence_async_shared();  // the panels' stores before the tensor cores'
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    products_begin();
    if (h.tq - q0 <= 16) {  // the sequence's end: one k16 step of queries
      product_t8<T, 1>(dvt, do_rows, p_panel);
      product_t8<T, 1>(dkt, q_rows, ds_panel);
    } else {
      product_t8<T, 4>(dvt, do_rows, p_panel);
      product_t8<T, 4>(dkt, q_rows, ds_panel);
    }
    products_end();
    keep_registers(dvt);
    keep_registers(dkt);
  }
  // dV^T and dK^T: (column row0 + 8 r, key 2 t + e) of the thread
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = row0 + 8 * ((i >> 1) & 1), key = k0 + 2 * at.t + (i & 1);
    if (key < h.tk) {
      dv_rows[(size_t)key * kPanelCols + col] = to_type<T>(dvt[i]);
      dk_rows[(size_t)key * kPanelCols + col] = to_type<T>(dkt[i] * h.scale);
    }
  }
}

// K3b at ViT lengths: persistent blocks, each walking heads blockIdx.x, +
// gridDim.x, ...; warpgroup g owns key tile g of every head, and the
// fourth tile's keys (tk above 192) go to warpgroup j % 3 for the block's
// j-th head: transposed when they are 8 or fewer, as a tile otherwise.
template <typename T>
__global__ void __launch_bounds__(kShortThreads, 1)
    flash_bwd_dkv_short_kernel(__grid_constant__ const CUtensorMap q_map,
                               __grid_constant__ const CUtensorMap do_map,
                               __grid_constant__ const CUtensorMap k_map,
                               __grid_constant__ const CUtensorMap v_map,
                               const float* __restrict__ l,
                               const float* __restrict__ m,
                               const float* __restrict__ di,
                               const float* __restrict__ kv_mask,
                               T* __restrict__ dk, T* __restrict__ dv, int bn,
                               int tq, int tk, int n_heads, float scale,
                               int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t keys = base + 2 * kQueryBytes;  // K's slots, then V's
  uint8_t* tails = smem + 2 * kQueryBytes + 2 * kHeadBytes;
  float* group_rows =
      reinterpret_cast<float*>(tails + kShortGroups * kTailBytes);
  int* words = reinterpret_cast<int*>(group_rows) +
               kShortGroups * kGroupRowsBytes / 4;
  // full[b]: query buffer b holds its head; key_full[s]: key slot s holds
  // its head's tile; done[b]: the groups that have finished with query
  // buffer b
  const uint32_t full0 = smem_u32(words + 4 * kShortGroups);
  const uint32_t key_full0 = full0 + 2 * 8;
  int* done = words + 4 * kShortGroups + 2 * (2 + kKeyTiles);
  const int tiles = (tk + kTileRows - 1) / kTileRows;  // 3 or 4
  const uint32_t q_bytes =
      (tq + kTileRows - 1) / kTileRows * 2 * kPanelBytes;
  const Lanes at;
  if (at.tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(full0 + 8 * b, 1);
      done[b] = 0;
    }
    for (int s = 0; s < kKeyTiles; ++s) mbar_init(key_full0 + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (at.tid == 0) {  // the block's first two heads' queries, its first keys
    for (int b = 0; b < 2; ++b) {
      const int head = blockIdx.x + b * gridDim.x;
      if (head < bn)
        load_queries(base + b * kQueryBytes, full0 + 8 * b, &q_map, &do_map,
                     head, q_bytes);
    }
    for (int s = 0; s < tiles; ++s)
      load_keys(keys + s * kPanelBytes, key_full0 + 8 * s, &k_map, &v_map,
                blockIdx.x, s);
  }

  const int group = at.group, in_group = at.tid & 127;
  const int bar_id = 1 + group;
  float* raw = group_rows + group * 7 * kShortRows;  // m, l, di, mask
  float* lse2_s = raw + 4 * kShortRows;
  float* di_s = lse2_s + kShortRows;
  float* flags = di_s + kShortRows;
  int* group_words = words + 4 * group;
  uint8_t* tail = tails + group * kTailBytes;
  ShortHead h;
  h.lse2_s = lse2_s;
  h.di_s = di_s;
  h.flags = flags;
  h.tq = tq;
  h.tk = tk;
  h.q_tiles = (tq + kTileRows - 1) / kTileRows;
  h.causal = causal;
  h.offset = tk - tq;
  h.scale = scale;
  h.scale2 = scale * kLog2e;
  stage_stats(raw, m, l, di, kv_mask, blockIdx.x, n_heads, tq, tk, in_group);

  for (int head = blockIdx.x, j = 0; head < bn; head += gridDim.x, ++j) {
    const int b = j & 1, next = head + gridDim.x;
    h.q_s = base + b * kQueryBytes;
    h.do_s = h.q_s + kHeadBytes;
    // the rows' exponent offsets and di (zeros past tq, as K3b's) and the
    // key flags, the group's own copy, from the rows this thread copied a
    // head ago; then the next head's copies
    cp_async_wait<0>();
#pragma unroll
    for (int r = in_group; r < kShortRows; r += 128) {
      lse2_s[r] = r < tq ? exponent_offset(raw[r], raw[kShortRows + r]) : 0.f;
      di_s[r] = raw[2 * kShortRows + r];
      flags[r] = kv_mask ? raw[3 * kShortRows + r] : r < tk ? 1.f : 0.f;
    }
    if (next < bn)
      stage_stats(raw, m, l, di, kv_mask, next, n_heads, tq, tk, in_group);
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    mbar_wait(full0 + 8 * b, (j >> 1) & 1);
    mbar_wait(key_full0 + 8 * group, j & 1);
    __syncwarp();  // converged for the warpgroup's products
    T* dk_rows = dk + (size_t)head * tk * kPanelCols;
    T* dv_rows = dv + (size_t)head * tk * kPanelCols;
    const uint32_t k_s = keys + group * kPanelBytes;
    // the group's own tile
    dkv_short_tile<T>(h, group * kTileRows, k_s, k_s + kHeadBytes, dk_rows,
                      dv_rows, group_words, bar_id, at, in_group);
    // the fourth tile's keys, this head's turn
    const bool fourth = tiles > kShortGroups && j % kShortGroups == group;
    const uint32_t k4 = keys + kShortGroups * kPanelBytes;
    if (fourth) {
      mbar_wait(key_full0 + 8 * kShortGroups, j & 1);
      __syncwarp();
      const int k0 = kShortGroups * kTileRows;
      if (tk - k0 <= 8)
        dkv_short_tail<T>(h, k0, k4, k4 + kHeadBytes, tail, dk_rows,
                          dv_rows, bar_id, at);
      else
        dkv_short_tile<T>(h, k0, k4, k4 + kHeadBytes, dk_rows, dv_rows,
                          group_words, bar_id, at, in_group);
    }

    // done with the buffers: the group's key slots take their next head,
    // the last group done with the query buffer fills it with the head two
    // on
    fence_async_shared();  // this thread's accesses before the copies
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (in_group == 0) {
      if (next < bn) {
        load_keys(k_s, key_full0 + 8 * group, &k_map, &v_map, next, group);
        if (fourth)
          load_keys(k4, key_full0 + 8 * kShortGroups, &k_map, &v_map, next,
                    kShortGroups);
      }
      __threadfence_block();
      const bool last = atomicAdd(done + b, 1) == kShortGroups - 1;
      if (last) done[b] = 0;
      __threadfence_block();
      if (last && head + 2 * gridDim.x < bn)
        load_queries(h.q_s, full0 + 8 * b, &q_map, &do_map,
                     head + 2 * gridDim.x, q_bytes);
    }
  }
}

// ---------------------------------------------------------------------------
// head size 32: the narrow kernels (see the note at the top)
// ---------------------------------------------------------------------------

// A narrow block is one warpgroup that owns 64 rows (keys in K3b, query
// rows in K3c) and passes the other side's tiles through a ring of
// kNarrowStages stages; kNarrowBlocks blocks an SM (the registers are fit
// to them).
constexpr int kNarrowStages = 4;
constexpr int kNarrowBlocks = 4;

// its own two operands' tiles, the ring (two tiles and the rows' floats a
// stage), flags
__host__ __device__ constexpr size_t narrow_smem_bytes() {
  return 1024 + 2 * kNarrowTileBytes +
         kNarrowStages * (2 * kNarrowTileBytes + kRowsBytes) + 64;
}

LaunchShape narrow_shape() {
  return {128, narrow_smem_bytes(), kTileRows, 1};
}

// K3b at head size 32: dk, dv for the block's 64 keys over all query tiles
template <typename T>
__global__ void __launch_bounds__(128, kNarrowBlocks)
    flash_bwd_dkv_narrow_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ l,
                                const float* __restrict__ m,
                                const float* __restrict__ di,
                                const float* __restrict__ kv_mask,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int tq, int tk, int n_heads, float scale,
                                int causal) {
  constexpr int kTile = kNarrowTileBytes, kStages = kNarrowStages;
  constexpr int kStageBytes = 2 * kTile, kHd = kNarrowCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t k_s = smem_u32(smem);
  const uint32_t v_s = k_s + kTile;
  const uint32_t ring = v_s + kTile;
  // [stage][exponent offset, di][query of the tile]
  float* rows_s =
      reinterpret_cast<float*>(smem + 2 * kTile + kStages * kStageBytes);
  int* flags_s = reinterpret_cast<int*>(rows_s + kStages * 2 * kTileRows);

  const Lanes at;
  const int bn = blockIdx.x, k0 = blockIdx.y * kTileRows;
  const T* qb = q + (size_t)bn * tq * kHd;
  const T* dob = dout + (size_t)bn * tq * kHd;
  T* dk_rows = dk + (size_t)bn * tk * kHd;
  T* dv_rows = dv + (size_t)bn * tk * kHd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  // under the causal mask only query rows with row + offset >= k0 reach
  // the block's keys: the first step's tile is the first that reaches them,
  // so every step has work
  const int first = causal && k0 - offset > 0 ? (k0 - offset) / kTileRows : 0;
  const int steps = (tq + kTileRows - 1) / kTileRows - first;

  auto stage_step = [&](int step) {
    if (step < steps) {
      const int stage = step % kStages, q0 = (first + step) * kTileRows;
      const uint32_t q_s = ring + stage * kStageBytes;
      stage_narrow_rows<kTileRows, 128>(q_s, qb, q0, tq, at.tid);
      stage_narrow_rows<kTileRows, 128>(q_s + kTile, dob, q0, tq, at.tid);
    }
    cp_async_commit();
  };

  // the passing tile's row statistics, as flash_bwd_dkv_tc_kernel's:
  // loaded by 64 threads kStages - 1 steps ahead, folded into the stage's
  // array at the end of the step
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
  RowStats rows_ahead[kStages - 1];
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) rows_ahead[i] = load_rows(i);

  // the thread's two keys: g and g + 8 of its warp's 16
  const int key_a = k0 + at.warp_in_group * 16 + at.g;
  bool key_ok[2];
  int keys_any, keys_all;
  block_keys(key_ok, keys_any, keys_all, mask_row, key_a, tk, at, flags_s);
  if (!keys_any) {  // no key of the block takes part: zeros, nothing read
    store_zero_rows<kHd>(dv_rows, k0, tk, at.tid);
    store_zero_rows<kHd>(dk_rows, k0, tk, at.tid);
    return;
  }

  stage_narrow_rows<kTileRows, 128>(k_s, k + (size_t)bn * tk * kHd, k0, tk,
                                    at.tid);
  stage_narrow_rows<kTileRows, 128>(v_s, v + (size_t)bn * tk * kHd, k0, tk,
                                    at.tid);
  for (int step = 0; step < kStages - 1; ++step) stage_step(step);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) store_rows(i, rows_ahead[i]);
  const float scale2 = scale * kLog2e;

  // dK and dV: one [64 x 32] accumulator each
  float dk_acc[16], dv_acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const RowStats ahead = load_rows(step + kStages - 1);
    stage_step(step + kStages - 1);

    const int stage = step % kStages, q0 = (first + step) * kTileRows;
    const uint32_t q_s = ring + stage * kStageBytes, do_s = q_s + kTile;
    const float* lse2_s = rows_s + stage * 2 * kTileRows;
    const float* di_s = lse2_s + kTileRows;

    float st[32], dpt[32];  // [key][query]
    products_begin();
    product_nt_panel<T, kNarrowCols>(st, k_s, q_s, 0);
    product_nt_panel<T, kNarrowCols>(dpt, v_s, do_s, 0);
    products_end();
    keep_registers(st);
    keep_registers(dpt);

    // every pair of the tile takes part: no test per element
    const bool unmasked = keys_all && q0 + kTileRows <= tq &&
                          (!causal || k0 + kTileRows - 1 <= q0 + offset);
    dkv_scores(st, dpt, lse2_s, di_s, scale2, unmasked, q0, tq, key_ok,
               key_a, causal, offset, at.t);
    uint32_t pt[4][4], dst[4][4];
    pack_a_fragments<T>(st, pt);
    pack_a_fragments<T>(dpt, dst);

    products_begin();
    product_tn<T>(dv_acc, pt, do_s);
    product_tn<T>(dk_acc, dst, q_s);
    products_end();
    keep_registers(pt);
    keep_registers(dst);
    keep_registers(dv_acc);
    keep_registers(dk_acc);
    store_rows(step + kStages - 1, ahead);
  }
  cp_async_wait<0>();

  store_fragments(dv_rows, dv_acc, 1.f, k0, tk, at.tid);
  store_fragments(dk_rows, dk_acc, scale, k0, tk, at.tid);
}

// K3c at head size 32: dq for the block's 64 query rows over all key tiles
template <typename T>
__global__ void __launch_bounds__(128, kNarrowBlocks)
    flash_bwd_dq_narrow_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ l,
                               const float* __restrict__ m,
                               const float* __restrict__ di,
                               const float* __restrict__ kv_mask,
                               T* __restrict__ dq, int tq, int tk,
                               int n_heads, float scale, int causal) {
  constexpr int kTile = kNarrowTileBytes, kStages = kNarrowStages;
  constexpr int kStageBytes = 2 * kTile, kHd = kNarrowCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + kTile;
  const uint32_t ring = do_s + kTile;
  float* valid_s =
      reinterpret_cast<float*>(smem + 2 * kTile + kStages * kStageBytes);
  int* flags_s = reinterpret_cast<int*>(valid_s + kStages * 2 * kTileRows);

  const Lanes at;
  const int bn = blockIdx.x, q0 = blockIdx.y * kTileRows;
  const T* kb = k + (size_t)bn * tk * kHd;
  const T* vb = v + (size_t)bn * tk * kHd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  // the thread's two rows and their statistics, loaded before any copy
  const int row_a = q0 + at.warp_in_group * 16 + at.g;
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
  // one the mask keeps: no step's tile lies wholly above the diagonal
  const int k_end = kept_key_end<128>(
      mask_row, causal ? min(tk, q0 + kTileRows + offset) : tk, at.tid,
      flags_s);
  const int steps = (max(k_end, 0) + kTileRows - 1) / kTileRows;
  stage_narrow_rows<kTileRows, 128>(q_s, q + (size_t)bn * tq * kHd, q0, tq,
                                    at.tid);
  stage_narrow_rows<kTileRows, 128>(do_s, dout + (size_t)bn * tq * kHd, q0,
                                    tq, at.tid);

  auto stage_step = [&](int step) {
    if (step < steps) {
      const int stage = step % kStages, k0 = step * kTileRows;
      const uint32_t k_s = ring + stage * kStageBytes;
      stage_narrow_rows<kTileRows, 128>(k_s, kb, k0, tk, at.tid);
      stage_narrow_rows<kTileRows, 128>(k_s + kTile, vb, k0, tk, at.tid);
      if (at.tid < kTileRows)  // which keys of the tile take part
        stage_key_flag(valid_s + stage * kTileRows + at.tid, mask_row,
                       k0 + at.tid, tk);
    }
    cp_async_commit();
  };
  for (int step = 0; step < kStages - 1; ++step) stage_step(step);

  const float lse2[2] = {exponent_offset(stats[0].m, stats[0].l),
                         exponent_offset(stats[1].m, stats[1].l)};
  const float di_r[2] = {stats[0].di, stats[1].di};
  const float scale2 = scale * kLog2e;
  const bool rows_inside = q0 + kTileRows <= tq;

  // dQ: one [64 x 32] accumulator
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    // the barrier also counts the tile's valid keys, each thread reading
    // back the one flag it copied itself
    const int stage = step % kStages, k0 = step * kTileRows;
    const float* valid = valid_s + stage * kTileRows;
    const int n_valid =
        __syncthreads_count(at.tid < kTileRows && valid[at.tid] > 0.f);
    stage_step(step + kStages - 1);
    if (n_valid == 0) continue;  // no valid key in the tile
    const uint32_t k_s = ring + stage * kStageBytes, v_s = k_s + kTile;

    float s[32], dp[32];
    products_begin();
    product_nt_panel<T, kNarrowCols>(s, q_s, k_s, 0);
    product_nt_panel<T, kNarrowCols>(dp, do_s, v_s, 0);
    products_end();
    keep_registers(s);
    keep_registers(dp);

    // every pair of the tile takes part: no test per element
    const bool unmasked =
        n_valid == kTileRows && rows_inside &&
        (!causal || k0 + kTileRows - 1 <= q0 + offset);
    dq_scores(s, dp, lse2, di_r, scale2, unmasked, valid, k0, row_a, tq, tk,
              causal, offset, at.t);
    uint32_t ds[4][4];
    pack_a_fragments<T>(s, ds);

    products_begin();
    product_tn<T>(acc, ds, k_s);
    products_end();
    keep_registers(ds);
    keep_registers(acc);
  }
  cp_async_wait<0>();

  store_fragments(dq + (size_t)bn * tq * kHd, acc, scale, q0, tq, at.tid);
}

// ---------------------------------------------------------------------------
// head sizes 128 and 256: K3b's producer kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kPairGroups = 2;  // consumer warpgroups
// the consumers and one warpgroup whose first warp is the producer
constexpr int kPairThreads = 128 * (kPairGroups + 1);
// the consumers' named barrier (store_panel's are 1 and 2)
constexpr int kPairBarrier = 3;

// The producer kernel's block by head panels. At 2 (head size 128) each
// consumer warpgroup owns a key tile of its own (128 keys a block) and
// accumulates all of its dK and dV; at 4 (256) both own the same 64 keys
// and split the panels, two each, and the work of p and ds
// (split_scores).
template <int kPanels>
struct Pair {
  static constexpr bool kSplit = kPanels == 4;
  static constexpr int kKeyTiles = kSplit ? 1 : kPairGroups;
  static constexpr int kKeys = kKeyTiles * kTileRows;  // a block's keys
  static constexpr int kOwn = kSplit ? kPanels / kPairGroups : kPanels;
  static constexpr int kStages = kSplit ? 2 : 4;  // the ring of Q and dO
  static constexpr int kTile = tile_bytes<kPanels>();  // 64 rows
  static constexpr int kStageBytes = 2 * kTile;        // Q and dO
  // the split groups' swap (split_scores): 32 KB
  static constexpr int kSwapBytes = kSplit ? 2 * kHandBytes : 0;
};

// the key tiles' K and V, the ring, the swap, each stage's row statistics,
// the barriers (each stage's full and empty, K and V's), the consumer
// warps' words
template <int kPanels>
__host__ __device__ constexpr size_t pair_smem_bytes() {
  using P = Pair<kPanels>;
  return 1024 + 2 * P::kKeyTiles * P::kTile +
         P::kStages * (P::kStageBytes + kRowsBytes) + P::kSwapBytes +
         (2 * P::kStages + 1) * 8 + 4 * kPairGroups * 4;
}

// K3b's split groups at head size 256: group kGroup holds its score tile
// whole (S^T for group 0, dP^T for group 1) and computes p and ds for the
// query columns 32 kGroup .. 32 kGroup + 31 (the fragment's values 16
// kGroup ..): it hands the other group the other half of its tile, takes
// the other tile's half of its own, and the two then hand each other their
// halves of p and ds rounded to T, so both hold the whole of pt and dst
// with the bits one group would compute. `swap` (32 KB): the halves of the
// tiles at word 0, the rounded halves at word 4096, [group][value][thread].
template <typename T, int kGroup>
__device__ __forceinline__ void split_scores(
    float (&st)[32], float (&dpt)[32], uint32_t (&pt)[4][4],
    uint32_t (&dst)[4][4], uint32_t* swap, int in_group, const float* lse2_s,
    const float* di_s, float scale2, bool unmasked, int q0, int tq,
    const bool (&key_ok)[2], int key_a, int causal, int offset, int t) {
  constexpr int kOther = 1 - kGroup, kArea = 16 * 128;
  float(&own)[32] = kGroup == 0 ? st : dpt;
  float(&other)[32] = kGroup == 0 ? dpt : st;
  uint32_t* halves = swap;
  uint32_t* rounded = swap + 2 * kArea;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    halves[kGroup * kArea + i * 128 + in_group] =
        __float_as_uint(own[16 * kOther + i]);
  asm volatile("bar.sync %0, %1;\n" ::"n"(kPairBarrier),
               "n"(128 * kPairGroups)
               : "memory");
#pragma unroll
  for (int i = 0; i < 16; ++i)
    other[16 * kGroup + i] =
        __uint_as_float(halves[kOther * kArea + i * 128 + in_group]);
  float s_half[16], d_half[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s_half[i] = st[16 * kGroup + i];
    d_half[i] = dpt[16 * kGroup + i];
  }
  dkv_scores(s_half, d_half, lse2_s + 32 * kGroup, di_s + 32 * kGroup,
             scale2, unmasked, q0 + 32 * kGroup, tq, key_ok, key_a, causal,
             offset, t);
  uint32_t p_half[2][4], d_round[2][4];
  pack_a_fragments<T>(s_half, p_half);
  pack_a_fragments<T>(d_half, d_round);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      rounded[kGroup * kArea + (4 * ks + x) * 128 + in_group] = p_half[ks][x];
      rounded[kGroup * kArea + (8 + 4 * ks + x) * 128 + in_group] =
          d_round[ks][x];
    }
  asm volatile("bar.sync %0, %1;\n" ::"n"(kPairBarrier),
               "n"(128 * kPairGroups)
               : "memory");
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      pt[2 * kGroup + ks][x] = p_half[ks][x];
      dst[2 * kGroup + ks][x] = d_round[ks][x];
      pt[2 * kOther + ks][x] =
          rounded[kOther * kArea + (4 * ks + x) * 128 + in_group];
      dst[2 * kOther + ks][x] =
          rounded[kOther * kArea + (8 + 4 * ks + x) * 128 + in_group];
    }
}

template <typename T, int kPanels>
__global__ void __launch_bounds__(kPairThreads, 1)
    flash_bwd_dkv_producer_kernel(__grid_constant__ const CUtensorMap q_map,
                                  __grid_constant__ const CUtensorMap do_map,
                                  __grid_constant__ const CUtensorMap k_map,
                                  __grid_constant__ const CUtensorMap v_map,
                                  const float* __restrict__ l,
                                  const float* __restrict__ m,
                                  const float* __restrict__ di,
                                  const float* __restrict__ kv_mask,
                                  T* __restrict__ dk, T* __restrict__ dv,
                                  int tq, int tk, int n_heads, float scale,
                                  int causal) {
  using P = Pair<kPanels>;
  constexpr int kHd = kPanels * kPanelCols, kTile = P::kTile,
                kStages = P::kStages, kStageBytes = P::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t k_s = smem_u32(smem);  // key tile g's K at g kTile
  const uint32_t v_s = k_s + P::kKeyTiles * kTile;
  const uint32_t ring = v_s + P::kKeyTiles * kTile;
  const uint32_t swap_s = ring + kStages * kStageBytes;
  // [stage][exponent offset, di][query of the tile]
  float* rows_s = reinterpret_cast<float*>(
      smem + 2 * P::kKeyTiles * kTile + kStages * kStageBytes +
      P::kSwapBytes);
  const uint32_t full0 = smem_u32(rows_s + kStages * 2 * kTileRows);
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t kv_full = empty0 + 8 * kStages;
  int* flags_s = reinterpret_cast<int*>(smem + (kv_full + 8 - k_s));

  const Lanes at;
  const int bn = blockIdx.x, k0 = blockIdx.y * P::kKeys;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;
  // under the causal mask only query rows with row + offset >= k0 reach
  // the block's keys (group 1's own keys skip more tiles below)
  const int first = causal && k0 - offset > 0 ? (k0 - offset) / kTileRows : 0;
  const int steps = (tq + kTileRows - 1) / kTileRows - first;

  // a consumer thread's two keys, g and g + 8 of its warp's 16 of its
  // group's key tile, whether each takes part, and whether any and all of
  // each group's 64 keys do
  const int group = at.group, in_group = at.tid & 127;
  const bool consumer = group < kPairGroups;
  const int group_k0 = k0 + (P::kSplit ? 0 : group * kTileRows);
  // the group's first panel of dK and dV
  const int panel0 = P::kSplit ? group * P::kOwn : 0;
  const int key_a = group_k0 + at.warp_in_group * 16 + at.g;
  bool key_ok[2] = {false, false};
  if (consumer) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_a + 8 * r;
      key_ok[r] = key < tk && (mask_row == nullptr || mask_row[key] > 0.f);
    }
    const bool any = __any_sync(0xffffffffu, key_ok[0] || key_ok[1]);
    const bool all = __all_sync(0xffffffffu, key_ok[0] && key_ok[1]);
    if (at.lane == 0) flags_s[at.tid >> 5] = (any ? 1 : 0) | (all ? 2 : 0);
  }
  __syncthreads();
  int active = 0, keys_any = 0, keys_all = 2;  // the thread's group's
#pragma unroll
  for (int g = 0; g < kPairGroups; ++g) {
    int any = 0, all = 2;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      any |= flags_s[4 * g + w] & 1;
      all &= flags_s[4 * g + w] & 2;
    }
    active += any;
    if (g == group) {
      keys_any = any;
      keys_all = all;
    }
  }
  // no key of the group's takes part: zeros (split groups: written once)
  if (consumer && !keys_any && (!P::kSplit || group == 0)) {
    store_zero_rows<kHd>(dv + (size_t)bn * tk * kHd, group_k0, tk, in_group);
    store_zero_rows<kHd>(dk + (size_t)bn * tk * kHd, group_k0, tk, in_group);
  }
  if (active == 0) return;  // nothing read
  if (at.tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty0 + 8 * s, 128 * active);  // the working consumers'
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (!consumer) {
    // the producer: its warpgroup gives its registers up, and its first
    // warp fills the ring kStages steps ahead of the consumers
    producer_registers();
    if (at.warp_in_group != 0) return;
    if (at.lane == 0) {  // the key tiles' K and V, once
      mbar_arrive_expect(kv_full, 2 * P::kKeyTiles * kTile);
#pragma unroll
      for (int g = 0; g < P::kKeyTiles; ++g)
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          const uint32_t at_tile = g * kTile + p * kPanelBytes;
          tma_load_head(k_s + at_tile, &k_map, bn, kv_full,
                        k0 + g * kTileRows, p * kPanelCols);
          tma_load_head(v_s + at_tile, &v_map, bn, kv_full,
                        k0 + g * kTileRows, p * kPanelCols);
        }
    }
    for (int step = 0; step < steps; ++step) {
      const int stage = step % kStages, use = step / kStages;
      if (use > 0) mbar_wait(empty0 + 8 * stage, (use - 1) & 1);
      const int q0 = (first + step) * kTileRows;
      // the tile's rows: exponent offset and di (zeros past tq), two a lane
      float* dst = rows_s + stage * 2 * kTileRows;
#pragma unroll
      for (int r = at.lane; r < kTileRows; r += 32) {
        const RowStats st = row_stats(m, l, di, bn, tq, q0 + r);
        dst[r] = exponent_offset(st.m, st.l);
        dst[kTileRows + r] = st.di;
      }
      const uint32_t full = full0 + 8 * stage;
      if (at.lane == 0) {
        const uint32_t q_tile = ring + stage * kStageBytes;
        mbar_arrive_expect(full, kStageBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load_head(q_tile + p * kPanelBytes, &q_map, bn, full, q0,
                        p * kPanelCols);
          tma_load_head(q_tile + kTile + p * kPanelBytes, &do_map, bn, full,
                        q0, p * kPanelCols);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  consumer_registers();
  if (!keys_any) return;  // written as zeros above
  const uint32_t own_k = k_s + (P::kSplit ? 0 : group * kTile);
  const uint32_t own_v = v_s + (P::kSplit ? 0 : group * kTile);
  const float scale2 = scale * kLog2e;

  // dK and dV: one [64 x 64] accumulator a panel each of the group's own
  float dk_acc[P::kOwn][32], dv_acc[P::kOwn][32];
#pragma unroll
  for (int p = 0; p < P::kOwn; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int step = 0; step < steps; ++step) {
    const int stage = step % kStages;
    const int q0 = (first + step) * kTileRows;
    mbar_wait(full0 + 8 * stage, (step / kStages) & 1);
    __syncwarp();  // converged for the warpgroup's products
    // a tile whose last row does not reach the group's first key is
    // skipped
    if (!(causal && group_k0 > q0 + kTileRows - 1 + offset)) {
      const uint32_t q_s = ring + stage * kStageBytes;
      const uint32_t do_s = q_s + kTile;
      const float* lse2_s = rows_s + stage * 2 * kTileRows;
      const float* di_s = lse2_s + kTileRows;

      float st[32], dpt[32];  // [key][query]
      products_begin();
      if (!P::kSplit) {
        product_nt<T, kPanels>(st, own_k, q_s);
        product_nt<T, kPanels>(dpt, own_v, do_s);
      } else if (group == 0) {
        product_nt<T, kPanels>(st, own_k, q_s);
      } else {
        product_nt<T, kPanels>(dpt, own_v, do_s);
      }
      products_end();
      if (!P::kSplit || group == 0) keep_registers(st);
      if (!P::kSplit || group == 1) keep_registers(dpt);
      // every pair of the tile takes part: no test per element
      const bool unmasked =
          keys_all && q0 + kTileRows <= tq &&
          (!causal || group_k0 + kTileRows - 1 <= q0 + offset);
      uint32_t pt[4][4], dst[4][4];
      if (!P::kSplit) {
        dkv_scores(st, dpt, lse2_s, di_s, scale2, unmasked, q0, tq, key_ok,
                   key_a, causal, offset, at.t);
        pack_a_fragments<T>(st, pt);
        pack_a_fragments<T>(dpt, dst);
      } else {
        uint32_t* swap =
            reinterpret_cast<uint32_t*>(smem + (swap_s - k_s));
        if (group == 0)
          split_scores<T, 0>(st, dpt, pt, dst, swap, in_group, lse2_s, di_s,
                             scale2, unmasked, q0, tq, key_ok, key_a, causal,
                             offset, at.t);
        else
          split_scores<T, 1>(st, dpt, pt, dst, swap, in_group, lse2_s, di_s,
                             scale2, unmasked, q0, tq, key_ok, key_a, causal,
                             offset, at.t);
      }

      products_begin();
#pragma unroll
      for (int p = 0; p < P::kOwn; ++p) {
        const int panel = panel0 + p;
        product_tn<T>(dv_acc[p], pt, do_s + panel * kPanelBytes);
        product_tn<T>(dk_acc[p], dst, q_s + panel * kPanelBytes);
      }
      products_end();
      keep_registers(pt);
      keep_registers(dst);
#pragma unroll
      for (int p = 0; p < P::kOwn; ++p) {
        keep_registers(dv_acc[p]);
        keep_registers(dk_acc[p]);
      }
    }
    mbar_arrive(empty0 + 8 * stage);  // the thread is done with the stage
  }

  // the key tiles are read no more: panel p of dV leaves through panel p
  // of the group's K tile, of dK through panel p of its V tile, under the
  // group's own named barrier (split groups, each over its own panels of
  // the one tile, after both are done with it)
  if (P::kSplit)
    asm volatile("bar.sync %0, %1;\n" ::"n"(kPairBarrier),
                 "n"(128 * kPairGroups)
                 : "memory");
  else
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
  const size_t cols = (size_t)bn * tk * kHd;
  const int tile = P::kSplit ? 0 : group;
#pragma unroll
  for (int p = 0; p < P::kOwn; ++p) {
    const int panel = panel0 + p;
    store_accumulator<kHd>(dv + cols + panel * kPanelCols,
                           smem + tile * kTile + panel * kPanelBytes,
                           dv_acc[p], 1.f, group_k0, tk, 1 + group, in_group);
    store_accumulator<kHd>(
        dk + cols + panel * kPanelCols,
        smem + (P::kKeyTiles + tile) * kTile + panel * kPanelBytes,
        dk_acc[p], scale, group_k0, tk, 1 + group, in_group);
  }
}

// ---------------------------------------------------------------------------
// head sizes above 256: K3c's cluster kernel (see the note at the top)
// ---------------------------------------------------------------------------

// A block: two consumer warpgroups over 64 query rows and at most kDqOwn
// panels of dQ (Q's and dO's resident), half of them, rounded up, to
// group 0, and a warpgroup whose first warp is the producer; the ring's
// items are two panels each
constexpr int kDqGroups = 2;
constexpr int kDqOwn = 8;  // 512 columns of dQ a block
constexpr int kDqGroupPanels = kDqOwn / kDqGroups;  // 128 registers of dQ
constexpr int kDqConsumers = 128 * kDqGroups;
constexpr int kDqThreads = kDqConsumers + 128;
constexpr int kDqItemBytes = 2 * kPanelBytes;
constexpr int kDqSlots = 4;      // the ring's items
constexpr int kDqFlagSteps = 4;  // the key flags of the last steps
// a [64 x 64] float32 tile, 8 units a thread; the exchange buffer holds a
// block's terms of S and of dP
constexpr int kDqScoreBytes = 8 * kUnitBytes;
constexpr int kDqExchangeBytes = 2 * kDqScoreBytes;
constexpr int kDqBarrier = 3;  // the consumers' named barrier

// How K3c's cluster kernel cuts a head of `panels` panels: `clusters`
// chunks along z, as few as clusters of the portable size allow, each
// chunk balanced over its cluster's `blocks` blocks, as few as hold kDqOwn
// panels a block (h 512: one block, no cluster; h 1216: 7 + 6 + 6)
struct DqClusterSplit {
  int blocks, clusters;
};

__host__ __device__ constexpr DqClusterSplit dq_cluster_split(int panels) {
  constexpr int most = kMaxCluster * kDqOwn;  // 64 a cluster
  const int clusters = (panels + most - 1) / most;
  const int widest = (panels + clusters - 1) / clusters;
  return {(widest + kDqOwn - 1) / kDqOwn, clusters};
}

// Q's and dO's own panels, the ring, the exchange buffer, the steps' key
// flags and counts of valid keys, the barriers (each slot's full and
// empty, Q's and dO's, the exchange buffer's ready and free), the warps'
// words of kept_key_end
__host__ __device__ constexpr size_t dq_cluster_smem_bytes() {
  return 1024 + 2 * kDqOwn * kPanelBytes + kDqSlots * kDqItemBytes +
         kDqExchangeBytes + kDqFlagSteps * (kTileRows + 1) * 4 +
         (2 * kDqSlots + 3) * 8 + kDqThreads / 32 * 4;
}

// The sum over the cluster's n blocks, in rank order, of a block's tile
// (8 units a thread) at `tile` (this thread's slot of unit 0, the same
// offset in every block), four units at a time, four of a rank's loads in
// flight: this block's terms come from `own` if it holds them in registers
// (and are left there), else from its shared memory; into `sum`.
template <bool kOwn>
__device__ __forceinline__ void cluster_tile_sum(float (&sum)[32],
                                                 uint32_t tile, int n,
                                                 int rank) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4 acc[4];
    for (int r = 0; r < n; ++r) {
      float4 term[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t at = tile + (4 * h + u) * kUnitBytes;
        term[u] = r != rank ? load_remote(at, r)
                  : kOwn    ? unit_of(sum, 4 * h + u)
                            : load_shared(at);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = r == 0 ? term[u] : acc[u] + term[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) set_unit(sum, 4 * h + u, acc[u]);
  }
}

// K3c: dq for the block's 64 query rows and its panels of the head's
// columns, over all key tiles. Group 0 computes the block's terms of S,
// group 1 those of dP; each sums both tiles over the cluster's blocks, so
// both hold S and dP, and each accumulates its share of the block's
// panels of dQ.
template <typename T>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_cluster_kernel(__grid_constant__ const CUtensorMap q_map,
                                __grid_constant__ const CUtensorMap do_map,
                                __grid_constant__ const CUtensorMap k_map,
                                __grid_constant__ const CUtensorMap v_map,
                                const float* __restrict__ l,
                                const float* __restrict__ m,
                                const float* __restrict__ di,
                                const float* __restrict__ kv_mask,
                                T* __restrict__ dq, int tq, int tk, int hd,
                                int n_heads, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem);  // Q's own panels, then dO's
  const uint32_t do_s = q_s + kDqOwn * kPanelBytes;
  const uint32_t ring = q_s + 2 * kDqOwn * kPanelBytes;
  const uint32_t xbuf = ring + kDqSlots * kDqItemBytes;
  // the key flags of the last kDqFlagSteps steps ([step][key]), written
  // with a step's first item: a step is at least six items and the ring
  // holds kDqSlots, so the producer never overwrites a step's flags before
  // its dQ products
  float* step_flags =
      reinterpret_cast<float*>(smem + (xbuf - q_s) + kDqExchangeBytes);
  int* step_valid = reinterpret_cast<int*>(step_flags +
                                           kDqFlagSteps * kTileRows);
  const uint32_t full0 = smem_u32(step_valid + kDqFlagSteps);
  const uint32_t empty0 = full0 + 8 * kDqSlots;
  const uint32_t q_full = empty0 + 8 * kDqSlots;
  const uint32_t ready = q_full + 8, free_bar = ready + 8;
  int* words = reinterpret_cast<int*>(smem + (free_bar + 8 - q_s));

  const Lanes at;
  const int group = at.group, in_group = at.tid & 127;
  const int n = cluster_blocks(), rank = cluster_rank();
  const int chunks = gridDim.z / n, chunk = blockIdx.z / n;
  const int panels = hd / kPanelCols;
  const Span mine = cluster_panels(panels, chunks, chunk, n, rank);
  const int own = mine.count;
  // group 0's panels of dQ are the first half0 of the block's, group 1's
  // the rest
  const int half0 = (own + 1) / 2;
  const int group_own = group ? own - half0 : half0;
  // the block's parts of the other chunks: the panels the blocks of the
  // same rank own in the other clusters, whose terms of S and dP this
  // block computes for its own cluster
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
  const int k_end = kept_key_end<kDqThreads>(
      mask_row, causal ? min(tk, q0 + kTileRows + offset) : tk, at.tid,
      words);
  const int steps = (max(k_end, 0) + kTileRows - 1) / kTileRows;
  T* dq_cols = dq + (size_t)bn * tq * hd + mine.first * kPanelCols;
  if (steps == 0) {  // no key reaches the block: zeros, nothing read
    for (int p = group; p < own && group < kDqGroups; p += kDqGroups)
      store_zero_panel(dq_cols + p * kPanelCols, q0, tq, hd, in_group);
    return;
  }

  // A key step's items pass through the ring in this order: for each panel
  // of the block's parts of the other chunks, that panel of Q and of K,
  // then of dO and of V; then the block's own panels of K and of V, two an
  // item, K's item j then V's (panels 2 j and 2 j + 1); then K's items for
  // dQ, item j holding panel j of each group's share (panels j and half0 +
  // j). A panel past the block's is the block's first panel again, which
  // a zero panel of Q or dO multiplies or whose dQ is not stored. A step's
  // first item also brings the tile's key flags and the count of its
  // valid keys.
  const int extra_items = 2 * n_extra, score_items = half0;
  const int step_items = extra_items + 2 * score_items + half0;
  if (at.tid == 0) {
    for (int slot = 0; slot < kDqSlots; ++slot) {
      mbar_init(full0 + 8 * slot, 32);             // the producer's lanes
      mbar_init(empty0 + 8 * slot, kDqConsumers);  // the consumers
    }
    mbar_init(q_full, 1);
    mbar_init(ready, n);     // a thread of each block: its terms are in
    mbar_init(free_bar, n);  // a thread of each block: it read the terms
    mbar_init_fence();
  }
  __syncthreads();
  // every block's barriers are set up before any block arrives on them
  cluster_arrive();
  cluster_wait();

  if (group == kDqGroups) {
    // the producer: its warpgroup gives its registers up, and its first
    // warp fills the ring kDqSlots items ahead of the consumers
    producer_registers();
    if (at.warp_in_group == 0) {
      const int lane = at.lane;
      if (lane == 0) {  // Q's and dO's own panels, once
        mbar_arrive_expect(q_full, 2 * own * kPanelBytes);
        for (int p = 0; p < own; ++p) {
          const int col = (mine.first + p) * kPanelCols;
          tma_load_head(q_s + p * kPanelBytes, &q_map, bn, q_full, q0, col);
          tma_load_head(do_s + p * kPanelBytes, &do_map, bn, q_full, q0,
                        col);
        }
      }
      int i = 0;  // the ring's items so far
      for (int step = 0; step < steps; ++step) {
        const int k0 = step * kTileRows;
        for (int j = 0; j < step_items; ++j) {
          const int slot = i % kDqSlots, use = i / kDqSlots;
          ++i;
          if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
          if (j == 0) {  // which keys of the step's tile take part
            float* flags = step_flags + (step % kDqFlagSteps) * kTileRows;
            int count = 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + lane + 32 * e;
              const float f = key >= tk ? 0.f : mask_row ? mask_row[key] : 1.f;
              flags[lane + 32 * e] = f;
              count += __popc(__ballot_sync(0xffffffffu, f > 0.f));
            }
            if (lane == 0) step_valid[step % kDqFlagSteps] = count;
          }
          const uint32_t full = full0 + 8 * slot;
          if (lane != 0) {
            mbar_arrive(full);
            continue;
          }
          const uint32_t dst = ring + slot * kDqItemBytes;
          mbar_arrive_expect(full, kDqItemBytes);
          if (j < extra_items) {  // Q and K, or dO and V, of another chunk
            int e = j / 2, col = 0;
            for (int c = 0; c < chunks; ++c) {
              if (c == chunk) continue;
              const Span part = cluster_panels(panels, chunks, c, n, rank);
              if (e < part.count) {
                col = (part.first + e) * kPanelCols;
                break;
              }
              e -= part.count;
            }
            const bool scores = (j & 1) == 0;
            tma_load_head(dst, scores ? &q_map : &do_map, bn, full, q0, col);
            tma_load_head(dst + kPanelBytes, scores ? &k_map : &v_map, bn,
                          full, k0, col);
            continue;
          }
          // the own items: K's or V's panels 2 u and 2 u + 1 for the score
          // products, then K's panels u and half0 + u for dQ
          const int u = j - extra_items;
          const bool scores = u < 2 * score_items;
          const CUtensorMap* map = scores && (u & 1) ? &v_map : &k_map;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = u - 2 * score_items;
            const int p = scores ? 2 * (u / 2) + e : e ? half0 + x : x;
            const bool inside =
                scores ? p < own : x < (e ? own - half0 : half0);
            tma_load_head(dst + e * kPanelBytes, map, bn, full, k0,
                          (mine.first + (inside ? p : 0)) * kPanelCols);
          }
        }
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
  // the thread's two rows' exponent offsets and di, zeros past tq
  float lse2[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const RowStats st = row_stats(m, l, di, bn, tq, row_a + 8 * r);
    lse2[r] = exponent_offset(st.m, st.l);
    di_r[r] = st.di;
  }
  const bool rows_inside = q0 + kTileRows <= tq;

  // group 0's panels of Q, group 1's of dO, past the block's: zeros, which
  // add nothing to the block's terms
  for (int p = own; p < kDqOwn; ++p)
    for (int x = in_group; x < kPanelBytes / 16; x += 128)
      store_shared((group ? do_s : q_s) + p * kPanelBytes + 16 * x,
                   make_float4(0.f, 0.f, 0.f, 0.f));
  fence_async_shared();  // visible to the tensor cores' reads
  auto consumers_sync = [] {
    asm volatile("bar.sync %0, %1;\n" ::"n"(kDqBarrier), "n"(kDqConsumers)
                 : "memory");
  };
  consumers_sync();
  mbar_wait(q_full, 0);

  // the group's panels of dQ: one [64 x 64] accumulator each
  float acc[kDqGroupPanels][32];
#pragma unroll
  for (int p = 0; p < kDqGroupPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  int item = 0, exchanges = 0;
  // the next item's slot, once it has arrived
  auto next_item = [&]() {
    const int slot = item % kDqSlots;
    mbar_wait(full0 + 8 * slot, (item / kDqSlots) & 1);
    __syncwarp();  // converged for the warpgroup's products
    ++item;
    return slot;
  };
  auto release = [&](int slot) { mbar_arrive(empty0 + 8 * slot); };
  // the group's resident operand: Q for S, dO for dP
  const uint32_t res = group ? do_s : q_s;

  for (int step = 0; step < steps; ++step) {
    const int k0 = step * kTileRows;
    const float* valid = step_flags + (step % kDqFlagSteps) * kTileRows;
    // the group's score product, S (group 0) or dP (group 1): its terms
    // over the block's parts of the other chunks, an item each, then over
    // its own panels, two an item (K's items for S, V's for dP)
    float s[32], b[32];
    int chain = 0, n_valid = 0;
    for (int j = 0; j < extra_items + 2 * score_items; ++j) {
      const int slot = next_item();
      if (j == 0) n_valid = step_valid[step % kDqFlagSteps];
      const uint32_t at_slot = ring + slot * kDqItemBytes;
      if (n_valid != 0 && (j & 1) == group) {
        products_begin();
        if (j < extra_items) {
          product_nt_panel<T>(s, at_slot, at_slot + kPanelBytes, 4 * chain);
          ++chain;
        } else {
          const int p = 2 * ((j - extra_items) / 2);
          product_nt_panel<T>(s, res + p * kPanelBytes, at_slot,
                              4 * (chain + p));
          product_nt_panel<T>(s, res + (p + 1) * kPanelBytes,
                              at_slot + kPanelBytes, 4 * (chain + p + 1));
        }
        products_end();
        keep_registers(s);
      }
      release(slot);
    }

    uint32_t ds[4][4];
    if (n_valid != 0) {
      // S and dP summed over the cluster's blocks in rank order, the same
      // bits in every group of every block. Group g writes its terms to
      // tile g of the exchange buffer (in a cluster of one, tile g ^ e for
      // the e-th exchange: a group then only overwrites the tile it read
      // itself at the exchange before); ready counts the blocks whose
      // terms are in, free the blocks that have read the exchange's terms
      // from every block.
      const int e = exchanges++;
      if (n > 1 && e > 0) mbar_wait_cluster(free_bar, (e - 1) & 1);
      const int mine_t = n > 1 ? group : group ^ (e & 1);
      const uint32_t slot_of = xbuf + in_group * 16;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        store_shared(slot_of + mine_t * kDqScoreBytes + u * kUnitBytes,
                     unit_of(s, u));
      consumers_sync();
      if (n > 1) {
        if (at.tid < n) mbar_arrive_remote(ready, at.tid);
        mbar_wait_cluster(ready, e & 1);
      }
      cluster_tile_sum<true>(s, slot_of + mine_t * kDqScoreBytes, n, rank);
      cluster_tile_sum<false>(b, slot_of + (mine_t ^ 1) * kDqScoreBytes, n,
                              rank);
      if (n > 1) {  // every block may write its next terms once all read
        consumers_sync();
        if (at.tid < n) mbar_arrive_remote(free_bar, at.tid);
      }
      // ds, the same in both groups: every pair of the tile takes part, or
      // the per-element tests
      const bool unmasked = n_valid == kTileRows && rows_inside &&
                            (!causal || k0 + kTileRows - 1 <= q0 + offset);
      if (group == 0) {  // s holds S, b dP
        dq_scores(s, b, lse2, di_r, scale2, unmasked, valid, k0, row_a, tq,
                  tk, causal, offset, at.t);
        pack_a_fragments<T>(s, ds);
      } else {  // s holds dP, b S
        dq_scores(b, s, lse2, di_r, scale2, unmasked, valid, k0, row_a, tq,
                  tk, causal, offset, at.t);
        pack_a_fragments<T>(b, ds);
      }
    }
    // dQ over the group's panels: K's item j holds its panel j
#pragma unroll
    for (int j = 0; j < kDqGroupPanels; ++j) {
      if (j >= half0) break;
      const int slot = next_item();
      if (n_valid != 0 && j < group_own) {
        products_begin();
        product_tn<T>(acc[j], ds,
                      ring + slot * kDqItemBytes + group * kPanelBytes);
        products_end();
        keep_registers(ds);
        keep_registers(acc[j]);
      }
      release(slot);
    }
  }
  // no block leaves while another may still read its exchange buffer or
  // arrive on its barriers
  cluster_arrive();
  cluster_wait();

  // Q's panels are read no more (the cluster's barrier above): panel a of
  // the group's share leaves through panel (half0 group + a) of them
#pragma unroll
  for (int a = 0; a < kDqGroupPanels; ++a) {
    if (a < group_own) {
      const int p = (group ? half0 : 0) + a;
      store_panel(dq_cols + p * kPanelCols, smem + p * kPanelBytes, acc[a],
                  scale, q0, tq, hd, 1 + group, in_group);
    }
  }
}

// K3b's launch at `panels` panels: the narrow kernel at 0 (head size 32),
// the whole-tile kernel at 1, the producer kernel at 2 (a block owns 128
// keys) and 4 (64 keys, its consumer warpgroups split the panels), the
// cluster kernel above 4
LaunchShape dkv_shape(int panels) {
  if (panels == 0) return narrow_shape();
  if (panels == 2)
    return {kPairThreads, pair_smem_bytes<2>(), Pair<2>::kKeys, 1};
  if (panels == 4)
    return {kPairThreads, pair_smem_bytes<4>(), Pair<4>::kKeys, 1};
  if (panels > 4) {
    const ClusterSplit split = cluster_split(panels);
    return {256, cluster_smem_bytes(), kTileRows,
            split.blocks * split.clusters, split.blocks};
  }
  return {128, smem_bytes<1>(1), kTileRows, 1};
}

// K3c's: the narrow kernel at 0 panels (head size 32), the whole-tile
// kernel (each warpgroup owns 64 query rows) or, above 4, the cluster
// kernel
LaunchShape dq_shape(int panels) {
  if (panels == 0) return narrow_shape();
  if (panels > 4) {
    const DqClusterSplit split = dq_cluster_split(panels);
    return {kDqThreads, dq_cluster_smem_bytes(), kTileRows,
            split.blocks * split.clusters, split.blocks};
  }
  const int groups = dq_groups(panels);
  return {128 * groups,
          panels == 1   ? smem_bytes<1>(groups)
          : panels == 2 ? smem_bytes<2>(groups)
                        : smem_bytes<4>(groups),
          groups * kTileRows, 1};
}

template <typename T>
cudaError_t launch_dkv_cluster(int hd, const void* q, const void* k,
                               const void* v, const void* dout,
                               const void* l, const void* m, const void* di,
                               const void* kv_mask, void* dk, void* dv,
                               int bn, int tq, int tk, int n_heads,
                               float scale, int causal,
                               cudaStream_t stream) {
  return launch_cluster_in<flash_bwd_dkv_cluster_kernel<T>>(
      dkv_shape(hd / kPanelCols), bn, tk, stream, (const T*)q, (const T*)k,
      (const T*)v, (const T*)dout, (const float*)l, (const float*)m,
      (const float*)di, (const float*)kv_mask, (T*)dk, (T*)dv, tq, tk, hd,
      n_heads, scale, causal);
}

// tensor maps of Q, dO, K and V of head size hd whose boxes are one panel
// of 64 rows
template <typename T>
cudaError_t panel_maps(CUtensorMap (&maps)[4], const void* q,
                       const void* dout, const void* k, const void* v,
                       int bn, int tq, int tk, int hd) {
  cudaError_t err = head_map<T>(&maps[0], q, bn, tq, kTileRows, hd);
  if (err == cudaSuccess)
    err = head_map<T>(&maps[1], dout, bn, tq, kTileRows, hd);
  if (err == cudaSuccess) err = head_map<T>(&maps[2], k, bn, tk, kTileRows, hd);
  if (err == cudaSuccess) err = head_map<T>(&maps[3], v, bn, tk, kTileRows, hd);
  return err;
}

// K3c's cluster kernel: clusters of blocks along z over each chunk of the
// head (launch_cluster_in; a cluster the card cannot place is refused
// there)
template <typename T>
cudaError_t launch_dq_cluster(int hd, const void* q, const void* k,
                              const void* v, const void* dout, const void* l,
                              const void* m, const void* di,
                              const void* kv_mask, void* dq, int bn, int tq,
                              int tk, int n_heads, float scale, int causal,
                              cudaStream_t stream) {
  CUtensorMap maps[4];
  const cudaError_t err = panel_maps<T>(maps, q, dout, k, v, bn, tq, tk, hd);
  if (err != cudaSuccess) return err;
  return launch_cluster_in<flash_bwd_dq_cluster_kernel<T>>(
      dq_shape(hd / kPanelCols), bn, tq, stream, maps[0], maps[1], maps[2],
      maps[3], (const float*)l, (const float*)m, (const float*)di,
      (const float*)kv_mask, (T*)dq, tq, tk, hd, n_heads, scale, causal);
}

template <typename T, int kPanels>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* l, const void* m,
                       const void* di, const void* kv_mask, void* dk,
                       void* dv, int bn, int tq, int tk, int n_heads,
                       float scale, int causal, cudaStream_t stream) {
  return launch_in<flash_bwd_dkv_tc_kernel<T, kPanels>>(
      dkv_shape(kPanels), bn, tk, stream, (const T*)q, (const T*)k,
      (const T*)v, (const T*)dout, (const float*)l, (const float*)m,
      (const float*)di, (const float*)kv_mask, (T*)dk, (T*)dv, tq, tk,
      n_heads, scale, causal);
}

// the producer kernel at head size 128 or 256 (kPanels 2 or 4)
template <typename T, int kPanels>
cudaError_t launch_dkv_producer(const void* q, const void* k, const void* v,
                                const void* dout, const void* l,
                                const void* m, const void* di,
                                const void* kv_mask, void* dk, void* dv,
                                int bn, int tq, int tk, int n_heads,
                                float scale, int causal,
                                cudaStream_t stream) {
  CUtensorMap maps[4];
  const cudaError_t err = panel_maps<T>(maps, q, dout, k, v, bn, tq, tk,
                                        kPanels * kPanelCols);
  if (err != cudaSuccess) return err;
  return launch_in<flash_bwd_dkv_producer_kernel<T, kPanels>>(
      dkv_shape(kPanels), bn, tk, stream, maps[0], maps[1], maps[2], maps[3],
      (const float*)l, (const float*)m, (const float*)di,
      (const float*)kv_mask, (T*)dk, (T*)dv, tq, tk, n_heads, scale, causal);
}

LaunchShape dkv_short_shape() {
  return {kShortThreads, dkv_short_smem_bytes(), kShortRows, 1};
}

// K3b's short kernel, persistent: as many blocks as the card holds, each
// walking the heads blockIdx.x, + gridDim.x, ...
template <typename T>
cudaError_t launch_dkv_short(const void* q, const void* k, const void* v,
                             const void* dout, const void* l, const void* m,
                             const void* di, const void* kv_mask, void* dk,
                             void* dv, int bn, int tq, int tk, int n_heads,
                             float scale, int causal, cudaStream_t stream) {
  // a copy brings whole tiles: rows past the sequence arrive as zeros
  const int q_rows = (tq + kTileRows - 1) / kTileRows * kTileRows;
  CUtensorMap maps[4];
  cudaError_t err = head_map<T>(&maps[0], q, bn, tq, q_rows);
  if (err == cudaSuccess) err = head_map<T>(&maps[1], dout, bn, tq, q_rows);
  if (err == cudaSuccess) err = head_map<T>(&maps[2], k, bn, tk, kTileRows);
  if (err == cudaSuccess) err = head_map<T>(&maps[3], v, bn, tk, kTileRows);
  if (err != cudaSuccess) return err;
  const LaunchShape shape = dkv_short_shape();
  const int blocks = resident_blocks<flash_bwd_dkv_short_kernel<T>>(shape);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  flash_bwd_dkv_short_kernel<T><<<bn < blocks ? bn : blocks, shape.threads,
                                  shape.smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)l, (const float*)m,
      (const float*)di, (const float*)kv_mask, (T*)dk, (T*)dv, bn, tq, tk,
      n_heads, scale, causal);
  return cudaGetLastError();
}

template <typename T, int kPanels>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* l, const void* m,
                      const void* di, const void* kv_mask, void* dq, int bn,
                      int tq, int tk, int n_heads, float scale, int causal,
                      cudaStream_t stream) {
  return launch_in<flash_bwd_dq_tc_kernel<T, kPanels>>(
      dq_shape(kPanels), bn, tq, stream, (const T*)q, (const T*)k,
      (const T*)v, (const T*)dout, (const float*)l, (const float*)m,
      (const float*)di, (const float*)kv_mask, (T*)dq, tq, tk, n_heads,
      scale, causal);
}

template <typename T>
cudaError_t launch_dkv_narrow(const void* q, const void* k, const void* v,
                              const void* dout, const void* l, const void* m,
                              const void* di, const void* kv_mask, void* dk,
                              void* dv, int bn, int tq, int tk, int n_heads,
                              float scale, int causal, cudaStream_t stream) {
  return launch_in<flash_bwd_dkv_narrow_kernel<T>>(
      narrow_shape(), bn, tk, stream, (const T*)q, (const T*)k, (const T*)v,
      (const T*)dout, (const float*)l, (const float*)m, (const float*)di,
      (const float*)kv_mask, (T*)dk, (T*)dv, tq, tk, n_heads, scale, causal);
}

template <typename T>
cudaError_t launch_dq_narrow(const void* q, const void* k, const void* v,
                             const void* dout, const void* l, const void* m,
                             const void* di, const void* kv_mask, void* dq,
                             int bn, int tq, int tk, int n_heads, float scale,
                             int causal, cudaStream_t stream) {
  return launch_in<flash_bwd_dq_narrow_kernel<T>>(
      narrow_shape(), bn, tq, stream, (const T*)q, (const T*)k, (const T*)v,
      (const T*)dout, (const float*)l, (const float*)m, (const float*)di,
      (const float*)kv_mask, (T*)dq, tq, tk, n_heads, scale, causal);
}

template <typename T>
cudaError_t dkv_panels(int panels, const void* q, const void* k,
                       const void* v, const void* dout, const void* l,
                       const void* m, const void* di, const void* kv_mask,
                       void* dk, void* dv, int bn, int tq, int tk,
                       int n_heads, float scale, int causal,
                       cudaStream_t stream) {
  if (panels == 0)
    return launch_dkv_narrow<T>(q, k, v, dout, l, m, di, kv_mask, dk, dv, bn,
                                tq, tk, n_heads, scale, causal, stream);
  if (takes_short_dkv(panels, tq, tk))
    return launch_dkv_short<T>(q, k, v, dout, l, m, di, kv_mask, dk, dv, bn,
                               tq, tk, n_heads, scale, causal, stream);
  if (panels == 1)
    return launch_dkv<T, 1>(q, k, v, dout, l, m, di, kv_mask, dk, dv, bn,
                            tq, tk, n_heads, scale, causal, stream);
  if (panels == 2)
    return launch_dkv_producer<T, 2>(q, k, v, dout, l, m, di, kv_mask, dk,
                                     dv, bn, tq, tk, n_heads, scale, causal,
                                     stream);
  if (panels == 4)
    return launch_dkv_producer<T, 4>(q, k, v, dout, l, m, di, kv_mask, dk,
                                     dv, bn, tq, tk, n_heads, scale, causal,
                                     stream);
  if (panels > 4)
    return launch_dkv_cluster<T>(panels * kPanelCols, q, k, v, dout, l, m,
                                 di, kv_mask, dk, dv, bn, tq, tk, n_heads,
                                 scale, causal, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dq_panels(int panels, const void* q, const void* k,
                      const void* v, const void* dout, const void* l,
                      const void* m, const void* di, const void* kv_mask,
                      void* dq, int bn, int tq, int tk, int n_heads,
                      float scale, int causal, cudaStream_t stream) {
  if (panels == 0)
    return launch_dq_narrow<T>(q, k, v, dout, l, m, di, kv_mask, dq, bn, tq,
                               tk, n_heads, scale, causal, stream);
  if (panels == 1)
    return launch_dq<T, 1>(q, k, v, dout, l, m, di, kv_mask, dq, bn, tq, tk,
                           n_heads, scale, causal, stream);
  if (panels == 2)
    return launch_dq<T, 2>(q, k, v, dout, l, m, di, kv_mask, dq, bn, tq, tk,
                           n_heads, scale, causal, stream);
  if (panels == 4)
    return launch_dq<T, 4>(q, k, v, dout, l, m, di, kv_mask, dq, bn, tq, tk,
                           n_heads, scale, causal, stream);
  if (panels > 4)
    return launch_dq_cluster<T>(panels * kPanelCols, q, k, v, dout, l, m,
                                di, kv_mask, dq, bn, tq, tk, n_heads, scale,
                                causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// f16: float16 operands (else bfloat16); panels: the head size over 64, 0
// (head size 32, the narrow kernels), 1, 2, 4 or any count above 4 (the
// cluster kernels of K3b and K3c)
cudaError_t flash_bwd_dkv_tc(int f16, int panels, const void* q,
                             const void* k, const void* v, const void* dout,
                             const void* l, const void* m, const void* di,
                             const void* kv_mask, void* dk, void* dv, int bn,
                             int tq, int tk, int n_heads, float scale,
                             int causal, cudaStream_t stream) {
  if (f16)
    return dkv_panels<__half>(panels, q, k, v, dout, l, m, di, kv_mask, dk,
                              dv, bn, tq, tk, n_heads, scale, causal, stream);
  return dkv_panels<__nv_bfloat16>(panels, q, k, v, dout, l, m, di, kv_mask,
                                   dk, dv, bn, tq, tk, n_heads, scale, causal,
                                   stream);
}

cudaError_t flash_bwd_dq_tc(int f16, int panels, const void* q,
                            const void* k, const void* v, const void* dout,
                            const void* l, const void* m, const void* di,
                            const void* kv_mask, void* dq, int bn, int tq,
                            int tk, int n_heads, float scale, int causal,
                            cudaStream_t stream) {
  if (f16)
    return dq_panels<__half>(panels, q, k, v, dout, l, m, di, kv_mask, dq,
                             bn, tq, tk, n_heads, scale, causal, stream);
  return dq_panels<__nv_bfloat16>(panels, q, k, v, dout, l, m, di, kv_mask,
                                  dq, bn, tq, tk, n_heads, scale, causal,
                                  stream);
}

// K3b's kernel for a call at `panels` panels and these lengths (0 the
// whole-tile kernel, 1 the short kernel, 2 the cluster kernel, 3 the narrow
// kernel, 4 the producer kernel)
int flash_bwd_dkv_kernel_of(int panels, int tq, int tk) {
  return panels == 0                        ? 3
         : takes_short_dkv(panels, tq, tk)  ? 1
         : panels > 4                       ? 2
         : panels == 2 || panels == 4       ? 4
                                            : 0;
}

// K3c's kernel at `panels` panels (0 the whole-tile kernel, 1 the cluster
// kernel, 2 the narrow kernel)
int flash_bwd_dq_kernel_of(int panels) {
  return panels == 0 ? 2 : panels > 4 ? 1 : 0;
}

// the launch shape of K3b (dkv nonzero) or K3c at `panels` panels and these
// lengths
flash_tiles::LaunchShape flash_bwd_tc_shape(int dkv, int panels, int tq,
                                            int tk) {
  if (!dkv) return dq_shape(panels);
  return takes_short_dkv(panels, tq, tk) ? dkv_short_shape()
                                         : dkv_shape(panels);
}

// how many blocks of K3b's kernel for these sizes, of float16 (f16
// nonzero) or bfloat16, the current card holds at once (or -1)
int flash_bwd_dkv_resident(int f16, int panels, int tq, int tk) {
  const LaunchShape shape = flash_bwd_tc_shape(1, panels, tq, tk);
  switch (flash_bwd_dkv_kernel_of(panels, tq, tk) * 2 + (f16 ? 1 : 0)) {
    case 2:
      return resident_blocks<flash_bwd_dkv_short_kernel<__nv_bfloat16>>(
          shape);
    case 3:
      return resident_blocks<flash_bwd_dkv_short_kernel<__half>>(shape);
    case 4:
      return resident_blocks<flash_bwd_dkv_cluster_kernel<__nv_bfloat16>>(
          shape);
    case 5:
      return resident_blocks<flash_bwd_dkv_cluster_kernel<__half>>(shape);
    case 6:
      return resident_blocks<flash_bwd_dkv_narrow_kernel<__nv_bfloat16>>(
          shape);
    case 7:
      return resident_blocks<flash_bwd_dkv_narrow_kernel<__half>>(shape);
    case 8:
      if (panels == 2)
        return resident_blocks<
            flash_bwd_dkv_producer_kernel<__nv_bfloat16, 2>>(shape);
      return resident_blocks<flash_bwd_dkv_producer_kernel<__nv_bfloat16, 4>>(
          shape);
    case 9:
      if (panels == 2)
        return resident_blocks<flash_bwd_dkv_producer_kernel<__half, 2>>(
            shape);
      return resident_blocks<flash_bwd_dkv_producer_kernel<__half, 4>>(shape);
  }
  return f16 ? resident_blocks<flash_bwd_dkv_tc_kernel<__half, 1>>(shape)
             : resident_blocks<flash_bwd_dkv_tc_kernel<__nv_bfloat16, 1>>(
                   shape);
}

// how many blocks of K3c's kernel at `panels` panels, of float16 (f16
// nonzero) or bfloat16, the current card holds at once (or -1)
int flash_bwd_dq_resident(int f16, int panels) {
  const LaunchShape shape = dq_shape(panels);
  switch (flash_bwd_dq_kernel_of(panels) * 2 + (f16 ? 1 : 0)) {
    case 2:
      return resident_blocks<flash_bwd_dq_cluster_kernel<__nv_bfloat16>>(
          shape);
    case 3:
      return resident_blocks<flash_bwd_dq_cluster_kernel<__half>>(shape);
    case 4:
      return resident_blocks<flash_bwd_dq_narrow_kernel<__nv_bfloat16>>(
          shape);
    case 5:
      return resident_blocks<flash_bwd_dq_narrow_kernel<__half>>(shape);
  }
  if (panels == 1)
    return f16 ? resident_blocks<flash_bwd_dq_tc_kernel<__half, 1>>(shape)
               : resident_blocks<flash_bwd_dq_tc_kernel<__nv_bfloat16, 1>>(
                     shape);
  if (panels == 2)
    return f16 ? resident_blocks<flash_bwd_dq_tc_kernel<__half, 2>>(shape)
               : resident_blocks<flash_bwd_dq_tc_kernel<__nv_bfloat16, 2>>(
                     shape);
  return f16 ? resident_blocks<flash_bwd_dq_tc_kernel<__half, 4>>(shape)
             : resident_blocks<flash_bwd_dq_tc_kernel<__nv_bfloat16, 4>>(
                   shape);
}

// how many clusters of K3b's cluster kernel at `panels` panels (above 4)
// of float16 (f16 nonzero) or bfloat16 the card holds at once
int flash_bwd_dkv_max_clusters(int f16, int panels) {
  const LaunchShape shape = dkv_shape(panels);
  return f16 ? max_active_clusters<flash_bwd_dkv_cluster_kernel<__half>>(shape)
             : max_active_clusters<
                   flash_bwd_dkv_cluster_kernel<__nv_bfloat16>>(shape);
}

// the same for K3c's cluster kernel
int flash_bwd_dq_max_clusters(int f16, int panels) {
  const LaunchShape shape = dq_shape(panels);
  return f16 ? max_active_clusters<flash_bwd_dq_cluster_kernel<__half>>(shape)
             : max_active_clusters<
                   flash_bwd_dq_cluster_kernel<__nv_bfloat16>>(shape);
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

