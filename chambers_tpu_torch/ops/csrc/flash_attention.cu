// Hand-written Hopper kernels for blockwise (flash) attention, forward and
// backward, with a plain C interface loaded through ctypes
// (chambers_tpu_torch/ops/flash_attention.py holds the wrapper, the
// autograd function and the plain PyTorch versions they are checked
// against). The flash_attention library has three sources, and each C
// function below chooses its kernel by the operands' type:
//   bfloat16, float16  the tensor-core kernels: flash_attention_fwd.cu
//                      (K3a) and flash_attention_bwd.cu (K3b, K3c), both
//                      on flash_tiles.cuh, templated on the type
//   float32            the FMA kernels of this file, for all three
//
// Replaces the Pallas TPU kernels of chambers_tpu/ops/flash_attention.py:
//   flash_fwd_kernel      <- _flash_forward / _flash_fwd_kernel        (K3a)
//   flash_bwd_dkv_kernel  <- _flash_backward / _flash_bwd_dkv_kernel   (K3b)
//   flash_bwd_dq_kernel   <- _flash_backward / _flash_bwd_dq_kernel    (K3c)
// (the 16-bit kernels carry the same names with _tc, at head sizes 128 and
// 256 K3b's with _producer, above head size 256 with _cluster, at head
// size 32 with _narrow; the float32 ones from head size 256 on with
// _cols).
//
// What they compute, over [bn, t, h] operands (bn = batch * heads):
//   forward  o = softmax(q k^T * scale) v by key tiles, with a float32
//            running max m and sum l per query row; returns o, l, m
//   dK/dV    per key tile, over all query tiles: p = exp(s - m) / l,
//            dv += p^T do, ds = p * (do v^T - di), dk += ds^T q * scale
//   dQ       per query tile, over all key tiles: dq += ds k * scale
// with di = sum(o * do) computed by the wrapper. The key padding mask is
// [b, tk] float32 and shared by the heads of a batch item (bn / n_heads);
// the causal diagonal sits at the sequence end (col <= row + tk - tq);
// a query row with no valid key gives exactly zero, forward and backward,
// and keeps m at the mask value.
//
// Bound: at the train step's shape, [128, 512, 64] bf16, the forward moves
// 34 MB (10.2 us at an H100 SXM's 3.35 TB/s) and does 4 * bn * tq * tk * h
// = 8.6 GFLOP (8.7 us at the tensor cores' 989 TFLOP/s in bf16): the two
// are level, and longer sequences tip it to operations. dK/dV (17.2 GFLOP,
// 17.4 us) and dQ (12.9 GFLOP, 13.0 us) are bound by operations. The
// kernels in this file do not use the tensor cores: every product is a
// float32 FMA on the CUDA cores, whose peak of 67 TFLOP/s is a fifteenth of
// the bf16 rate (measured 26 to 31 TFLOP/s on an NVIDIA H100 80GB HBM3 at
// 700 W by chip_smoke.py). float32 operands need them: the card holds
// float32 outputs to 2e-5 and gradients to 1e-4 of their largest value,
// which TF32's three digits cannot meet. bfloat16 and float16 operands,
// where the gap to a library call was widest, take the tensor-core
// kernels.
//
// Design: the TPU grid's last, sequential dimension carried m, l and the
// accumulators in VMEM scratch from step to step. Here that dimension is a
// loop inside the block: one block of 256 threads owns a 64-row tile of
// queries (forward, dQ) or of keys (dK/dV), keeps its accumulators in
// registers over the whole loop, and writes each output once. Nothing is
// carried between blocks and there are no atomics, so results repeat from
// run to run. Tiles are staged in shared memory in rows padded by four
// floats, which makes the float4 reads of the inner products free of bank
// conflicts. Threads form a 16 x 16 grid; thread (ty, tx) computes rows
// ty + 16 r and columns tx + 16 c of a 64 x 64 score tile (a 4 x 4 register
// tile), and rows ty + 16 r of the [64, h] accumulators. The softmax's row
// reductions run over the 16 lanes that share a row with shuffles. The
// dK/dV kernel computes the transposed score tile (keys by queries)
// directly, so its second products read p^T and ds^T from shared memory in
// natural layout. The ragged edge (row >= tq, col >= tk) is masked in the
// kernel; operands are not padded. Tiles wholly above the causal diagonal
// are skipped. The forward keeps the accumulator unnormalised and divides
// by l once at the end, where the TPU kernel renormalises at every key
// step.
//
// Takes head size 64, 128 and every multiple of 64 from 256 on (float32:
// the kernels below at 64 and 128, templates over the head size, and from
// 256 on the _cols kernels, which take it at run time; bfloat16 and
// float16 go to the tensor-core kernels, built at 64, 128 and 256, and
// above 256 to the cluster ones, which take it at run time; the wrapper
// zero-pads any other head size to the next of these), contiguous
// operands whose base addresses are multiples of 16 bytes. At 128 the FMA
// kernels keep the same 16 x 16 threads, each holding 8 columns of every
// accumulator row (two groups of 4, 64 apart), and stage
// 64-row tiles of 132 floats a row: 116, 149 and 167 KB of shared memory
// for K3a, K3c and K3b; nvcc gives them 128, 128 and 222 registers, and K3c
// spills 48 bytes.
//
// From 256 on neither way fits: whole tiles of 260 floats a row would take
// 266 KB for K3b and K3c, and accumulators of 16 columns a thread would
// double the registers of 128, K3b's past 255. So the _cols kernels give
// each block HO = 128 of the head's output columns (blockIdx.z picks the
// slice; where the head size is an odd multiple of 64 the last slice
// holds 64, its other columns loaded as zeros and not stored) and the
// accumulators of 128, and stream the score products q k^T and do v^T
// over the whole head (its size a run-time argument) in chunks of 64
// columns through tiles of 68 floats a row; the second products read the
// block's columns of v, k, do or q. Every slice of a row tile computes the
// same scores: the recompute multiplies the score products' work by the
// number of slices (the float32 path is for correctness, not speed) and
// keeps blocks independent. K3a's l and m are written by the first slice.
// 84, 118 and 169 KB of shared memory.
//
// Built WITHOUT --fmad=false: the inner products of these kernels are FMAs,
// and those of the 16-bit kernels run on the tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using flash_tiles::LaunchShape;
using flash_tiles::launch_in;
using flash_tiles::kMaskValue;
using flash_tiles::resident_blocks;

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPad = 4;         // floats of padding per shared-memory row
constexpr int kLdp = kTile + kPad;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  static __device__ __forceinline__ void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
  static __device__ __forceinline__ void store4(float* dst, float a, float b,
                                                float c, float d) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  }
};

// rows [row0, row0 + 64) of HD columns of an array of row stride `stride`
// (``src`` at the first column) into dst[64][HD + kPad] as float32; rows
// past the end, and columns from `cols` on, are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int tid, int stride = HD,
                                          int cols = HD) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kPerRow = HD / kVec;
  constexpr int kLd = HD + kPad;
  for (int i = tid; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* d = dst + r * kLd + c;
    if (row0 + r < rows && c < cols) {
      Elem<T>::load(src + (size_t)(row0 + r) * stride + c, d);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        *reinterpret_cast<float4*>(d + j) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// acc[r][c] = sum_d A[ty + 16 r][d] * B[tx + 16 c][d]; A, B [64][HD + kPad]
template <int HD>
__device__ __forceinline__ void gemm_nt(const float* A, const float* B,
                                        int ty, int tx, float (&acc)[4][4]) {
  constexpr int kLd = HD + kPad;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * kLd + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * kLd + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = acc[r][c];
        t = fmaf(a[r].x, b[c].x, t);
        t = fmaf(a[r].y, b[c].y, t);
        t = fmaf(a[r].z, b[c].z, t);
        t = fmaf(a[r].w, b[c].w, t);
        acc[r][c] = t;
      }
  }
}

// acc[r][c] += sum_{d < 64} A[ty + 16 r][d] * B[tx + 16 c][d], in the order
// of gemm_nt: a 64-column chunk of a score product, A and B [64][kLdp]
__device__ __forceinline__ void gemm_nt_add(const float* A, const float* B,
                                            int ty, int tx,
                                            float (&acc)[4][4]) {
#pragma unroll 4
  for (int d = 0; d < kTile; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * kLdp + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * kLdp + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = acc[r][c];
        t = fmaf(a[r].x, b[c].x, t);
        t = fmaf(a[r].y, b[c].y, t);
        t = fmaf(a[r].z, b[c].z, t);
        t = fmaf(a[r].w, b[c].w, t);
        acc[r][c] = t;
      }
  }
}

// acc[r][c] += sum_j P[ty + 16 r][j] * V[j][col(c)], P [64][kLdp],
// V [64][HD + kPad]; the thread's HD / 16 columns are
// col(c) = 64 (c / 4) + 4 tx + c % 4
template <int HD>
__device__ __forceinline__ void gemm_nn(const float* P, const float* V,
                                        int ty, int tx,
                                        float (&acc)[4][HD / 16]) {
  constexpr int kLd = HD + kPad;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 t =
          *reinterpret_cast<const float4*>(P + (ty + 16 * r) * kLdp + j);
      p[r][0] = t.x;
      p[r][1] = t.y;
      p[r][2] = t.z;
      p[r][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int g = 0; g < HD / 64; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            V + (j + jj) * kLd + g * 64 + tx * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][g * 4 + 0] = fmaf(p[r][jj], v.x, acc[r][g * 4 + 0]);
          acc[r][g * 4 + 1] = fmaf(p[r][jj], v.y, acc[r][g * 4 + 1]);
          acc[r][g * 4 + 2] = fmaf(p[r][jj], v.z, acc[r][g * 4 + 2]);
          acc[r][g * 4 + 3] = fmaf(p[r][jj], v.w, acc[r][g * 4 + 3]);
        }
      }
  }
}

// rows row0 + ty + 16 r of the first `cols` of HD columns (a multiple of
// 64) of an output of row stride `stride` (``dst`` at the first column),
// each times mul[r]
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float (&acc)[4][HD / 16],
                                           const float (&mul)[4], int row0,
                                           int rows, int ty, int tx,
                                           int stride = HD, int cols = HD) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 16 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int g = 0; g < HD / 64; ++g)
      if (g * 64 < cols)
        Elem<T>::store4(dst + (size_t)row * stride + g * 64 + tx * 4,
                        acc[r][g * 4 + 0] * mul[r],
                        acc[r][g * 4 + 1] * mul[r],
                        acc[r][g * 4 + 2] * mul[r],
                        acc[r][g * 4 + 3] * mul[r]);
  }
}

// reductions over the 16 lanes (one tx each) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// validity of the keys of one tile into valid[64]: inside the sequence and
// kept by the padding mask
__device__ __forceinline__ void load_key_validity(float* valid,
                                                  const float* mask_row,
                                                  int k0, int tk, int tid) {
  if (tid < kTile) {
    const int col = k0 + tid;
    valid[tid] =
        (col < tk && (mask_row == nullptr || mask_row[col] > 0.f)) ? 1.f : 0.f;
  }
}

// K3a
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ kv_mask,
                     T* __restrict__ o, float* __restrict__ l_out,
                     float* __restrict__ m_out, int tq, int tk, int n_heads,
                     float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = HD + kPad;
  float* Qs = smem;
  float* Ks = Qs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* Ps = Vs + kTile * kLd;
  float* valid = Ps + kTile * kLdp;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bn = blockIdx.x, q0 = blockIdx.y * kTile;
  const T* qb = q + (size_t)bn * tq * HD;
  const T* kb = k + (size_t)bn * tk * HD;
  const T* vb = v + (size_t)bn * tk * HD;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  load_tile<T, HD>(Qs, qb, q0, tq, tid);

  float m_run[4], l_run[4], acc[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kMaskValue;  // what a row keeps if no key tile reaches it
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[r][c] = 0.f;
  }

  // keys past the last row's diagonal take no part
  const int k_end = causal ? min(tk, q0 + kTile + offset) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last step's readers of Ks, Vs, Ps are done
    load_tile<T, HD>(Ks, kb, k0, tk, tid);
    load_tile<T, HD>(Vs, vb, k0, tk, tid);
    load_key_validity(valid, mask_row, k0, tk, tid);
    __syncthreads();

    float s[4][4];
    gemm_nt<HD>(Qs, Ks, ty, tx, s);

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
      bool ok[4];
      float mx = kMaskValue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jc = tx + 16 * c;
        ok[c] = valid[jc] > 0.f && (!causal || k0 + jc <= row + offset);
        s[r][c] = ok[c] ? s[r][c] * scale : kMaskValue;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = row_max(mx);
      const float m_next = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // the explicit zero makes a fully masked row sum to l == 0
        const float p = ok[c] ? expf(s[r][c] - m_next) : 0.f;
        sum += p;
        Ps[(ty + 16 * r) * kLdp + tx + 16 * c] = p;
      }
      sum = row_sum(sum);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_next;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    gemm_nn<HD>(Ps, Vs, ty, tx, acc);
  }

  float inv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    inv[r] = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
    const int row = q0 + ty + 16 * r;
    if (tx == 0 && row < tq) {
      l_out[(size_t)bn * tq + row] = l_run[r];
      m_out[(size_t)bn * tq + row] = m_run[r];
    }
  }
  store_rows<T, HD>(o + (size_t)bn * tq * HD, acc, inv, q0, tq, ty, tx);
}

// K3c
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ l, const float* __restrict__ m,
                        const float* __restrict__ di,
                        const float* __restrict__ kv_mask, T* __restrict__ dq,
                        int tq, int tk, int n_heads, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = HD + kPad;
  float* Qs = smem;
  float* dOs = Qs + kTile * kLd;
  float* Ks = dOs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* dSs = Vs + kTile * kLd;
  float* valid = dSs + kTile * kLdp;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bn = blockIdx.x, q0 = blockIdx.y * kTile;
  const T* kb = k + (size_t)bn * tk * HD;
  const T* vb = v + (size_t)bn * tk * HD;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  load_tile<T, HD>(Qs, q + (size_t)bn * tq * HD, q0, tq, tid);
  load_tile<T, HD>(dOs, dout + (size_t)bn * tq * HD, q0, tq, tid);

  float m_row[4], linv_row[4], di_row[4], acc[4][HD / 16];
  bool row_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    row_ok[r] = row < tq;
    const size_t at = (size_t)bn * tq + (row_ok[r] ? row : 0);
    const float lr = l[at];
    m_row[r] = m[at];
    linv_row[r] = lr == 0.f ? 1.f : 1.f / lr;
    di_row[r] = di[at];
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[r][c] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + kTile + offset) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(Ks, kb, k0, tk, tid);
    load_tile<T, HD>(Vs, vb, k0, tk, tid);
    load_key_validity(valid, mask_row, k0, tk, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    gemm_nt<HD>(Qs, Ks, ty, tx, s);
    gemm_nt<HD>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jc = tx + 16 * c;
        const bool ok = row_ok[r] && valid[jc] > 0.f &&
                        (!causal || k0 + jc <= row + offset);
        const float p =
            ok ? expf(s[r][c] * scale - m_row[r]) * linv_row[r] : 0.f;
        dSs[(ty + 16 * r) * kLdp + jc] = p * (dp[r][c] - di_row[r]);
      }
    }
    __syncthreads();
    gemm_nn<HD>(dSs, Ks, ty, tx, acc);
  }

  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, HD>(dq + (size_t)bn * tq * HD, acc, mul, q0, tq, ty, tx);
}

// K3b
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ l,
                         const float* __restrict__ m,
                         const float* __restrict__ di,
                         const float* __restrict__ kv_mask,
                         T* __restrict__ dk, T* __restrict__ dv, int tq,
                         int tk, int n_heads, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = HD + kPad;
  float* Ks = smem;
  float* Vs = Ks + kTile * kLd;
  float* Qs = Vs + kTile * kLd;
  float* dOs = Qs + kTile * kLd;
  float* Pt = dOs + kTile * kLd;    // [key][query]
  float* dSt = Pt + kTile * kLdp;   // [key][query]
  float* m_s = dSt + kTile * kLdp;  // per query of the tile
  float* linv_s = m_s + kTile;
  float* di_s = linv_s + kTile;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bn = blockIdx.x, k0 = blockIdx.y * kTile;
  const T* qb = q + (size_t)bn * tq * HD;
  const T* dob = dout + (size_t)bn * tq * HD;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  load_tile<T, HD>(Ks, k + (size_t)bn * tk * HD, k0, tk, tid);
  load_tile<T, HD>(Vs, v + (size_t)bn * tk * HD, k0, tk, tid);

  bool key_ok[4];
  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    key_ok[r] =
        key < tk && (mask_row == nullptr || mask_row[key] > 0.f);
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      dk_acc[r][c] = 0.f;
      dv_acc[r][c] = 0.f;
    }
  }

  // under the causal mask only query rows with row + offset >= k0 reach
  // this key tile
  int q_begin = 0;
  if (causal && k0 - offset > 0) q_begin = (k0 - offset) / kTile * kTile;
  for (int q0 = q_begin; q0 < tq; q0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(Qs, qb, q0, tq, tid);
    load_tile<T, HD>(dOs, dob, q0, tq, tid);
    if (tid < kTile) {
      const int row = q0 + tid;
      const size_t at = (size_t)bn * tq + (row < tq ? row : 0);
      const float lr = l[at];
      m_s[tid] = m[at];
      linv_s[tid] = lr == 0.f ? 1.f : 1.f / lr;
      di_s[tid] = di[at];
    }
    __syncthreads();

    float st[4][4], dpt[4][4];  // [key r][query c]
    gemm_nt<HD>(Ks, Qs, ty, tx, st);
    gemm_nt<HD>(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = k0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jc = tx + 16 * c;
        const int row = q0 + jc;
        const bool ok =
            key_ok[r] && row < tq && (!causal || key <= row + offset);
        const float p =
            ok ? expf(st[r][c] * scale - m_s[jc]) * linv_s[jc] : 0.f;
        Pt[(ty + 16 * r) * kLdp + jc] = p;
        dSt[(ty + 16 * r) * kLdp + jc] = p * (dpt[r][c] - di_s[jc]);
      }
    }
    __syncthreads();
    gemm_nn<HD>(Pt, dOs, ty, tx, dv_acc);
    gemm_nn<HD>(dSt, Qs, ty, tx, dk_acc);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, HD>(dv + (size_t)bn * tk * HD, dv_acc, one, k0, tk, ty, tx);
  store_rows<T, HD>(dk + (size_t)bn * tk * HD, dk_acc, mul, k0, tk, ty, tx);
}


// ---------------------------------------------------------------------------
// head size 256 and above: HO of the hd output columns a block (the last
// slice may hold 64), the score products streamed over the head in
// 64-column chunks (see the note at the top)
// ---------------------------------------------------------------------------

// K3a
template <typename T, int HO>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ kv_mask,
                          T* __restrict__ o, float* __restrict__ l_out,
                          float* __restrict__ m_out, int tq, int tk, int hd,
                          int n_heads, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLdo = HO + kPad;
  float* Qc = smem;                  // a 64-column chunk of the query tile
  float* Kc = Qc + kTile * kLdp;     // the same chunk of the key tile
  float* Vs = Kc + kTile * kLdp;     // the block's HO columns of v
  float* Ps = Vs + kTile * kLdo;
  float* valid = Ps + kTile * kLdp;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bn = blockIdx.x, q0 = blockIdx.y * kTile, c0 = blockIdx.z * HO;
  const int ho = min(HO, hd - c0);  // the slice's columns
  const T* qb = q + (size_t)bn * tq * hd;
  const T* kb = k + (size_t)bn * tk * hd;
  const T* vb = v + (size_t)bn * tk * hd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  float m_run[4], l_run[4], acc[4][HO / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kMaskValue;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < HO / 16; ++c) acc[r][c] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + kTile + offset) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last step's readers of Vs, Ps are done
    load_tile<T, HO>(Vs, vb + c0, k0, tk, tid, hd, ho);
    load_key_validity(valid, mask_row, k0, tk, tid);
    float s[4][4] = {};
    for (int c = 0; c < hd; c += kTile) {
      if (c) __syncthreads();  // the last chunk's readers are done
      load_tile<T, kTile>(Qc, qb + c, q0, tq, tid, hd);
      load_tile<T, kTile>(Kc, kb + c, k0, tk, tid, hd);
      __syncthreads();
      gemm_nt_add(Qc, Kc, ty, tx, s);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
      bool ok[4];
      float mx = kMaskValue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jc = tx + 16 * c;
        ok[c] = valid[jc] > 0.f && (!causal || k0 + jc <= row + offset);
        s[r][c] = ok[c] ? s[r][c] * scale : kMaskValue;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = row_max(mx);
      const float m_next = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_next) : 0.f;
        sum += p;
        Ps[(ty + 16 * r) * kLdp + tx + 16 * c] = p;
      }
      sum = row_sum(sum);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_next;
#pragma unroll
      for (int c = 0; c < HO / 16; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    gemm_nn<HO>(Ps, Vs, ty, tx, acc);
  }

  float inv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    inv[r] = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
    const int row = q0 + ty + 16 * r;
    if (blockIdx.z == 0 && tx == 0 && row < tq) {
      l_out[(size_t)bn * tq + row] = l_run[r];
      m_out[(size_t)bn * tq + row] = m_run[r];
    }
  }
  store_rows<T, HO>(o + (size_t)bn * tq * hd + c0, acc, inv, q0, tq, ty, tx,
                    hd, ho);
}

// K3c
template <typename T, int HO>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ l,
                             const float* __restrict__ m,
                             const float* __restrict__ di,
                             const float* __restrict__ kv_mask,
                             T* __restrict__ dq, int tq, int tk, int hd,
                             int n_heads, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLdo = HO + kPad;
  float* Qc = smem;                  // 64-column chunks of q, do, k, v
  float* dOc = Qc + kTile * kLdp;
  float* Kc = dOc + kTile * kLdp;
  float* Vc = Kc + kTile * kLdp;
  float* Ks = Vc + kTile * kLdp;     // the block's HO columns of k
  float* dSs = Ks + kTile * kLdo;
  float* valid = dSs + kTile * kLdp;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bn = blockIdx.x, q0 = blockIdx.y * kTile, c0 = blockIdx.z * HO;
  const int ho = min(HO, hd - c0);  // the slice's columns
  const T* qb = q + (size_t)bn * tq * hd;
  const T* dob = dout + (size_t)bn * tq * hd;
  const T* kb = k + (size_t)bn * tk * hd;
  const T* vb = v + (size_t)bn * tk * hd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  float m_row[4], linv_row[4], di_row[4], acc[4][HO / 16];
  bool row_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    row_ok[r] = row < tq;
    const size_t at = (size_t)bn * tq + (row_ok[r] ? row : 0);
    const float lr = l[at];
    m_row[r] = m[at];
    linv_row[r] = lr == 0.f ? 1.f : 1.f / lr;
    di_row[r] = di[at];
#pragma unroll
    for (int c = 0; c < HO / 16; ++c) acc[r][c] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + kTile + offset) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, HO>(Ks, kb + c0, k0, tk, tid, hd, ho);
    load_key_validity(valid, mask_row, k0, tk, tid);
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < hd; c += kTile) {
      if (c) __syncthreads();
      load_tile<T, kTile>(Qc, qb + c, q0, tq, tid, hd);
      load_tile<T, kTile>(dOc, dob + c, q0, tq, tid, hd);
      load_tile<T, kTile>(Kc, kb + c, k0, tk, tid, hd);
      load_tile<T, kTile>(Vc, vb + c, k0, tk, tid, hd);
      __syncthreads();
      gemm_nt_add(Qc, Kc, ty, tx, s);
      gemm_nt_add(dOc, Vc, ty, tx, dp);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jc = tx + 16 * c;
        const bool ok = row_ok[r] && valid[jc] > 0.f &&
                        (!causal || k0 + jc <= row + offset);
        const float p =
            ok ? expf(s[r][c] * scale - m_row[r]) * linv_row[r] : 0.f;
        dSs[(ty + 16 * r) * kLdp + jc] = p * (dp[r][c] - di_row[r]);
      }
    }
    __syncthreads();
    gemm_nn<HO>(dSs, Ks, ty, tx, acc);
  }

  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, HO>(dq + (size_t)bn * tq * hd + c0, acc, mul, q0, tq, ty,
                    tx, hd, ho);
}

// K3b
template <typename T, int HO>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_cols_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ l,
                              const float* __restrict__ m,
                              const float* __restrict__ di,
                              const float* __restrict__ kv_mask,
                              T* __restrict__ dk, T* __restrict__ dv, int tq,
                              int tk, int hd, int n_heads, float scale,
                              int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLdo = HO + kPad;
  float* Kc = smem;                  // 64-column chunks of k, v, q, do
  float* Vc = Kc + kTile * kLdp;
  float* Qc = Vc + kTile * kLdp;
  float* dOc = Qc + kTile * kLdp;
  float* Qs = dOc + kTile * kLdp;    // the block's HO columns of q and do
  float* dOs = Qs + kTile * kLdo;
  float* Pt = dOs + kTile * kLdo;    // [key][query]
  float* dSt = Pt + kTile * kLdp;    // [key][query]
  float* m_s = dSt + kTile * kLdp;   // per query of the tile
  float* linv_s = m_s + kTile;
  float* di_s = linv_s + kTile;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bn = blockIdx.x, k0 = blockIdx.y * kTile, c0 = blockIdx.z * HO;
  const int ho = min(HO, hd - c0);  // the slice's columns
  const T* qb = q + (size_t)bn * tq * hd;
  const T* dob = dout + (size_t)bn * tq * hd;
  const T* kb = k + (size_t)bn * tk * hd;
  const T* vb = v + (size_t)bn * tk * hd;
  const float* mask_row =
      kv_mask ? kv_mask + (size_t)(bn / n_heads) * tk : nullptr;
  const int offset = tk - tq;

  bool key_ok[4];
  float dk_acc[4][HO / 16], dv_acc[4][HO / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    key_ok[r] =
        key < tk && (mask_row == nullptr || mask_row[key] > 0.f);
#pragma unroll
    for (int c = 0; c < HO / 16; ++c) {
      dk_acc[r][c] = 0.f;
      dv_acc[r][c] = 0.f;
    }
  }

  int q_begin = 0;
  if (causal && k0 - offset > 0) q_begin = (k0 - offset) / kTile * kTile;
  for (int q0 = q_begin; q0 < tq; q0 += kTile) {
    __syncthreads();
    load_tile<T, HO>(Qs, qb + c0, q0, tq, tid, hd, ho);
    load_tile<T, HO>(dOs, dob + c0, q0, tq, tid, hd, ho);
    if (tid < kTile) {
      const int row = q0 + tid;
      const size_t at = (size_t)bn * tq + (row < tq ? row : 0);
      const float lr = l[at];
      m_s[tid] = m[at];
      linv_s[tid] = lr == 0.f ? 1.f : 1.f / lr;
      di_s[tid] = di[at];
    }
    float st[4][4] = {}, dpt[4][4] = {};  // [key r][query c]
    for (int c = 0; c < hd; c += kTile) {
      if (c) __syncthreads();
      load_tile<T, kTile>(Kc, kb + c, k0, tk, tid, hd);
      load_tile<T, kTile>(Vc, vb + c, k0, tk, tid, hd);
      load_tile<T, kTile>(Qc, qb + c, q0, tq, tid, hd);
      load_tile<T, kTile>(dOc, dob + c, q0, tq, tid, hd);
      __syncthreads();
      gemm_nt_add(Kc, Qc, ty, tx, st);
      gemm_nt_add(Vc, dOc, ty, tx, dpt);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = k0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jc = tx + 16 * c;
        const int row = q0 + jc;
        const bool ok =
            key_ok[r] && row < tq && (!causal || key <= row + offset);
        const float p =
            ok ? expf(st[r][c] * scale - m_s[jc]) * linv_s[jc] : 0.f;
        Pt[(ty + 16 * r) * kLdp + jc] = p;
        dSt[(ty + 16 * r) * kLdp + jc] = p * (dpt[r][c] - di_s[jc]);
      }
    }
    __syncthreads();
    gemm_nn<HO>(Pt, dOs, ty, tx, dv_acc);
    gemm_nn<HO>(dSt, Qs, ty, tx, dk_acc);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, HO>(dv + (size_t)bn * tk * hd + c0, dv_acc, one, k0, tk, ty,
                    tx, hd, ho);
  store_rows<T, HO>(dk + (size_t)bn * tk * hd + c0, dk_acc, mul, k0, tk, ty,
                    tx, hd, ho);
}

constexpr size_t fwd_smem(int hd) {
  return sizeof(float) * (3 * kTile * (hd + kPad) + kTile * kLdp + kTile);
}
constexpr size_t dq_smem(int hd) {
  return sizeof(float) * (4 * kTile * (hd + kPad) + kTile * kLdp + kTile);
}
constexpr size_t dkv_smem(int hd) {
  return sizeof(float) *
         (4 * kTile * (hd + kPad) + 2 * kTile * kLdp + 3 * kTile);
}

// the _cols kernels' shared memory at HO output columns a block
constexpr size_t fwd_cols_smem(int ho) {
  return sizeof(float) * (3 * kTile * kLdp + kTile * (ho + kPad) + kTile);
}
constexpr size_t dq_cols_smem(int ho) {
  return sizeof(float) *
         (5 * kTile * kLdp + kTile * (ho + kPad) + kTile);
}
constexpr size_t dkv_cols_smem(int ho) {
  return sizeof(float) *
         (6 * kTile * kLdp + 2 * kTile * (ho + kPad) + 3 * kTile);
}

constexpr int kColsHO = 128;  // output columns a _cols block

constexpr int kFwd = 0, kDkv = 1, kDq = 2;  // flash_launch_shape's kernels

// the float32 launch of `kernel` at head size hd: the whole-head kernels
// (64 and 128) or, from 256 on, the _cols kernels, kColsHO columns a
// block (the last slice may hold 64); a block owns kTile rows
LaunchShape f32_shape(int kernel, int hd) {
  const bool cols = hd >= 256;
  const size_t smem[3][2] = {{fwd_smem(hd), fwd_cols_smem(kColsHO)},
                             {dkv_smem(hd), dkv_cols_smem(kColsHO)},
                             {dq_smem(hd), dq_cols_smem(kColsHO)}};
  return {kThreads, smem[kernel][cols], kTile,
          cols ? (hd + kColsHO - 1) / kColsHO : 1};
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kv_mask, void* o, void* l, void* m, int bn,
                       int tq, int tk, int n_heads, float scale, int causal,
                       cudaStream_t stream) {
  return launch_in<flash_fwd_kernel<T, HD>>(
      f32_shape(kFwd, HD), bn, tq, stream, (const T*)q, (const T*)k,
      (const T*)v, (const float*)kv_mask, (T*)o, (float*)l, (float*)m, tq,
      tk, n_heads, scale, causal);
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* l, const void* m,
                      const void* di, const void* kv_mask, void* dq, int bn,
                      int tq, int tk, int n_heads, float scale, int causal,
                      cudaStream_t stream) {
  return launch_in<flash_bwd_dq_kernel<T, HD>>(
      f32_shape(kDq, HD), bn, tq, stream, (const T*)q, (const T*)k,
      (const T*)v, (const T*)dout, (const float*)l, (const float*)m,
      (const float*)di, (const float*)kv_mask, (T*)dq, tq, tk, n_heads,
      scale, causal);
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* l, const void* m,
                       const void* di, const void* kv_mask, void* dk,
                       void* dv, int bn, int tq, int tk, int n_heads,
                       float scale, int causal, cudaStream_t stream) {
  return launch_in<flash_bwd_dkv_kernel<T, HD>>(
      f32_shape(kDkv, HD), bn, tk, stream, (const T*)q, (const T*)k,
      (const T*)v, (const T*)dout, (const float*)l, (const float*)m,
      (const float*)di, (const float*)kv_mask, (T*)dk, (T*)dv, tq, tk,
      n_heads, scale, causal);
}

template <typename T>
cudaError_t launch_fwd_cols(int hd, const void* q, const void* k,
                            const void* v, const void* kv_mask, void* o,
                            void* l, void* m, int bn, int tq, int tk,
                            int n_heads, float scale, int causal,
                            cudaStream_t stream) {
  return launch_in<flash_fwd_cols_kernel<T, kColsHO>>(
      f32_shape(kFwd, hd), bn, tq, stream, (const T*)q, (const T*)k,
      (const T*)v, (const float*)kv_mask, (T*)o, (float*)l, (float*)m, tq,
      tk, hd, n_heads, scale, causal);
}

template <typename T>
cudaError_t launch_dq_cols(int hd, const void* q, const void* k,
                           const void* v, const void* dout, const void* l,
                           const void* m, const void* di, const void* kv_mask,
                           void* dq, int bn, int tq, int tk, int n_heads,
                           float scale, int causal, cudaStream_t stream) {
  return launch_in<flash_bwd_dq_cols_kernel<T, kColsHO>>(
      f32_shape(kDq, hd), bn, tq, stream, (const T*)q, (const T*)k,
      (const T*)v, (const T*)dout, (const float*)l, (const float*)m,
      (const float*)di, (const float*)kv_mask, (T*)dq, tq, tk, hd, n_heads,
      scale, causal);
}

template <typename T>
cudaError_t launch_dkv_cols(int hd, const void* q, const void* k,
                            const void* v, const void* dout, const void* l,
                            const void* m, const void* di,
                            const void* kv_mask, void* dk, void* dv, int bn,
                            int tq, int tk, int n_heads, float scale,
                            int causal, cudaStream_t stream) {
  return launch_in<flash_bwd_dkv_cols_kernel<T, kColsHO>>(
      f32_shape(kDkv, hd), bn, tk, stream, (const T*)q, (const T*)k,
      (const T*)v, (const T*)dout, (const float*)l, (const float*)m,
      (const float*)di, (const float*)kv_mask, (T*)dk, (T*)dv, tq, tk, hd,
      n_heads, scale, causal);
}

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

}  // namespace

// the bfloat16 (f16 = 0) and float16 (f16 = 1) kernels on the tensor
// cores, at `panels` = head size / 64: 1, 2 or 4, or above 4 the cluster
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu); also at 0, head
// size 32, on the narrow kernels
cudaError_t flash_fwd_tc(int f16, int panels, const void* q, const void* k,
                         const void* v, const void* kv_mask, void* o, void* l,
                         void* m, int bn, int tq, int tk, int n_heads,
                         float scale, int causal, cudaStream_t stream);
cudaError_t flash_bwd_dkv_tc(int f16, int panels, const void* q,
                             const void* k, const void* v, const void* dout,
                             const void* l, const void* m, const void* di,
                             const void* kv_mask, void* dk, void* dv, int bn,
                             int tq, int tk, int n_heads, float scale,
                             int causal, cudaStream_t stream);
cudaError_t flash_bwd_dq_tc(int f16, int panels, const void* q,
                            const void* k, const void* v, const void* dout,
                            const void* l, const void* m, const void* di,
                            const void* kv_mask, void* dq, int bn, int tq,
                            int tk, int n_heads, float scale, int causal,
                            cudaStream_t stream);
int flash_fwd_tc_kernel_of(int panels, int tq, int tk);
LaunchShape flash_fwd_tc_shape(int panels, int tq, int tk);
int flash_fwd_tc_resident(int f16, int panels, int tq, int tk);
int flash_fwd_tc_max_clusters(int f16, int panels);
int flash_bwd_dkv_kernel_of(int panels, int tq, int tk);
int flash_bwd_dq_kernel_of(int panels);
LaunchShape flash_bwd_tc_shape(int dkv, int panels, int tq, int tk);
int flash_bwd_dkv_resident(int f16, int panels, int tq, int tk);
int flash_bwd_dq_resident(int f16, int panels);
int flash_bwd_dkv_max_clusters(int f16, int panels);
int flash_bwd_dq_max_clusters(int f16, int panels);

// the head size of the narrow kernels (bfloat16 and float16)
constexpr int kNarrowHead = 32;

// the head sizes each kernel (K3a, K3b, K3c) takes in type dtype: 64, 128,
// and every multiple of 64 from 256 on; also 32 in bfloat16 and float16
inline bool head_size_taken(int h, int dtype) {
  return h == 64 || h == 128 || (h >= 256 && h % 64 == 0) ||
         (h == kNarrowHead && (dtype == kBFloat16 || dtype == kFloat16));
}

// dtype: 0 float32, 1 bfloat16, 2 float16; h: a size head_size_taken
// accepts. Anything else is refused with cudaErrorInvalidValue. Empty
// problems launch nothing. float32 takes this file's kernels (LAUNCH at 64
// and 128, COLS from 256 on), bfloat16 and float16 the tensor-core ones
// (TC, at h / 64 panels: 0 for the narrow kernels).
#define FLASH_DISPATCH(LAUNCH, COLS, TC, ...)                                \
  if (dtype < kFloat32 || dtype > kFloat16 || !head_size_taken(h, dtype))    \
    return (int)cudaErrorInvalidValue;                                       \
  if (dtype == kFloat32 && h == 64)                                          \
    return (int)LAUNCH<float, 64>(__VA_ARGS__);                              \
  if (dtype == kFloat32 && h == 128)                                         \
    return (int)LAUNCH<float, 128>(__VA_ARGS__);                             \
  if (dtype == kFloat32)                                                     \
    return (int)COLS<float>(h, __VA_ARGS__);                                 \
  return (int)TC(dtype == kFloat16, h / 64, __VA_ARGS__);

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, void* o, void* l, void* m,
                         int bn, int tq, int tk, int h, int n_heads,
                         float scale, int causal, int dtype, void* stream) {
  if (bn == 0 || tq == 0) return (int)cudaSuccess;
  FLASH_DISPATCH(launch_fwd, launch_fwd_cols, flash_fwd_tc, q, k, v,
                 kv_mask, o, l, m, bn, tq, tk, n_heads, scale, causal,
                 (cudaStream_t)stream)
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* l, const void* m,
                             const void* di, const void* kv_mask, void* dk,
                             void* dv, int bn, int tq, int tk, int h,
                             int n_heads, float scale, int causal, int dtype,
                             void* stream) {
  if (bn == 0 || tk == 0) return (int)cudaSuccess;
  FLASH_DISPATCH(launch_dkv, launch_dkv_cols, flash_bwd_dkv_tc, q, k,
                 v, dout, l, m, di, kv_mask, dk, dv, bn, tq, tk, n_heads,
                 scale, causal, (cudaStream_t)stream)
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* l, const void* m,
                            const void* di, const void* kv_mask, void* dq,
                            int bn, int tq, int tk, int h, int n_heads,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (bn == 0 || tq == 0) return (int)cudaSuccess;
  FLASH_DISPATCH(launch_dq, launch_dq_cols, flash_bwd_dq_tc, q, k, v,
                 dout, l, m, di, kv_mask, dq, bn, tq, tk, n_heads, scale,
                 causal, (cudaStream_t)stream)
}

// The launch shape a call of kernel `kernel` (0 K3a, 1 K3b, 2 K3c) at head
// size h, type dtype and lengths tq, tk takes, from the functions its
// launcher calls: threads a block, dynamic shared memory a block, the slices
// of the head (blocks along z), the blocks a cluster (1: none), how many
// such clusters the card holds at once (0 without clusters), which kernel
// of the family runs (KERNEL_NAMES in ops/flash_attention.py) and how many
// of its blocks the card holds at once. Asks the current device. Returns
// cudaErrorInvalidValue for what the dispatch refuses.
extern "C" int flash_launch_shape(int kernel, int h, int dtype, int tq,
                                  int tk, int* shape) {
  if (kernel < kFwd || kernel > kDq || dtype < kFloat32 ||
      dtype > kFloat16 || !head_size_taken(h, dtype) || tq < 0 ||
      tk < 0)
    return (int)cudaErrorInvalidValue;
  const int f16 = dtype == kFloat16, panels = h / 64;
  const LaunchShape s = dtype == kFloat32 ? f32_shape(kernel, h)
                        : kernel == kFwd ? flash_fwd_tc_shape(panels, tq, tk)
                                         : flash_bwd_tc_shape(kernel == kDkv,
                                                              panels, tq, tk);
  shape[0] = s.threads;
  shape[1] = (int)s.smem;
  shape[2] = s.slices;
  shape[3] = s.cluster;
  shape[4] = s.cluster == 1   ? 0
             : kernel == kFwd ? flash_fwd_tc_max_clusters(f16, panels)
             : kernel == kDkv ? flash_bwd_dkv_max_clusters(f16, panels)
                              : flash_bwd_dq_max_clusters(f16, panels);
  // the family's kernels: float32 the FMA kernel (0) or its _cols form
  // (1); the 16-bit ones from 2 on, K3a's whole-tile, short, narrow and
  // cluster kernels, K3b's whole-tile, short, cluster, narrow and producer
  // kernels, K3c's whole-tile, cluster and narrow kernels
  shape[5] = dtype == kFloat32 ? (h >= 256 ? 1 : 0)
             : kernel == kFwd   ? 2 + flash_fwd_tc_kernel_of(panels, tq, tk)
             : kernel == kDkv   ? 2 + flash_bwd_dkv_kernel_of(panels, tq, tk)
                                : 2 + flash_bwd_dq_kernel_of(panels);
  if (kernel == kFwd)
    shape[6] =
        dtype != kFloat32 ? flash_fwd_tc_resident(f16, panels, tq, tk)
        : h == 64         ? resident_blocks<flash_fwd_kernel<float, 64>>(s)
        : h == 128        ? resident_blocks<flash_fwd_kernel<float, 128>>(s)
                   : resident_blocks<flash_fwd_cols_kernel<float, kColsHO>>(s);
  else if (kernel == kDkv)
    shape[6] =
        dtype != kFloat32 ? flash_bwd_dkv_resident(f16, panels, tq, tk)
        : h == 64         ? resident_blocks<flash_bwd_dkv_kernel<float, 64>>(s)
        : h == 128 ? resident_blocks<flash_bwd_dkv_kernel<float, 128>>(s)
                   : resident_blocks<
                         flash_bwd_dkv_cols_kernel<float, kColsHO>>(s);
  else
    shape[6] =
        dtype != kFloat32 ? flash_bwd_dq_resident(f16, panels)
        : h == 64         ? resident_blocks<flash_bwd_dq_kernel<float, 64>>(s)
        : h == 128 ? resident_blocks<flash_bwd_dq_kernel<float, 128>>(s)
                   : resident_blocks<
                         flash_bwd_dq_cols_kernel<float, kColsHO>>(s);
  return shape[6] < 0 ? (int)cudaErrorInvalidConfiguration
                      : (int)cudaSuccess;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
