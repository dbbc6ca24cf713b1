// Hand-written Hopper kernels for blockwise (flash) attention, forward and
// backward, with a plain C interface loaded through ctypes
// (chambers_tpu_torch/ops/flash_attention.py holds the wrapper, the
// autograd function and the plain PyTorch versions they are checked
// against). The flash_attention library has three sources, and each C
// function below chooses its kernel by the operands' type:
//   bfloat16  the tensor-core kernels: flash_attention_fwd.cu (K3a) and
//             flash_attention_bwd.cu (K3b, K3c), both on flash_tiles.cuh
//   float32   the FMA kernels of this file, for all three
//
// Replaces the Pallas TPU kernels of chambers_tpu/ops/flash_attention.py:
//   flash_fwd_kernel      <- _flash_forward / _flash_fwd_kernel        (K3a)
//   flash_bwd_dkv_kernel  <- _flash_backward / _flash_bwd_dkv_kernel   (K3b)
//   flash_bwd_dq_kernel   <- _flash_backward / _flash_bwd_dq_kernel    (K3c)
// (the bf16 kernels carry the same names with _tc).
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
// which TF32's three digits cannot meet. bfloat16 operands, where the gap
// to a library call was widest, take the tensor-core kernels.
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
// Takes head size 64 (the kernels are templates over the type and the head
// size; only float32 and 64 are instantiated, being what a path runs and
// the card checks), contiguous operands whose base addresses are multiples
// of 16 bytes. Built WITHOUT --fmad=false: the inner products of these
// kernels are FMAs, and those of the bf16 kernels run on the tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using flash_tiles::allow_smem;
using flash_tiles::kMaskValue;

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

// rows [row0, row0 + 64) of a [rows, HD] array into dst[64][HD + kPad] as
// float32; rows past the end are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int tid) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kPerRow = HD / kVec;
  constexpr int kLd = HD + kPad;
  for (int i = tid; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* d = dst + r * kLd + c;
    if (row0 + r < rows) {
      Elem<T>::load(src + (size_t)(row0 + r) * HD + c, d);
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

// rows row0 + ty + 16 r of a [rows, HD] output, each times mul[r]
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float (&acc)[4][HD / 16],
                                           const float (&mul)[4], int row0,
                                           int rows, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 16 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int g = 0; g < HD / 64; ++g)
      Elem<T>::store4(dst + (size_t)row * HD + g * 64 + tx * 4,
                      acc[r][g * 4 + 0] * mul[r], acc[r][g * 4 + 1] * mul[r],
                      acc[r][g * 4 + 2] * mul[r], acc[r][g * 4 + 3] * mul[r]);
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

inline dim3 tiles(int bn, int t) { return dim3(bn, (t + kTile - 1) / kTile); }

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kv_mask, void* o, void* l, void* m, int bn,
                       int tq, int tk, int n_heads, float scale, int causal,
                       cudaStream_t stream) {
  const cudaError_t err = allow_smem<flash_fwd_kernel<T, HD>>(
      fwd_smem(HD));
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, HD><<<tiles(bn, tq), kThreads, fwd_smem(HD), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kv_mask, (T*)o,
      (float*)l, (float*)m, tq, tk, n_heads, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* l, const void* m,
                      const void* di, const void* kv_mask, void* dq, int bn,
                      int tq, int tk, int n_heads, float scale, int causal,
                      cudaStream_t stream) {
  const cudaError_t err = allow_smem<flash_bwd_dq_kernel<T, HD>>(
      dq_smem(HD));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD>
      <<<tiles(bn, tq), kThreads, dq_smem(HD), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)l,
      (const float*)m, (const float*)di, (const float*)kv_mask, (T*)dq, tq,
      tk, n_heads, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* l, const void* m,
                       const void* di, const void* kv_mask, void* dk,
                       void* dv, int bn, int tq, int tk, int n_heads,
                       float scale, int causal, cudaStream_t stream) {
  const cudaError_t err = allow_smem<flash_bwd_dkv_kernel<T, HD>>(
      dkv_smem(HD));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, HD>
      <<<tiles(bn, tk), kThreads, dkv_smem(HD), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)l,
      (const float*)m, (const float*)di, (const float*)kv_mask, (T*)dk,
      (T*)dv, tq, tk, n_heads, scale, causal);
  return cudaGetLastError();
}

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

}  // namespace

// the bfloat16 kernels on the tensor cores, head size 64
// (flash_attention_fwd.cu, flash_attention_bwd.cu)
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           const void* kv_mask, void* o, void* l, void* m,
                           int bn, int tq, int tk, int n_heads, float scale,
                           int causal, cudaStream_t stream);
cudaError_t flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const void* l, const void* m,
                               const void* di, const void* kv_mask, void* dk,
                               void* dv, int bn, int tq, int tk, int n_heads,
                               float scale, int causal, cudaStream_t stream);
cudaError_t flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* l, const void* m,
                              const void* di, const void* kv_mask, void* dq,
                              int bn, int tq, int tk, int n_heads, float scale,
                              int causal, cudaStream_t stream);

// dtype: 0 float32, 1 bfloat16; h: 64. Anything else is refused
// with cudaErrorInvalidValue. Empty problems launch nothing. float32 takes
// this file's kernels (LAUNCH), bfloat16 the tensor-core ones (BF16).
#define FLASH_DISPATCH(LAUNCH, BF16, ...)                                    \
  if (dtype == kFloat32 && h == 64)                                          \
    return (int)LAUNCH<float, 64>(__VA_ARGS__);                              \
  if (dtype == kBFloat16 && h == 64) return (int)BF16(__VA_ARGS__);          \
  return (int)cudaErrorInvalidValue;

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, void* o, void* l, void* m,
                         int bn, int tq, int tk, int h, int n_heads,
                         float scale, int causal, int dtype, void* stream) {
  if (bn == 0 || tq == 0) return (int)cudaSuccess;
  FLASH_DISPATCH(launch_fwd, flash_fwd_bf16, q, k, v, kv_mask, o, l, m, bn,
                 tq, tk, n_heads, scale, causal, (cudaStream_t)stream)
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* l, const void* m,
                             const void* di, const void* kv_mask, void* dk,
                             void* dv, int bn, int tq, int tk, int h,
                             int n_heads, float scale, int causal, int dtype,
                             void* stream) {
  if (bn == 0 || tk == 0) return (int)cudaSuccess;
  FLASH_DISPATCH(launch_dkv, flash_bwd_dkv_bf16, q, k, v, dout, l, m, di,
                 kv_mask, dk, dv, bn, tq, tk, n_heads, scale, causal,
                 (cudaStream_t)stream)
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* l, const void* m,
                            const void* di, const void* kv_mask, void* dq,
                            int bn, int tq, int tk, int h, int n_heads,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (bn == 0 || tq == 0) return (int)cudaSuccess;
  FLASH_DISPATCH(launch_dq, flash_bwd_dq_bf16, q, k, v, dout, l, m, di,
                 kv_mask, dq, bn, tq, tk, n_heads, scale, causal,
                 (cudaStream_t)stream)
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
