// Hand-written Hopper kernels for the RandAugment round and the separable
// warp, with a plain C interface loaded through ctypes
// (chambers_tpu_torch/ops/warp_kernels.py holds the wrappers and the plain
// PyTorch versions they are checked against).
//
// Replaces the Pallas TPU kernels of chambers_tpu/ops/warp_pallas.py:
//   fused_round_kernel  <- fused_round_pallas / _fused_round_kernel  (K1)
//   warp_kernel         <- transform_affine_separable_pallas /
//                          _warp_kernel / _warp_body                 (K2)
// Both warp through one device function, warp_runs, as the two Pallas
// kernels share _warp_body.
//
// Bound: bytes. At the main path's shape (uint8 [32, 224, 224, 3]) a
// launch reads 4.82 MB and writes 4.82 MB: about 2.9 us at an H100 SXM's
// 3.35 TB/s; a device copy_ of the same bytes takes about 5 us. The work is
// a few dozen integer and float operations a pixel, so what keeps a kernel
// off that bound is its instruction stream and the latency of each
// thread's chain of loads (transform, source pixels) before its stores.
//
// Design:
// - The TPU kernels replay the three shear passes as ~26 conditional rolls
//   over a VMEM-resident image, because gathers are slow there. Here the
//   passes compose into one source index per output pixel:
//     x3 = x + pad + n3[y]   (fill unless 0 <= x3 < wp)
//     y2 = y + n2[x3]        (fill unless 0 <= y2 < h)
//     x1 = x3 + n1[y2]       (fill unless pad <= x1 < pad + w)
//     out = img[y2, x1 - pad]
//   Each thread computes the shifts it needs from its image's row of the
//   [b, 8] transforms: decompose_affine_shears and _shift_vectors of the
//   plain version, every step rounded explicitly (__fdiv_rn, __fmul_rn,
//   __fadd_rn, __fsub_rn), so they equal the plain version's to the bit,
//   and a wrapper call is one launch. A shift whose coefficient is zero in
//   an image (translations, shears) is a constant for it.
// - Blocks of R rows (about kRowPixels pixels), no cluster: the batch is
//   thousands of small blocks resident at once, so the slow class of one
//   image spreads over many SMs. Rows are read from device memory through
//   the read-only path; a warp's gathers and a Sharpness halo hit L1 and
//   the 50 MB L2, which holds the batch.
// - Where w is a multiple of 16 and both batches are 16-byte aligned, every
//   class writes 16 pixels (16 c bytes) of a row a thread with c 16-byte
//   stores. Color, CutOut, passthrough and Sharpness read those pixels
//   (and Sharpness the rows above and below) as 16-byte loads. The warp
//   gathers 512 pixels a warp, lane l taking pixels l, l + 32, ..., so a
//   load instruction reads neighbouring words; each pixel goes to a word
//   of the warp's buffer in shared memory, and lane l packs 16 of them
//   with byte permutes before its stores. Other shapes take one pixel a
//   thread with byte accesses through the same arithmetic. K1 takes c = 3
//   only; K2 has instances for c = 1, 3, 4 and one for any c.
// - Measured slower at the main path's shape and dropped (PERF.md §6):
//   one image per thread-block cluster with its rows in distributed shared
//   memory (gathers of single bytes across the cluster), rows copied into
//   each block's shared memory first (cp.async.bulk), shift tables filled
//   in shared memory by every block, one pixel a thread, 2D patches of
//   pixels a gather step, a 16-byte path for translations (a larger
//   kernel), and 4, 8, 10, 11 or 13 rows a block.
//
// Exactness: COLOR and SHARPNESS repeat the JAX arithmetic order with
// explicitly rounded intrinsics (__fmul_rn / __fadd_rn / __fsub_rn), so no
// multiply is contracted into an add; the library is also built with
// --fmad=false. An FMA flips pixels at magnitude 9: float32(1.72) * (-75)
// is exactly -129.0 only as a separate multiply.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include <algorithm>

namespace {

// op-class ids (warp_pallas.py: PASSTHROUGH, WARP, COLOR, SHARPNESS, CUTOUT)
constexpr int kPassthrough = 0;
constexpr int kWarp = 1;
constexpr int kColor = 2;
constexpr int kSharpness = 3;
constexpr int kCutout = 4;

constexpr int kMaxThreads = 512;
constexpr int kGroup = 16;  // pixels a thread writes on the 16-byte path
constexpr int kSpan = 32 * kGroup;  // pixels a warp gathers at a time
constexpr int kSpanWords = kSpan + kSpan / 4;  // its buffer, padded
constexpr int kTooLarge = -1;  // launcher code: beyond 32-bit offsets
constexpr int kRowPixels = 2016;  // pixels a block writes, in whole rows

// ITU-R 601 weights as the float32 values numpy rounds 0.299, 0.587 and
// 0.114 to, and float32(1) / float32(255).
constexpr float kGrayR = 0x1.322d0ep-2f;
constexpr float kGrayG = 0x1.2c8b44p-1f;
constexpr float kGrayB = 0x1.d2f1aap-4f;
constexpr float kInv255 = 0x1.010102p-8f;

inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// A gather buffer holds pixel p of its span as one word at span_slot(p):
// four padding words after every 16, so that lane l reading the words of
// pixels 16 l .. 16 l + 15 as four 16-byte loads hits every bank once a
// quarter warp.
__device__ __forceinline__ int span_slot(int p) { return p + (p >> 4) * 4; }

// ---- bytes in 32-bit words (constant k after unrolling: register moves)

__device__ __forceinline__ uint32_t get8(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

// ORs v into a zeroed byte lane
__device__ __forceinline__ void put8(uint32_t* w, int k, uint32_t v) {
  w[k >> 2] |= v << (8 * (k & 3));
}

__device__ __forceinline__ uint32_t ld8(const uint8_t* p) { return __ldg(p); }

// N 16-byte words from device memory through the read-only path
template <int N>
__device__ __forceinline__ void load16(const uint8_t* p, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store16(uint8_t* p, const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    reinterpret_cast<uint4*>(p)[i] =
        make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

// ---- the rows a block writes

struct Band {
  const uint8_t* src;   // the image in device memory
  uint8_t* dst;         // its output
  int h, w, row_bytes, r0, r1;
};

// Block blockIdx.x writes rows [r0, r1) of image blockIdx.x / S, R rows a
// block, S = ceil(h / R).
__device__ __forceinline__ Band open_band(const uint8_t* images,
                                          uint8_t* out, int h, int w, int c,
                                          int R) {
  const int S = (h + R - 1) / R;
  const int image = blockIdx.x / S;
  Band b;
  b.row_bytes = w * c;
  const size_t plane = (size_t)h * b.row_bytes;
  b.src = images + image * plane;
  b.dst = out + image * plane;
  b.h = h;
  b.w = w;
  b.r0 = (blockIdx.x - image * S) * R;
  b.r1 = min(h, b.r0 + R);
  return b;
}

__device__ __forceinline__ const uint8_t* row_at(const Band& b, int y) {
  return b.src + (size_t)y * b.row_bytes;
}

// ---- the three shear passes

// The shear coefficients of image_ops.decompose_affine_shears for one
// image's transform t (a0 a1 a2 b0 b1 b2 ..), each step rounded as torch
// rounds it.
struct Shifts {
  float A1, B1, A2, B2, A3, B3;
  int pad, wp;
};

__device__ __forceinline__ Shifts shears_of(const float* t, int pad, int w) {
  const float a0 = t[0], a1 = t[1], a2 = t[2];
  const float b0 = t[3], b1 = t[4], b2 = t[5];
  const bool nz = fabsf(b0) > 1e-8f;  // no float32 lies between 1e-8f and 1e-8
  Shifts s;
  s.A2 = b0;
  s.A1 = nz ? __fdiv_rn(__fsub_rn(a0, 1.0f), b0) : 0.0f;
  s.A3 = nz ? __fdiv_rn(__fsub_rn(b1, 1.0f), b0) : a1;
  s.B3 = nz ? 0.0f : a2;
  s.B2 = __fsub_rn(b2, __fmul_rn(s.A2, s.B3));
  s.B1 = __fsub_rn(__fsub_rn(a2, __fmul_rn(a0, s.B3)), __fmul_rn(s.A1, s.B2));
  s.pad = pad;
  s.wp = w + 2 * pad;
  return s;
}

// one entry of warp_kernels._shift_vectors: floor(A coord + B + 0.5)
__device__ __forceinline__ int shift_at(float A, float B, int coord) {
  return (int)floorf(
      __fadd_rn(__fadd_rn(__fmul_rn(A, __int2float_rn(coord)), B), 0.5f));
}

// The byte offset in its image of output pixel (y, x)'s source pixel, or
// -1 for the fill; n3y = shift_at(A3, B3, y). Without branches: the 16
// pixels of a lane compute side by side. kVary1 / kVary2: whether n1 / n2
// vary (A1, A2 nonzero); where one does not, it is the constant n1c / n2c
// (0 * coord is a signed zero, and B plus a signed zero is B).
template <bool kVary1 = true, bool kVary2 = true>
__device__ __forceinline__ int warp_offset(const Band& b, const Shifts& s,
                                           int n1c, int n2c, int n3y, int y,
                                           int x, int c) {
  const int x3 = x + s.pad + n3y;
  const int y2 = y + (kVary2 ? shift_at(s.A2, s.B2, x3 - s.pad) : n2c);
  const int x1 = x3 + (kVary1 ? shift_at(s.A1, s.B1, y2) : n1c) - s.pad;
  const bool ok = (unsigned)x3 < (unsigned)s.wp &&
                  (unsigned)y2 < (unsigned)b.h && (unsigned)x1 < (unsigned)b.w;
  return ok ? y2 * b.row_bytes + x1 * c : -1;
}

// One source pixel's kC bytes in the low bytes of a word, without
// branches. For kC = 3 it is two aligned words (the same one twice where
// the pixel does not cross into the next): the image starts 16-byte
// aligned on this path, and the words never reach past its last byte.
template <int kC>
__device__ __forceinline__ uint32_t gather(const uint8_t* img, int off,
                                           uint32_t fill) {
  const int o = max(off, 0);
  uint32_t v;
  if constexpr (kC == 1) {
    v = __ldg(img + o);
  } else if constexpr (kC == 4) {
    v = __ldg(reinterpret_cast<const uint32_t*>(img + o));
  } else {
    const uint32_t* at = reinterpret_cast<const uint32_t*>(img + (o & ~3));
    const int shift = o & 3;
    v = __funnelshift_r(__ldg(at), __ldg(at + (shift >> 1)), 8 * shift);
  }
  return off < 0 ? fill * 0x01010101u : v;
}

// 16 pixels, kC bytes each in the low bytes of px[j], packed into 4 kC
// words in order
template <int kC>
__device__ __forceinline__ void pack(const uint32_t* px, uint32_t* o) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t p0 = px[4 * q], p1 = px[4 * q + 1], p2 = px[4 * q + 2],
                   p3 = px[4 * q + 3];
    if constexpr (kC == 1) {
      o[q] = __byte_perm(__byte_perm(p0, p1, 0x0040),
                         __byte_perm(p2, p3, 0x0040), 0x5410);
    } else if constexpr (kC == 3) {
      o[3 * q] = __byte_perm(p0, p1, 0x4210);
      o[3 * q + 1] = __byte_perm(p1, p2, 0x5421);
      o[3 * q + 2] = __byte_perm(p2, p3, 0x6542);
    } else {
      o[4 * q] = p0;
      o[4 * q + 1] = p1;
      o[4 * q + 2] = p2;
      o[4 * q + 3] = p3;
    }
  }
}

// The warp on the 16-byte path. A warp gathers 512 consecutive pixels of
// the band, lane l taking pixels l, l + 32, ..., so that a load
// instruction reads neighbouring words: first the 16 source offsets, then
// all 16 gathers, one word a pixel into the warp's buffer in shared
// memory; then lane l packs pixels 16 l .. 16 l + 15 and writes them with
// kC 16-byte stores.
template <int kC, bool kVary1, bool kVary2>
__device__ __forceinline__ void warp_runs(const Band& b, const Shifts& s,
                                           uint32_t fill, uint32_t* buffers) {
  const int lane = threadIdx.x & 31;
  uint32_t* buf = buffers + (threadIdx.x >> 5) * kSpanWords;
  const int end = b.r1 * b.w;
  for (int base = b.r0 * b.w + (threadIdx.x >> 5) * kSpan; base < end;
       base += (blockDim.x >> 5) * kSpan) {
    int off[kGroup];
    int q = base + lane;
    int y = q / b.w;
    int x = q - y * b.w;
    int n3y = shift_at(s.A3, s.B3, y);
    const int n1c = shift_at(s.A1, s.B1, 0), n2c = shift_at(s.A2, s.B2, 0);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      off[j] = q < end ? warp_offset<kVary1, kVary2>(b, s, n1c, n2c, n3y, y,
                                                     x, kC)
                       : -1;
      q += 32;
      x += 32;
      if (x >= b.w) {
        while (x >= b.w) {
          x -= b.w;
          ++y;
        }
        n3y = shift_at(s.A3, s.B3, y);
      }
    }
    uint32_t px[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) px[j] = gather<kC>(b.src, off[j], fill);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) buf[span_slot(lane + 32 * j)] = px[j];
    __syncwarp();
    const int g = base + kGroup * lane;
    if (g < end) {
      const uint4* mine = reinterpret_cast<const uint4*>(buf + 20 * lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = mine[i];
        px[4 * i] = v.x;
        px[4 * i + 1] = v.y;
        px[4 * i + 2] = v.z;
        px[4 * i + 3] = v.w;
      }
      uint32_t o[4 * kC];
      pack<kC>(px, o);
      store16<kC>(b.dst + (size_t)g * kC, o);
    }
    __syncwarp();
  }
}

// warp_runs with the shifts that vary in this image (uniform in a block)
template <int kC>
__device__ __forceinline__ void warp_spans(const Band& b, const Shifts& s,
                                           uint32_t fill, uint32_t* buffers) {
  const bool v1 = s.A1 != 0.0f, v2 = s.A2 != 0.0f;
  if (v1 && v2)
    warp_runs<kC, true, true>(b, s, fill, buffers);
  else if (v1)
    warp_runs<kC, true, false>(b, s, fill, buffers);
  else if (v2)
    warp_runs<kC, false, true>(b, s, fill, buffers);
  else
    warp_runs<kC, false, false>(b, s, fill, buffers);
}

// ---- Color, Sharpness

// degenerate + f * (v - degenerate), each step rounded, clipped to
// [0, 255] and truncated (image_ops.blend's arithmetic).
__device__ __forceinline__ uint32_t blend_toward(float degenerate, float v,
                                                 float f) {
  float t = __fadd_rn(degenerate, __fmul_rn(f, __fsub_rn(v, degenerate)));
  t = fminf(fmaxf(t, 0.0f), 255.0f);
  return (uint32_t)(int)t;
}

// the grayscale degenerate of one RGB pixel (image_ops.to_grayscale)
__device__ __forceinline__ float gray_of(uint32_t r, uint32_t g,
                                         uint32_t b) {
  const float gray = __fadd_rn(
      __fadd_rn(__fmul_rn(kGrayR, __fmul_rn((float)r, kInv255)),
                __fmul_rn(kGrayG, __fmul_rn((float)g, kInv255))),
      __fmul_rn(kGrayB, __fmul_rn((float)b, kInv255)));
  return floorf(fminf(fmaxf(__fmul_rn(gray, 255.5f), 0.0f), 255.0f));
}

// the 3x3 smoothing of a 9-term sum s >= 0 (centre weighted 5): s / 13
// rounded half to even. 13 is odd, so no quotient is a half-way case and
// that is floor((2 s + 13) / 26); for 2 s + 13 <= 6643 (s <= 13 * 255)
// the product by ceil(2^18 / 26) = 10083 is off by at most 0.014 < 1 / 26.
__device__ __forceinline__ uint32_t smooth(uint32_t s) {
  return ((2 * s + 13) * 10083u) >> 18;
}

// Per-image parameters of K1.
struct Round {
  float fc, fs;
  long long cy, cx;
  int cut_half;
  uint32_t fill, cut_fill;
};

// ---- K1 on the 16-byte path: 16 pixels of row y from x0, c = 3

__device__ __forceinline__ void round_group(int opc, const Band& b,
                                            const Round& r, int y, int x0,
                                            uint32_t* out) {
  uint32_t m[12];
  const uint8_t* mid = row_at(b, y) + 3 * x0;
  load16<3>(mid, m);
  if (opc == kColor) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float d =
          gray_of(get8(m, 3 * j), get8(m, 3 * j + 1), get8(m, 3 * j + 2));
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        put8(out, 3 * j + ch,
             blend_toward(d, (float)get8(m, 3 * j + ch), r.fc));
    }
  } else if (opc == kSharpness) {
    if (y == 0 || y == b.h - 1) {
#pragma unroll
      for (int k = 0; k < 3 * kGroup; ++k) {
        const float v = (float)get8(m, k);
        put8(out, k, blend_toward(v, v, r.fs));
      }
      return;
    }
    const uint8_t* up = mid - b.row_bytes;
    const uint8_t* dn = mid + b.row_bytes;
    uint32_t u[12], d[12];
    load16<3>(up, u);
    load16<3>(dn, d);
    // column sums over the three rows of the 18 pixels from x0 - 1 to
    // x0 + 16, a channel at a time: col(k) for byte k of the group,
    // col(-3 .. -1) and col(48 .. 50) for the pixels beside it (zero past
    // the image's edge, where the edge pixels take no smoothing anyway)
    const bool left = x0 > 0, right = x0 + kGroup < b.w;
    uint32_t side[6];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      side[ch] = left ? ld8(up + ch - 3) + ld8(mid + ch - 3) +
                            ld8(dn + ch - 3)
                      : 0;
      side[3 + ch] = right ? ld8(up + 48 + ch) + ld8(mid + 48 + ch) +
                                 ld8(dn + 48 + ch)
                           : 0;
    }
#pragma unroll
    for (int k = 0; k < 3 * kGroup; ++k) {
      const int j = k / 3, ch = k % 3;
      const uint32_t v = get8(m, k);
      const uint32_t lc = j == 0 ? side[ch]
                                 : get8(u, k - 3) + get8(m, k - 3) +
                                       get8(d, k - 3);
      const uint32_t cc = get8(u, k) + v + get8(d, k);
      const uint32_t rc = j == kGroup - 1 ? side[3 + ch]
                                          : get8(u, k + 3) + get8(m, k + 3) +
                                                get8(d, k + 3);
      uint32_t degen = smooth(lc + cc + rc + 4 * v);
      // x == 0 only at j == 0 and x == w - 1 only at j == 15 (w and x0 are
      // multiples of 16): the edge pixels keep their value
      if (j == 0) degen = left ? degen : v;
      if (j == kGroup - 1) degen = right ? degen : v;
      put8(out, k, blend_toward((float)degen, (float)v, r.fs));
    }
  } else if (opc == kCutout && (long long)y >= r.cy - r.cut_half &&
             (long long)y < r.cy + r.cut_half) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const long long x = x0 + j;
      const bool in_x = x >= r.cx - r.cut_half && x < r.cx + r.cut_half;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        put8(out, 3 * j + ch, in_x ? r.cut_fill : get8(m, 3 * j + ch));
    }
  } else {  // kPassthrough (LUT-class images are overwritten later), a
            // CutOut row outside the square
#pragma unroll
    for (int k = 0; k < 12; ++k) out[k] = m[k];
  }
}

// ---- K1 on the byte path: pixel (y, x), c = 3

__device__ __forceinline__ void round_pixel(int opc, const Band& b,
                                            const Shifts& s, const Round& r,
                                            int y, int x) {
  uint8_t* to = b.dst + ((size_t)y * b.w + x) * 3;
  const uint8_t* at = row_at(b, y) + 3 * x;
  if (opc == kWarp) {
    const int off = warp_offset(b, s, 0, 0, shift_at(s.A3, s.B3, y), y, x, 3);
    for (int ch = 0; ch < 3; ++ch)
      to[ch] = off >= 0 ? b.src[off + ch] : (uint8_t)r.fill;
  } else if (opc == kColor) {
    const float d = gray_of(at[0], at[1], at[2]);
    for (int ch = 0; ch < 3; ++ch)
      to[ch] = (uint8_t)blend_toward(d, (float)at[ch], r.fc);
  } else if (opc == kSharpness) {
    const bool interior = y >= 1 && y <= b.h - 2 && x >= 1 && x <= b.w - 2;
    const uint8_t* up = interior ? at - b.row_bytes : at;
    const uint8_t* dn = interior ? at + b.row_bytes : at;
    for (int ch = 0; ch < 3; ++ch) {
      const uint32_t v = at[ch];
      uint32_t degen = v;
      if (interior) {
        uint32_t sum = 4 * v;  // centre weight 5 = 4 here + 1 in the loop
        for (int dx = -3; dx <= 3; dx += 3)
          sum += up[dx + ch] + at[dx + ch] + dn[dx + ch];
        degen = smooth(sum);
      }
      to[ch] = (uint8_t)blend_toward((float)degen, (float)v, r.fs);
    }
  } else if (opc == kCutout) {
    const bool in = (long long)y >= r.cy - r.cut_half &&
                    (long long)y < r.cy + r.cut_half &&
                    (long long)x >= r.cx - r.cut_half &&
                    (long long)x < r.cx + r.cut_half;
    for (int ch = 0; ch < 3; ++ch) to[ch] = in ? (uint8_t)r.cut_fill : at[ch];
  } else {
    for (int ch = 0; ch < 3; ++ch) to[ch] = at[ch];
  }
}

// ---- the kernels: S = ceil(h / R) blocks an image, R rows a block

__global__ void __launch_bounds__(kMaxThreads) fused_round_kernel(
    const uint8_t* __restrict__ images, uint8_t* __restrict__ out,
    const float* __restrict__ transforms, int t_stride,
    const int* __restrict__ op_class, const long long* __restrict__ cut_cy,
    const long long* __restrict__ cut_cx,
    const float* __restrict__ color_factor, float color_scalar,
    const float* __restrict__ sharp_factor, float sharp_scalar, int h, int w,
    int pad, int fill, int cut_half, int cut_fill, int R, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Band b = open_band(images, out, h, w, 3, R);
  const int image = blockIdx.x / ((h + R - 1) / R);
  const int opc = op_class[image];
  const Shifts s = shears_of(transforms + (size_t)image * t_stride, pad, w);
  Round r;
  r.fc = color_factor ? color_factor[image] : color_scalar;
  r.fs = sharp_factor ? sharp_factor[image] : sharp_scalar;
  r.cy = cut_cy[image];
  r.cx = cut_cx[image];
  r.cut_half = cut_half;
  r.fill = (uint32_t)fill;
  r.cut_fill = (uint32_t)cut_fill;

  const int rows = b.r1 - b.r0;
  if (vec && opc == kWarp) {
    warp_spans<3>(b, s, r.fill, reinterpret_cast<uint32_t*>(smem));
  } else if (vec) {
    const int per_row = w / kGroup;
    for (int g = threadIdx.x; g < rows * per_row; g += blockDim.x) {
      const int y = b.r0 + g / per_row;
      const int x0 = (g - (y - b.r0) * per_row) * kGroup;
      uint32_t o[12] = {};
      round_group(opc, b, r, y, x0, o);
      store16<3>(b.dst + (size_t)y * b.row_bytes + 3 * x0, o);
    }
  } else {
    for (int p = threadIdx.x; p < rows * w; p += blockDim.x) {
      const int y = b.r0 + p / w;
      round_pixel(opc, b, s, r, y, p - (y - b.r0) * w);
    }
  }
}

// kC = 0: any number of channels, one pixel a thread
template <int kC>
__global__ void __launch_bounds__(kMaxThreads) warp_kernel(
    const uint8_t* __restrict__ images, uint8_t* __restrict__ out,
    const float* __restrict__ transforms, int t_stride, int h, int w, int c,
    int pad, int fill, int R, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int cc = kC ? kC : c;
  const Band b = open_band(images, out, h, w, cc, R);
  const int image = blockIdx.x / ((h + R - 1) / R);
  const Shifts s = shears_of(transforms + (size_t)image * t_stride, pad, w);

  if constexpr (kC != 0) {
    if (vec) {
      warp_spans<kC>(b, s, (uint32_t)fill, reinterpret_cast<uint32_t*>(smem));
      return;
    }
  }
  const int rows = b.r1 - b.r0;
  for (int p = threadIdx.x; p < rows * w; p += blockDim.x) {
    const int y = b.r0 + p / w;
    const int x = p - (y - b.r0) * w;
    const int off = warp_offset(b, s, 0, 0, shift_at(s.A3, s.B3, y), y, x, cc);
    uint8_t* to = b.dst + ((size_t)y * w + x) * cc;
    for (int ch = 0; ch < cc; ++ch)
      to[ch] = off >= 0 ? b.src[off + ch] : (uint8_t)fill;
  }
}

// ---- launching

// Threads a block: the fewest passes of at most kMaxThreads over `items`,
// spread evenly, in whole warps.
int threads_for(long long items) {
  const long long passes = (items + kMaxThreads - 1) / kMaxThreads;
  const long long per = passes ? (items + passes - 1) / passes : 1;
  return (int)std::min<long long>(kMaxThreads, round_up(per, 32));
}

// A launch's shape: R rows a block (about kRowPixels pixels), threads a
// block, dynamic shared memory (each warp's gather buffer on the 16-byte
// path: 2560 bytes, so 40 KB at most, below the 48 KB default).
struct Shape {
  int R, threads;
  long long smem;
};

Shape shape_of(int h, int w, bool vec, bool spans) {
  Shape sh;
  sh.R = std::max(1, std::min(h, kRowPixels / w));
  sh.threads = threads_for(vec ? (long long)sh.R * (w / kGroup)
                               : (long long)sh.R * w);
  sh.smem = spans ? 4LL * (sh.threads / 32) * kSpanWords : 0;
  return sh;
}

// Launches kKernel on b * ceil(h / R) blocks. Returns kTooLarge for an
// image of 2^31 bytes or more (the kernels index an image with 32-bit
// offsets), else the CUDA error of the launch.
template <auto kKernel, class... Args>
int launch(int b, int h, int w, int c, bool vec, bool spans,
           cudaStream_t stream, Args... args) {
  const Shape sh = shape_of(h, w, vec, spans);
  const long long blocks = (long long)b * ((h + sh.R - 1) / sh.R);
  if ((long long)h * w * c > INT_MAX || blocks > INT_MAX) return kTooLarge;
  kKernel<<<(unsigned)blocks, sh.threads, (size_t)sh.smem, stream>>>(
      args..., sh.R, (int)vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The 16-byte path: rows a multiple of 16 pixels, both batches aligned
// (the output of torch.empty_like is).
bool vec_path(const void* images, const void* out, int w) {
  return w % kGroup == 0 && aligned16(images) && aligned16(out);
}

}  // namespace

// Each entry point launches on `stream` and returns a CUDA error code (or
// kTooLarge), so a refused launch reaches the wrapper, which raises.
// Nothing here synchronises or allocates. `transforms` is [b, 8] float32
// read with row stride t_stride (0: one transform for the whole batch).
extern "C" int warp_launch(const void* images, void* out,
                           const void* transforms, int t_stride, int b,
                           int h, int w, int c, int pad, int fill,
                           void* stream) {
  if (b == 0 || h == 0 || w == 0 || c == 0) return (int)cudaSuccess;
  const bool vec = vec_path(images, out, w);
  const auto* in = (const uint8_t*)images;
  auto* o = (uint8_t*)out;
  const auto* t = (const float*)transforms;
  const auto st = (cudaStream_t)stream;
#define WARP_LAUNCH(KC)                                                   \
  launch<warp_kernel<KC>>(b, h, w, c, vec, KC && vec, st, in, o, t,       \
                          t_stride, h, w, c, pad, fill)
  switch (c) {
    case 1: return WARP_LAUNCH(1);
    case 3: return WARP_LAUNCH(3);
    case 4: return WARP_LAUNCH(4);
    default: return WARP_LAUNCH(0);
  }
#undef WARP_LAUNCH
}

// c = 3. op_class int32 [b]; cut_cy, cut_cx int64 [b]; color_factor and
// sharp_factor float32 [b], or null for the scalar beside each.
extern "C" int fused_round_launch(
    const void* images, void* out, const void* transforms, int t_stride,
    const void* op_class, const void* cut_cy, const void* cut_cx,
    const void* color_factor, float color_scalar, const void* sharp_factor,
    float sharp_scalar, int b, int h, int w, int pad, int fill, int cut_half,
    int cut_fill, void* stream) {
  if (b == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  const bool vec = vec_path(images, out, w);
  return launch<fused_round_kernel>(
      b, h, w, 3, vec, vec, (cudaStream_t)stream, (const uint8_t*)images,
      (uint8_t*)out, (const float*)transforms, t_stride, (const int*)op_class,
      (const long long*)cut_cy, (const long long*)cut_cx,
      (const float*)color_factor, color_scalar, (const float*)sharp_factor,
      sharp_scalar, h, w, pad, fill, cut_half, cut_fill);
}

// The shape a launch on `images` (and an aligned output) takes, for the
// record: shape = {rows a block, threads a block, shared memory bytes}.
extern "C" void warp_launch_shape(const void* images, int h, int w, int c,
                                  int round, int* shape) {
  const bool vec = vec_path(images, images, w);
  const Shape sh =
      shape_of(h, w, vec, vec && (round || c == 1 || c == 3 || c == 4));
  shape[0] = sh.R;
  shape[1] = sh.threads;
  shape[2] = (int)sh.smem;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
