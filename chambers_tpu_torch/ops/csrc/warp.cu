// Hand-written Hopper kernels for the RandAugment round and the separable
// warp, with a plain C interface loaded through ctypes
// (chambers_tpu_torch/ops/warp_kernels.py holds the wrappers and the plain
// PyTorch versions they are checked against).
//
// Replaces the Pallas TPU kernels of chambers_tpu/ops/warp_pallas.py:
//   fused_round_kernel  <- fused_round_pallas / _fused_round_kernel  (K1)
//   warp_kernel         <- transform_affine_separable_pallas /
//                          _warp_kernel / _warp_body                 (K2)
// Both use one device function, warp_pixel, as the two Pallas kernels share
// _warp_body.
//
// Bound: both kernels are memory-bound. At the main path's shape
// (uint8 [32, 224, 224, 3]) each launch reads 4.82 MB and writes 4.82 MB,
// 9.63 MB in all: about 2.9 us at an H100 SXM's 3.35 TB/s. Arithmetic is a
// few integer ops a byte (a 3x3 stencil at most). No single PyTorch call
// computes either function.
//
// Design: the TPU kernels replay the three shear passes as ~26 conditional
// lane/sublane rolls over a VMEM-resident image, because gathers are slow
// there. On Hopper a gather is cheap, so each thread computes its output
// bytes directly: the three passes compose into one source index,
//   x3 = x + pad + n3[y]   (fill unless 0 <= x3 < wp)
//   y2 = y + n2[x3]        (fill unless 0 <= y2 < h)
//   x1 = x3 + n1[y2]       (fill unless pad <= x1 < pad + w)
//   out = img[y2, x1 - pad]
// with n1, n3 per row ([h]) and n2 per padded column ([wp]), the raw
// integer shifts the wrapper computes exactly as warp_pallas._shift_vectors.
// The grid is (row tiles, batch): every block reads its image's op class
// once, so the K1 branch is uniform within a block. Loads are byte-wise and
// unshared: the simple, correct first version; shared-memory tiling and
// 16-byte vector accesses are later work.
//
// Exactness: COLOR and SHARPNESS repeat the JAX arithmetic order with
// explicitly rounded intrinsics (__fmul_rn / __fadd_rn / __fsub_rn), so no
// multiply is contracted into an add; the library is also built with
// --fmad=false. An FMA flips pixels at magnitude 9:
// float32(1.72) * (-75) is exactly -129.0 only as a separate multiply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// op-class ids (warp_pallas.py: PASSTHROUGH, WARP, COLOR, SHARPNESS, CUTOUT)
constexpr int kPassthrough = 0;
constexpr int kWarp = 1;
constexpr int kColor = 2;
constexpr int kSharpness = 3;
constexpr int kCutout = 4;

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 4;

// ITU-R 601 weights as the float32 values numpy rounds 0.299, 0.587 and
// 0.114 to, and float32(1) / float32(255).
constexpr float kGrayR = 0x1.322d0ep-2f;
constexpr float kGrayG = 0x1.2c8b44p-1f;
constexpr float kGrayB = 0x1.d2f1aap-4f;
constexpr float kInv255 = 0x1.010102p-8f;

__device__ __forceinline__ uint8_t warp_pixel(
    const uint8_t* __restrict__ img, const int* __restrict__ n1,
    const int* __restrict__ n2, const int* __restrict__ n3, int y, int x,
    int ch, int h, int w, int c, int pad, uint8_t fill) {
  const int wp = w + 2 * pad;
  const int x3 = x + pad + n3[y];
  if (x3 < 0 || x3 >= wp) return fill;
  const int y2 = y + n2[x3];
  if (y2 < 0 || y2 >= h) return fill;
  const int x1 = x3 + n1[y2];
  if (x1 < pad || x1 >= pad + w) return fill;
  return img[((size_t)y2 * w + (x1 - pad)) * c + ch];
}

// degenerate + f * (v - degenerate), each step rounded, clipped to
// [0, 255] and truncated (image_ops.blend's arithmetic).
__device__ __forceinline__ uint8_t blend_toward(float degenerate, float v,
                                                float f) {
  float t = __fadd_rn(degenerate, __fmul_rn(f, __fsub_rn(v, degenerate)));
  t = fminf(fmaxf(t, 0.0f), 255.0f);
  return (uint8_t)(int)t;
}

__device__ __forceinline__ uint8_t color_pixel(const uint8_t* __restrict__ px,
                                               int ch, float f) {
  const float r = __fmul_rn((float)px[0], kInv255);
  const float g = __fmul_rn((float)px[1], kInv255);
  const float b = __fmul_rn((float)px[2], kInv255);
  const float gray = __fadd_rn(
      __fadd_rn(__fmul_rn(kGrayR, r), __fmul_rn(kGrayG, g)),
      __fmul_rn(kGrayB, b));
  const float degen =
      floorf(fminf(fmaxf(__fmul_rn(gray, 255.5f), 0.0f), 255.0f));
  return blend_toward(degen, (float)px[ch], f);
}

__device__ __forceinline__ uint8_t sharp_pixel(const uint8_t* __restrict__ src,
                                               int y, int x, int ch, int h,
                                               int w, int c, float f) {
  const int v = src[((size_t)y * w + x) * c + ch];
  int degen = v;
  if (y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2) {
    int s = 4 * v;  // centre weight 5 = 4 here + 1 in the loop
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx)
        s += src[((size_t)(y + dy) * w + (x + dx)) * c + ch];
    const int n = s / 13;  // s >= 0: truncation == floor
    const int r = s - 13 * n;
    degen = n + (2 * r > 13 ? 1 : 0);  // round half to even
  }
  return blend_toward((float)degen, (float)v, f);
}

__global__ void __launch_bounds__(kThreads)
    warp_kernel(const uint8_t* __restrict__ images, uint8_t* __restrict__ out,
                const int* __restrict__ n1, const int* __restrict__ n2,
                const int* __restrict__ n3, int h, int w, int c, int pad,
                int fill) {
  const int b = blockIdx.y;
  const int wp = w + 2 * pad;
  const size_t plane = (size_t)h * w * c;
  const uint8_t* src = images + b * plane;
  uint8_t* dst = out + b * plane;
  const int* r1 = n1 + (size_t)b * h;
  const int* r2 = n2 + (size_t)b * wp;
  const int* r3 = n3 + (size_t)b * h;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, h - row0);
  const int row_bytes = w * c;
  for (int i = threadIdx.x; i < rows * row_bytes; i += blockDim.x) {
    const int y = row0 + i / row_bytes;
    const int rem = i - (y - row0) * row_bytes;
    const int x = rem / c;
    const int ch = rem - x * c;
    dst[(size_t)y * row_bytes + rem] =
        warp_pixel(src, r1, r2, r3, y, x, ch, h, w, c, pad, (uint8_t)fill);
  }
}

__global__ void __launch_bounds__(kThreads) fused_round_kernel(
    const uint8_t* __restrict__ images, uint8_t* __restrict__ out,
    const int* __restrict__ n1, const int* __restrict__ n2,
    const int* __restrict__ n3, const int* __restrict__ op_class,
    const int* __restrict__ cut_cy, const int* __restrict__ cut_cx,
    const float* __restrict__ color_factor,
    const float* __restrict__ sharp_factor, int h, int w, int c, int pad,
    int fill, int cut_half, int cut_fill) {
  const int b = blockIdx.y;
  const int opc = op_class[b];
  const int wp = w + 2 * pad;
  const size_t plane = (size_t)h * w * c;
  const uint8_t* src = images + b * plane;
  uint8_t* dst = out + b * plane;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, h - row0);
  const int row_bytes = w * c;
  const int* r1 = n1 + (size_t)b * h;
  const int* r2 = n2 + (size_t)b * wp;
  const int* r3 = n3 + (size_t)b * h;
  const float fc = color_factor[b];
  const float fs = sharp_factor[b];
  const int cy = cut_cy[b];
  const int cx = cut_cx[b];
  for (int i = threadIdx.x; i < rows * row_bytes; i += blockDim.x) {
    const int y = row0 + i / row_bytes;
    const int rem = i - (y - row0) * row_bytes;
    const int x = rem / c;
    const int ch = rem - x * c;
    const size_t at = (size_t)y * row_bytes + rem;
    uint8_t v;
    switch (opc) {
      case kWarp:
        v = warp_pixel(src, r1, r2, r3, y, x, ch, h, w, c, pad,
                       (uint8_t)fill);
        break;
      case kColor:
        v = color_pixel(src + at - ch, ch, fc);
        break;
      case kSharpness:
        v = sharp_pixel(src, y, x, ch, h, w, c, fs);
        break;
      case kCutout: {
        const bool in_y = y >= cy - cut_half && y < cy + cut_half;
        const bool in_x = x >= cx - cut_half && x < cx + cut_half;
        v = (in_y && in_x) ? (uint8_t)cut_fill : src[at];
        break;
      }
      default:  // kPassthrough (and LUT-class images, overwritten later)
        v = src[at];
    }
    dst[at] = v;
  }
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError(), so a
// refused launch (bad grid, too many threads) reaches the wrapper, which
// raises. Nothing here synchronises or allocates.
extern "C" int warp_launch(const void* images, void* out, const void* n1,
                           const void* n2, const void* n3, int b, int h,
                           int w, int c, int pad, int fill, void* stream) {
  if (b == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  dim3 grid((h + kRowsPerBlock - 1) / kRowsPerBlock, b);
  warp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)images, (uint8_t*)out, (const int*)n1, (const int*)n2,
      (const int*)n3, h, w, c, pad, fill);
  return (int)cudaGetLastError();
}

extern "C" int fused_round_launch(const void* images, void* out,
                                  const void* n1, const void* n2,
                                  const void* n3, const void* op_class,
                                  const void* cut_cy, const void* cut_cx,
                                  const void* color_factor,
                                  const void* sharp_factor, int b, int h,
                                  int w, int c, int pad, int fill,
                                  int cut_half, int cut_fill, void* stream) {
  if (b == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  dim3 grid((h + kRowsPerBlock - 1) / kRowsPerBlock, b);
  fused_round_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)images, (uint8_t*)out, (const int*)n1, (const int*)n2,
      (const int*)n3, (const int*)op_class, (const int*)cut_cy,
      (const int*)cut_cx, (const float*)color_factor,
      (const float*)sharp_factor, h, w, c, pad, fill, cut_half, cut_fill);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
