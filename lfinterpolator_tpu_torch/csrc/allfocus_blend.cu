// Per-pixel-focus blend for Hopper (sm_90a): the select and the view
// contraction of an all-in-focus render in one kernel.
//
//   f = decode[map[y, x]]
//   out[v,c,y,x] = u8(min(max(rint(sum_{g=0..G-1} W[v,g] *
//                      img[g, c, clamp(trunc(y + f*oy_g)), clamp(trunc(x + f*ox_g))]), 0), 255))
//
// Replaces the TPU kernel allfocus_pallas._af_kernel
// (lfinterpolator_tpu/ops/allfocus_pallas.py:102), which selected every
// image by its pixel's focus level into a stack that
// blend_pallas._blend_tiled_kernel (blend_pallas.py:217) then contracted.
// The TPU kernel scanned the map's byte levels with a presence table
// because TPU gathers are slow; here each thread decodes its pixel's focus
// once (a 256-entry table built on the host, so no division runs on the
// device) and gathers its G source pixels directly, so the selected stack
// never exists in device memory. One kernel serves both methods: the
// caller passes the filtered map (STD) or the raw map (TEN).
//
// Numerics: coordinates as the oracle (ops/reference.py blend_allfocus):
// trunc(__fadd_rn(f32(q), __fmul_rn(f, o))), clamped; the contraction is
// shift_blend.cu's (lfi::blend_views: f32 in ascending g, no FMA, round
// half to even, clip, cast), so the result is bit-equal to the oracle.
//
// Bound: at the headline frame (8x8 grid, 1080x1920, 64 views) the
// contraction is the same 25.5 G multiply-adds (f32 issue) as the fixed
// render; the gather adds two multiplies, two adds, two conversions and
// the clamps per (pixel, channel, g, chunk of 32 views), about a fifth of
// the contraction's ~96 instructions there. Loads stay mostly coalesced along x:
// neighbouring pixels' focus values are usually equal, so their source
// columns are neighbours too. The tensor-core contraction and staging the
// gathered operands in shared memory come later.

#include "lfi_common.cuh"

namespace {

using lfi::kMaxGrid;
using lfi::kTileX;
using lfi::kViewChunk;

__global__ void __launch_bounds__(kTileX)
allfocus_blend_kernel(const uint8_t* __restrict__ img,   // [G, C, H, W]
                      const float* __restrict__ w,       // [V, G]
                      const float* __restrict__ offs,    // [G, 2] (x, y)
                      const uint8_t* __restrict__ fmap,  // [H, W]
                      const float* __restrict__ decode,  // [256]
                      uint8_t* __restrict__ out,         // [V, C, H, W]
                      int G, int C, int H, int W, int V, int64_t tiles_x) {
  __shared__ float w_s[kViewChunk * kMaxGrid];
  __shared__ float ox_s[kMaxGrid];
  __shared__ float oy_s[kMaxGrid];

  const int64_t block = blockIdx.x;
  const int64_t row = block / tiles_x;  // c * H + y
  const int x = (int)(block - row * tiles_x) * kTileX + threadIdx.x;
  const int c = (int)(row / H);
  const int y = (int)(row - (int64_t)c * H);

  for (int g = threadIdx.x; g < G; g += kTileX) {
    ox_s[g] = offs[2 * g];
    oy_s[g] = offs[2 * g + 1];
  }
  const float f = x < W ? decode[fmap[(int64_t)y * W + x]] : 0.0f;

  const int64_t plane = (int64_t)H * W;
  uint8_t* const px = out + (int64_t)c * plane + (int64_t)y * W + x;
  const int64_t view_stride = (int64_t)C * plane;
  lfi::blend_views<false>(w, G, V, x < W, w_s,
                   [&](int v) { return px + v * view_stride; }, [&](int g) {
                     const int sy = lfi::focus_coord(y, f, oy_s[g], H);
                     const int sx = lfi::focus_coord(x, f, ox_s[g], W);
                     return (float)img[((int64_t)g * C + c) * plane +
                                       (int64_t)sy * W + sx];
                   });
}

}  // namespace

extern "C" {

// Largest G the kernel takes (the wrapper checks against it).
int lfi_allfocus_blend_max_grid(void) { return kMaxGrid; }

// Launches on `stream`; does not synchronise and allocates nothing.
// Returns cudaGetLastError() after the launch (0 on success).
int lfi_allfocus_blend(const uint8_t* img, const float* w, const float* offs,
                       const uint8_t* fmap, const float* decode, uint8_t* out,
                       int G, int C, int H, int W, int V, cudaStream_t stream) {
  if (G < 1 || G > kMaxGrid || C < 1 || H < 1 || W < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_x = (W + kTileX - 1) / kTileX;
  const int64_t blocks = (int64_t)C * H * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  allfocus_blend_kernel<<<(unsigned)blocks, kTileX, 0, stream>>>(
      img, w, offs, fmap, decode, out, G, C, H, W, V, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
