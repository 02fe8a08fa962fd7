// Fixed-focus shift + blend for Hopper (sm_90a): one kernel for the whole
// fixed-focus render.
//
//   out[v,c,y,x] = u8(min(max(rint(sum_{g=0..G-1} W[v,g] *
//                      img[g, c, clamp(y+dy_g, 0, H-1), clamp(x+dx_g, 0, W-1)]), 0), 255))
//
// Replaces three TPU kernels of the JAX package:
//   * shift_pallas._pshift_kernel      (lfinterpolator_tpu/ops/shift_pallas.py:277)
//   * blend_pallas._blend_tiled_kernel (lfinterpolator_tpu/ops/blend_pallas.py:217)
//   * blend_pallas._blend_kernel       (lfinterpolator_tpu/ops/blend_pallas.py:165)
// and, on the streaming path, a fourth as its operand load:
//   * shift_pallas._shift_kernel       (lfinterpolator_tpu/ops/shift_pallas.py:90),
//     the clamp-shift from the raw tile-padded stack that fed
//     _blend_tiled_kernel for each streamed frame (streaming.py:262-272);
//     the clamped index below reads the unpadded stack at any geometry.
// and, as its quilt instantiation (kQuilt), a fifth:
//   * blend_pallas._blend_quilt_kernel (lfinterpolator_tpu/ops/blend_pallas.py:311),
//     fed by _pshift_kernel in quilt.render_fixed_quilt_padded: the same
//     sums for views 0..n-1 only (n = cols * rows), view v's byte stored at
//     its tile (v / cols, v % cols) of the [C, rows * H, cols * W] canvas,
//     so the 64-view stack never exists. The TPU needed h % 8 == 0 and
//     w % 128 == 0 for the tiles to butt inside its blocks
//     (blend_pallas.supports_quilt); a computed store address takes any
//     geometry.
// The TPU needed an edge-padded stack to encode the clamp and two blend
// tilings (flat and 8x128); a clamped source index makes both unnecessary,
// so the shift is this kernel's operand load and nothing is staged in
// device memory between the two stages.
//
// Numerics: f32 accumulation in ascending g as __fadd_rn(acc, __fmul_rn(w, p)),
// so no FMA contraction; __float2int_rn (half to even), then clamp, then cast.
// With fp16-valued weights every product is exact, so the result is
// bit-equal to the NumPy oracle (ops/reference.py blend_fixed).
//
// Bound: at the headline frame (8x8 grid, 1080x1920, 64 views) the
// contraction is 25.5 G multiply-adds (51 GFLOP) against 796 MB of traffic,
// so this scalar-f32 kernel is bound by f32 issue, not by memory. Its
// design does no more than keep the bytes low: each block owns one
// 128-pixel row segment of one channel, loads each source byte once per
// chunk of 32 views (coalesced along x, since the shift is constant per
// image), keeps the chunk's weights in shared memory (read as broadcasts)
// and its 32 sums in registers. The tensor-core version (mma/wgmma on
// fp16 operands, f32 accumulation) and TMA staging come later.

#include "lfi_common.cuh"

namespace {

using lfi::kMaxGrid;
using lfi::kTileX;
using lfi::kViewChunk;

constexpr int kMaxQuiltViews = 256;  // largest cols * rows of a quilt

// kQuilt: `out` is the [C, (V / cols) * H, cols * W] canvas, else [V, C, H, W].
template <bool kQuilt>
__global__ void __launch_bounds__(kTileX)
shift_blend_kernel(const uint8_t* __restrict__ img,   // [G, C, H, W]
                   const float* __restrict__ w,       // [V, G]
                   const int32_t* __restrict__ shifts, // [G, 2] (dx, dy), |dx|<=W, |dy|<=H
                   uint8_t* __restrict__ out,
                   int G, int C, int H, int W, int V, int cols,
                   int64_t tiles_x) {
  __shared__ float w_s[kViewChunk * kMaxGrid];
  __shared__ int src_row[kMaxGrid];  // clamp(y + dy_g, 0, H-1)
  __shared__ int dx_s[kMaxGrid];
  // kQuilt: view v's tile origin in a canvas plane, so that no thread
  // divides by cols in its store loop.
  __shared__ int64_t tile_s[kQuilt ? kMaxQuiltViews : 1];

  const int64_t block = blockIdx.x;
  const int64_t row = block / tiles_x;        // c * H + y
  const int x = (int)(block - row * tiles_x) * kTileX + threadIdx.x;
  const int c = (int)(row / H);
  const int y = (int)(row - (int64_t)c * H);

  for (int g = threadIdx.x; g < G; g += kTileX) {
    src_row[g] = lfi::clamp_index(y + shifts[2 * g + 1], H);
    dx_s[g] = shifts[2 * g];
  }

  const int64_t plane = (int64_t)H * W;
  const int64_t canvas_w = (int64_t)cols * W;
  if (kQuilt)
    for (int v = threadIdx.x; v < V; v += kTileX)
      tile_s[v] = (int64_t)(v / cols) * H * canvas_w + (int64_t)(v % cols) * W;
  uint8_t* const px =
      kQuilt ? out + (int64_t)c * (V / cols) * H * canvas_w + y * canvas_w + x
             : out + (int64_t)c * plane + (int64_t)y * W + x;
  lfi::blend_views<kQuilt>(w, G, V, x < W, w_s, [&](int v) {
                     return kQuilt ? px + tile_s[v] : px + v * ((int64_t)C * plane);
                   }, [&](int g) {
                     const int sx = lfi::clamp_index(x + dx_s[g], W);
                     return (float)img[((int64_t)g * C + c) * plane +
                                       (int64_t)src_row[g] * W + sx];
                   });
}

}  // namespace

extern "C" {

// Largest G the kernel takes (the wrapper checks against it).
int lfi_shift_blend_max_grid(void) { return kMaxGrid; }
// Largest cols * rows the quilt instantiation takes.
int lfi_quilt_blend_max_views(void) { return kMaxQuiltViews; }

// Launches on `stream`; does not synchronise and allocates nothing.
// Returns cudaGetLastError() after the launch (0 on success).
int lfi_shift_blend(const uint8_t* img, const float* w, const int32_t* shifts,
                    uint8_t* out, int G, int C, int H, int W, int V,
                    cudaStream_t stream) {
  if (G < 1 || G > kMaxGrid || C < 1 || H < 1 || W < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_x = (W + kTileX - 1) / kTileX;
  const int64_t blocks = (int64_t)C * H * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  shift_blend_kernel<false><<<(unsigned)blocks, kTileX, 0, stream>>>(
      img, w, shifts, out, G, C, H, W, V, 1, tiles_x);
  return (int)cudaGetLastError();
}

// The quilt instantiation: blends views 0..cols*rows-1 (the first
// cols * rows <= 256 rows of `w`) straight into the canvas `out`,
// [C, rows * H, cols * W] uint8, view v at tile (v / cols, v % cols).
int lfi_quilt_blend(const uint8_t* img, const float* w, const int32_t* shifts,
                    uint8_t* out, int G, int C, int H, int W, int cols,
                    int rows, cudaStream_t stream) {
  if (G < 1 || G > kMaxGrid || C < 1 || H < 1 || W < 1 || cols < 1 ||
      rows < 1 || cols * rows > kMaxQuiltViews)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_x = (W + kTileX - 1) / kTileX;
  const int64_t blocks = (int64_t)C * H * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  shift_blend_kernel<true><<<(unsigned)blocks, kTileX, 0, stream>>>(
      img, w, shifts, out, G, C, H, W, cols * rows, cols, tiles_x);
  return (int)cudaGetLastError();
}

const char* lfi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
