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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 128;     // threads per block = pixels per row segment
constexpr int kViewChunk = 32;  // views accumulated in registers per pass
constexpr int kMaxGrid = 256;   // largest G (images) the kernel takes

__global__ void __launch_bounds__(kTileX)
shift_blend_kernel(const uint8_t* __restrict__ img,   // [G, C, H, W]
                   const float* __restrict__ w,       // [V, G]
                   const int32_t* __restrict__ shifts, // [G, 2] (dx, dy), |dx|<=W, |dy|<=H
                   uint8_t* __restrict__ out,         // [V, C, H, W]
                   int G, int C, int H, int W, int V, int64_t tiles_x) {
  __shared__ float w_s[kViewChunk * kMaxGrid];
  __shared__ int src_row[kMaxGrid];  // clamp(y + dy_g, 0, H-1)
  __shared__ int dx_s[kMaxGrid];

  const int64_t block = blockIdx.x;
  const int64_t row = block / tiles_x;        // c * H + y
  const int x = (int)(block - row * tiles_x) * kTileX + threadIdx.x;
  const int c = (int)(row / H);
  const int y = (int)(row - (int64_t)c * H);

  for (int g = threadIdx.x; g < G; g += kTileX) {
    const int sy = y + shifts[2 * g + 1];
    src_row[g] = sy < 0 ? 0 : (sy > H - 1 ? H - 1 : sy);
    dx_s[g] = shifts[2 * g];
  }

  const int64_t plane = (int64_t)H * W;
  for (int v0 = 0; v0 < V; v0 += kViewChunk) {
    const int vn = V - v0 < kViewChunk ? V - v0 : kViewChunk;
    __syncthreads();  // previous chunk done with w_s (and src_row ready)
    for (int i = threadIdx.x; i < kViewChunk * G; i += kTileX) {
      const int vv = i / G;
      w_s[i] = vv < vn ? w[(int64_t)(v0 + vv) * G + (i - vv * G)] : 0.0f;
    }
    __syncthreads();
    if (x < W) {
      float acc[kViewChunk];
#pragma unroll
      for (int vv = 0; vv < kViewChunk; ++vv) acc[vv] = 0.0f;
      for (int g = 0; g < G; ++g) {
        int sx = x + dx_s[g];
        sx = sx < 0 ? 0 : (sx > W - 1 ? W - 1 : sx);
        const float p = (float)img[((int64_t)g * C + c) * plane +
                                   (int64_t)src_row[g] * W + sx];
#pragma unroll
        for (int vv = 0; vv < kViewChunk; ++vv)
          acc[vv] = __fadd_rn(acc[vv], __fmul_rn(w_s[vv * G + g], p));
      }
      uint8_t* dst = out + ((int64_t)v0 * C + c) * plane + (int64_t)y * W + x;
      const int64_t view_stride = (int64_t)C * plane;
#pragma unroll
      for (int vv = 0; vv < kViewChunk; ++vv) {
        if (vv < vn) {
          int q = __float2int_rn(acc[vv]);
          q = q < 0 ? 0 : (q > 255 ? 255 : q);
          dst[vv * view_stride] = (uint8_t)q;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Largest G the kernel takes (the wrapper checks against it).
int lfi_shift_blend_max_grid(void) { return kMaxGrid; }

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
  shift_blend_kernel<<<(unsigned)blocks, kTileX, 0, stream>>>(
      img, w, shifts, out, G, C, H, W, V, tiles_x);
  return (int)cudaGetLastError();
}

const char* lfi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
