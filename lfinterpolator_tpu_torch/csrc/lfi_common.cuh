// Device helpers shared by the port's kernels: the oracle's coordinate rule
// and the view contraction of the blend kernels (shift_blend.cu, with its
// quilt instantiation, and allfocus_blend.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lfi {

constexpr int kTileX = 128;     // threads per blend block = pixels per row segment
constexpr int kViewChunk = 32;  // views accumulated in registers per pass
constexpr int kMaxGrid = 256;   // largest G (images) the blend kernels take

// trunc(v) toward zero, as C's int cast does (focusCoords in the reference).
// |v| is first held to 2^24: past it every coordinate clamps to an edge
// anyway, and the conversion and the stencil offsets added to the result
// stay far from int overflow.
__device__ __forceinline__ int trunc_coord(float v) {
  return __float2int_rz(fminf(fmaxf(v, -16777216.0f), 16777216.0f));
}

__device__ __forceinline__ int clamp_index(int t, int n) {
  return t < 0 ? 0 : (t > n - 1 ? n - 1 : t);
}

// The oracle's per-pixel source coordinate clamp(trunc(f32(q) + f32(f*o))):
// multiply and add rounded separately, never contracted to an FMA.
__device__ __forceinline__ int focus_coord(int q, float f, float o, int n) {
  return clamp_index(trunc_coord(__fadd_rn((float)q, __fmul_rn(f, o))), n);
}

// One chunk of kN views of one thread's output pixel: the sums over g of
// w_s[vv * G + g] * pixel(g), stored for the first vn views.
template <int kN, class Pixel, class Dst>
__device__ __forceinline__ void blend_chunk(const float* w_s, int G, int v0,
                                            int vn, Dst dst, Pixel pixel) {
  float acc[kN];
#pragma unroll
  for (int vv = 0; vv < kN; ++vv) acc[vv] = 0.0f;
  for (int g = 0; g < G; ++g) {
    const float p = pixel(g);
#pragma unroll
    for (int vv = 0; vv < kN; ++vv)
      acc[vv] = __fadd_rn(acc[vv], __fmul_rn(w_s[vv * G + g], p));
  }
#pragma unroll
  for (int vv = 0; vv < kN; ++vv) {
    if (vv < vn) {
      int q = __float2int_rn(acc[vv]);
      q = q < 0 ? 0 : (q > 255 ? 255 : q);
      *dst(v0 + vv) = (uint8_t)q;
    }
  }
}

// All V views of one thread's output pixel (c, y, x):
//   *dst(v) = u8(clamp(rint(sum_{g = 0..G-1} w[v, g] * pixel(g)), 0, 255))
// summed in f32 in ascending g as __fadd_rn(acc, __fmul_rn(w, p)), views in
// chunks of kViewChunk held in registers, each chunk's weights staged in
// `w_s` ([kViewChunk * kMaxGrid] shared floats, read as broadcasts).
// With kHalfTail a last chunk of at most kViewChunk / 2 views runs half as
// many sums (45 quilt views cost 48 view-sums, not 64); without it the
// kernel carries one chunk body only: with both bodies, the 64-view
// shift_blend and allfocus_blend measured 1.5-3% slower (NVIDIA H100 80GB
// HBM3, 700 W).
// `pixel(g)` is the kernel's operand load, called once per g and chunk;
// `dst(v)` the address of view v's byte of this pixel.
// Every thread of the block calls this (it synchronises, also covering the
// caller's own shared-memory set-up); `active` is false past the row's end.
template <bool kHalfTail, class Pixel, class Dst>
__device__ __forceinline__ void blend_views(const float* __restrict__ w, int G,
                                            int V, bool active, float* w_s,
                                            Dst dst, Pixel pixel) {
  for (int v0 = 0; v0 < V; v0 += kViewChunk) {
    const int vn = V - v0 < kViewChunk ? V - v0 : kViewChunk;
    __syncthreads();  // previous chunk done with w_s (and the caller's set-up)
    for (int i = threadIdx.x; i < kViewChunk * G; i += blockDim.x) {
      const int vv = i / G;
      w_s[i] = vv < vn ? w[(int64_t)(v0 + vv) * G + (i - vv * G)] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    if (kHalfTail && vn <= kViewChunk / 2)
      blend_chunk<kViewChunk / 2>(w_s, G, v0, vn, dst, pixel);
    else
      blend_chunk<kViewChunk>(w_s, G, v0, vn, dst, pixel);
  }
}

}  // namespace lfi
