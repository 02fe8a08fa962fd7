// Device helpers shared by the port's kernels: the oracle's coordinate rule
// and the view contraction of the two blend kernels (shift_blend.cu,
// allfocus_blend.cu).
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

// All V views of one thread's output pixel (c, y, x):
//   dst[v * view_stride] = u8(clamp(rint(sum_{g = 0..G-1} w[v, g] * pixel(g)), 0, 255))
// summed in f32 in ascending g as __fadd_rn(acc, __fmul_rn(w, p)), views in
// chunks of kViewChunk held in registers, each chunk's weights staged in
// `w_s` ([kViewChunk * kMaxGrid] shared floats, read as broadcasts).
// `pixel(g)` is the kernel's operand load, called once per g and chunk.
// Every thread of the block calls this (it synchronises, also covering the
// caller's own shared-memory set-up); `active` is false past the row's end.
template <class Pixel>
__device__ __forceinline__ void blend_views(const float* __restrict__ w, int G,
                                            int V, bool active, float* w_s,
                                            uint8_t* dst, int64_t view_stride,
                                            Pixel pixel) {
  for (int v0 = 0; v0 < V; v0 += kViewChunk) {
    const int vn = V - v0 < kViewChunk ? V - v0 : kViewChunk;
    __syncthreads();  // previous chunk done with w_s (and the caller's set-up)
    for (int i = threadIdx.x; i < kViewChunk * G; i += blockDim.x) {
      const int vv = i / G;
      w_s[i] = vv < vn ? w[(int64_t)(v0 + vv) * G + (i - vv * G)] : 0.0f;
    }
    __syncthreads();
    if (active) {
      float acc[kViewChunk];
#pragma unroll
      for (int vv = 0; vv < kViewChunk; ++vv) acc[vv] = 0.0f;
      for (int g = 0; g < G; ++g) {
        const float p = pixel(g);
#pragma unroll
        for (int vv = 0; vv < kViewChunk; ++vv)
          acc[vv] = __fadd_rn(acc[vv], __fmul_rn(w_s[vv * G + g], p));
      }
#pragma unroll
      for (int vv = 0; vv < kViewChunk; ++vv) {
        if (vv < vn) {
          int q = __float2int_rn(acc[vv]);
          q = q < 0 ? 0 : (q > 255 ? 255 : q);
          dst[(int64_t)(v0 + vv) * view_stride] = (uint8_t)q;
        }
      }
    }
  }
}

}  // namespace lfi
