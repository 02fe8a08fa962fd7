// Device helpers shared by the port's kernels: the oracle's coordinate rule
// and the view contraction of the blend kernels (shift_blend.cu, with its
// quilt instantiation, and allfocus_blend.cu).
//
// The contraction replaces the matrix-unit products of the JAX package's
// blend kernels (blend_pallas._blend_kernel, _blend_tiled_kernel and
// _blend_quilt_kernel, lfinterpolator_tpu/ops/blend_pallas.py:165, 217, 311:
// jnp.dot with f32 sums on the MXU). Per block and pixel tile it is
//
//   out[V, P] = W[V, G] . X[G, P]
//
// on the tensor cores: mma.sync.aligned.m16n8k16 with fp16 operands and f32
// sums, fragments read from shared memory with ldmatrix (.trans for X,
// which lies pixel-major). mma.sync rather than wgmma: the headline frame
// is 51 GFLOP against 796 MB of traffic, so a fraction of the tensor peak
// already leaves the kernels bound by memory, and mma.sync takes plain
// padded rows in shared memory where wgmma wants descriptors and swizzled
// layouts.
//
// What the design does about the bound (bytes):
//   * the operand tile X is converted to fp16 and staged in shared memory
//     once per pixel tile by the kernel that owns the load, then reused by
//     every chunk of kViewChunk views;
//   * the weights are staged as fp16 [kViewChunk, G] per chunk;
//   * the result bytes are transposed through shared memory so that each
//     thread stores 16 consecutive bytes of one view's row.
// Rows of both shared operands are padded by 16 bytes, which spreads the 8
// rows of an ldmatrix over all banks.
//
// Numerics: u8 pixels and fp16-valued weights are exact fp16 operands (the
// callers guarantee fp16-valued weights, see ops/shift_blend.py), every
// product is exact, and k runs over g in ascending steps of 16 with G padded
// by zero weights, so a pixel's sum depends on its own G products only, not
// on how views are chunked, padded or batched. The tensor cores add in
// their own order inside a step, so the result is not bit-equal to a
// sequential f32 sum. It obeys the near-tie rule: where the exact sum lies
// further than 2^-8 from a half-integer the byte is clip(rint(sum))
// exactly, elsewhere it is one of the two neighbouring bytes. Rounding is
// half to even (__float2int_rn), then clip, then cast.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lfi {

constexpr int kThreads = 128;   // 4 warps per blend block
constexpr int kViewChunk = 64;  // views per contraction: 4 mma row tiles
constexpr int kMaxGrid = 256;   // largest G (images) the blend kernels take
constexpr int kRowPad = 8;      // fp16 values appended to each shared row

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

__host__ __device__ constexpr int padded_grid(int G) { return (G + 15) / 16 * 16; }

// The shared-memory layout of a blend block with kNT mma column tiles per
// warp: a pixel tile of kP = 32 * kNT pixels of one image row.
//   w_s   [kViewChunk][Gp + kRowPad] fp16   the chunk's weights
//   out_s [kViewChunk][kP + 16] u8          the chunk's result bytes
//   x_s   [channels][Gp][kP + kRowPad] fp16 the staged operand
template <int kNT>
struct BlendTile {
  static_assert(kNT % 2 == 0, "ldmatrix.x4 loads two column tiles at once");
  static constexpr int kP = 32 * kNT;
  static constexpr int kXStride = kP + kRowPad;  // fp16 values per x_s row
  static constexpr int kOutStride = kP + 16;     // bytes per out_s row

  __host__ __device__ static constexpr int w_stride(int Gp) { return Gp + kRowPad; }
  __host__ __device__ static constexpr size_t w_bytes(int Gp) {
    return (size_t)kViewChunk * w_stride(Gp) * sizeof(__half);
  }
  __host__ __device__ static constexpr size_t out_bytes() {
    return (size_t)kViewChunk * kOutStride;
  }
  __host__ __device__ static constexpr size_t x_bytes(int Gp) {
    return (size_t)Gp * kXStride * sizeof(__half);  // of one channel
  }
  __host__ __device__ static constexpr size_t smem_bytes(int Gp, int channels) {
    return w_bytes(Gp) + out_bytes() + channels * x_bytes(Gp);
  }
};

// Two pixel bytes of `word` (selected by `sel`, a PRMT selector that puts
// them under the 0x64 exponent bytes) as two exact fp16 values: 0x6400 | b
// is 1024 + b, and the subtraction is exact.
__device__ __forceinline__ uint32_t bytes_to_half2(uint32_t word, uint32_t sel) {
  const uint32_t biased = __byte_perm(word, 0x64646464u, sel);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&biased),
                            __half2half2(__ushort_as_half(0x6400)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The chunk's weights w[v0 .. v0 + vn, 0 .. G] as fp16 into w_s, rows past
// vn and columns past G zero. Exact for fp16-valued weights. Four weights a
// load where G and the matrix's address allow it.
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, int G,
                                              int Gp, int v0, int vn,
                                              __half* w_s) {
  const int stride = Gp + kRowPad;
  if ((G & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const int quads = Gp / 4;
    for (int i = threadIdx.x; i < kViewChunk * quads; i += kThreads) {
      const int vv = i / quads;
      const int g = (i - vv * quads) * 4;
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (vv < vn && g < G)
        f = __ldg(reinterpret_cast<const float4*>(w + (int64_t)(v0 + vv) * G + g));
      const __half2 lo = __floats2half2_rn(f.x, f.y);
      const __half2 hi = __floats2half2_rn(f.z, f.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(w_s + vv * stride + g) = packed;
    }
    return;
  }
  for (int i = threadIdx.x; i < kViewChunk * Gp; i += kThreads) {
    const int vv = i / Gp;
    const int g = i - vv * Gp;
    const float f = (vv < vn && g < G) ? __ldg(w + (int64_t)(v0 + vv) * G + g) : 0.0f;
    w_s[vv * stride + g] = __float2half_rn(f);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16, 8] += a[16, 16] . b[16, 8], fp16 operands, f32 sums.
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t round_byte(float v) {
  const int q = __float2int_rn(v);
  return (uint32_t)(q < 0 ? 0 : (q > 255 ? 255 : q));
}

// One chunk of views of one staged channel tile, by all threads of the
// block: the contraction of w_s (vn <= kViewChunk rows) with x_s over Gp,
// the bytes through out_s, then view v0 + vv's kP bytes (those with
// x0 + p < W) to dst(v0 + vv), the address of the tile's first pixel in
// that view's row. Warp i owns pixel columns [8 * kNT * i, 8 * kNT * (i + 1))
// for all the chunk's views. Row tiles past vn are skipped.
// w_s and x_s must be staged and visible (a __syncthreads() since); on
// return every thread has passed a barrier after its last access, so the
// caller may overwrite any of the three buffers.
template <int kNT, class Dst>
__device__ __forceinline__ void blend_tile(const __half* x_s, const __half* w_s,
                                           uint8_t* out_s, int Gp, int v0, int vn,
                                           int x0, int W, Dst dst) {
  using T = BlendTile<kNT>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w_stride = T::w_stride(Gp);

  float acc[4][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  // ldmatrix.x4: lanes 8m .. 8m + 7 address the rows of matrix m.
  //   W (row-major [view][g]): matrices (views 0-7, g 0-7), (views 8-15,
  //   g 0-7), (views 0-7, g 8-15), (views 8-15, g 8-15): the a0..a3 of mma.
  //   X ([g][pixel], transposed on load): (g 0-7, px 0-7), (g 8-15, px 0-7),
  //   (g 0-7, px 8-15), (g 8-15, px 8-15): b0, b1 of two column tiles.
  const int m = lane >> 3, r = lane & 7;
  const uint32_t a_base =
      smem_addr(w_s + ((m & 1) * 8 + r) * w_stride + (m >> 1) * 8);
  const uint32_t b_base = smem_addr(
      x_s + ((m & 1) * 8 + r) * T::kXStride + warp * 8 * kNT + (m >> 1) * 8);

  for (int k0 = 0; k0 < Gp; k0 += 16) {  // ascending g, always in this order
    uint32_t b[kNT / 2][4];
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np)
      ldmatrix_x4_trans(b[np], b_base + (uint32_t)(k0 * T::kXStride + np * 16) *
                                            (uint32_t)sizeof(__half));
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt * 16 < vn) {
        uint32_t a[4];
        ldmatrix_x4(a, a_base + (uint32_t)(mt * 16 * w_stride + k0) *
                                    (uint32_t)sizeof(__half));
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_m16n8k16(acc[mt][nt], a, b[nt / 2][(nt & 1) * 2],
                       b[nt / 2][(nt & 1) * 2 + 1]);
      }
    }
  }

  // The accumulator fragment holds rows lane / 4 and lane / 4 + 8, columns
  // 2 * (lane % 4) and the next: two bytes per store into out_s.
  {
    uint8_t* const o = out_s + (lane >> 2) * T::kOutStride + warp * 8 * kNT +
                       2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt * 16 < vn) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float(&c)[4] = acc[mt][nt];
          uint8_t* const p = o + mt * 16 * T::kOutStride + nt * 8;
          *reinterpret_cast<uint16_t*>(p) =
              (uint16_t)(round_byte(c[0]) | (round_byte(c[1]) << 8));
          *reinterpret_cast<uint16_t*>(p + 8 * T::kOutStride) =
              (uint16_t)(round_byte(c[2]) | (round_byte(c[3]) << 8));
        }
      }
    }
  }
  __syncthreads();

  // 16 consecutive bytes of one view's row per thread; bytes where the
  // address is not 16-byte aligned or the row ends inside the segment.
  constexpr int kSegs = T::kP / 16;
  for (int i = threadIdx.x; i < vn * kSegs; i += kThreads) {
    const int vv = i / kSegs;
    const int seg = i - vv * kSegs;
    const int x = x0 + seg * 16;
    if (x >= W) continue;
    const uint8_t* const s = out_s + vv * T::kOutStride + seg * 16;
    uint8_t* const d = dst(v0 + vv) + seg * 16;
    if (x + 16 <= W && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int k = 0; k < 16 && x + k < W; ++k) d[k] = s[k];
    }
  }
  __syncthreads();
}

}  // namespace lfi
