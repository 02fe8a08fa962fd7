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
//     by the kernel that owns the load, then reused by every chunk of
//     kViewChunk views;
//   * the weights are staged as fp16 [kViewChunk, G] per chunk;
//   * the result bytes are transposed through shared memory so that each
//     thread stores 16 consecutive bytes of one view's row.
// Rows of both shared operands are padded by 16 bytes, which spreads the 8
// rows of an ldmatrix over all banks.
//
// Grids of many images: a grid of at most kGridChunk (96) images is one
// pass, staged once per pixel tile as before. A larger grid is staged in
// passes of kPassRows (64) images, each pass's products added to f32
// accumulators that stay in registers from the first pass to the last.
// Staging all G images at once would take one block's shared memory past
// what an SM holds twice (128.75 KB at G = 289), and the loads in flight
// of the other resident blocks are what hides the latency of the operand
// loads and gathers. Each kernel is compiled twice from one body, picked
// by G: for one pass, and with the loop of later passes. The accumulators
// live across a later pass's loads raise shift_blend's registers from 96
// to 168 a thread, which in a one-pass kernel would cut the blocks on an
// SM from five to three and cost 27% at G = 64 (NVIDIA H100 80GB HBM3,
// 700 W); the one-pass instantiation has no such loop and keeps 96.
//
// Numerics: u8 pixels and fp16-valued weights are exact fp16 operands (the
// callers guarantee fp16-valued weights, see ops/shift_blend.py), every
// product is exact, and k runs over g in ascending steps of 16 with G padded
// by zero weights, so a pixel's sum depends on its own G products only, not
// on how views are chunked, padded or batched, nor on how the images are
// split into passes: the passes issue the same mma steps on the same
// accumulator in the same order as one pass would. The tensor cores add in
// their own order inside a step, so the result is not bit-equal to a
// sequential f32 sum. It obeys the near-tie rule: where the exact sum lies
// further than 2^-8 from a half-integer the byte is clip(rint(sum))
// exactly, elsewhere it is one of the two neighbouring bytes. Rounding is
// half to even (__float2int_rn), then clip, then cast.
//
// Why the rule holds up to kMaxGrid = 512 images. The weights of a render
// are >= 0 and sum to 1 within fp16 rounding (< 1 + 2^-10), so every
// partial sum of products, in any order, lies in [0, 256) and its f32 ulp
// is at most 2^-16. An mma step adds its 16 exact products and the f32
// accumulator aligned to the largest exponent among them, truncating each
// below a few bits past the f32 significand, and normalises once,
// truncating (the published models of these tensor cores, Volta to Hopper:
// Fasi, Higham, Mikaitis and Pranesh, PeerJ Computer Science 2021; Khattak
// and Mikaitis 2025). With 2 such bits a step errs by less than
// 17 * 2^-18 + 2^-16 = 5.25 * 2^-16, and by less than 2 * (9 * 2^-18 +
// 2^-16) = 6.5 * 2^-16 were it done as two halves of 8 products. Over the
// Gp / 16 steps: 6.5 * 2^-16 * 32 = 3.2e-3 at G = 512 and 1.9e-3 at G = 289,
// under the band 2^-8 = 3.9e-3, so a byte whose exact sum lies further than
// the band from a half-integer rounds to clip(rint(sum)). A card test
// (tests/test_torch_wide_grid.py) plants at G = 512 products whose low bits
// such truncation drops, 255/256 of an ulp each, which hardware without
// those bits would turn into rule breaks. 512 is also as far as
// shift_blend's resident fp16 weights [kViewChunk, Gp] leave two blocks
// on an SM.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lfi {

constexpr int kThreads = 128;   // 4 warps per blend block
constexpr int kViewChunk = 64;  // views per contraction: 4 mma row tiles
constexpr int kMaxGrid = 512;   // largest G (images) the blend kernels take
constexpr int kGridChunk = 96;  // most images a grid of one pass has
constexpr int kPassRows = 64;   // images a pass of a larger grid stages
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

// The passes of a blend over G images: a padded grid of at most
// kGridChunk images is one pass; a larger one is staged kPassRows images a
// pass, the last pass taking the rest (a multiple of 16).
__host__ __device__ constexpr int grid_chunk(int G) {
  return padded_grid(G) <= kGridChunk ? padded_grid(G) : kPassRows;
}
__host__ __device__ constexpr int grid_passes(int G) {
  return (padded_grid(G) + grid_chunk(G) - 1) / grid_chunk(G);
}
static_assert(kGridChunk % 16 == 0 && kPassRows % 16 == 0, "passes hold whole mma k steps");

// The shared-memory layout of a blend block with kNT mma column tiles per
// warp: a pixel tile of kP = 32 * kNT pixels of one image row.
//   w_s    [kViewChunk][w_cols + kRowPad] fp16  the chunk's weights
//   out_s  [kViewChunk][kP + 16] u8             the chunk's result bytes
//   x_s    [x_rows][kP + kRowPad] fp16          one pass's staged operand
//   tables                                      the kernel's per-image tables
// w_cols is Gp where a block keeps all its weights (shift_blend), else the
// pass's images; x_rows is grid_chunk(G).
template <int kNT>
struct BlendTile {
  static_assert(kNT % 2 == 0, "ldmatrix.x4 loads two column tiles at once");
  static constexpr int kP = 32 * kNT;
  static constexpr int kXStride = kP + kRowPad;  // fp16 values per x_s row
  static constexpr int kOutStride = kP + 16;     // bytes per out_s row

  __host__ __device__ static constexpr int w_stride(int w_cols) { return w_cols + kRowPad; }
  __host__ __device__ static constexpr size_t w_bytes(int w_cols) {
    return (size_t)kViewChunk * w_stride(w_cols) * sizeof(__half);
  }
  __host__ __device__ static constexpr size_t out_bytes() {
    return (size_t)kViewChunk * kOutStride;
  }
  __host__ __device__ static constexpr size_t x_bytes(int x_rows) {
    return (size_t)x_rows * kXStride * sizeof(__half);
  }
  __host__ __device__ static constexpr size_t smem_bytes(int w_cols, int x_rows,
                                                         size_t tables) {
    return w_bytes(w_cols) + out_bytes() + x_bytes(x_rows) + tables;
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

// The chunk's weights w[v0 .. v0 + vn, g0 .. g0 + cols) as fp16 into w_s
// (rows of `stride` values, column g at g - g0), rows past vn and columns
// past G zero. Exact for fp16-valued weights. Four weights a load where G
// and the matrix's address allow it. g0 and cols are multiples of 16.
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, int G,
                                              int g0, int cols, int stride, int v0,
                                              int vn, __half* w_s) {
  if ((G & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const int quads = cols / 4;
    for (int i = threadIdx.x; i < kViewChunk * quads; i += kThreads) {
      const int vv = i / quads;
      const int j = (i - vv * quads) * 4;
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (vv < vn && g0 + j < G)
        f = __ldg(reinterpret_cast<const float4*>(w + (int64_t)(v0 + vv) * G + g0 + j));
      const __half2 lo = __floats2half2_rn(f.x, f.y);
      const __half2 hi = __floats2half2_rn(f.z, f.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(w_s + vv * stride + j) = packed;
    }
    return;
  }
  for (int i = threadIdx.x; i < kViewChunk * cols; i += kThreads) {
    const int vv = i / cols;
    const int j = i - vv * cols;
    const float f =
        (vv < vn && g0 + j < G) ? __ldg(w + (int64_t)(v0 + vv) * G + g0 + j) : 0.0f;
    w_s[vv * stride + j] = __float2half_rn(f);
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

// A thread's f32 accumulators of one chunk of views: row tile mt, column
// tile nt, the four values of an mma fragment. Held in registers from a
// tile's first pass to its store.
template <int kNT>
struct BlendAcc {
  float c[4][kNT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mt][nt][i] = 0.0f;
  }
};

// One pass of the contraction, by all threads of the block: acc +=
// w_s[0 .. vn, 0 .. rows) . x_s[0 .. rows, tile), k ascending in steps of
// 16. w_s is the pass's first weight column, in rows of `w_stride` values
// (a multiple of 8). Warp i owns pixel columns [8 * kNT * i,
// 8 * kNT * (i + 1)) for all the chunk's views; row tiles past vn are
// skipped. w_s and x_s must be staged and visible (a __syncthreads()
// since); the caller syncs again before overwriting either.
template <int kNT>
__device__ __forceinline__ void contract(BlendAcc<kNT>& acc, const __half* x_s,
                                         const __half* w_s, int w_stride, int rows,
                                         int vn) {
  using T = BlendTile<kNT>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

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

  for (int k0 = 0; k0 < rows; k0 += 16) {  // ascending g, always in this order
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
          mma_m16n8k16(acc.c[mt][nt], a, b[nt / 2][(nt & 1) * 2],
                       b[nt / 2][(nt & 1) * 2 + 1]);
      }
    }
  }
}

// The chunk's bytes, by all threads of the block: the accumulators rounded
// into out_s, then view v0 + vv's kP bytes (those with x0 + p < W) to
// dst(v0 + vv), the address of the tile's first pixel in that view's row.
// Every thread must have finished its last contract() (out_s lies apart
// from w_s and x_s, so no barrier is needed before the bytes go in); on
// return every thread has passed a barrier after its last access, so the
// caller may overwrite any of the shared buffers.
template <int kNT, class Dst>
__device__ __forceinline__ void store_tile(const BlendAcc<kNT>& acc, uint8_t* out_s,
                                           int v0, int vn, int x0, int W, Dst dst) {
  using T = BlendTile<kNT>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

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
          const float(&c)[4] = acc.c[mt][nt];
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
