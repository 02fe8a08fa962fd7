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
//     sums for views 0..n-1 only (n = cols * rows), view v's bytes stored at
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
// Bound: bytes. At the headline frame (8x8 grid, 1080x1920, 64 views) the
// kernel must read 398 MB and write 398 MB (0.238 ms at the card's memory
// rate) and do 51 GFLOP (0.05 ms on the tensor cores). What the design does
// about it: a block owns 128 pixels of one image row, for all channels in
// turn. The shift is constant per image, so a channel's operand is, per g,
// one contiguous span of row clamp(y + dy_g): each thread loads 16 pixels
// of it as five aligned 4-byte words, removes the byte misalignment with a
// funnel shift, converts to fp16 and stages them in shared memory once for
// every view (spans that touch an edge of the row take clamped byte loads).
// A thread issues the loads of four spans before it converts the first, so
// that their latencies overlap.
// lfi::contract then contracts the staged tile with the weights on the
// tensor cores, 64 views at a time, and lfi::store_tile stores 16 bytes per
// thread. The weights of all G images stay staged, once per block when
// there are at most 64 views, once per channel and chunk otherwise. A grid
// of more than lfi::kGridChunk images is staged in passes of
// lfi::kPassRows images, the sums carried in registers from pass to pass:
// at G = 289, five passes (the last of 48 images), 67.4 KB of shared memory
// a block, three blocks to an SM where all 289 images at once would leave
// one. Staging each pass's weights instead, in 37.4 KB, took 1.95 ms
// against 1.29 at G = 289 (three times the weights read, on top of the
// operand); passes of 80 and 128 images took 1.43 and 1.66 ms.
//
// Numerics: the near-tie rule of lfi_common.cuh (exact fp16 operands, f32
// tensor-core sums in ascending steps of 16 over g, round half to even,
// clip, cast): the byte is clip(rint(exact sum)) wherever the exact sum is
// further than 2^-8 from a half-integer, else one of the two neighbours;
// at most 1 LSB from the NumPy oracle (ops/reference.py blend_fixed) and
// the plain version. A pixel's byte does not depend on the number of views
// in the launch, so batches and chunks of views are bit-equal to one pass.

#include "lfi_common.cuh"

namespace {

using lfi::kMaxGrid;
using lfi::kThreads;
using lfi::kViewChunk;

constexpr int kNT = 4;  // 8-pixel mma column tiles per warp: 128-pixel tiles
using Tile = lfi::BlendTile<kNT>;

// The five aligned 4-byte words that cover the 16 pixels
// img_row[sx0 .. sx0 + 16) when the span lies inside the row. The words may
// cover up to 3 bytes on either side of the span, inside the tensor
// [lo, hi) but outside the row. A span that touches an edge of the row (or
// the tensor's first or last bytes) is an `edge` span: its words stay zero
// and finish_span16 loads it byte by byte. A span of a row that is not
// `real` (a zero row that pads G) has zero words and is no edge span.
// Issued apart from their use and without a branch, so that a thread's
// loads of several spans are in flight together.
struct Span16 {
  uint32_t wd[5];
  uint32_t shift;  // bits to drop from wd[0]
  bool edge;
};

__device__ __forceinline__ Span16 load_span16(const uint8_t* __restrict__ img_row,
                                              int W, int sx0, bool real,
                                              const uint8_t* lo, const uint8_t* hi) {
  Span16 s;
  const uintptr_t ai = reinterpret_cast<uintptr_t>(img_row + sx0);
  const uint32_t* const a0 = reinterpret_cast<const uint32_t*>(ai & ~(uintptr_t)3);
  s.shift = (uint32_t)(ai & 3) * 8;
  const bool inside = sx0 >= 0 && sx0 + 16 <= W &&
                      reinterpret_cast<const uint8_t*>(a0) >= lo &&
                      reinterpret_cast<const uint8_t*>(a0 + 5) <= hi;
  s.edge = real && !inside;
#pragma unroll
  for (int k = 0; k < 5; ++k) s.wd[k] = (real && inside) ? __ldg(a0 + k) : 0u;
  return s;
}

// 16 pixels img_row[clamp(sx0 + k, 0, W - 1)], k = 0..15, as fp16 to dst
// (32 bytes, 16-byte aligned): from the words of load_span16, or, for an
// edge span, from clamped byte loads.
__device__ __forceinline__ void finish_span16(const Span16& s,
                                              const uint8_t* __restrict__ img_row,
                                              int W, int sx0, __half* dst) {
  uint32_t px[4];
  if (!s.edge) {
#pragma unroll
    for (int k = 0; k < 4; ++k) px[k] = __funnelshift_r(s.wd[k], s.wd[k + 1], s.shift);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= (uint32_t)img_row[lfi::clamp_index(sx0 + 4 * k + b, W)] << (8 * b);
      px[k] = word;
    }
  }
  uint4 h[2];
  h[0].x = lfi::bytes_to_half2(px[0], 0x4140);
  h[0].y = lfi::bytes_to_half2(px[0], 0x4342);
  h[0].z = lfi::bytes_to_half2(px[1], 0x4140);
  h[0].w = lfi::bytes_to_half2(px[1], 0x4342);
  h[1].x = lfi::bytes_to_half2(px[2], 0x4140);
  h[1].y = lfi::bytes_to_half2(px[2], 0x4342);
  h[1].z = lfi::bytes_to_half2(px[3], 0x4140);
  h[1].w = lfi::bytes_to_half2(px[3], 0x4342);
  reinterpret_cast<uint4*>(dst)[0] = h[0];
  reinterpret_cast<uint4*>(dst)[1] = h[1];
}

// Stages rows [g0, g0 + rows) of channel c's operand for the block's tile
// into x_s (row g - g0), as fp16: row g is the span of image g's row
// src_row[g] from x0 + dx_s[g]. A thread's spans go kBatch at a time: all
// their words are loaded before the first is converted, so the loads'
// latencies overlap. Rows g >= G are the zero rows that pad G to a
// multiple of 16.
__device__ __forceinline__ void stage_spans(const uint8_t* __restrict__ img, int G,
                                            int C, int W, int64_t plane, int c,
                                            int x0, const int* src_row,
                                            const int* dx_s, int g0, int rows,
                                            const uint8_t* img_end, __half* x_s) {
  constexpr int kSpans = Tile::kP / 16;  // 16-pixel spans per staged row
  constexpr int kBatch = 4;              // spans a thread has in flight
  for (int q0 = threadIdx.x; q0 < rows * kSpans; q0 += kBatch * kThreads) {
    Span16 span[kBatch];
    const uint8_t* row[kBatch];
    int sx0[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * kThreads;
      const int g = g0 + q / kSpans;
      const bool real = g < G;
      const int gi = real ? g : 0;  // the tables hold g < G only
      row[u] = img + ((int64_t)gi * C + c) * plane + (int64_t)(real ? src_row[gi] : 0) * W;
      sx0[u] = x0 + (q % kSpans) * 16 + (real ? dx_s[gi] : 0);
      span[u] = load_span16(row[u], W, sx0[u], real, img, img_end);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * kThreads;
      if (q < rows * kSpans)
        finish_span16(span[u], row[u], W, sx0[u],
                      x_s + (q / kSpans) * Tile::kXStride + (q % kSpans) * 16);
    }
  }
}

// Dynamic shared memory of a block: all its weights, one pass's operand
// and the two per-image tables.
__host__ __device__ constexpr size_t smem_bytes(int G) {
  return Tile::smem_bytes(lfi::padded_grid(G), lfi::grid_chunk(G),
                          2 * lfi::padded_grid(G) * sizeof(int));
}

// Renders rows [r0, r0 + hb) of the frame: block row j is image row
// y = r0 + j, and the shifts clamp against the full H. kQuilt: `out` is the
// [C, (V / cols) * H, cols * W] canvas (r0 = 0, hb = H), else [V, C, hb, W].
// kPasses: G takes more than one pass (lfi::grid_passes). Dynamic shared
// memory: smem_bytes(G).
template <bool kQuilt, bool kPasses>
__global__ void __launch_bounds__(kThreads)
shift_blend_kernel(const uint8_t* __restrict__ img,    // [G, C, H, W]
                   const float* __restrict__ w,        // [V, G], fp16-valued
                   const int32_t* __restrict__ shifts,  // [G, 2] (dx, dy), |dx|<=W, |dy|<=H
                   uint8_t* __restrict__ out,
                   int G, int C, int H, int W, int V, int cols,
                   int r0, int hb, int tiles_x) {
  extern __shared__ uint4 smem[];
  const int Gp = lfi::padded_grid(G);
  const int Gc = kPasses ? lfi::grid_chunk(G) : Gp;  // images a pass stages
  const int w_stride = Tile::w_stride(Gp);
  __half* const w_s = reinterpret_cast<__half*>(smem);
  uint8_t* const out_s = reinterpret_cast<uint8_t*>(smem) + Tile::w_bytes(Gp);
  __half* const x_s = reinterpret_cast<__half*>(out_s + Tile::out_bytes());
  int* const src_row = reinterpret_cast<int*>(  // clamp(y + dy_g, 0, H-1)
      reinterpret_cast<uint8_t*>(x_s) + Tile::x_bytes(Gc));
  int* const dx_s = src_row + Gp;

  const int yb = blockIdx.x / tiles_x;  // row of the block
  const int x0 = (blockIdx.x - yb * tiles_x) * Tile::kP;
  const int y = r0 + yb;  // row of the frame

  for (int g = threadIdx.x; g < G; g += kThreads) {
    src_row[g] = lfi::clamp_index(y + shifts[2 * g + 1], H);
    dx_s[g] = shifts[2 * g];
  }
  __syncthreads();

  const int64_t plane = (int64_t)H * W;
  const int64_t out_plane = (int64_t)hb * W;
  const int64_t canvas_w = (int64_t)cols * W;
  const uint8_t* const img_end = img + (int64_t)G * C * plane;

  for (int c = 0; c < C; ++c) {
    for (int v0 = 0; v0 < V; v0 += kViewChunk) {
      const int vn = V - v0 < kViewChunk ? V - v0 : kViewChunk;
      // The first pass (the only one where the grid fits one): its operand
      // is staged while no sums are live. One pass stages the channel once
      // for every chunk of views. The weights of all G images stay staged:
      // once per block when there are at most 64 views, once per channel
      // and chunk otherwise.
      if (v0 == 0 || kPasses)
        stage_spans(img, G, C, W, plane, c, x0, src_row, dx_s, 0, Gc, img_end, x_s);
      if (c == 0 || V > kViewChunk) lfi::stage_weights(w, G, 0, Gp, w_stride, v0, vn, w_s);
      __syncthreads();
      lfi::BlendAcc<kNT> acc;
      acc.zero();
      lfi::contract<kNT>(acc, x_s, w_s, w_stride, Gc, vn);
      // Later passes add to the sums in registers.
      if (kPasses) {
        for (int g0 = Gc; g0 < Gp; g0 += Gc) {
          const int rows = Gp - g0 < Gc ? Gp - g0 : Gc;
          __syncthreads();  // every warp is done with the last pass's operand
          stage_spans(img, G, C, W, plane, c, x0, src_row, dx_s, g0, rows, img_end, x_s);
          __syncthreads();
          lfi::contract<kNT>(acc, x_s, w_s + g0, w_stride, rows, vn);
        }
      }
      lfi::store_tile<kNT>(acc, out_s, v0, vn, x0, W, [&](int v) {
        if (kQuilt)  // view v's tile (v / cols, v % cols) of channel c's canvas plane
          return out + ((int64_t)c * (V / cols) * H + (int64_t)(v / cols) * H + y) * canvas_w +
                 (int64_t)(v % cols) * W + x0;
        return out + ((int64_t)v * C + c) * out_plane + (int64_t)yb * W + x0;
      });
    }
  }
}

// The kernel for G images: the one-pass instantiation where the grid
// fits one pass, else the one that runs later passes.
template <bool kQuilt>
auto kernel_for(int G) {
  return lfi::grid_passes(G) > 1 ? shift_blend_kernel<kQuilt, true>
                                 : shift_blend_kernel<kQuilt, false>;
}

// Sets the kernel's dynamic shared memory for G images; more than 48 KB
// must be asked for, and a refusal is the launch's error.
template <bool kQuilt>
cudaError_t prepare(int G) {
  return cudaFuncSetAttribute(kernel_for<kQuilt>(G),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(G));
}

template <bool kQuilt>
int launch(const uint8_t* img, const float* w, const int32_t* shifts, uint8_t* out,
           int G, int C, int H, int W, int V, int cols, int r0, int hb,
           cudaStream_t stream) {
  const int64_t tiles_x = (W + Tile::kP - 1) / Tile::kP;
  const int64_t blocks = (int64_t)hb * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = prepare<kQuilt>(G);
  if (err != cudaSuccess) return (int)err;
  kernel_for<kQuilt>(G)<<<(unsigned)blocks, kThreads, smem_bytes(G), stream>>>(
      img, w, shifts, out, G, C, H, W, V, cols, r0, hb, (int)tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest G the kernel takes (the wrapper checks against it).
int lfi_shift_blend_max_grid(void) { return kMaxGrid; }

// The passes over the images each pixel tile of a blend of G images runs
// (shift_blend, its quilt instantiation and allfocus_blend alike).
int lfi_blend_grid_passes(int G) { return lfi::grid_passes(G); }

// Dynamic shared memory of a block for G images, in bytes.
int lfi_shift_blend_smem_bytes(int G) { return (int)smem_bytes(G); }

// Blocks of the kernel resident on one SM for G images, as the runtime's
// occupancy calculator gives them, or minus the CUDA error.
int lfi_shift_blend_blocks_per_sm(int G) {
  if (G < 1 || G > kMaxGrid) return -(int)cudaErrorInvalidValue;
  cudaError_t err = prepare<false>(G);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_for<false>(G),
                                                        kThreads, smem_bytes(G));
  return err == cudaSuccess ? n : -(int)err;
}

// Rows [r0, r0 + hb) of the render into `out` [V, C, hb, W]; r0 = 0 and
// hb = H render the frame. Launches on `stream`; does not synchronise and
// allocates nothing. Returns the launch's CUDA error (0 on success).
int lfi_shift_blend(const uint8_t* img, const float* w, const int32_t* shifts,
                    uint8_t* out, int G, int C, int H, int W, int V, int r0,
                    int hb, cudaStream_t stream) {
  if (G < 1 || G > kMaxGrid || C < 1 || H < 1 || W < 1 || V < 1 || r0 < 0 ||
      hb < 1 || hb > H - r0)
    return (int)cudaErrorInvalidValue;
  return launch<false>(img, w, shifts, out, G, C, H, W, V, 1, r0, hb, stream);
}

// The quilt instantiation: blends views 0..cols*rows-1 (the first
// cols * rows rows of `w`) straight into the canvas `out`,
// [C, rows * H, cols * W] uint8, view v at tile (v / cols, v % cols).
int lfi_quilt_blend(const uint8_t* img, const float* w, const int32_t* shifts,
                    uint8_t* out, int G, int C, int H, int W, int cols,
                    int rows, cudaStream_t stream) {
  if (G < 1 || G > kMaxGrid || C < 1 || H < 1 || W < 1 || cols < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  return launch<true>(img, w, shifts, out, G, C, H, W, cols * rows, cols, 0, H, stream);
}

const char* lfi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
