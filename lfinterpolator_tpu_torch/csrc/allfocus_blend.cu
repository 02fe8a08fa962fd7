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
// because TPU gathers are slow; here each pixel's focus is decoded once (a
// 256-entry table built on the host, so no division runs on the device)
// and its G source pixels are gathered directly, so the selected stack
// never exists in device memory. One kernel serves both methods: the
// caller passes the filtered map (STD) or the raw map (TEN).
//
// Bound: bytes, as the fixed render (0.238 ms of traffic at the headline
// frame against 0.05 ms of tensor-core work); what the kernel spends beyond
// that goes to the gather: 398 M byte loads a frame, each its own 32-byte
// sector where neighbouring pixels differ in focus. What the design does
// about it: a block owns 128 pixels of one row of one channel. A thread
// takes one pixel: it decodes the pixel's focus once, then for 8 images at
// a time computes the source coordinates and issues the 8 byte loads
// together, so that their latencies overlap, and stages the fp16 values in
// shared memory, where they serve every view chunk's contraction
// (lfi::blend_tile: tensor cores, 16-byte stores). Loads coalesce along x
// wherever neighbouring pixels share their focus.
// Blocks are ordered channel by channel. A block that staged all three
// channels of its pixels would compute each coordinate once instead of
// three times, and measured 1.0 ms against this kernel's 1.5 ms where the
// map is coherent; but on a map of per-pixel noise, where a source sector
// is used by pixels many rows apart, three times as many source planes in
// flight overran the caches and it took 3.0 to 5.3 ms against 1.9 ms
// (NVIDIA H100 80GB HBM3, 700 W; headline frame). The even time was kept.
//
// Numerics: coordinates as the oracle (ops/reference.py blend_allfocus):
// trunc(__fadd_rn(f32(q), __fmul_rn(f, o))), clamped, so the select is
// bit-exact; the contraction obeys the near-tie rule of lfi_common.cuh: the
// byte is clip(rint(exact sum)) wherever the exact sum is further than 2^-8
// from a half-integer, else one of the two neighbours; at most 1 LSB from
// the oracle and the plain version, and independent of the number of views
// in the launch.

#include "lfi_common.cuh"

namespace {

using lfi::kMaxGrid;
using lfi::kThreads;
using lfi::kViewChunk;

constexpr int kNT = 4;  // 8-pixel mma column tiles per warp: 128-pixel tiles
using Tile = lfi::BlendTile<kNT>;

static_assert(Tile::kP == kThreads, "a thread stages one pixel of the tile");

// Renders rows [r0, r0 + hb) of the frame: the coordinates take the frame
// row y = r0 + yb and clamp against the full H; the map and the output hold
// the block's rows only. Dynamic shared memory: Tile::smem_bytes(padded_grid(G), 1).
__global__ void __launch_bounds__(kThreads)
allfocus_blend_kernel(const uint8_t* __restrict__ img,   // [G, C, H, W]
                      const float* __restrict__ w,       // [V, G], fp16-valued
                      const float* __restrict__ offs,    // [G, 2] (x, y)
                      const uint8_t* __restrict__ fmap,  // [hb, W]
                      const float* __restrict__ decode,  // [256]
                      uint8_t* __restrict__ out,         // [V, C, hb, W]
                      int G, int C, int H, int W, int V, int r0, int hb,
                      int tiles_x) {
  extern __shared__ uint4 smem[];
  __shared__ float ox_s[kMaxGrid];
  __shared__ float oy_s[kMaxGrid];

  const int Gp = lfi::padded_grid(G);
  __half* const w_s = reinterpret_cast<__half*>(smem);
  uint8_t* const out_s = reinterpret_cast<uint8_t*>(smem) + Tile::w_bytes(Gp);
  __half* const x_s = reinterpret_cast<__half*>(out_s + Tile::out_bytes());

  const int row = blockIdx.x / tiles_x;  // c * hb + yb
  const int x0 = (blockIdx.x - row * tiles_x) * Tile::kP;
  const int c = row / hb;
  const int yb = row - c * hb;  // row of the block
  const int y = r0 + yb;        // row of the frame

  for (int g = threadIdx.x; g < Gp; g += kThreads) {
    ox_s[g] = g < G ? offs[2 * g] : 0.0f;
    oy_s[g] = g < G ? offs[2 * g + 1] : 0.0f;
  }
  const int x = x0 + threadIdx.x;
  const float f = x < W ? decode[fmap[(int64_t)yb * W + x]] : 0.0f;
  __syncthreads();

  // This thread's pixel of every image, kLoads images at a time: the loads
  // of a batch are all issued before the first is converted. Rows g >= G
  // are the zero rows that pad G to a multiple of 16.
  const int64_t plane = (int64_t)H * W;
  constexpr int kLoads = 8;  // divides padded_grid(G)
  for (int g0 = 0; g0 < Gp; g0 += kLoads) {
    uint8_t px[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      // No branch around the load, or the batch's loads would not be
      // issued together; ox_s and oy_s are in bounds for every g < Gp.
      const int g = g0 + u;
      const bool real = g < G;
      const int sy = lfi::focus_coord(y, f, oy_s[g], H);
      const int sx = lfi::focus_coord(x, f, ox_s[g], W);
      const uint8_t* const src =
          img + ((int64_t)(real ? g : 0) * C + c) * plane + (int64_t)sy * W + sx;
      px[u] = real ? *src : (uint8_t)0;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      x_s[(g0 + u) * Tile::kXStride + threadIdx.x] = __ushort2half_rn(px[u]);
  }

  const int64_t out_plane = (int64_t)hb * W;
  uint8_t* const px0 = out + (int64_t)c * out_plane + (int64_t)yb * W + x0;
  const int64_t view_stride = (int64_t)C * out_plane;
  for (int v0 = 0; v0 < V; v0 += kViewChunk) {
    const int vn = V - v0 < kViewChunk ? V - v0 : kViewChunk;
    lfi::stage_weights(w, G, Gp, v0, vn, w_s);
    __syncthreads();
    lfi::blend_tile<kNT>(x_s, w_s, out_s, Gp, v0, vn, x0, W,
                         [&](int v) { return px0 + v * view_stride; });
  }
}

}  // namespace

extern "C" {

// Largest G the kernel takes (the wrapper checks against it).
int lfi_allfocus_blend_max_grid(void) { return kMaxGrid; }

// Rows [r0, r0 + hb) of the render into `out` [V, C, hb, W], with `fmap`
// the map of those rows [hb, W]; r0 = 0 and hb = H render the frame.
// Launches on `stream`; does not synchronise and allocates nothing.
// Returns the launch's CUDA error (0 on success).
int lfi_allfocus_blend(const uint8_t* img, const float* w, const float* offs,
                       const uint8_t* fmap, const float* decode, uint8_t* out,
                       int G, int C, int H, int W, int V, int r0, int hb,
                       cudaStream_t stream) {
  if (G < 1 || G > kMaxGrid || C < 1 || H < 1 || W < 1 || V < 1 || r0 < 0 ||
      hb < 1 || hb > H - r0)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_x = (W + Tile::kP - 1) / Tile::kP;
  const int64_t blocks = (int64_t)C * hb * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = Tile::smem_bytes(lfi::padded_grid(G), 1);
  // More than 48 KB of shared memory must be asked for; a refusal is the
  // launch's error.
  cudaError_t err = cudaFuncSetAttribute(allfocus_blend_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  allfocus_blend_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      img, w, offs, fmap, decode, out, G, C, H, W, V, r0, hb, (int)tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
