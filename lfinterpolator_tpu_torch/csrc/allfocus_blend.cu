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
// (lfi::contract on the tensor cores, lfi::store_tile's 16-byte stores).
// Loads coalesce along x wherever neighbouring pixels share their focus.
// A grid of more than lfi::kGridChunk images is gathered in passes of
// lfi::kPassRows images, each with its images' weights, the sums carried in
// registers from pass to pass: at G = 289, five passes (the last of 48
// images), 37.4 KB of shared memory a block, four blocks to an SM (as the
// registers allow), where all 289 images at once would leave one.
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

// This thread's pixel x of images [g0, g0 + rows) of channel c, at focus f,
// as fp16 into x_s (row g - g0), kLoads images at a time: the loads of a
// batch are all issued before the first is converted, so that their
// latencies overlap. Rows g >= G are the zero rows that pad G to a multiple
// of 16; kLoads divides every pass's rows.
template <int kLoads>
__device__ __forceinline__ void gather(const uint8_t* __restrict__ img, int G, int C,
                                       int H, int W, int64_t plane, int c, int x, int y,
                                       float f, const float* ox_s, const float* oy_s,
                                       int g0, int rows, __half* x_s) {
  for (int j0 = 0; j0 < rows; j0 += kLoads) {
    uint8_t px[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      // No branch around the load, or the batch's loads would not be
      // issued together; ox_s and oy_s are in bounds for every g < Gp.
      const int g = g0 + j0 + u;
      const bool real = g < G;
      const int sy = lfi::focus_coord(y, f, oy_s[g], H);
      const int sx = lfi::focus_coord(x, f, ox_s[g], W);
      const uint8_t* const src =
          img + ((int64_t)(real ? g : 0) * C + c) * plane + (int64_t)sy * W + sx;
      px[u] = real ? *src : (uint8_t)0;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      x_s[(j0 + u) * Tile::kXStride + threadIdx.x] = __ushort2half_rn(px[u]);
  }
}

// Dynamic shared memory of a block: one pass's weights and operand and the
// images' offsets.
__host__ __device__ constexpr size_t smem_bytes(int G) {
  return Tile::smem_bytes(lfi::grid_chunk(G), lfi::grid_chunk(G),
                          2 * lfi::padded_grid(G) * sizeof(float));
}

// Renders rows [r0, r0 + hb) of the frame: the coordinates take the frame
// row y = r0 + yb and clamp against the full H; the map and the output hold
// the block's rows only. Dynamic shared memory: smem_bytes(G).
template <bool kPasses>
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
  const int Gp = lfi::padded_grid(G);
  const int Gc = kPasses ? lfi::grid_chunk(G) : Gp;  // images a pass stages
  const int w_stride = Tile::w_stride(Gc);
  __half* const w_s = reinterpret_cast<__half*>(smem);
  uint8_t* const out_s = reinterpret_cast<uint8_t*>(smem) + Tile::w_bytes(Gc);
  __half* const x_s = reinterpret_cast<__half*>(out_s + Tile::out_bytes());
  float* const ox_s = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(x_s) + Tile::x_bytes(Gc));
  float* const oy_s = ox_s + Gp;

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

  const int64_t plane = (int64_t)H * W;
  const int64_t out_plane = (int64_t)hb * W;
  uint8_t* const px0 = out + (int64_t)c * out_plane + (int64_t)yb * W + x0;
  const int64_t view_stride = (int64_t)C * out_plane;
  for (int v0 = 0; v0 < V; v0 += kViewChunk) {
    const int vn = V - v0 < kViewChunk ? V - v0 : kViewChunk;
    // The first pass (the only one where the grid fits one): its pixels
    // are gathered while no sums are live, 8 loads in flight a thread. One
    // pass gathers once for every chunk of views.
    if (v0 == 0 || kPasses)
      gather<8>(img, G, C, H, W, plane, c, x, y, f, ox_s, oy_s, 0, Gc, x_s);
    lfi::stage_weights(w, G, 0, Gc, w_stride, v0, vn, w_s);
    __syncthreads();
    lfi::BlendAcc<kNT> acc;
    acc.zero();
    lfi::contract<kNT>(acc, x_s, w_s, w_stride, Gc, vn);
    // Later passes add to the sums in registers, with 16 loads in flight:
    // the registers they take leave four blocks on an SM, as one pass has
    // (16 measured 7% faster than 8 at G = 289).
    if (kPasses) {
      for (int g0 = Gc; g0 < Gp; g0 += Gc) {
        const int rows = Gp - g0 < Gc ? Gp - g0 : Gc;
        __syncthreads();  // every warp is done with the last pass's operands
        gather<16>(img, G, C, H, W, plane, c, x, y, f, ox_s, oy_s, g0, rows, x_s);
        lfi::stage_weights(w, G, g0, rows, w_stride, v0, vn, w_s);
        __syncthreads();
        lfi::contract<kNT>(acc, x_s, w_s, w_stride, rows, vn);
      }
    }
    lfi::store_tile<kNT>(acc, out_s, v0, vn, x0, W,
                         [&](int v) { return px0 + v * view_stride; });
  }
}

// The kernel for G images: the one-pass instantiation where the grid
// fits one pass, else the one that runs later passes.
auto kernel_for(int G) {
  return lfi::grid_passes(G) > 1 ? allfocus_blend_kernel<true> : allfocus_blend_kernel<false>;
}

// Sets the kernel's dynamic shared memory for G images; more than 48 KB
// must be asked for, and a refusal is the launch's error.
cudaError_t prepare(int G) {
  return cudaFuncSetAttribute(kernel_for(G), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(G));
}

}  // namespace

extern "C" {

// Largest G the kernel takes (the wrapper checks against it).
int lfi_allfocus_blend_max_grid(void) { return kMaxGrid; }

// Dynamic shared memory of a block for G images, in bytes.
int lfi_allfocus_blend_smem_bytes(int G) { return (int)smem_bytes(G); }

// Blocks of the kernel resident on one SM for G images, as the runtime's
// occupancy calculator gives them, or minus the CUDA error.
int lfi_allfocus_blend_blocks_per_sm(int G) {
  if (G < 1 || G > kMaxGrid) return -(int)cudaErrorInvalidValue;
  cudaError_t err = prepare(G);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_for(G),
                                                        kThreads, smem_bytes(G));
  return err == cudaSuccess ? n : -(int)err;
}

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
  cudaError_t err = prepare(G);
  if (err != cudaSuccess) return (int)err;
  kernel_for(G)<<<(unsigned)blocks, kThreads, smem_bytes(G), stream>>>(
      img, w, offs, fmap, decode, out, G, C, H, W, V, r0, hb, (int)tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
