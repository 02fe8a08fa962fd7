// Focus-map estimate for Hopper (sm_90a): the per-pixel disparity search of
// an all-in-focus render.
//
//   for each candidate f_i (i = 0..S-1), per pixel:
//     cost_i = sum over the 3x3 stencil taps (spacing rx, ry) of
//              max_c(max_k - min_k) of img_k[c, clamp(ty), clamp(tx)]
//   map[y, x] = cand_bytes[first i with the strictly smallest cost_i]
//
// with the tap coordinates of view k
//   exact (kExact):  ty = trunc(f32(y) + f_i*oy_k) + sy       (at the center)
//   fast:            ty = trunc(f32(y + sy) + f_i*oy_k)       (at the tap)
// and likewise in x.
//
// Replaces two TPU kernels of the JAX package, one instantiation each:
//   * estimate_pallas._est_kernel      (lfinterpolator_tpu/ops/estimate_pallas.py:271), exact
//   * estimate_pallas._est_fast_kernel (lfinterpolator_tpu/ops/estimate_pallas.py:587), fast
// Their DMA windows, lane chunks, slab mode and SWAR packing worked around
// VMEM and the TPU's missing u8 min/max; a GPU thread reads its taps
// straight from device memory, and __vminu4/__vmaxu4 do the four byte
// lanes of an interleaved RGBx word in one call.
//
// Numerics: coordinates with __fmul_rn/__fadd_rn (never an FMA) and C
// truncation, as the oracle (ops/reference.py focus_map_estimate); costs
// are exact integers; the candidate values and their map bytes come from
// host tables, so no division runs here. Bit-equal to the oracle (exact
// rule) and to the JAX package's fast sweep (fast rule).
//
// Bound: one headline estimate (1080x1920, 32 candidates, K = 32 views,
// 9 taps) is 19.1 G tap loads and twice as many byte-lane min/max calls,
// which the SASS emulates in a few instructions each: the kernel is bound
// by instruction issue and L1/L2 load throughput, not by DRAM (each
// candidate sweep touches the 265 MB RGBx copy about once). The design
// keeps every load a single coalesced 4-byte word (a warp spans 32
// neighbouring pixels of one row, whose taps are neighbours too), the 18
// running min/max words in registers, and a block's 32x8 pixels close
// together so that the 9 taps of neighbouring threads share cache lines.
// Sharing taps across threads through shared memory and packing two
// channels per 16-bit lane for the DPX min/max come later.

#include <limits.h>

#include "lfi_common.cuh"

namespace {

constexpr int kBlockX = 32;     // pixels per block along x (one warp)
constexpr int kBlockY = 8;      // rows per block
constexpr int kMaxViews = 256;  // largest K the kernel takes
constexpr int kMaxSteps = 256;  // largest number of candidates

// max over the byte lanes of (mx - mn); byte 3 is 0 - 0 for RGB data.
__device__ __forceinline__ int chebyshev(uint32_t mx, uint32_t mn) {
  const uint32_t d = __vabsdiffu4(mx, mn);
  const uint32_t lo = max(d & 0xffu, (d >> 8) & 0xffu);
  const uint32_t hi = max((d >> 16) & 0xffu, d >> 24);
  return (int)max(lo, hi);
}

template <bool kExact>
__global__ void __launch_bounds__(kBlockX * kBlockY)
focus_estimate_kernel(const uint32_t* __restrict__ views,     // [K, H, W] RGBx
                      const float* __restrict__ offs,         // [K, 2] (x, y)
                      const float* __restrict__ cands,        // [S]
                      const uint8_t* __restrict__ cand_bytes, // [S]
                      uint8_t* __restrict__ out,              // [H, W]
                      int K, int H, int W, int S, int rx, int ry) {
  __shared__ float ox_s[kMaxViews];
  __shared__ float oy_s[kMaxViews];
  __shared__ float cand_s[kMaxSteps];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < K; i += kBlockX * kBlockY) {
    ox_s[i] = offs[2 * i];
    oy_s[i] = offs[2 * i + 1];
  }
  for (int i = tid; i < S; i += kBlockX * kBlockY) cand_s[i] = cands[i];
  __syncthreads();

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int64_t plane = (int64_t)H * W;
  const int sy[3] = {-ry, 0, ry};
  const int sx[3] = {-rx, 0, rx};

  int best_cost = INT_MAX;
  int best = 0;
  for (int i = 0; i < S; ++i) {
    const float f = cand_s[i];
    uint32_t mn[9], mx[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      mn[t] = 0xffffffffu;
      mx[t] = 0u;
    }
    for (int k = 0; k < K; ++k) {
      const float fy = __fmul_rn(f, oy_s[k]);
      const float fx = __fmul_rn(f, ox_s[k]);
      int rows[3], cols[3];
      if (kExact) {
        const int ty = lfi::trunc_coord(__fadd_rn((float)y, fy));
        const int tx = lfi::trunc_coord(__fadd_rn((float)x, fx));
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          rows[j] = lfi::clamp_index(ty + sy[j], H);
          cols[j] = lfi::clamp_index(tx + sx[j], W);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          rows[j] = lfi::focus_coord(y + sy[j], f, oy_s[k], H);
          cols[j] = lfi::focus_coord(x + sx[j], f, ox_s[k], W);
        }
      }
      const uint32_t* vk = views + (int64_t)k * plane;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const uint32_t* row = vk + (int64_t)rows[a] * W;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const uint32_t p = row[cols[b]];
          mn[3 * a + b] = __vminu4(mn[3 * a + b], p);
          mx[3 * a + b] = __vmaxu4(mx[3 * a + b], p);
        }
      }
    }
    int cost = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) cost += chebyshev(mx[t], mn[t]);
    if (cost < best_cost) {  // strict: the first minimum wins
      best_cost = cost;
      best = i;
    }
  }
  out[(int64_t)y * W + x] = cand_bytes[best];
}

}  // namespace

extern "C" {

int lfi_focus_estimate_max_views(void) { return kMaxViews; }
int lfi_focus_estimate_max_steps(void) { return kMaxSteps; }

// `exact` != 0 picks the exact tap rule, 0 the fast one. Launches on
// `stream`; does not synchronise and allocates nothing. Returns
// cudaGetLastError() after the launch (0 on success).
int lfi_focus_estimate(const uint32_t* views, const float* offs,
                       const float* cands, const uint8_t* cand_bytes,
                       uint8_t* out, int K, int H, int W, int S, int rx,
                       int ry, int exact, cudaStream_t stream) {
  if (K < 1 || K > kMaxViews || S < 1 || S > kMaxSteps || H < 1 || W < 1 ||
      rx < 0 || ry < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  if (exact)
    focus_estimate_kernel<true><<<grid, block, 0, stream>>>(
        views, offs, cands, cand_bytes, out, K, H, W, S, rx, ry);
  else
    focus_estimate_kernel<false><<<grid, block, 0, stream>>>(
        views, offs, cands, cand_bytes, out, K, H, W, S, rx, ry);
  return (int)cudaGetLastError();
}

}  // extern "C"
