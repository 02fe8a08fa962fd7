// Focus-map estimate for Hopper (sm_90a): the per-pixel disparity search of
// an all-in-focus render.
//
//   for each candidate f_i (i = 0..S-1), per pixel:
//     cost_i = sum over the 3x3 stencil taps (spacing rx, ry) of
//              max_c(max_k - min_k) of img_k[c, clamp(ty), clamp(tx)]
//   map[y, x] = cand_bytes[first i with the strictly smallest cost_i]
//
// with the tap coordinates of view k
//   exact:  ty = trunc(f32(y) + f_i*oy_k) + sy       (at the center)
//   fast:   ty = trunc(f32(y + sy) + f_i*oy_k)       (at the tap)
// and likewise in x.
//
// Replaces three TPU kernels of the JAX package:
//   * estimate_pallas._est_kernel      (lfinterpolator_tpu/ops/estimate_pallas.py:271), exact
//   * estimate_pallas._est_fast_kernel (lfinterpolator_tpu/ops/estimate_pallas.py:587), fast
//   * _est_kernel(predicated=True), the presence-predicated refine pass of
//     the coarse-to-fine estimate (estimate_pallas.py:320-338, 502, 540;
//     entries _estimate_fused_pres :1238, estimate_fused_pyramid :1251),
//     exact taps: candidate i is skipped for a pixel when bit i % sc of
//     pres[y / tb][x / wco][i / sc] is clear. tb is a multiple of kBlockY and
//     wco of kBlockX (the entry point refuses anything else), so all 256
//     threads of a block share one presence word and skip together.
// Their DMA windows, lane chunks, slab mode and SWAR packing worked around
// VMEM and the TPU's missing u8 min/max; here a thread reads its taps
// straight from device memory as interleaved RGBx words (rgbx_pack_kernel
// makes them from the planar views), one 4-byte load a tap, and Hopper's
// three-input 16-bit-lane min/max (DPX) takes the channels of two views in
// four instructions (struct Spread).
//
// Two passes, one min/max pass over the views per candidate instead of one
// per stencil tap (ops/focus_torch.py states the formulation in plain ops):
//
//   1. cheby_map_kernel: D_f(q) = max_c(max_k - min_k) img_k[c,
//      clamp(trunc(q_y + f*oy_k)), clamp(trunc(q_x + f*ox_k))] for q on the
//      extended domain [-ry, H + ry) x [-rx, W + rx), one byte per (candidate,
//      q). The fast rule truncates at the tap, so its tap (sy, sx) of pixel
//      (y, x) is D_f(y + sy, x + sx).
//   2. focus_argmin_kernel: cost_i = the nine bytes of D_{f_i} around the
//      pixel, summed; the running best is (cost << 8 | i), so the minimum of
//      the keys is the strict first minimum. The exact rule truncates at the
//      center, and reads what the hoisted rule reads except where a
//      coordinate changes sign between center and tap or an f32 rounding
//      flips the truncation: the wrapper flags the rows and the columns
//      where no view and no stencil offset differs (row_clean [S, H],
//      col_clean [S, W]; focus_torch.clean_flags). A pixel whose row and
//      column are clean for candidate i sums D_{f_i}; any other (candidate,
//      pixel) pair runs the nine-tap loop over the views (nine_tap_cost, the
//      slow arm). A warp is one row: a dirty row sends the whole warp down
//      the slow arm, a dirty column only its lanes. With every flag clear
//      the slow arm alone computes the map.
//
// Numerics: coordinates with __fmul_rn/__fadd_rn (never an FMA) and C
// truncation, as the oracle (ops/reference.py focus_map_estimate); costs
// are exact integers (a D byte <= 255, a cost <= 2295); the candidate values
// and their map bytes come from host tables, so no division runs here.
// Bit-equal to the oracle (exact rule) and to the JAX package's fast sweep
// (fast rule).
//
// Bound: one headline estimate (1080x1920, 32 candidates, K = 32 views,
// radius (20, 10)) is 2.2 G word loads in the map pass (one per candidate,
// view and extended pixel) with a min and a max each, 0.6 G byte loads in
// the argmin pass, and the slow arm's nine taps per view on the dirty pairs.
// It is bound by instruction throughput and L1/L2 loads, and stays clear of DRAM
// (the RGBx copy is 265 MB, the maps 69 MB) only if the 32 candidates do not
// each stream the views from device memory. What the design does about it:
//   * the map pass's grid runs the candidates of one tile together (the
//     candidate is blockIdx.x), so a view's pixels are read from device
//     memory once and from L2 by the other candidates;
//   * the map pass computes a block's clamped row offsets and columns once
//     per candidate and view tile into shared memory (0.06 coordinate
//     evaluations per tap instead of 2), so a tap is two shared loads, one
//     add, one coalesced 4-byte load and its share of the min/max;
//   * a thread owns kMapRows rows of one column and takes two views a step,
//     so 2 * kMapRows independent loads are in flight and a column lookup
//     serves kMapRows taps;
//   * a warp spans 32 neighbouring pixels of one row in every pass, so every
//     load of pixels, map bytes and flags is one coalesced segment.
//
// Row blocks: both passes can compute rows [r0, r0 + hb) of the frame only
// (one rank's rows of a multi-GPU render; the exact and fast rules, not the
// pyramid's refine pass). The map pass then covers the
// extended rows [r0 - ry, r0 + hb + ry), the argmin pass the block's pixels;
// every coordinate is the frame's, clamped against the full H, so a block's
// neighbours across its edges are the frame's real rows. The row flags, the
// running best and the map are the block's [.., hb] rows. r0 = 0, hb = H is
// the whole frame.

#include <limits.h>

#include "lfi_common.cuh"

namespace {

constexpr int kBlockX = 32;     // pixels per block along x (one warp)
constexpr int kBlockY = 8;      // warps per block
constexpr int kMaxViews = 256;  // largest K the kernels take
constexpr int kMaxSteps = 256;  // largest number of candidates
constexpr int kMapRows = 4;     // rows of one column per thread, map pass
constexpr int kViewTile = 32;   // views per coordinate table, map pass
constexpr int kNoBest = INT_MAX & ~0xff;  // no candidate yet: index 0

// The running min and max of the colour bytes of RGBx words, and their
// spread max_c(max - min). Bytes 0, 2 and bytes 1, 3 of a word become two
// pairs of 16-bit lanes, which Hopper's three-input min/max (DPX) takes
// natively, two views an instruction; the byte-lane __vminu4/__vmaxu4 are
// emulated in several instructions each.
struct Spread {
  uint32_t mn_a = 0x00ff00ffu, mn_b = 0x00ff00ffu, mx_a = 0u, mx_b = 0u;
  __device__ __forceinline__ void add(uint32_t p, uint32_t q) {
    const uint32_t pa = __byte_perm(p, 0u, 0x4240), pb = __byte_perm(p, 0u, 0x4341);
    const uint32_t qa = __byte_perm(q, 0u, 0x4240), qb = __byte_perm(q, 0u, 0x4341);
    mn_a = __vimin3_u16x2(mn_a, pa, qa);
    mn_b = __vimin3_u16x2(mn_b, pb, qb);
    mx_a = __vimax3_u16x2(mx_a, pa, qa);
    mx_b = __vimax3_u16x2(mx_b, pb, qb);
  }
  __device__ __forceinline__ int value() const {
    const uint32_t d = __vimax3_u16x2(mx_a - mn_a, mx_b - mn_b, 0u);
    return (int)max(d & 0xffffu, d >> 16);
  }
};

// The presence words of the refine pass: pixel (y, x) searches candidate i
// only when bit i % sc of words[((y / tb) * n_wc + x / wco) * cc + i / sc] is set.
struct Presence {
  const int32_t* words;  // [NB, N_WC, CC]
  int tb, wco, sc, n_wc, cc;
};

// [K, C, P] planar bytes -> [K, P] RGBx words: channel c in byte c, the
// unused bytes 0. kVec pixels a thread (4: one 4-byte load a channel and one
// 16-byte store, where P and the addresses allow it).
template <int kVec>
__global__ void rgbx_pack_kernel(const uint8_t* __restrict__ planar,
                                 uint32_t* __restrict__ words, int C, int64_t P,
                                 int64_t groups) {  // groups = K * P / kVec
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = g / (P / kVec);
    const int64_t p = (g - k * (P / kVec)) * kVec;
    const uint8_t* src = planar + k * C * P + p;
    uint32_t w[kVec] = {};
    for (int c = 0; c < C; ++c, src += P) {
      if (kVec == 4) {
        const uint32_t four = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
        for (int i = 0; i < kVec; ++i) w[i] |= ((four >> (8 * i)) & 0xffu) << (8 * c);
      } else {
        w[0] |= (uint32_t)src[0] << (8 * c);
      }
    }
    uint32_t* dst = words + k * P + p;
    if (kVec == 4)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      dst[0] = w[0];
  }
}

// Pass 1. Block (j, bx, by) computes D of candidate cands[j] on the tile of
// 32 columns x (kBlockY * kMapRows) rows of the row block's extended domain
// at (bx, by), into d[j]; extended row ey is frame row r0 + ey - ry.
// Thread (tx, ty) owns column tx, rows ty + kBlockY * r. The candidate is
// the fastest grid dimension: the blocks of one tile run
// together and read nearly the same pixels of every view (neighbouring
// candidates shift a view by a few pixels), so the views come from L2 and
// not once per candidate from device memory.
__global__ void __launch_bounds__(kBlockX * kBlockY)
cheby_map_kernel(const uint32_t* __restrict__ views,  // [K, H, W] RGBx
                 const float* __restrict__ offs,      // [K, 2] (x, y)
                 const float* __restrict__ cands,     // [gridDim.x]
                 uint8_t* __restrict__ d,             // [gridDim.x, hb + 2ry, W + 2rx]
                 int K, int H, int W, int rx, int ry, int r0, int hb) {
  constexpr int kTileRows = kBlockY * kMapRows;
  __shared__ int col_s[kViewTile][kBlockX];    // clamped source column
  __shared__ int row_s[kViewTile][kTileRows];  // clamped source row * W
  const int We = W + 2 * rx, He = hb + 2 * ry;
  const float f = cands[blockIdx.x];
  const int ex0 = blockIdx.y * kBlockX;
  const int ey0 = blockIdx.z * kTileRows;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int64_t plane = (int64_t)H * W;

  Spread spread[kMapRows];
  for (int k0 = 0; k0 < K; k0 += kViewTile) {
    const int kn = min(kViewTile, K - k0);
    __syncthreads();  // the previous tile's tables are read no more
    for (int e = tid; e < kn * kBlockX; e += kBlockX * kBlockY) {
      const int kk = e / kBlockX, j = e % kBlockX;
      col_s[kk][j] = lfi::focus_coord(ex0 + j - rx, f, offs[2 * (k0 + kk)], W);
    }
    for (int e = tid; e < kn * kTileRows; e += kBlockX * kBlockY) {
      const int kk = e / kTileRows, j = e % kTileRows;
      row_s[kk][j] = lfi::focus_coord(r0 + ey0 + j - ry, f, offs[2 * (k0 + kk) + 1], H) * W;
    }
    __syncthreads();
    const uint32_t* vk = views + (int64_t)k0 * plane;
    int kk = 0;
#pragma unroll 2
    for (; kk + 1 < kn; kk += 2, vk += 2 * plane) {  // two views a step
      const int c0 = col_s[kk][threadIdx.x], c1 = col_s[kk + 1][threadIdx.x];
#pragma unroll
      for (int r = 0; r < kMapRows; ++r)
        spread[r].add(vk[row_s[kk][threadIdx.y + kBlockY * r] + c0],
                      vk[plane + row_s[kk + 1][threadIdx.y + kBlockY * r] + c1]);
    }
    if (kk < kn) {
      const int c0 = col_s[kk][threadIdx.x];
#pragma unroll
      for (int r = 0; r < kMapRows; ++r) {
        const uint32_t p = vk[row_s[kk][threadIdx.y + kBlockY * r] + c0];
        spread[r].add(p, p);
      }
    }
  }
  const int ex = ex0 + threadIdx.x;
  if (ex >= We) return;
  uint8_t* const dj = d + (int64_t)blockIdx.x * He * We;
#pragma unroll
  for (int r = 0; r < kMapRows; ++r) {
    const int ey = ey0 + threadIdx.y + kBlockY * r;
    if (ey < He) dj[(int64_t)ey * We + ex] = (uint8_t)spread[r].value();
  }
}

// Clamped rows and columns of the exact rule's taps of view k at (x, y).
__device__ __forceinline__ void exact_taps(float fy, float fx, int x, int y, int rx,
                                           int ry, int H, int W, int (&rows)[3],
                                           int (&cols)[3]) {
  const int ty = lfi::trunc_coord(__fadd_rn((float)y, fy));
  const int tx = lfi::trunc_coord(__fadd_rn((float)x, fx));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    rows[j] = lfi::clamp_index(ty + (j - 1) * ry, H) * W;
    cols[j] = lfi::clamp_index(tx + (j - 1) * rx, W);
  }
}

// The slow arm: the exact rule's cost of candidate f at pixel (x, y), nine
// taps per view, each a 4-byte load; two views a step.
__device__ __forceinline__ int nine_tap_cost(const uint32_t* __restrict__ views,
                                             const float* ox_s, const float* oy_s,
                                             float f, int K, int H, int W, int x,
                                             int y, int rx, int ry) {
  const int64_t plane = (int64_t)H * W;
  Spread spread[9];
  const uint32_t* vk = views;
  int k = 0;
  for (; k + 1 < K; k += 2, vk += 2 * plane) {
    int r0[3], c0[3], r1[3], c1[3];
    exact_taps(__fmul_rn(f, oy_s[k]), __fmul_rn(f, ox_s[k]), x, y, rx, ry, H, W, r0, c0);
    exact_taps(__fmul_rn(f, oy_s[k + 1]), __fmul_rn(f, ox_s[k + 1]), x, y, rx, ry, H, W,
               r1, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        spread[3 * a + b].add(vk[r0[a] + c0[b]], vk[plane + r1[a] + c1[b]]);
  }
  if (k < K) {
    int r0[3], c0[3];
    exact_taps(__fmul_rn(f, oy_s[k]), __fmul_rn(f, ox_s[k]), x, y, rx, ry, H, W, r0, c0);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const uint32_t p = vk[r0[a] + c0[b]];
        spread[3 * a + b].add(p, p);
      }
  }
  int cost = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) cost += spread[t].value();
  return cost;
}

// Pass 2 over the candidates [c0, c0 + n), whose maps are d[0 .. n), for
// the pixels of rows [row0, row0 + rows). The running best of a pixel is
// the key (cost << 8) | i: it comes from `best` unless c0 == 0, and goes
// back there unless c0 + n == S, where the map byte is written instead.
// kPres (the pyramid's refine pass) always takes the whole frame, fixed at
// compile time, so its code stays as it was before row blocks: with a
// runtime block it ran 10% slower on an H100 (chip_smoke.py phase 12).
template <bool kExact, bool kPres>
__global__ void __launch_bounds__(kBlockX * kBlockY)
focus_argmin_kernel(const uint32_t* __restrict__ views,     // [K, H, W] RGBx
                    const float* __restrict__ offs,         // [K, 2] (x, y)
                    const float* __restrict__ cands,        // [S]
                    const uint8_t* __restrict__ cand_bytes, // [S]
                    const uint8_t* __restrict__ d,          // [n, hb + 2ry, W + 2rx]
                    const uint8_t* __restrict__ row_clean,  // [S, hb], kExact
                    const uint8_t* __restrict__ col_clean,  // [S, W], kExact
                    int32_t* __restrict__ best,             // [hb, W] keys
                    uint8_t* __restrict__ out,              // [hb, W]
                    int K, int H, int W, int S, int rx, int ry, int row0,
                    int rows, int c0, int n, Presence pres) {
  const int r0 = kPres ? 0 : row0;
  const int hb = kPres ? H : rows;
  __shared__ float ox_s[kMaxViews];
  __shared__ float oy_s[kMaxViews];
  if (kExact) {
    const int tid = threadIdx.y * kBlockX + threadIdx.x;
    for (int i = tid; i < K; i += kBlockX * kBlockY) {
      ox_s[i] = offs[2 * i];
      oy_s[i] = offs[2 * i + 1];
    }
    __syncthreads();
  }
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int yb = blockIdx.y * kBlockY + threadIdx.y;  // row of the block
  if (x >= W || yb >= hb) return;
  const int y = r0 + yb;  // row of the frame
  const int We = W + 2 * rx, He = hb + 2 * ry;
  const int64_t map_plane = (int64_t)He * We;
  // tap (sy, sx) of this pixel lies at dp[(ry + sy) * We + rx + sx]
  const uint8_t* dp = d + (int64_t)yb * We + x;
  const int64_t pixel = (int64_t)yb * W + x;

  const int32_t* words =
      kPres ? pres.words + ((int64_t)(y / pres.tb) * pres.n_wc + x / pres.wco) * pres.cc
            : nullptr;
  int key = c0 == 0 ? kNoBest : best[pixel];
  for (int j = 0; j < n; ++j, dp += map_plane) {
    const int i = c0 + j;
    if (kPres && !((words[i / pres.sc] >> (i % pres.sc)) & 1)) continue;
    int cost;
    if (kExact && !(row_clean[(int64_t)i * hb + yb] & col_clean[(int64_t)i * W + x])) {
      cost = nine_tap_cost(views, ox_s, oy_s, cands[i], K, H, W, x, y, rx, ry);
    } else {
      cost = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) cost += dp[(int64_t)a * ry * We + b * rx];
    }
    key = min(key, (cost << 8) | i);  // the first strict minimum
  }
  if (c0 + n == S)
    out[pixel] = cand_bytes[key & 0xff];
  else
    best[pixel] = key;
}

bool bad_shape(int K, int H, int W, int S, int rx, int ry, int r0, int hb) {
  return K < 1 || K > kMaxViews || S < 1 || S > kMaxSteps || H < 1 || W < 1 ||
         rx < 0 || ry < 0 || r0 < 0 || hb < 1 || hb > H - r0 ||
         (int64_t)(hb + 2 * ry) * (W + 2 * rx) > INT_MAX;
}

template <bool kPres>
int launch_argmin(const uint32_t* views, const float* offs, const float* cands,
                  const uint8_t* cand_bytes, const uint8_t* d,
                  const uint8_t* row_clean, const uint8_t* col_clean,
                  int32_t* best, uint8_t* out, int K, int H, int W, int S, int rx,
                  int ry, int r0, int hb, int c0, int n, Presence pres,
                  cudaStream_t stream) {
  if (kPres && (r0 != 0 || hb != H)) return (int)cudaErrorInvalidValue;
  const bool exact = row_clean != nullptr;
  if (bad_shape(K, H, W, S, rx, ry, r0, hb) || c0 < 0 || n < 1 || c0 + n > S ||
      (row_clean == nullptr) != (col_clean == nullptr) ||
      (best == nullptr && (c0 > 0 || c0 + n < S)) || (kPres && !exact))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (hb + kBlockY - 1) / kBlockY);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  if (exact)
    focus_argmin_kernel<true, kPres><<<grid, block, 0, stream>>>(
        views, offs, cands, cand_bytes, d, row_clean, col_clean, best, out, K, H, W,
        S, rx, ry, r0, hb, c0, n, pres);
  else
    focus_argmin_kernel<false, false><<<grid, block, 0, stream>>>(
        views, offs, cands, cand_bytes, d, row_clean, col_clean, best, out, K, H, W,
        S, rx, ry, r0, hb, c0, n, pres);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lfi_focus_estimate_max_views(void) { return kMaxViews; }
int lfi_focus_estimate_max_steps(void) { return kMaxSteps; }

// Every entry launches on `stream`, does not synchronise, allocates nothing
// and returns cudaGetLastError() after the launch (0 on success).

// The K views [K, C, H * W] (planar bytes, C <= 4) as RGBx words [K, H * W].
int lfi_rgbx_pack(const uint8_t* planar, uint32_t* words, int K, int C,
                  int64_t P, cudaStream_t stream) {
  if (K < 1 || C < 1 || C > 4 || P < 1) return (int)cudaErrorInvalidValue;
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(planar) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(words) % 16 == 0;
  const int64_t groups = (int64_t)K * P / (vec ? 4 : 1);
  const int64_t wanted = (groups + 255) / 256;
  const int blocks = wanted < 132 * 16 ? (int)wanted : 132 * 16;  // grid-stride
  if (vec)
    rgbx_pack_kernel<4><<<blocks, 256, 0, stream>>>(planar, words, C, P, groups);
  else
    rgbx_pack_kernel<1><<<blocks, 256, 0, stream>>>(planar, words, C, P, groups);
  return (int)cudaGetLastError();
}

// The map and argmin entries take the row block [r0, r0 + hb) of the H
// rows (r0 = 0, hb = H: the whole frame; the presence-predicated argmin
// takes the whole frame only); `views` always hold the frame.

// Pass 1: the maps of the n candidates cands[0 .. n) on the block's
// extended rows into d [n, hb + 2ry, W + 2rx].
int lfi_focus_cheby_map(const uint32_t* views, const float* offs,
                        const float* cands, uint8_t* d, int K, int H, int W,
                        int n, int rx, int ry, int r0, int hb,
                        cudaStream_t stream) {
  if (bad_shape(K, H, W, n, rx, ry, r0, hb)) return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid(n, (W + 2 * rx + kBlockX - 1) / kBlockX,
                  (hb + 2 * ry + kBlockY * kMapRows - 1) / (kBlockY * kMapRows));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  cheby_map_kernel<<<grid, block, 0, stream>>>(views, offs, cands, d, K, H, W, rx, ry,
                                               r0, hb);
  return (int)cudaGetLastError();
}

// Pass 2 over the candidates [c0, c0 + n) of the S in cands, whose maps are
// d [n, ...]. The fast rule when row_clean and col_clean are null, else the
// exact rule with those flags ([S, hb] and [S, W] bytes, 1 = clean; the
// block's rows of the frame's flags). `best` ([hb, W] int32) carries the
// running keys between calls and may be null when one call covers all S;
// the call that ends at S writes `out` [hb, W].
int lfi_focus_estimate(const uint32_t* views, const float* offs,
                       const float* cands, const uint8_t* cand_bytes,
                       const uint8_t* d, const uint8_t* row_clean,
                       const uint8_t* col_clean, int32_t* best, uint8_t* out,
                       int K, int H, int W, int S, int rx, int ry, int r0, int hb,
                       int c0, int n, cudaStream_t stream) {
  return launch_argmin<false>(views, offs, cands, cand_bytes, d, row_clean,
                              col_clean, best, out, K, H, W, S, rx, ry, r0, hb, c0,
                              n, Presence{nullptr, 1, 1, 1, 1, 1}, stream);
}

// The exact rule restricted by the presence words `pres` ([nb, n_wc, cc]
// int32; see Presence), on the whole frame (d from a map pass with r0 = 0,
// hb = H). The words must cover the frame and the candidates (nb * tb >=
// H, n_wc * wco >= W, cc * sc >= S), and tb and wco must be multiples of
// the block's 8 rows and 32 columns.
int lfi_focus_estimate_pres(const uint32_t* views, const float* offs,
                            const float* cands, const uint8_t* cand_bytes,
                            const uint8_t* d, const uint8_t* row_clean,
                            const uint8_t* col_clean, int32_t* best,
                            const int32_t* pres, uint8_t* out, int K, int H,
                            int W, int S, int rx, int ry, int c0, int n, int tb,
                            int wco, int sc, int nb, int n_wc, int cc,
                            cudaStream_t stream) {
  if (tb < 1 || wco < 1 || sc < 1 || sc > 31 || tb % kBlockY != 0 ||
      wco % kBlockX != 0 || (int64_t)nb * tb < H || (int64_t)n_wc * wco < W ||
      (int64_t)cc * sc < S)
    return (int)cudaErrorInvalidValue;
  return launch_argmin<true>(views, offs, cands, cand_bytes, d, row_clean,
                             col_clean, best, out, K, H, W, S, rx, ry, 0, H, c0, n,
                             Presence{pres, tb, wco, sc, n_wc, cc}, stream);
}

}  // extern "C"
