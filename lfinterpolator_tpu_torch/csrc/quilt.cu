// Quilt tile copy for Hopper (sm_90a): the montage of a two-stage quilt.
//
//   canvas[c, r * th + y, cl * tw + x] = tiles[r * cols + cl, c, y, x]
//
// for r < rows, cl < cols: tile i = r * cols + cl of a [N >= cols * rows,
// C, th, tw] stack lands at cell (i / cols, i % cols) of the
// [C, rows * th, cols * tw] canvas, row-major from the top left (the order
// of scripts/viewsToQuilt.sh's montage).
//
// Replaces quilt._copy_kernel (lfinterpolator_tpu/ops/quilt.py:38, entry
// _assemble_pallas :42), one auto-pipelined VMEM block copy per (tile,
// channel, band of rows) that needed th % 8 == 0 and tw % 128 == 0.
//
// Bound: a pure copy, 2 bytes of device memory traffic per canvas byte
// (2 x 280 MB for a 5 x 9 quilt of 1080 x 1920 tiles, ~0.17 ms at
// 3.35 TB/s). One block per canvas row, its threads striding along the
// row: reads and writes are contiguous runs of tw bytes, coalesced. When
// tw is a multiple of 16 (and both buffers 16-byte aligned, as torch
// allocates them) each thread moves 16-byte words, which never straddle a
// tile seam; otherwise it moves single bytes.

#include "lfi_common.cuh"

namespace {

constexpr int kThreads = 256;

template <class T>
__global__ void __launch_bounds__(kThreads)
quilt_copy_kernel(const T* __restrict__ tiles,  // [N, C, th, tw / sizeof(T)]
                  T* __restrict__ canvas,       // [C, rows * th, cols * tw / sizeof(T)]
                  int C, int th, int tw, int cols, int rows) {
  const int64_t row = blockIdx.x;  // c * rows * th + r * th + y
  const int64_t per_c = (int64_t)rows * th;
  const int c = (int)(row / per_c);
  const int r = (int)((row - c * per_c) / th);
  const int y = (int)(row - c * per_c - (int64_t)r * th);
  const int64_t row_w = (int64_t)cols * tw;
  T* dst = canvas + row * row_w;
  for (int64_t i = threadIdx.x; i < row_w; i += kThreads) {
    const int cl = (int)(i / tw);
    const int x = (int)(i - (int64_t)cl * tw);
    const int64_t tile = (int64_t)r * cols + cl;
    dst[i] = tiles[((tile * C + c) * th + y) * tw + x];
  }
}

}  // namespace

extern "C" {

// Copies the first cols * rows tiles of `tiles` ([N, C, th, tw] uint8,
// N >= cols * rows) into `canvas` ([C, rows * th, cols * tw] uint8).
// Launches on `stream`; does not synchronise and allocates nothing.
// Returns cudaGetLastError() after the launch (0 on success).
int lfi_quilt_copy(const uint8_t* tiles, uint8_t* canvas, int C, int th,
                   int tw, int cols, int rows, cudaStream_t stream) {
  if (C < 1 || th < 1 || tw < 1 || cols < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)C * rows * th;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool wide = tw % 16 == 0 && (uintptr_t)tiles % 16 == 0 &&
                    (uintptr_t)canvas % 16 == 0;
  if (wide)
    quilt_copy_kernel<uint4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(tiles), reinterpret_cast<uint4*>(canvas),
        C, th, tw / 16, cols, rows);
  else
    quilt_copy_kernel<uint8_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        tiles, canvas, C, th, tw, cols, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
