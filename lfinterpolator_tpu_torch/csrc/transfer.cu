// Device-to-host copy of a block of rows of every view of a frame, for the
// download of a frame in row bands (utils/transfer.py).
//
// A band [r0, r0 + hb) of V views is V runs of hb * W * C bytes: contiguous
// on the device ([V, hb, W, C]), H * W * C bytes apart in the host's
// [V, H, W, C] array. One cudaMemcpy2DAsync moves all V runs, so a band is
// one copy, with no host-side staging and no copy per view. No kernel: the
// copy engine moves the bytes.

#include <cstdint>

#include <cuda_runtime.h>

extern "C" {

// Copies `height` runs of `width` bytes, `src_pitch` bytes apart on the
// device at `src`, to `dst_pitch` bytes apart in (pinned) host memory at
// `dst`. Enqueued on `stream`; does not synchronise and allocates nothing.
// Returns the CUDA error of the enqueue (0 on success).
int lfi_copy_rows_to_host(uint8_t* dst, int64_t dst_pitch, const uint8_t* src,
                          int64_t src_pitch, int64_t width, int64_t height,
                          cudaStream_t stream) {
  if (width < 1 || height < 1 || dst_pitch < width || src_pitch < width)
    return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpy2DAsync(dst, (size_t)dst_pitch, src, (size_t)src_pitch,
                                (size_t)width, (size_t)height,
                                cudaMemcpyDeviceToHost, stream);
}

}  // extern "C"
