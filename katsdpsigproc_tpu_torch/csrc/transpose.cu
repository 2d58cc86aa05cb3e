// Tiled 2-D transpose (corner turn) for Hopper (sm_90a), with a plain C ABI.
//
// K5 `transpose_kernel` replaces the TPU kernels
//   katsdpsigproc_tpu/ops/transpose.py::_transpose_kernel_2d / _transpose_kernel_3d
// (a Pallas grid of VMEM tiles, each stored transposed; complex64 split into
// two float32 planes first).
//
// What bounds it on the card: memory.  Every element is read once and
// written once, 2 x the array's bytes: 4.2 GB for the flagger's
// (32768, 8064, 2) float32 corner turn, 1.26 ms at 3.35 TB/s.  A naive
// transpose coalesces only one of the two sides, so the other side moves a
// 32-byte sector for every element.
//
// What the design does about it: one CTA moves one 32 x 32 tile through
// shared memory, so both the read of a source row and the write of a
// destination row are whole-warp contiguous.  The tile is padded by one
// column, so the column-wise reads out of shared memory fall in distinct
// banks.  The kernel is templated on the element size: 1 byte (uint8
// flags), 4 bytes (float32) and 8 bytes (complex64 or a planar (re, im)
// float32 pair, moved as one float2, so complex data needs no split into
// planes).  It copies bits, so any dtype of those sizes goes through it.
// Ragged edges are masked in the kernel.  The grid is one-dimensional over
// tiles, so neither side is limited by gridDim.y.  The CTA is 32 x
// kBlockRows threads, each moving 32 / kBlockRows elements of a tile
// column.  kBlockRows is fixed by the element size, at the best value of an
// A/B of 2, 4, 8, 16 and 32 on an H100 (700 W) at the corner-turn sizes: 2
// for 1-byte elements, 4 for 4- and 8-byte ones; 32 was the slowest for
// every size and type.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;

template <typename T>
constexpr int kBlockRows = sizeof(T) == 1 ? 2 : 4;

template <typename T>
__global__ void transpose_kernel(const T* __restrict__ src, T* __restrict__ dst, int rows,
                                 int cols, long long src_row_stride, int tiles_c) {
  __shared__ T tile[kTile][kTile + 1];
  const int tile_r = blockIdx.x / tiles_c;
  const int tile_c = blockIdx.x - tile_r * tiles_c;
  const int r0 = tile_r * kTile;
  const int c0 = tile_c * kTile;
  const int tx = threadIdx.x;
  // Read: warp y takes source row r0 + y, lanes along its columns.
  for (int y = threadIdx.y; y < kTile; y += blockDim.y) {
    const int r = r0 + y;
    const int c = c0 + tx;
    if (r < rows && c < cols) tile[y][tx] = src[(long long)r * src_row_stride + c];
  }
  __syncthreads();
  // Write: warp y takes destination row c0 + y (a source column), lanes
  // along the source rows.
  for (int y = threadIdx.y; y < kTile; y += blockDim.y) {
    const int c = c0 + y;
    const int r = r0 + tx;
    if (c < cols && r < rows) dst[(long long)c * rows + r] = tile[tx][y];
  }
}

template <typename T>
int launch(const void* src, void* dst, int rows, int cols, long long src_row_stride,
           cudaStream_t stream) {
  const long long tiles_r = (rows + kTile - 1) / kTile;
  const long long tiles_c = (cols + kTile - 1) / kTile;
  if (tiles_r * tiles_c > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kTile, kBlockRows<T>);
  transpose_kernel<T><<<(unsigned)(tiles_r * tiles_c), block, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), rows, cols, src_row_stride,
      (int)tiles_c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dst (cols, rows) = src (rows, cols)^T for elements of `elem_bytes` (1, 4
// or 8) bytes.  Source rows are `src_row_stride` elements apart, each row
// contiguous; dst is contiguous.  Returns a cudaError_t; 0 when the launch
// was accepted.
int tr_transpose(const void* src, void* dst, int elem_bytes, int rows, int cols,
                 long long src_row_stride, void* stream) {
  if (rows < 1 || cols < 1 || src_row_stride < cols) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t>(src, dst, rows, cols, src_row_stride, s);
    case 4:
      return launch<float>(src, dst, rows, cols, src_row_stride, s);
    case 8:
      return launch<float2>(src, dst, rows, cols, src_row_stride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
