// Per-row [min, max, p25, p75, p50] of positive float32 data for Hopper
// (sm_90a), with a plain C ABI.
//
// K4 `percentile5_kernel` replaces the TPU kernel
//   katsdpsigproc_tpu/ops/percentile.py::_percentile5_kernel
// (a VMEM-resident row block: NaN-ignoring min and max, then the
// lower-element percentiles at ranks (n-1)//4, 3(n-1)//4 and (n-1)//2 by a
// 31-round bitwise search over the IEEE-754 bit pattern, all three targets
// per round).
//
// What bounds it on the card: not memory.  At 4000 x 5000 the input is
// 80 MB, about 24 us at 3.35 TB/s.  Each row then needs 31 dependent rounds,
// each a count of x < candidate for three candidates over the whole row
// and a block-wide sum that every thread must see before the next round.
// The pace is set by those dependent reductions (a pass over the row in
// shared memory plus a barrier's latency, 31 times a row).
//
// What the design does about it: one CTA of 256 threads per row.  The row
// is read from device memory once into dynamic shared memory when it fits
// (about 58k columns on an H100), and all 31 rounds count from there;
// a wider row is not refused but read from device memory (mostly from L2)
// every round.  Each round counts all three targets in one pass and one
// block reduction: warp sums by __reduce_add_sync, then one barrier over a
// double-banked partials buffer (the bank alternates by round, so no
// second barrier is needed before the next round's writes).  Several CTAs
// share an SM, so one row's reduction latency hides behind another row's
// counting.
//
// Parity with the JAX kernel, bit for bit:
//  * NaN is absent: it is skipped by min and max and compares false against
//    every candidate; the targets come from the column count, NaN included;
//  * counts are exact integers (the JAX kernel sums 0/1 in float32, which is
//    exact below 2**24 columns);
//  * a candidate is accepted when count(x < candidate) <= target;
//  * an all-NaN row gives min = +inf and max = -inf.
// The row is `row_stride` floats from the next (columns contiguous), so a
// column range is a view and never a copy.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Targets {
  int t[3];  // p25, p75, p50 ranks
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    percentile5_kernel(const float* __restrict__ src, long long row_stride, int n, Targets tg,
                       float* __restrict__ out, int rows) {
  extern __shared__ __align__(16) float row_smem[];
  __shared__ int partials[2][kWarps][3];
  __shared__ float minmax[kWarps][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* g = src + (long long)blockIdx.x * row_stride;
  const float* x = kShared ? row_smem : g;

  float mn = CUDART_INF_F;
  float mx = -CUDART_INF_F;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = g[i];
    if (kShared) row_smem[i] = v;
    if (v < mn) mn = v;  // false for NaN
    if (v > mx) mx = v;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float omn = __shfl_xor_sync(0xffffffffu, mn, off);
    const float omx = __shfl_xor_sync(0xffffffffu, mx, off);
    if (omn < mn) mn = omn;
    if (omx > mx) mx = omx;
  }
  if (lane == 0) {
    minmax[warp][0] = mn;
    minmax[warp][1] = mx;
  }
  __syncthreads();  // also publishes the row in shared memory

  unsigned cur[3] = {0u, 0u, 0u};
#pragma unroll 1
  for (int round = 0; round < 31; ++round) {
    const unsigned bit = 1u << (30 - round);
    const float c0 = __uint_as_float(cur[0] | bit);
    const float c1 = __uint_as_float(cur[1] | bit);
    const float c2 = __uint_as_float(cur[2] | bit);
    int n0 = 0, n1 = 0, n2 = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float v = x[i];
      n0 += v < c0;
      n1 += v < c1;
      n2 += v < c2;
    }
    n0 = __reduce_add_sync(0xffffffffu, n0);
    n1 = __reduce_add_sync(0xffffffffu, n1);
    n2 = __reduce_add_sync(0xffffffffu, n2);
    const int bank = round & 1;
    if (lane == 0) {
      partials[bank][warp][0] = n0;
      partials[bank][warp][1] = n1;
      partials[bank][warp][2] = n2;
    }
    __syncthreads();
    int t0 = 0, t1 = 0, t2 = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t0 += partials[bank][w][0];
      t1 += partials[bank][w][1];
      t2 += partials[bank][w][2];
    }
    if (t0 <= tg.t[0]) cur[0] |= bit;
    if (t1 <= tg.t[1]) cur[1] |= bit;
    if (t2 <= tg.t[2]) cur[2] |= bit;
  }

  if (threadIdx.x == 0) {
    mn = minmax[0][0];
    mx = minmax[0][1];
    for (int w = 1; w < kWarps; ++w) {
      if (minmax[w][0] < mn) mn = minmax[w][0];
      if (minmax[w][1] > mx) mx = minmax[w][1];
    }
    const long long r = blockIdx.x;
    out[r] = mn;
    out[rows + r] = mx;
    out[2LL * rows + r] = __uint_as_float(cur[0]);
    out[3LL * rows + r] = __uint_as_float(cur[1]);
    out[4LL * rows + r] = __uint_as_float(cur[2]);
  }
}

// Dynamic shared memory a row may take on the current device, in bytes.
int shared_budget(int* bytes) {
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, percentile5_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  *bytes = optin - (int)attr.sharedSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

const char* pc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The widest row (in columns) that K4 holds in shared memory on the current
// device; wider rows are read from device memory every round.  0 on error.
int pc_max_shared_columns(void) {
  int bytes = 0;
  return shared_budget(&bytes) ? 0 : bytes / (int)sizeof(float);
}

// out (5, rows) float32 = [min, max, p25, p75, p50] of each row of src, a
// (rows, n) float32 array whose rows are `row_stride` floats apart.
// Returns a cudaError_t; 0 when the launch was accepted.
int pc_percentile5(const void* src, long long row_stride, int rows, int n, void* out,
                   void* stream) {
  if (rows < 1 || n < 1 || row_stride < n) return (int)cudaErrorInvalidValue;
  Targets tg;
  tg.t[0] = (n - 1) / 4;
  tg.t[1] = (int)((3LL * (n - 1)) / 4);
  tg.t[2] = (n - 1) / 2;
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int budget = 0;
  int err = shared_budget(&budget);
  if (err) return err;
  const size_t smem = (size_t)n * sizeof(float);
  if (smem <= (size_t)budget) {
    err = (int)cudaFuncSetAttribute(percentile5_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    percentile5_kernel<true><<<rows, kThreads, smem, st>>>(s, row_stride, n, tg, o, rows);
  } else {
    percentile5_kernel<false><<<rows, kThreads, 0, st>>>(s, row_stride, n, tg, o, rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
