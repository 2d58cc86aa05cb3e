// The tutorial kernel K7 for Hopper (sm_90a), with a plain C ABI.  It
// replaces doc/examples/triple.py::multiply_kernel (:27), the Pallas kernel
// that `multiply` (:31-41) calls to scale a block by a scalar held in SMEM.
//
// out = data * scale, float32, each product rounded once as the plain
// version's is.  `scale` is a kernel argument by value: it lives in the
// kernel's constant bank, the card's counterpart of the TPU's SMEM scalar,
// and every thread reads it with no load from device memory.
//
// What bounds it: bytes.  Each element is read once and written once, 8 B
// for one multiply, far below the card's ratio of operations to bytes, so
// 2**28 elements (2.15 GB moved) take at least 0.64 ms at 3.35 TB/s.  The
// kernel streams tiles: a CTA owns a contiguous tile of `threads` float4s
// (each warp-wide load covers 512 contiguous bytes) and retires; offsets
// inside a tile are 32-bit, the tile's base 64-bit; a last partial tile is
// masked, and CTA 0 does the n % 4 ragged tail one element at a time.  At
// 1024 threads (triple.multiply's default) it beat, on the H100, four
// float4s a thread with evict-first loads and stores, Hopper's bulk copy
// through shared memory, and the earlier grid-stride kernel (PERF.md).
// ex_multiply takes that grid-stride kernel, one element at a time, for a
// buffer that does not start on 16 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 scale4(float4 v, float scale) {
  v.x = __fmul_rn(v.x, scale);
  v.y = __fmul_rn(v.y, scale);
  v.z = __fmul_rn(v.z, scale);
  v.w = __fmul_rn(v.w, scale);
  return v;
}

// One tile of blockDim.x * U float4s per CTA, a thread's U loads all
// issued before its first store; K7 launches U = 1, the fastest on the
// H100 (PERF.md).  At most 32 registers a thread, so that 2048 threads
// fit on an SM.
template <int U>
__global__ void __launch_bounds__(1024, 2)
    multiply_tiles(const float* __restrict__ data, float* __restrict__ out, long long n,
                   float scale) {
  const unsigned step = blockDim.x;
  const long long first = (long long)blockIdx.x * step * U;
  const float4* d = reinterpret_cast<const float4*>(data) + first;
  float4* o = reinterpret_cast<float4*>(out) + first;
  const long long left = (n >> 2) - first;
  float4 v[U];
  if (left >= (long long)step * U) {
#pragma unroll
    for (int k = 0; k < U; ++k) v[k] = d[threadIdx.x + k * step];
#pragma unroll
    for (int k = 0; k < U; ++k) o[threadIdx.x + k * step] = scale4(v[k], scale);
  } else {
    const unsigned rest = (unsigned)left;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (threadIdx.x + k * step < rest) v[k] = d[threadIdx.x + k * step];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (threadIdx.x + k * step < rest) o[threadIdx.x + k * step] = scale4(v[k], scale);
    }
  }
  // The n % 4 elements after the last float4.
  const long long i = (n & ~3LL) + threadIdx.x;
  if (blockIdx.x == 0 && i < n) out[i] = __fmul_rn(data[i], scale);
}

// The earlier kernel: a grid-stride loop with one float4 in flight per thread
// (`vec`), or one element at a time (ex_multiply's unaligned buffers).
__global__ void multiply_kernel(const float* __restrict__ data, float* __restrict__ out,
                                long long n, float scale, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* d4 = reinterpret_cast<const float4*>(data);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) o4[i] = scale4(d4[i], scale);
    head = n4 << 2;
  }
  for (long long i = head + tid; i < n; i += stride) out[i] = __fmul_rn(data[i], scale);
}

// The grid-stride kernel on a grid capped at the CTAs resident at once
// (2048 threads an SM).
int launch_grid_stride(const float* data, float* out, long long n, float scale, int threads,
                       int vec, cudaStream_t stream) {
  int device = 0;
  int sms = 0;
  int err = (int)cudaGetDevice(&device);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err) return err;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  const long long fill = (long long)sms * (2048 / threads);
  if (blocks > fill) blocks = fill;
  multiply_kernel<<<(unsigned)blocks, threads, 0, stream>>>(data, out, n, scale, vec);
  return (int)cudaGetLastError();
}

bool bad_args(long long n, int threads) {
  return n < 0 || threads < 32 || threads > 1024 || threads % 32 != 0;
}

bool aligned(const void* data, const void* out) {
  return (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0;
}

// `launch()` with `device` the current device, the caller's restored after.
// (Setting the device here costs the host far less than PyTorch's
// torch.cuda.device context around the call.)
template <typename Launch>
int on_device(int device, Launch launch) {
  int current = 0;
  int err = (int)cudaGetDevice(&current);
  if (err) return err;
  if (current != device && (err = (int)cudaSetDevice(device))) return err;
  err = launch();
  if (current != device) {
    const int restore = (int)cudaSetDevice(current);
    if (!err) err = restore;
  }
  return err;
}

}  // namespace

extern "C" {

const char* ex_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K7: out[i] = data[i] * scale for i < n, one tile of `threads` float4s
// per CTA of `threads` threads (a multiple of 32, at most 1024), on
// `stream` of CUDA device `device`.  Returns a cudaError_t; 0 when the
// launch was accepted.
int ex_multiply(const void* data, void* out, long long n, float scale, int threads, int device,
                void* stream) {
  if (bad_args(n, threads)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* d = static_cast<const float*>(data);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned(data, out)) {
    return on_device(device, [&] { return launch_grid_stride(d, o, n, scale, threads, 0, s); });
  }
  long long blocks = ((n >> 2) + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks < 1) blocks = 1;  // n < 4: the ragged tail alone
  return on_device(device, [&] {
    multiply_tiles<1><<<(unsigned)blocks, threads, 0, s>>>(d, o, n, scale);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
