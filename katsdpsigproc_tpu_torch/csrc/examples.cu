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
// design keeps the memory system busy: 16-byte loads and stores (float4),
// neighbouring threads on neighbouring vectors, and a grid-stride loop over
// a grid that fills every SM (2048 threads each), so each SM keeps 2048
// loads of 16 B in flight.  The ragged tail (n % 4), or all of a buffer that
// does not start on 16 B, is done one element at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void multiply_kernel(const float* __restrict__ data, float* __restrict__ out,
                                long long n, float scale, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long head = 0;  // elements done by the vector loop
  if (vec) {
    const long long n4 = n >> 2;
    const float4* d4 = reinterpret_cast<const float4*>(data);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      float4 v = d4[i];
      v.x = __fmul_rn(v.x, scale);
      v.y = __fmul_rn(v.y, scale);
      v.z = __fmul_rn(v.z, scale);
      v.w = __fmul_rn(v.w, scale);
      o4[i] = v;
    }
    head = n4 << 2;
  }
  for (long long i = head + tid; i < n; i += stride) out[i] = __fmul_rn(data[i], scale);
}

}  // namespace

extern "C" {

const char* ex_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out[i] = data[i] * scale for i < n, with `threads` threads per CTA (a
// multiple of 32, at most 1024).  Returns a cudaError_t; 0 when the launch
// was accepted.
int ex_multiply(const void* data, void* out, long long n, float scale, int threads,
                void* stream) {
  if (n < 0 || threads < 32 || threads > 1024 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  int device = 0;
  int sms = 0;
  int err = (int)cudaGetDevice(&device);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err) return err;
  const int vec = (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  const long long fill = (long long)sms * (2048 / threads);  // CTAs resident at once
  if (blocks > fill) blocks = fill;
  multiply_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<float*>(out), n, scale, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
