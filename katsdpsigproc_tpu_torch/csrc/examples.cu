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
// kernel streams tiles: a CTA owns a contiguous tile of `threads * U`
// float4s and retires; a thread's U 16-byte loads are `threads` float4s
// apart (each warp-wide load covers 512 contiguous bytes) and are all issued
// before the first store; offsets inside a tile are 32-bit, the tile's base
// 64-bit; a last partial tile is masked, and CTA 0 does the n % 4 ragged
// tail one element at a time.
//
// K7 is the build with U = 1 (K7_UNROLL) and the default cache policy, at
// 1024 threads (triple.multiply's default).  scripts/examples_ab.py times
// it beside two measurement builds of this file, both slower on the H100
// (PERF.md): U = 4 with evict-first loads and stores (K7_UNROLL=4
// K7_EVICT_FIRST=1, __ldcs/__stcs), and Hopper's bulk copy through shared
// memory (K7_BULK=1, below).  ex_multiply_grid_stride launches the earlier
// design, a grid-stride kernel, for the same A/B; ex_multiply takes that
// kernel, one element at a time, for a buffer that does not start on 16
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K7_UNROLL
#define K7_UNROLL 1
#endif
#ifndef K7_EVICT_FIRST
#define K7_EVICT_FIRST 0
#endif
#ifndef K7_BULK
#define K7_BULK 0
#endif
#ifndef K7_BULK_CHUNK
#define K7_BULK_CHUNK 32768
#endif
#ifndef K7_BULK_STAGES
#define K7_BULK_STAGES 4
#endif
#ifndef K7_BULK_CTAS
#define K7_BULK_CTAS 1
#endif

namespace {

__device__ __forceinline__ float4 scale4(float4 v, float scale) {
  v.x = __fmul_rn(v.x, scale);
  v.y = __fmul_rn(v.y, scale);
  v.z = __fmul_rn(v.z, scale);
  v.w = __fmul_rn(v.w, scale);
  return v;
}

__device__ __forceinline__ float4 load4(const float4* p) {
#if K7_EVICT_FIRST
  return __ldcs(p);
#else
  return *p;
#endif
}

__device__ __forceinline__ void store4(float4* p, float4 v) {
#if K7_EVICT_FIRST
  __stcs(p, v);
#else
  *p = v;
#endif
}

// One tile of blockDim.x * U float4s per CTA.  At most 32 registers a
// thread, so that 2048 threads fit on an SM.
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
    for (int k = 0; k < U; ++k) v[k] = load4(d + threadIdx.x + k * step);
#pragma unroll
    for (int k = 0; k < U; ++k) store4(o + threadIdx.x + k * step, scale4(v[k], scale));
  } else {
    const unsigned rest = (unsigned)left;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (threadIdx.x + k * step < rest) v[k] = load4(d + threadIdx.x + k * step);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (threadIdx.x + k * step < rest) store4(o + threadIdx.x + k * step, scale4(v[k], scale));
    }
  }
  // The n % 4 elements after the last float4.
  const long long i = (n & ~3LL) + threadIdx.x;
  if (blockIdx.x == 0 && i < n) out[i] = __fmul_rn(data[i], scale);
}

#if K7_BULK
// The measurement build K7_BULK=1: Hopper's 1-D bulk copy.  K7_BULK_CTAS
// persistent CTAs an SM each stream their chunks of K7_BULK_CHUNK bytes
// (every gridDim.x-th chunk) through a ring of K7_BULK_STAGES stages in
// shared memory.  Thread 0 issues each chunk's load, which completes on the
// stage's mbarrier, and, once all threads have multiplied the stage in
// place, its store; it refills a stage once the store from it has been read
// out.  A thread that waits on an mbarrier for about 2**20 polls traps, so
// that a fault fails the launch instead of hanging the card.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (int polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1 << 20)) __trap();
  }
}

__global__ void __launch_bounds__(1024)
    multiply_bulk(const float* __restrict__ data, float* __restrict__ out, long long n,
                  float scale) {
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K7_BULK_STAGES * K7_BULK_CHUNK);
  const long long bytes = (n >> 2) * 16;
  const long long chunks = (bytes + K7_BULK_CHUNK - 1) / K7_BULK_CHUNK;
  const long long mine =
      chunks > blockIdx.x ? (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  // The byte offset and length of this CTA's i-th chunk.
  auto offset = [&](long long i) { return (blockIdx.x + i * gridDim.x) * K7_BULK_CHUNK; };
  auto length = [&](long long i) {
    const long long left = bytes - offset(i);
    return (unsigned)(left < K7_BULK_CHUNK ? left : K7_BULK_CHUNK);
  };
  auto load = [&](long long i) {
    const int s = (int)(i % K7_BULK_STAGES);
    const unsigned len = length(i);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(&full[s])),
                 "r"(len)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(ring + s * K7_BULK_CHUNK)),
        "l"(reinterpret_cast<const char*>(data) + offset(i)), "r"(len),
        "r"(smem_addr(&full[s]))
        : "memory");
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < K7_BULK_STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long i = 0; i < K7_BULK_STAGES && i < mine; ++i) load(i);
  }
  __syncthreads();
  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % K7_BULK_STAGES);
    mbar_wait(&full[s], (unsigned)((i / K7_BULK_STAGES) & 1));
    float4* v = reinterpret_cast<float4*>(ring + s * K7_BULK_CHUNK);
    const unsigned len = length(i);
    for (unsigned j = threadIdx.x; j < len / 16; j += blockDim.x) v[j] = scale4(v[j], scale);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                       reinterpret_cast<char*>(out) + offset(i)),
                   "r"(smem_addr(v)), "r"(len)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // Refill the stage of chunk i - 1 once its store has read it out.
      if (i >= 1 && i - 1 + K7_BULK_STAGES < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        load(i - 1 + K7_BULK_STAGES);
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  // The n % 4 elements after the last float4.
  const long long i = (n & ~3LL) + threadIdx.x;
  if (blockIdx.x == 0 && i < n) out[i] = __fmul_rn(data[i], scale);
}
#endif

// The earlier kernel: a grid-stride loop with one float4 in flight per thread
// (`vec`), or one element at a time.
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

// K7: out[i] = data[i] * scale for i < n, one tile of `threads` * K7_UNROLL
// float4s per CTA of `threads` threads (a multiple of 32, at most 1024), on
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
#if K7_BULK
  return on_device(device, [&] {
    int sms = 0;
    int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int smem = K7_BULK_STAGES * K7_BULK_CHUNK + K7_BULK_STAGES * 8;
    if (!err) {
      err = (int)cudaFuncSetAttribute(multiply_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
    }
    if (err) return err;
    multiply_bulk<<<sms * K7_BULK_CTAS, threads, smem, s>>>(d, o, n, scale);
    return (int)cudaGetLastError();
  });
#else
  const long long tile = (long long)threads * K7_UNROLL;
  long long blocks = ((n >> 2) + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks < 1) blocks = 1;  // n < 4: the ragged tail alone
  return on_device(device, [&] {
    multiply_tiles<K7_UNROLL><<<(unsigned)blocks, threads, 0, s>>>(d, o, n, scale);
    return (int)cudaGetLastError();
  });
#endif
}

// The same function by the earlier design of K7, the grid-stride kernel; for
// the A/B.
int ex_multiply_grid_stride(const void* data, void* out, long long n, float scale,
                            int threads, int device, void* stream) {
  if (bad_args(n, threads)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return on_device(device, [&] {
    return launch_grid_stride(static_cast<const float*>(data), static_cast<float*>(out), n,
                              scale, threads, aligned(data, out),
                              static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
