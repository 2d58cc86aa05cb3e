// The per-primitive cost probe K8 for Hopper (sm_90a), with a plain C ABI.
// It replaces scripts/prim_cost.py::make_kernel.kernel (:90, call :116),
// the TPU kernel that times a dependent chain of one vector primitive over a
// (rows, width) float32 block.
//
// Semantics (make_kernel :82-123): x0 from the input, y0 = x0 * 0.5 + 0.125,
// then steps x kUnroll reps of (x, y) -> (body(x, y), x), and the output
// x + y.  kEmpty is the kernel with no reps, whose time is subtracted.  The
// bodies (prim_cost.py:133-162), each operation rounded once:
//   add        min(x, 3) + y
//   minmax     min(x, 3) + max(y, 5)
//   mul        x * y + 1
//   select     (lane < width / 2 ? y : x) + y
//   cmp_f32    x + (y < x)
//   roll_lane  min(y[lane - 1], 3) + x            (a lane roll by 1, wrapped)
//   shift_ch   y[lane + 1] + x                    (the channel shift at h = 1)
//   reduce     min(x, 3) + sum(y over the row)
//   rank_round min(x, 3) + count(y < x[row, lane 0])
//   sqrt       x + sqrt(y * y + 1)
// The min(., 3) barriers keep the compiler from folding a linear chain, as
// they keep XLA from it (prim_cost.py:16-26).
//
// Layout: one CTA per row, one thread per lane (width <= 1024), so x and y
// live in registers and every body but the neighbour and row-wide ones is
// one dependent chain per thread.  A lane roll is a neighbour in shared
// memory behind a barrier, as K1 reads a median member; `reduce` is a warp
// shuffle tree and one barrier over double-banked partials; `rank_round`
// broadcasts lane 0's x through shared memory and counts with
// __syncthreads_count.
//
// What bounds it: operations, by design: each rep is a few dependent
// instructions per element, and the block (1 MiB at 256 x 1024) is read and
// written once.  The wrapper launches with the strided layout's dynamic
// shared memory (ff_device.cuh), so one CTA runs per SM as in K2's strided
// design, K1's stage probes and K10: the cost of an operation depends on
// the occupancy it runs at, as the TPU's depended on the block's layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Body : int {
  kEmpty = 0,
  kAdd = 1,
  kMinMax = 2,
  kMul = 3,
  kSelect = 4,
  kCmpF32 = 5,
  kRollLane = 6,
  kShiftCh = 7,
  kReduce = 8,
  kRankRound = 9,
  kSqrt = 10,
};

constexpr float kC = 3.0f;
constexpr float kC2 = 5.0f;
constexpr int kMaxWidth = 1024;

// Shared memory: two banks of `width` floats for the lane rolls, two banks
// of 32 partial sums, and lane 0's value for rank_round.
__host__ __device__ inline size_t needed_smem(int width) {
  return (2 * (size_t)width + 2 * 32 + 1) * sizeof(float);
}

__device__ __forceinline__ float block_sum(float v, float* part, int& bank) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  float* b = part + bank * 32;
  if ((threadIdx.x & 31) == 0) b[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  const int warps = blockDim.x >> 5;
  for (int i = 0; i < warps; ++i) s = __fadd_rn(s, b[i]);
  bank ^= 1;
  return s;
}

// y's value at lane `src` of this row, through bank `bank` of the roll buffer.
__device__ __forceinline__ float neighbour(float y, int src, float* roll, int& bank) {
  float* b = roll + bank * blockDim.x;
  b[threadIdx.x] = y;
  __syncthreads();
  bank ^= 1;
  return b[src];
}

struct Lanes {
  bool mask;  // lane < width / 2
  int left;   // lane - 1, wrapped
  int right;  // lane + 1, wrapped
};

template <int kBody>
__device__ __forceinline__ float rep(float x, float y, const Lanes& l, float* smem, int& bank) {
  const int width = blockDim.x;
  if constexpr (kBody == kAdd) {
    return __fadd_rn(fminf(x, kC), y);
  } else if constexpr (kBody == kMinMax) {
    return __fadd_rn(fminf(x, kC), fmaxf(y, kC2));
  } else if constexpr (kBody == kMul) {
    return __fadd_rn(__fmul_rn(x, y), 1.0f);
  } else if constexpr (kBody == kSelect) {
    return __fadd_rn(l.mask ? y : x, y);
  } else if constexpr (kBody == kCmpF32) {
    return __fadd_rn(x, y < x ? 1.0f : 0.0f);
  } else if constexpr (kBody == kRollLane) {
    return __fadd_rn(fminf(neighbour(y, l.left, smem, bank), kC), x);
  } else if constexpr (kBody == kShiftCh) {
    return __fadd_rn(neighbour(y, l.right, smem, bank), x);
  } else if constexpr (kBody == kReduce) {
    return __fadd_rn(fminf(x, kC), block_sum(y, smem + 2 * width, bank));
  } else if constexpr (kBody == kRankRound) {
    // One slot suffices: lane 0 rewrites it only after the count's barrier,
    // which every thread reaches after reading it.
    float* lane0 = smem + 2 * width + 64;
    if (threadIdx.x == 0) *lane0 = x;
    __syncthreads();
    const int count = __syncthreads_count(y < *lane0);
    return __fadd_rn(fminf(x, kC), (float)count);
  } else {
    static_assert(kBody == kSqrt, "unknown body");
    return __fadd_rn(x, __fsqrt_rn(__fadd_rn(__fmul_rn(y, y), 1.0f)));
  }
}

template <int kBody, int kUnroll>
__global__ void __launch_bounds__(kMaxWidth, 1)
    prim_kernel(const float* __restrict__ in, float* __restrict__ out, int steps) {
  extern __shared__ __align__(16) float smem[];
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float x = in[i];
  float y = __fadd_rn(__fmul_rn(x, 0.5f), 0.125f);
  if constexpr (kBody != kEmpty) {
    const int width = blockDim.x;
    const Lanes l{(int)threadIdx.x < (width >> 1),
                  threadIdx.x == 0 ? width - 1 : (int)threadIdx.x - 1,
                  (int)threadIdx.x == width - 1 ? 0 : (int)threadIdx.x + 1};
    int bank = 0;
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float next = rep<kBody>(x, y, l, smem, bank);
        y = x;
        x = next;
      }
    }
  }
  out[i] = __fadd_rn(x, y);
}

template <int kBody, typename F>
int with_unroll(int unroll, F&& f) {
  switch (unroll) {
    case 1: return f(prim_kernel<kBody, 1>);
    case 2: return f(prim_kernel<kBody, 2>);
    case 4: return f(prim_kernel<kBody, 4>);
    case 8: return f(prim_kernel<kBody, 8>);
    case 16: return f(prim_kernel<kBody, 16>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Calls f with the kernel of `body` unrolled `unroll` times.
template <typename F>
int with_kernel(int body, int unroll, F&& f) {
  switch (body) {
    case kEmpty: return with_unroll<kEmpty>(unroll, f);
    case kAdd: return with_unroll<kAdd>(unroll, f);
    case kMinMax: return with_unroll<kMinMax>(unroll, f);
    case kMul: return with_unroll<kMul>(unroll, f);
    case kSelect: return with_unroll<kSelect>(unroll, f);
    case kCmpF32: return with_unroll<kCmpF32>(unroll, f);
    case kRollLane: return with_unroll<kRollLane>(unroll, f);
    case kShiftCh: return with_unroll<kShiftCh>(unroll, f);
    case kReduce: return with_unroll<kReduce>(unroll, f);
    case kRankRound: return with_unroll<kRankRound>(unroll, f);
    case kSqrt: return with_unroll<kSqrt>(unroll, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

int check_shape(int width, long long smem) {
  if (width < 32 || width > kMaxWidth || width % 32 != 0 || smem < (long long)needed_smem(width)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename Kernel>
int set_smem(Kernel kernel, long long bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" {

// As in fused_flagger.cu, so the wrappers share their checks.
const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The shared memory a launch at `width` needs at least.
long long pc_needed_smem(int width) { return (long long)needed_smem(width); }

// How `body` launches at `width` threads with `smem` bytes of dynamic
// shared memory: threads per CTA, the shared memory, and the CTAs that fit
// one SM at once.
int pc_launch_config(int body, int unroll, int width, long long smem, int* threads,
                     long long* smem_out, int* ctas_per_sm) {
  int err = check_shape(width, smem);
  if (err) return err;
  err = with_kernel(body, unroll, [&](auto kernel) {
    int e = set_smem(kernel, smem);
    if (e) return e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, width,
                                                              (size_t)smem);
  });
  *threads = width;
  *smem_out = smem;
  return err;
}

// The chain of `body` over (rows, width) float32 `in` to `out`, steps x
// unroll reps, one CTA of `width` threads per row with `smem` bytes of
// dynamic shared memory.  Returns a cudaError_t; 0 when the launch was
// accepted.
int pc_chain(int body, int unroll, const void* in, void* out, int rows, int width, int steps,
             long long smem, void* stream) {
  int err = check_shape(width, smem);
  if (err) return err;
  if (rows < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  err = with_kernel(body, unroll, [&](auto kernel) {
    int e = set_smem(kernel, smem);
    if (e) return e;
    kernel<<<rows, width, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(in), static_cast<float*>(out), steps);
    return 0;
  });
  return err ? err : (int)cudaGetLastError();
}

}  // extern "C"
