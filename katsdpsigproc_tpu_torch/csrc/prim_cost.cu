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
// and (no TPU body) shift_reg: y[lane + 1] + x with the lane taken modulo
// kPart inside each piece of kPart channels.  The min(., 3) barriers keep
// the compiler from folding a linear chain, as they keep XLA from it
// (prim_cost.py:16-26).
//
// What bounds it: operations, by design: each rep is a few dependent
// instructions per element, and the block is read and written once.  An
// operation's cost depends on the machine it runs on, as the TPU's depended
// on the block's layout, so the chains run at K1's launch (k1_prim_kernel),
// exactly as K1's flagger_kernel launches at 32768 channels: kThreads
// threads a CTA, one CTA per row, K1's dynamic shared memory
// (runs::smem_bytes(32768), 151840 B: one CTA per SM),
// __launch_bounds__(kThreads, 1) (at most 64 registers a thread).  The
// row of C channels (a multiple of 64, up to 32768) is loaded coalesced into
// shared memory in the run layout of ff_runs.cuh (channel c at word
// runs::phys(c)) and stored back coalesced, as K1 loads and stores its row;
// thread t owns the run of kRun = 32 channels from 32t, as in K1's
// SumThreshold at 32768 channels (threads from C / 32 on own none).  Each
// body prices its primitive the way K1 executes it:
//   add, mul, select, cmp_f32, sqrt: the arithmetic above in registers, a
//     piece of kPart channels of the run at a time (an elementwise chain
//     needs nothing of other channels); sqrt is __fsqrt_rn, K1's amplitude;
//   minmax: runs::min_nan / runs::max_nan, the min.NaN.f32 / max.NaN.f32 of
//     K1's selection networks;
//   shift_ch, roll_lane: the member at channel c + 1 (c - 1) read from the
//     padded row in shared memory, as runs::median_to_deviations reads its
//     members; the carry x goes back into the row for the next rep, one
//     store per read (the median stores one deviation per 13 reads);
//   reduce: a thread's sum over its run, then the warp and block reduction
//     of runs::block_sum32, in float;
//   rank_round: one round of runs::mad_noise: a count over the run against
//     the threshold, runs::block_sum32 (a warp reduction, the partials
//     through shared memory behind one barrier, a warp reduction), and the
//     threshold's update.  The chain needs y (the previous x) whole and x
//     only through x[row, 0]: x_i = min(y_i, 3) + n_(i-1) for i >= 1, so a
//     thread keeps y's run in registers and every thread tracks x[row, 0]
//     as mad_noise tracks its candidate, with the same operations a rep;
//   shift_reg: the roll inside a piece in registers, as SumThreshold's
//     doubling reads s[i + m] (runs::run_hits): no instruction beyond the
//     add that takes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ff_runs.cuh"  // kThreads, kWarps, set_smem, the run layout, K1's comparators

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
  kShiftReg = 11,  // no TPU body
};

constexpr float kC = 3.0f;
constexpr float kC2 = 5.0f;

__device__ __forceinline__ float y0_of(float x) { return __fadd_rn(__fmul_rn(x, 0.5f), 0.125f); }

constexpr int kRun = 32;                      // runs::run_length(32768)
constexpr int kPart = 8;                      // channels an elementwise chain holds at once
constexpr int kK1Channels = kRun * kThreads;  // 32768

static_assert(kRun % kPart == 0, "whole pieces");

// The float block sum of runs::block_sum32: a warp reduction, the warp
// partials in one of two banks behind one barrier, then a warp reduction of
// the kWarps partials, one load a lane.  Butterfly sums of commutative adds
// leave every lane the same value.
__device__ __forceinline__ float block_fsum32(float v, float* red, int& bank) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  float* b = red + bank * kWarps;
  if ((threadIdx.x & 31) == 0) b[threadIdx.x >> 5] = v;
  __syncthreads();
  bank ^= 1;
  float s = b[threadIdx.x & 31];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// One rep of an elementwise body over a piece of kPart channels.
template <int kBody>
__device__ __forceinline__ void piece_rep(float (&x)[kPart], float (&y)[kPart], bool lower) {
  float nx[kPart];
#pragma unroll
  for (int k = 0; k < kPart; ++k) {
    if constexpr (kBody == kAdd) {
      nx[k] = __fadd_rn(fminf(x[k], kC), y[k]);
    } else if constexpr (kBody == kMinMax) {
      nx[k] = __fadd_rn(runs::min_nan(x[k], kC), runs::max_nan(y[k], kC2));
    } else if constexpr (kBody == kMul) {
      nx[k] = __fadd_rn(__fmul_rn(x[k], y[k]), 1.0f);
    } else if constexpr (kBody == kSelect) {
      nx[k] = __fadd_rn(lower ? y[k] : x[k], y[k]);
    } else if constexpr (kBody == kCmpF32) {
      nx[k] = __fadd_rn(x[k], y[k] < x[k] ? 1.0f : 0.0f);
    } else if constexpr (kBody == kSqrt) {
      nx[k] = __fadd_rn(x[k], __fsqrt_rn(__fadd_rn(__fmul_rn(y[k], y[k]), 1.0f)));
    } else {
      static_assert(kBody == kShiftReg, "not an elementwise body");
      nx[k] = __fadd_rn(y[(k + 1) % kPart], x[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPart; ++k) {
    y[k] = x[k];
    x[k] = nx[k];
  }
}

// An elementwise body over the run, a piece of kPart channels at a time in
// registers (kEmpty: y0 and the output only).
template <int kBody, int kUnroll>
__device__ __forceinline__ void elementwise_chain(float* p, bool lower, int steps) {
#pragma unroll 1
  for (int q = 0; q < kRun; q += kPart) {
    float x[kPart];
    float y[kPart];
#pragma unroll
    for (int k = 0; k < kPart; ++k) {
      x[k] = p[q + k];
      y[k] = y0_of(x[k]);
    }
    if constexpr (kBody != kEmpty) {
      for (int s = 0; s < steps; ++s) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) piece_rep<kBody>(x, y, lower);
      }
    }
#pragma unroll
    for (int k = 0; k < kPart; ++k) p[q + k] = __fadd_rn(x[k], y[k]);
  }
}

// One rep of shift_ch or roll_lane: x's run in registers, y (the previous
// x) in the padded row; `edge` is the word of the channel past the run's
// end, the next run's first (shift_ch) or the previous run's last
// (roll_lane).
template <int kBody>
__device__ __forceinline__ void neighbour_rep(float (&x)[kRun], float* p, const float* edge,
                                              bool active) {
  const float v_edge = active ? *edge : 0.f;
  __syncthreads();  // every thread has read its edge before it is rewritten
  if (active) {
    if constexpr (kBody == kShiftCh) {
      // Channel c0 + k + 1 is read before this thread rewrites it.
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const float v = k + 1 < kRun ? p[k + 1] : v_edge;
        p[k] = x[k];
        x[k] = __fadd_rn(v, x[k]);
      }
    } else {
      static_assert(kBody == kRollLane, "a neighbour body");
#pragma unroll
      for (int k = kRun - 1; k >= 0; --k) {
        const float v = k > 0 ? p[k - 1] : v_edge;
        p[k] = x[k];
        x[k] = __fadd_rn(fminf(v, kC), x[k]);
      }
    }
  }
  __syncthreads();  // the row holds this rep's y before the next rep reads it
}

template <int kBody, int kUnroll>
__device__ __forceinline__ void neighbour_chain(float* p, const float* edge, bool active,
                                                int steps) {
  float x[kRun];
  if (active) {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      x[k] = p[k];
      p[k] = y0_of(x[k]);
    }
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) neighbour_rep<kBody>(x, p, edge, active);
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kRun; ++k) p[k] = __fadd_rn(x[k], p[k]);
  }
}

// One rep i >= 1 of reduce or rank_round, on one array of the run in
// registers and scalars every thread holds alike.
//   reduce:     v holds x_i, s = sum(y_i); x_(i+1) = min(x_i, 3) + s, and
//               sum(y_(i+1)) = sum(x_i) (`z` unused).
//   rank_round: v holds y_i, s = n_(i-1) (the count of the rep before),
//               z = x_i[row, 0], tracked by every thread as mad_noise tracks
//               its candidate; n_i = count(y_i < z), y_(i+1) = x_i =
//               min(y_i, 3) + n_(i-1), z = min(z, 3) + n_i.
template <int kBody>
__device__ __forceinline__ void scalar_rep(float (&v)[kRun], float& s, float& z, int* red,
                                           int& bank, bool active) {
  if constexpr (kBody == kReduce) {
    float sum = 0.f;
    if (active) {
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        sum = __fadd_rn(sum, v[k]);
        v[k] = __fadd_rn(fminf(v[k], kC), s);
      }
    }
    s = block_fsum32(sum, reinterpret_cast<float*>(red), bank);
  } else {
    static_assert(kBody == kRankRound, "a row-wide body");
    int c = 0;
    if (active) {
#pragma unroll
      for (int k = 0; k < kRun; ++k) c += v[k] < z;
    }
    const float count = (float)runs::block_sum32(c, red, bank);
    if (active) {
#pragma unroll
      for (int k = 0; k < kRun; ++k) v[k] = __fadd_rn(fminf(v[k], kC), s);
    }
    z = __fadd_rn(fminf(z, kC), count);
    s = count;
  }
}

// reduce and rank_round: rep 0 from x_0 (z0 = x_0[row, 0]), then the other
// steps x kUnroll - 1 reps (steps >= 1).  The output is x_n + y_n =
// (min(v, 3) + s) + v.
template <int kBody, int kUnroll>
__device__ __forceinline__ void scalar_chain(float* p, int* red, bool active, float z0,
                                             int steps) {
  float v[kRun];
  if (active) {
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = p[k];
  }
  int bank = 0;
  float s;
  float z = 0.f;
  if constexpr (kBody == kReduce) {
    float part = 0.f;
    if (active) {
#pragma unroll
      for (int k = 0; k < kRun; ++k) part = __fadd_rn(part, y0_of(v[k]));
    }
    s = block_fsum32(part, reinterpret_cast<float*>(red), bank);  // sum(y_0)
  } else {
    int cnt = 0;
    if (active) {
#pragma unroll
      for (int k = 0; k < kRun; ++k) cnt += y0_of(v[k]) < z0;
    }
    s = (float)runs::block_sum32(cnt, red, bank);  // n_0; v holds x_0 = y_1
    z = __fadd_rn(fminf(z0, kC), s);
  }
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) scalar_rep<kBody>(v, s, z, red, bank, active);
  for (int i = 1; i < steps; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) scalar_rep<kBody>(v, s, z, red, bank, active);
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kRun; ++k) p[k] = __fadd_rn(__fadd_rn(fminf(v[k], kC), s), v[k]);
  }
}

template <int kBody, int kUnroll>
__global__ void __launch_bounds__(kThreads, 1)
    k1_prim_kernel(const float* __restrict__ in, float* __restrict__ out, int C, int steps) {
  extern __shared__ __align__(16) float smem[];
  float* row = smem;  // channel c at word runs::phys(c)
  int* red = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) +
                                    runs::masks_offset(kK1Channels));
  const float* src = in + (size_t)blockIdx.x * C;
  float* dst = out + (size_t)blockIdx.x * C;
  for (int c = threadIdx.x; c < C; c += kThreads) row[runs::phys(c)] = src[c];
  __syncthreads();

  const int c0 = threadIdx.x * kRun;
  const bool active = c0 < C;
  float* p = row + runs::phys(c0);  // channel c0 + k at p[k], k < kRun
  constexpr bool kElementwise = kBody != kShiftCh && kBody != kRollLane && kBody != kReduce &&
                                kBody != kRankRound;
  if constexpr (kElementwise) {
    // C % 64 == 0, so a run lies wholly on one side of C / 2.
    if (active) elementwise_chain<kBody, kUnroll>(p, c0 < C / 2, steps);
  } else if (steps == 0) {
    if (active) elementwise_chain<kEmpty, kUnroll>(p, false, 0);
  } else if constexpr (kBody == kShiftCh || kBody == kRollLane) {
    const int edge = kBody == kShiftCh ? (c0 + kRun == C ? 0 : c0 + kRun)
                                       : (c0 == 0 ? C - 1 : c0 - 1);
    neighbour_chain<kBody, kUnroll>(p, row + runs::phys(edge), active, steps);
  } else {
    scalar_chain<kBody, kUnroll>(p, red, active, row[0], steps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) dst[c] = row[runs::phys(c)];
}

// Calls f with the kernel of `kBody` unrolled `unroll` times.
template <int kBody, typename F>
int with_unroll(int unroll, F&& f) {
  switch (unroll) {
    case 1: return f(k1_prim_kernel<kBody, 1>);
    case 2: return f(k1_prim_kernel<kBody, 2>);
    case 4: return f(k1_prim_kernel<kBody, 4>);
    case 8: return f(k1_prim_kernel<kBody, 8>);
    case 16: return f(k1_prim_kernel<kBody, 16>);
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
    case kShiftReg: return with_unroll<kShiftReg>(unroll, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

int check_k1(int channels) {
  return channels < 64 || channels > kK1Channels || channels % 64 != 0
             ? (int)cudaErrorInvalidValue
             : 0;
}

// K1's dynamic shared memory at 32768 channels.
size_t k1_smem() { return runs::smem_bytes(kK1Channels); }

// Threads, shared memory and the CTAs that fit one SM for `kernel`.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem, int* threads_out, long long* smem_out,
              int* ctas_per_sm) {
  int err = set_smem(kernel, smem);
  if (!err) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, smem);
  }
  *threads_out = threads;
  *smem_out = (long long)smem;
  return err;
}

}  // namespace

extern "C" {

// As in fused_flagger.cu, so the wrappers share their checks.
const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// How `body` launches at K1's launch: kThreads threads, K1's dynamic shared
// memory at 32768 channels, and the CTAs that fit one SM at once.
int pc_k1_launch_config(int body, int unroll, int* threads, long long* smem_out,
                        int* ctas_per_sm) {
  *threads = kThreads;
  *smem_out = (long long)k1_smem();
  return with_kernel(body, unroll, [&](auto kernel) {
    return occupancy(kernel, kThreads, k1_smem(), threads, smem_out, ctas_per_sm);
  });
}

// The chain of `body` over (rows, channels) float32 `in` to `out`, steps x
// unroll reps, at K1's launch: one CTA of kThreads threads per row with
// K1's dynamic shared memory.  `channels` is a multiple of 64 up to 32768.
// Returns a cudaError_t; 0 when the launch was accepted.
int pc_k1_chain(int body, int unroll, const void* in, void* out, int rows, int channels,
                int steps, void* stream) {
  int err = check_k1(channels);
  if (err) return err;
  if (rows < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  err = with_kernel(body, unroll, [&](auto kernel) {
    int e = set_smem(kernel, k1_smem());
    if (e) return e;
    kernel<<<rows, kThreads, k1_smem(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(in), static_cast<float*>(out), channels, steps);
    return 0;
  });
  return err ? err : (int)cudaGetLastError();
}

}  // extern "C"
