// Device code of the fused 1-D flagger shared by K1 and K2
// (fused_flagger.cu) and by K1's stage probes (flagger_probe.cu): the
// launch's parameters, the amplitude, the block reductions, the median's
// edge fills and selection networks, the rank search's target and the
// channel-strided stage arithmetic that the wide-row path runs on a row in
// device memory.  The run layout of ff_runs.cuh builds K1's shared-memory
// row on top of it.  The arithmetic rules that keep every stage bit for
// bit equal to the JAX reference are in fused_flagger.cu's header.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// FF_WIDTH, and either FF_NET_FAST(w) and FF_NET_LOWER(w), the selection
// networks over a window's members in registers, or FF_MEDIAN_COUNT, where
// the window is too wide for that and count_deviation takes the ranks.
#include "ff_network.h"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWindows = 16;
constexpr int kHalf = FF_WIDTH / 2;

static_assert(FF_WIDTH % 2 == 1 && kHalf >= 1, "odd width >= 3");

struct Params {
  int channels;
  int n_windows;  // windows 1, 2, ..., 2**(n_windows-1), all <= channels
  float n_sigma;
  float scales[kMaxWindows];
  int flag_value;
};

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

#define FF_CE_BOTH(w, i, j)      \
  {                              \
    const float a_ = (w)[i];     \
    const float b_ = (w)[j];     \
    (w)[i] = nan_min(a_, b_);    \
    (w)[j] = nan_max(a_, b_);    \
  }
#define FF_CE_MIN(w, i, j) \
  { (w)[i] = nan_min((w)[i], (w)[j]); }
#define FF_CE_MAX(w, i, j) \
  { (w)[j] = nan_max((w)[i], (w)[j]); }

// |re + i im|, each operation rounded once.
__device__ __forceinline__ float amplitude(float2 x) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y)));
}

// Block-wide sum (or max) of one value per thread; every thread receives
// the result.  The partials alternate between two banks, so one barrier per
// reduction suffices: a bank is rewritten only after the barrier of the
// reduction in between, which every thread reaches after its reads.
template <typename T>
__device__ __forceinline__ T block_sum(T v, int* red, int& bank) {
  v = __reduce_add_sync(0xffffffffu, v);
  T* b = reinterpret_cast<T*>(red) + bank * kWarps;
  if ((threadIdx.x & 31) == 0) b[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += b[i];
  bank ^= 1;
  return s;
}

__device__ __forceinline__ unsigned block_max(unsigned v, int* red, int& bank) {
  v = __reduce_max_sync(0xffffffffu, v);
  unsigned* b = reinterpret_cast<unsigned*>(red) + bank * kWarps;
  if ((threadIdx.x & 31) == 0) b[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) m = max(m, b[i]);
  bank ^= 1;
  return m;
}

// The fast path's fill for the member at offset d of channel c, out of
// range: -inf iff the out-of-range distance is odd, the parity of -d at the
// left edge, of d + C - 1 at the right edge, taken relative to the parity
// of c (pallas_flagger.py::_median_parity_fill:325-339).
__device__ __forceinline__ float edge_fill(int c, int d, int C) {
  const int q = d < 0 ? ((-d) & 1) : ((d + C - 1) & 1);
  const bool c_odd = (c & 1) != 0;
  return (q ? !c_odd : c_odd) ? -CUDART_INF_F : CUDART_INF_F;
}

// The fast path's median of the sorted window: ranks kHalf and kHalf + 1
// hold it, averaged where the window lost an odd number of members.
__device__ __forceinline__ float fast_median(const float* w, int c, int C) {
  const float lo = w[kHalf];
  const float hi = w[kHalf + 1];
  const int k_abs = max(kHalf - c, 0) + max(c - (C - 1 - kHalf), 0);
  return (k_abs & 1) == 0 ? lo : __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

#ifndef FF_MEDIAN_COUNT
// The deviation of channel c, its window's members read by get(j) for j in
// [0, C) and filled past the row's edges: the arithmetic of the edge tiles
// of ff_runs.cuh's median_to_deviations, for a row in device memory.
template <bool kFast, bool kUseFlags, typename Get>
__device__ __forceinline__ float network_deviation(Get get, int c, int C) {
  float w[FF_WIDTH];
#pragma unroll
  for (int k = 0; k < FF_WIDTH; ++k) {
    const int d = k - kHalf;
    const int j = c + d;
    w[k] = (j < 0 || j >= C) ? (kFast ? edge_fill(c, d, C) : CUDART_INF_F) : get(j);
  }
  const float amp = w[kHalf];
  if (kFast) {
    FF_NET_FAST(w);
    return __fsub_rn(amp, fast_median(w, c, C));
  }
  int n = 0;
#pragma unroll
  for (int k = 0; k < FF_WIDTH; ++k) {
    const int j = c + k - kHalf;
    n += kUseFlags ? (w[k] != CUDART_INF_F) : (j >= 0 && j < C);
  }
  FF_NET_LOWER(w);
  const int lo_rank = (n - 1) >> 1;
  const int hi_rank = n >> 1;
  float v_lo = 0.f;
  float v_hi = 0.f;
#pragma unroll
  for (int k = 0; k <= kHalf; ++k) {
    if (lo_rank == k) v_lo = w[k];
    if (hi_rank == k) v_hi = w[k];
  }
  const float med = __fmul_rn(__fadd_rn(v_lo, v_hi), 0.5f);
  return amp == CUDART_INF_F ? 0.f : __fsub_rn(amp, med);
}
#endif  // FF_MEDIAN_COUNT

// The deviation of channel c as network_deviation computes it, for windows
// too wide for their members to sit in registers (FF_MEDIAN_COUNT): the
// sorted rank r of the members m is the member m_i with
// count(m < m_i) <= r < count(m <= m_i), each member read from get(j)
// (shared or device memory) FF_WIDTH + 2 times.  A NaN member makes the
// median NaN, as the networks' NaN-propagating min/max make it: an output
// of a selection network depends on every input, so a NaN input reaches it.
// Amplitudes are never -0, so equal members are equal bits.
template <bool kFast, bool kUseFlags, typename Get>
__device__ float count_deviation(Get get, int c, int C) {
  const auto member = [&](int k) {
    const int d = k - kHalf;
    const int j = c + d;
    return (j < 0 || j >= C) ? (kFast ? edge_fill(c, d, C) : CUDART_INF_F) : get(j);
  };
  int n = 0;
  bool nan = false;
  for (int k = 0; k < FF_WIDTH; ++k) {
    const float x = member(k);
    const int j = c + k - kHalf;
    nan |= x != x;
    n += kUseFlags ? (x != CUDART_INF_F) : (j >= 0 && j < C);
  }
  // The fast path's ranks kHalf and kHalf + 1; the masked path's middle
  // ranks of the n members present (a rank of -1 selects nothing: 0).
  const int lo_rank = kFast ? kHalf : (n - 1) >> 1;
  const int hi_rank = kFast ? kHalf + 1 : n >> 1;
  float v_lo = 0.f;
  float v_hi = 0.f;
  for (int i = 0; i < FF_WIDTH; ++i) {
    const float x = member(i);
    int lt = 0;
    int le = 0;
    for (int k = 0; k < FF_WIDTH; ++k) {
      const float y = member(k);
      lt += y < x;
      le += y <= x;
    }
    if (lt <= lo_rank && lo_rank < le) v_lo = x;
    if (lt <= hi_rank && hi_rank < le) v_hi = x;
  }
  const float amp = get(c);
  const float avg = __fmul_rn(__fadd_rn(v_lo, v_hi), 0.5f);
  if (kFast) {
    const int k_abs = max(kHalf - c, 0) + max(c - (C - 1 - kHalf), 0);
    const float med = nan ? CUDART_NAN_F : ((k_abs & 1) == 0 ? v_lo : avg);
    return __fsub_rn(amp, med);
  }
  return amp == CUDART_INF_F ? 0.f : __fsub_rn(amp, nan ? CUDART_NAN_F : avg);
}

__device__ __forceinline__ float clamped(const float* dev, const uint8_t* flags, int j, float thr) {
  return (flags[j] & 1) ? thr : dev[j];
}

// Sum of the 2**L clamped values from c, in Kogge-Stone tree order.
template <int L>
__device__ __forceinline__ float tree_sum(const float* dev, const uint8_t* flags, int c, float thr) {
  if constexpr (L == 0) {
    return clamped(dev, flags, c, thr);
  } else {
    return __fadd_rn(tree_sum<L - 1>(dev, flags, c, thr),
                     tree_sum<L - 1>(dev, flags, c + (1 << (L - 1)), thr));
  }
}

// The same tree order for any L: a stack of completed power-of-two blocks,
// merged left + right as each block completes.
__device__ float tree_sum_any(const float* dev, const uint8_t* flags, int c, int L, float thr) {
  float stack[kMaxWindows + 1];
  int top = 0;
  for (int j = 0; j < (1 << L); ++j) {
    float v = clamped(dev, flags, c + j, thr);
    for (int m = j; m & 1; m >>= 1) v = __fadd_rn(stack[--top], v);
    stack[top++] = v;
  }
  return stack[0];
}

__device__ __forceinline__ float window_sum(const float* dev, const uint8_t* flags, int c, int L,
                                            float thr) {
  switch (L) {
    case 0: return tree_sum<0>(dev, flags, c, thr);
    case 1: return tree_sum<1>(dev, flags, c, thr);
    case 2: return tree_sum<2>(dev, flags, c, thr);
    case 3: return tree_sum<3>(dev, flags, c, thr);
    case 4: return tree_sum<4>(dev, flags, c, thr);
    case 5: return tree_sum<5>(dev, flags, c, thr);
    default: return tree_sum_any(dev, flags, c, L, thr);
  }
}

// The rank search's target for the noise: the median of the non-zero
// |dev| is the global strict-rank target (C + zeros) // 2, halfway when
// C + zeros is even.  NaN counts nowhere.
struct RankTarget {
  int target;
  bool halfway;
};

__device__ __forceinline__ RankTarget rank_target(int C, int zeros) {
  const int rank2 = C + zeros;
  return {rank2 >> 1, (rank2 & 1) == 0};
}

__device__ __forceinline__ int count_zeros(const float* dev, int C) {
  int z = 0;
  for (int c = threadIdx.x; c < C; c += kThreads) z += (fabsf(dev[c]) == 0.f);
  return z;
}

__device__ __forceinline__ int count_less(const float* dev, int C, float cand) {
  int cnt = 0;
  for (int c = threadIdx.x; c < C; c += kThreads) cnt += (fabsf(dev[c]) < cand);
  return cnt;
}

// The noise from the rank search's result: `cur` holds the bits of the
// largest candidate with count(|dev| < cand) <= target and `r_cur` that
// count (0 for cur = 0).  Halfway, the median averages it with the largest
// |dev| below it.
__device__ float noise_from_rank(const float* dev, int* red, int& bank, int C, unsigned cur,
                                 int r_cur, RankTarget t) {
  const float result = __uint_as_float(cur);
  unsigned below = 0;  // bits of the largest |dev| < result, or of +0
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float a = fabsf(dev[c]);
    if (a < result) below = max(below, __float_as_uint(a));
  }
  const float prev = __uint_as_float(block_max(below, red, bank));
  const float med =
      (t.halfway && r_cur == t.target) ? __fmul_rn(__fadd_rn(result, prev), 0.5f) : result;
  return __fmul_rn(1.4826f, med);
}

// MAD noise of the deviations of one row (the wide-row path's, in device
// memory), one bit per dependent round (pallas_flagger.py::_madnz_band,
// radix 1).
__device__ float mad_noise(const float* dev, int* red, int& bank, int C) {
  const RankTarget t = rank_target(C, block_sum(count_zeros(dev, C), red, bank));
  unsigned cur = 0;
  int r_cur = 0;  // count(|dev| < cur): 0 for cur = 0
  for (int i = 0; i < 31; ++i) {
    const unsigned test = cur | (1u << (30 - i));
    const int cnt = block_sum(count_less(dev, C, __uint_as_float(test)), red, bank);
    if (cnt <= t.target) {
      cur = test;
      r_cur = cnt;
    }
  }
  return noise_from_rank(dev, red, bank, C, cur, r_cur, t);
}

// The launch's parameters; `any_length` lifts the limit of 64 channels a
// thread that the run layout's register masks set.
int make_params(Params* p, int channels, float n_sigma, const float* scales, int n_windows,
                int flag_value, bool any_length = false) {
  if (channels < 1 || n_windows < 0 || n_windows > kMaxWindows ||
      (n_windows > 0 && (1 << (n_windows - 1)) > channels) ||
      (!any_length && (channels + kThreads - 1) / kThreads > 64) || flag_value < 0 ||
      flag_value > 255) {
    return (int)cudaErrorInvalidValue;
  }
  p->channels = channels;
  p->n_windows = n_windows;
  p->n_sigma = n_sigma;
  for (int i = 0; i < kMaxWindows; ++i) p->scales[i] = i < n_windows ? scales[i] : 0.f;
  p->flag_value = flag_value;
  return 0;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace
