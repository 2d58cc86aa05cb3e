// Fused 1-D RFI flagger kernels for Hopper (sm_90a), with a plain C ABI.
//
// K1 `flagger_kernel` replaces the TPU kernel
//   katsdpsigproc_tpu/models/rfi/pallas_flagger.py::_flagger_body
// (amplitude, width-W masked median background, MAD-of-non-zero noise by a
// 31-round bitwise rank search, SumThreshold, flags x flag_value -> u8).
// K2 `madnz_threshold_kernel` replaces its back half
//   pallas_flagger.py::_madnz_threshold_block
// (MAD noise + SumThreshold from deviations; the hybrid engine).
// Both are single launches over all rows, one CTA per row, which takes the
// place of the TPU's double-buffered HBM->VMEM block loop
//   pallas_flagger.py::_dma_block_loop.
//
// What bounds it on the card: the minimum traffic is 9 B per visibility
// (8 B planar read, 1 B flag write; K2 reads 4 B of deviations), about
// 0.7 ms for the 32768 x 8064 dump at 3.35 TB/s.  The row never leaves
// shared memory, so the limit is on-chip work: 31 dependent block-wide
// count reductions per row (each a full pass over the row in shared memory
// plus two barriers' worth of latency), the 13-member selection network per
// channel, and the window ladders.
//
// What the design does about it: one CTA of 1024 threads owns a whole row
// (C x 4 B of deviations + C x 1 B of flags in dynamic shared memory, so
// 160 KiB at 32768 channels), reads each visibility once and writes each
// flag once.  The deviations overwrite the amplitudes in place, one tile of
// 1024 channels at a time, with a small halo holding the amplitudes that
// the next tile's windows still need.  Each block-wide reduction is a warp
// `__reduce_*_sync` plus one barrier over a double-banked partials buffer.
// Faster variants (prefetching the next row, fewer reduction rounds) are
// later work; this is the simple, exact version.
//
// Parity with the JAX reference, bit for bit:
//  * no FMA contraction anywhere (built with -fmad=false), and re*re+im*im
//    is written with __fmul_rn/__fadd_rn; sqrt is the IEEE __fsqrt_rn;
//  * averages are (a + b) * 0.5f in float32, in the JAX operand order;
//  * window sums are built in Kogge-Stone tree order,
//    s8 = ((x0+x1)+(x2+x3))+((x4+x5)+(x6+x7)), compared as sum > thr * window;
//  * the per-window threshold scales are float32(falloff ** -w) computed in
//    double on the host, and base = float32(n_sigma) * noise;
//  * min/max in the selection networks propagate NaN as jnp.minimum and
//    jnp.maximum do (CUDA's fminf/fmaxf would drop it).
// The selection networks come from ff_network.h, which the loader renders
// from katsdpsigproc_tpu_torch.ops.rank.selection_network for the width.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ff_network.h"  // FF_WIDTH, FF_NET_FAST(w), FF_NET_LOWER(w)

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWindows = 16;
constexpr int kHalf = FF_WIDTH / 2;

static_assert(FF_WIDTH % 2 == 1 && kHalf >= 1 && kHalf <= 15, "odd width 3..31");

struct Params {
  int channels;
  int n_windows;  // windows 1, 2, ..., 2**(n_windows-1), all <= channels
  float n_sigma;
  float scales[kMaxWindows];
  int flag_value;
};

// Shared memory: deviations (C floats), flags (C bytes), then the
// reduction partials (two banks of kWarps ints) and the median halo.
__host__ __device__ inline size_t flags_offset(int c) { return (size_t)c * 4; }
__host__ __device__ inline size_t scratch_offset(int c) {
  return ((size_t)c * 5 + 15) & ~(size_t)15;
}
constexpr size_t kScratchBytes = 2 * kWarps * sizeof(int) + 16 * sizeof(float);
__host__ inline size_t smem_bytes(int c) { return scratch_offset(c) + kScratchBytes; }

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

// Block-wide sum (or max) of one value per thread; every thread receives
// the result.  The partials alternate between two banks, so one barrier per
// reduction suffices: a bank is rewritten only after the barrier of the
// reduction in between, which every thread reaches after its reads.
__device__ __forceinline__ int block_sum(int v, int* red, int& bank) {
  v = __reduce_add_sync(0xffffffffu, v);
  int* b = red + bank * kWarps;
  if ((threadIdx.x & 31) == 0) b[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
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

// Median background over the row in `buf` (amplitudes, +inf where flagged),
// replaced in place by the deviations.  kFast: no input flags and
// C >= FF_WIDTH, so members are absent only at the edges and the +-inf
// parity fills pin the median at sorted ranks kHalf and kHalf + 1
// (pallas_flagger.py::_median_parity_fill).  Otherwise the masked path
// (pallas_flagger.py::_masked_median_rows and _flagger_body:702-720).
template <bool kFast, bool kUseFlags>
__device__ void median_to_deviations(float* buf, float* halo, int C) {
  for (int base = 0; base < C; base += kThreads) {
    const int c = base + threadIdx.x;
    float amp = 0.f;
    float dev = 0.f;
    if (c < C) {
      float w[FF_WIDTH];
#pragma unroll
      for (int k = 0; k < FF_WIDTH; ++k) {
        const int d = k - kHalf;
        const int j = c + d;
        float x;
        if (j < 0 || j >= C) {
          if (kFast) {
            // -inf iff the out-of-range distance is odd: the parity of
            // -d at the left edge, of d + C - 1 at the right edge, taken
            // relative to the parity of c (_median_parity_fill:325-339).
            const int q = d < 0 ? ((-d) & 1) : ((d + C - 1) & 1);
            const bool c_odd = (c & 1) != 0;
            x = (q ? !c_odd : c_odd) ? -CUDART_INF_F : CUDART_INF_F;
          } else {
            x = CUDART_INF_F;
          }
        } else if (j < base) {
          x = halo[j - base + kHalf];  // previous tile, already deviations in buf
        } else {
          x = buf[j];
        }
        w[k] = x;
      }
      amp = w[kHalf];
      if (kFast) {
        FF_NET_FAST(w);
        const float lo = w[kHalf];
        const float hi = w[kHalf + 1];
        const int k_abs = max(kHalf - c, 0) + max(c - (C - 1 - kHalf), 0);
        const float med = (k_abs & 1) == 0 ? lo : __fmul_rn(__fadd_rn(lo, hi), 0.5f);
        dev = __fsub_rn(amp, med);
      } else {
        int n = 0;
#pragma unroll
        for (int k = 0; k < FF_WIDTH; ++k) {
          if (kUseFlags) {
            n += (w[k] != CUDART_INF_F);
          } else {
            const int j = c + k - kHalf;
            n += (j >= 0 && j < C);
          }
        }
        FF_NET_LOWER(w);
        const int lo_rank = (n - 1) >> 1;  // floor division, as jnp's (n - 1) // 2
        const int hi_rank = n >> 1;
        float v_lo = 0.f;
        float v_hi = 0.f;
#pragma unroll
        for (int k = 0; k <= kHalf; ++k) {
          if (lo_rank == k) v_lo = w[k];
          if (hi_rank == k) v_hi = w[k];
        }
        const float med = __fmul_rn(__fadd_rn(v_lo, v_hi), 0.5f);
        // Flagged centres map to deviation 0 (the host's NaN -> 0 fill).
        dev = amp == CUDART_INF_F ? 0.f : __fsub_rn(amp, med);
      }
    }
    __syncthreads();  // every window of this tile has read its members
    if (c < C) {
      // The next tile's first windows reach back kHalf channels.
      if (threadIdx.x >= kThreads - kHalf) halo[threadIdx.x - (kThreads - kHalf)] = amp;
      buf[c] = dev;
    }
    __syncthreads();
  }
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

// MAD noise + SumThreshold on the deviations of one row in shared memory;
// writes the row's flags (pallas_flagger.py::_madnz_band, radix 1, and
// ::_threshold_sum_band).
__device__ void madnz_threshold_row(const float* dev, uint8_t* flags, int* red, uint8_t* out,
                                    const Params& p) {
  const int C = p.channels;
  int bank = 0;

  // Noise: median of the non-zero |dev| as the global strict-rank target
  // (C + zeros) // 2, halfway when C + zeros is even.  NaN counts nowhere.
  int z = 0;
  for (int c = threadIdx.x; c < C; c += kThreads) z += (fabsf(dev[c]) == 0.f);
  z = block_sum(z, red, bank);
  const int rank2 = C + z;
  const int target = rank2 >> 1;
  const bool halfway = (rank2 & 1) == 0;
  unsigned cur = 0;
  int r_cur = 0;  // count(|dev| < cur): 0 for cur = 0
  for (int i = 0; i < 31; ++i) {
    const unsigned test = cur | (1u << (30 - i));
    const float cand = __uint_as_float(test);
    int cnt = 0;
    for (int c = threadIdx.x; c < C; c += kThreads) cnt += (fabsf(dev[c]) < cand);
    cnt = block_sum(cnt, red, bank);
    if (cnt <= target) {
      cur = test;
      r_cur = cnt;
    }
  }
  const float result = __uint_as_float(cur);
  unsigned below = 0;  // bits of the largest |dev| < result, or of +0
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float a = fabsf(dev[c]);
    if (a < result) below = max(below, __float_as_uint(a));
  }
  const float prev = __uint_as_float(block_max(below, red, bank));
  const float med =
      (halfway && r_cur == target) ? __fmul_rn(__fadd_rn(result, prev), 0.5f) : result;
  const float noise = __fmul_rn(1.4826f, med);
  const float base = __fmul_rn(p.n_sigma, noise);

  // SumThreshold.  flags[c] bit 0: flagged so far; bit 1: this window's
  // sum flag.  Each thread keeps its channels' bits in a register mask
  // between barriers, so no byte is written while others read it.
  for (int c = threadIdx.x; c < C; c += kThreads) flags[c] = 0;
  __syncthreads();
  for (int w = 0; w < p.n_windows; ++w) {
    const int window = 1 << w;
    const float thr = __fmul_rn(base, p.scales[w]);
    const float thr_w = __fmul_rn(thr, (float)window);
    const int last = C - window;  // full windows start at c <= last
    unsigned long long mask = 0;
    int k = 0;
    for (int c = threadIdx.x; c < C; c += kThreads, ++k) {
      if (c <= last && window_sum(dev, flags, c, w, thr) > thr_w) mask |= 1ull << k;
    }
    __syncthreads();
    k = 0;
    for (int c = threadIdx.x; c < C; c += kThreads, ++k) {
      if ((mask >> k) & 1) flags[c] |= 2;
    }
    __syncthreads();
    // Dilation: flag c if any window starting in [c - window + 1, c] hit.
    mask = 0;
    k = 0;
    for (int c = threadIdx.x; c < C; c += kThreads, ++k) {
      bool hit = false;
      for (int j = max(c - window + 1, 0); j <= c; ++j) hit |= (flags[j] & 2) != 0;
      if (hit) mask |= 1ull << k;
    }
    __syncthreads();
    k = 0;
    for (int c = threadIdx.x; c < C; c += kThreads, ++k) {
      flags[c] = (flags[c] & 1) | ((mask >> k) & 1);
    }
    __syncthreads();
  }
  const uint8_t fv = (uint8_t)p.flag_value;
  for (int c = threadIdx.x; c < C; c += kThreads) out[c] = (flags[c] & 1) ? fv : 0;
}

// K1.  kMode 0: no input flags; 1: FULL (rows, C) u8; 2: CHANNEL (C,) u8.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    flagger_kernel(const float2* __restrict__ vis, const uint8_t* __restrict__ in_flags,
                   uint8_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.channels;
  float* buf = reinterpret_cast<float*>(smem);
  uint8_t* flags = smem + flags_offset(C);
  int* red = reinterpret_cast<int*>(smem + scratch_offset(C));
  float* halo = reinterpret_cast<float*>(red + 2 * kWarps);
  const size_t row = blockIdx.x;

  const float2* v = vis + row * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float2 x = v[c];
    float a = __fsqrt_rn(__fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y)));
    if (kMode == 1 && in_flags[row * C + c] != 0) a = CUDART_INF_F;
    if (kMode == 2 && in_flags[c] != 0) a = CUDART_INF_F;
    buf[c] = a;
  }
  __syncthreads();
  if (kMode == 0 && C >= FF_WIDTH) {
    median_to_deviations<true, false>(buf, halo, C);
  } else {
    median_to_deviations<false, kMode != 0>(buf, halo, C);
  }
  madnz_threshold_row(buf, flags, red, out + row * C, p);
}

// K2.
__global__ void __launch_bounds__(kThreads, 1)
    madnz_threshold_kernel(const float* __restrict__ dev, uint8_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.channels;
  float* buf = reinterpret_cast<float*>(smem);
  uint8_t* flags = smem + flags_offset(C);
  int* red = reinterpret_cast<int*>(smem + scratch_offset(C));
  const size_t row = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += kThreads) buf[c] = dev[row * C + c];
  __syncthreads();
  madnz_threshold_row(buf, flags, red, out + row * C, p);
}

int make_params(Params* p, int channels, float n_sigma, const float* scales, int n_windows,
                int flag_value) {
  if (channels < 1 || n_windows < 0 || n_windows > kMaxWindows ||
      (n_windows > 0 && (1 << (n_windows - 1)) > channels) ||
      (channels + kThreads - 1) / kThreads > 64 || flag_value < 0 || flag_value > 255) {
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

extern "C" {

// The largest channel count whose row fits one CTA's shared memory on the
// current device (0 on error).
int ff_max_channels(void) {
  int device = 0;
  int optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess) {
    return 0;
  }
  int c = (int)((optin - (int)kScratchBytes) / 5);
  while (c > 0 && smem_bytes(c) > (size_t)optin) --c;
  return c;
}

const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1 over `rows` rows of planar (re, im) float32 pairs, (rows, channels, 2).
// mode 0: in_flags unused; 1: (rows, channels) u8; 2: (channels,) u8.
// Returns a cudaError_t; 0 when the launch was accepted.
int ff_flagger(const void* vis, const void* in_flags, int mode, void* out, int rows,
               int channels, float n_sigma, const float* scales, int n_windows,
               int flag_value, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value);
  if (err) return err;
  if (rows < 1 || mode < 0 || mode > 2 || (mode != 0 && in_flags == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(channels);
  const float2* v = static_cast<const float2*>(vis);
  const uint8_t* f = static_cast<const uint8_t*>(in_flags);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      if ((err = set_smem(flagger_kernel<0>, smem))) return err;
      flagger_kernel<0><<<rows, kThreads, smem, s>>>(v, f, o, p);
      break;
    case 1:
      if ((err = set_smem(flagger_kernel<1>, smem))) return err;
      flagger_kernel<1><<<rows, kThreads, smem, s>>>(v, f, o, p);
      break;
    default:
      if ((err = set_smem(flagger_kernel<2>, smem))) return err;
      flagger_kernel<2><<<rows, kThreads, smem, s>>>(v, f, o, p);
      break;
  }
  return (int)cudaGetLastError();
}

// K2 over (rows, channels) float32 deviations.
int ff_madnz_threshold(const void* dev, void* out, int rows, int channels, float n_sigma,
                       const float* scales, int n_windows, int flag_value, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value);
  if (err) return err;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(channels);
  if ((err = set_smem(madnz_threshold_kernel, smem))) return err;
  madnz_threshold_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dev), static_cast<uint8_t*>(out), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
