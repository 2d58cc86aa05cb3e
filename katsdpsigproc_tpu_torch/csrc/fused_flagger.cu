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
// (8 B planar read, 1 B flag write; K2 reads 4 B of deviations: 0.394 ms),
// 0.710 ms for the 32768 x 8064 dump at 3.35 TB/s.  The row never leaves shared
// memory, so the limit is on-chip work: the 13-member selection network per
// channel, the window ladders, and 31 dependent block-wide count reductions
// per row, each a pass over the row plus a barrier.
//
// The row's layout is the run layout (ff_runs.cuh), one CTA per row that
// reads each visibility once and writes each flag once, of the fewest of
// 128-1024 threads whose rank search holds the row in registers (K2: 1024):
// deviations padded one word in 32, SumThreshold on per-thread runs of
// channels with bit-mask flags and window sums by doubling in registers,
// one-instruction min.NaN/max.NaN comparators in the median, the rank
// search's |dev| in registers.  Its header says what each does about the
// stage costs, and why the NaN payload and signed zero of min.NaN/max.NaN
// cannot reach the flags.  K2 runs K1's rank search and SumThreshold on
// the same layout, its deviations loaded coalesced into the padded words.
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
// from katsdpsigproc_tpu_torch.ops.rank.selection_network for the width;
// a window too wide for its members to sit in registers takes the median's
// ranks by counting instead (FF_MEDIAN_COUNT, ff_device.cuh's
// count_deviation), equal to the networks' on every input.
//
// The wide-row path: a row longer than the run layout holds
// (runs::max_channels, 52310 channels on the H100), or a window wider than
// the run layout's in-place median takes (runs::kMaxInPlaceWidth), runs
// K1's and K2's stages in ff_device.cuh's channel-strided arithmetic on
// the CTA's slice of a device scratch buffer instead of shared memory:
// amplitudes, deviations, flags and hits, 10 B a channel.  The reduction partials stay
// in static shared memory.  A grid of (SMs x CTAs per SM) CTAs loops over
// the rows, so the scratch is that many rows, not the dump's.  Every pass
// over the row (31 rank rounds, each window's sums) reads device memory or
// the caches: the simple design that is right at any channel count.

#include "ff_runs.cuh"  // includes ff_device.cuh

namespace {

// K1.  kMode 0: no input flags; 1: FULL (rows, C) u8; 2: CHANNEL (C,) u8.
// kT threads a CTA, 1024 / kT CTAs to an SM at 64 registers a thread (the
// caller's rule, fused_flagger.py::k1_threads, picks kT from C).  Its stage
// probes (flagger_probe.cu, K11 and K13) repeat kMode 0 with one stage
// replaced, at the 1024-thread launch.
template <int kMode, int kT>
__global__ void __launch_bounds__(kT, kThreads / kT)
    flagger_kernel(const float2* __restrict__ vis, const uint8_t* __restrict__ in_flags,
                   uint8_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.channels;
  float* buf = reinterpret_cast<float*>(smem);
  runs::u64* flag_masks = reinterpret_cast<runs::u64*>(smem + runs::masks_offset(C));
  runs::u64* hit_masks = flag_masks + kT;
  int* red = reinterpret_cast<int*>(hit_masks + kT);
  float* stage = reinterpret_cast<float*>(red + 2 * (kT / 32));  // below 1024 threads
  const size_t row = blockIdx.x;

  const float2* v = vis + row * C;
  for (int c = threadIdx.x; c < C; c += kT) {
    float a = amplitude(v[c]);
    if (kMode == 1 && in_flags[row * C + c] != 0) a = CUDART_INF_F;
    if (kMode == 2 && in_flags[c] != 0) a = CUDART_INF_F;
    buf[c] = a;
  }
  __syncthreads();
  if (kMode == 0 && C >= FF_WIDTH) {
    runs::median_to_deviations<true, false, kT>(buf, C, stage);
  } else {
    runs::median_to_deviations<false, kMode != 0, kT>(buf, C, stage);
  }
  int bank = 0;
  const float noise = runs::mad_noise<kT>(buf, red, bank, C);
  runs::sum_threshold<kT>(buf, flag_masks, hit_masks, noise, out + row * C, p);
}

// K2, in the run layout: the deviations, coalesced, into the padded words,
// then K1's rank search and SumThreshold.  Unlike K1's, its deviations come
// from the caller and may hold NaN, +-inf, -0 or denormals: the rank search
// counts by float compares and SumThreshold sums in the reference's tree
// order, both as the plain version does for any float32.
__global__ void __launch_bounds__(kThreads, 1)
    madnz_threshold_kernel(const float* __restrict__ dev, uint8_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.channels;
  float* buf = reinterpret_cast<float*>(smem);
  runs::u64* flag_masks = reinterpret_cast<runs::u64*>(smem + runs::masks_offset(C));
  runs::u64* hit_masks = flag_masks + kThreads;
  int* red = reinterpret_cast<int*>(hit_masks + kThreads);
  const size_t row = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += kThreads) buf[runs::phys(c)] = dev[row * C + c];
  __syncthreads();
  int bank = 0;
  const float noise = runs::mad_noise(buf, red, bank, C);
  runs::sum_threshold(buf, flag_masks, hit_masks, noise, out + row * C, p);
}

// ---- The wide-row path ----

// A CTA's slice of the scratch: amplitudes, deviations, flags, hits.
__host__ __device__ inline size_t wide_row_bytes(int c) {
  return ((size_t)c * 10 + 15) & ~(size_t)15;
}

struct WideRow {
  float* amp;
  float* dev;
  uint8_t* flags;
  uint8_t* hits;
};

__device__ __forceinline__ WideRow wide_row(unsigned char* scratch, int C) {
  WideRow r;
  r.amp = reinterpret_cast<float*>(scratch + blockIdx.x * wide_row_bytes(C));
  r.dev = r.amp + C;
  r.flags = reinterpret_cast<uint8_t*>(r.dev + C);
  r.hits = r.flags + C;
  return r;
}

// Median background from the amplitudes `amp` into the deviations `dev`,
// channel-strided: the two arrays are apart, so no halo and any width.
template <bool kFast, bool kUseFlags>
__device__ void median_wide(const float* amp, float* dev, int C) {
  const auto get = [amp](int j) { return amp[j]; };
  for (int c = threadIdx.x; c < C; c += kThreads) {
#ifdef FF_MEDIAN_COUNT
    dev[c] = count_deviation<kFast, kUseFlags>(get, c, C);
#else
    dev[c] = network_deviation<kFast, kUseFlags>(get, c, C);
#endif
  }
  __syncthreads();
}

// SumThreshold (pallas_flagger.py::_threshold_sum_band) with a window's
// hits in their own bytes, so that a thread may own any number of
// channels: a window's sums read the flags and write the hits,
// its dilation reads the hits and writes the flags, each pass behind a
// barrier.
__device__ void sum_threshold_wide(const float* dev, uint8_t* flags, uint8_t* hits, float noise,
                                   uint8_t* out, const Params& p) {
  const int C = p.channels;
  const float base = __fmul_rn(p.n_sigma, noise);
  for (int c = threadIdx.x; c < C; c += kThreads) flags[c] = 0;
  __syncthreads();
  for (int w = 0; w < p.n_windows; ++w) {
    const int window = 1 << w;
    const float thr = __fmul_rn(base, p.scales[w]);
    const float thr_w = __fmul_rn(thr, (float)window);
    const int last = C - window;  // full windows start at c <= last
    for (int c = threadIdx.x; c < C; c += kThreads) {
      hits[c] = c <= last && window_sum(dev, flags, c, w, thr) > thr_w;
    }
    __syncthreads();
    // Dilation: flag c if any window starting in [c - window + 1, c] hit.
    for (int c = threadIdx.x; c < C; c += kThreads) {
      bool hit = false;
      for (int j = max(c - window + 1, 0); j <= min(c, last) && !hit; ++j) hit = hits[j] != 0;
      if (hit) flags[c] = 1;
    }
    __syncthreads();
  }
  const uint8_t fv = (uint8_t)p.flag_value;
  for (int c = threadIdx.x; c < C; c += kThreads) out[c] = flags[c] ? fv : 0;
}

// K1 on the wide-row path, every flag mode as flagger_kernel.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    flagger_wide_kernel(const float2* __restrict__ vis, const uint8_t* __restrict__ in_flags,
                        uint8_t* __restrict__ out, unsigned char* scratch, int rows, Params p) {
  __shared__ int red[2 * kWarps];
  const int C = p.channels;
  const WideRow r = wide_row(scratch, C);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float2* v = vis + (size_t)row * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float a = amplitude(v[c]);
      if (kMode == 1 && in_flags[(size_t)row * C + c] != 0) a = CUDART_INF_F;
      if (kMode == 2 && in_flags[c] != 0) a = CUDART_INF_F;
      r.amp[c] = a;
    }
    __syncthreads();
    if (kMode == 0 && C >= FF_WIDTH) {
      median_wide<true, false>(r.amp, r.dev, C);
    } else {
      median_wide<false, kMode != 0>(r.amp, r.dev, C);
    }
    int bank = 0;
    const float noise = mad_noise(r.dev, red, bank, C);
    sum_threshold_wide(r.dev, r.flags, r.hits, noise, out + (size_t)row * C, p);
    __syncthreads();  // the row's last reads end before the next row's writes
  }
}

// K2 on the wide-row path: its deviations are read where they lie.
__global__ void __launch_bounds__(kThreads, 1)
    madnz_threshold_wide_kernel(const float* __restrict__ dev, uint8_t* __restrict__ out,
                                unsigned char* scratch, int rows, Params p) {
  __shared__ int red[2 * kWarps];
  const int C = p.channels;
  const WideRow r = wide_row(scratch, C);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* d = dev + (size_t)row * C;
    int bank = 0;
    const float noise = mad_noise(d, red, bank, C);
    sum_threshold_wide(d, r.flags, r.hits, noise, out + (size_t)row * C, p);
    __syncthreads();
  }
}

// ---- BG: the hybrid engine's background pass ----
//
// background_kernel replaces the eager background pass of the hybrid engine
// (models/rfi/device.py::background_median_filter, then the turn of its
// deviations to baseline-major); no Pallas kernel: XLA computes it in the
// JAX package (katsdpsigproc_tpu/models/rfi/device.py:218).  It reads a
// slab of the channel-major dump where it lies, (channels, rows) planar
// pairs or amplitudes with any stride between channels, and writes the
// slab's float32 deviations (rows, channels), K2's layout.
//
// What bounds it: bytes.  8 B read and 4 B written a visibility, 0.947 ms
// for the 32768 x 8064 dump at 3.35 TB/s, against ~0.6 ms of the median's
// operations at 33.5e12 a second.  A CTA takes a tile of kBgTC channels x
// kBgTR rows and the kHalf channels beyond each end: the pairs are loaded
// along rows (a channel's rows are contiguous), each amplitude and invalid
// mark formed once into shared memory, a channel's rows kBgTR + 1 words
// apart.  A warp's lanes then take 32 adjacent channels of one row: each
// window member is one conflict-free load, and the deviations go out along
// the channels of a row of the output, 128 B a warp.  A tile of 64 channels
// computes 1.19 amplitudes (each a correctly rounded root) a visibility for
// its halo, where 32 computed 1.38 and took 9% longer; 128 took 2% longer
// (H100, 700 W, a 1008-row slab of the 32k dump).
//
// What it computes is background_median_filter's, bit for bit:
//  * general path (kBgGeneral): a member is absent where its amplitude is
//    NaN, flagged or (amplitudes) negative, or past the row's edge; the
//    absent become +inf before the network, the rest are counted (n), ranks
//    (n - 1) >> 1 and n >> 1 picked, their average taken from the picks
//    plus +0 (the plain version sums them into zeros, which turns a -0 of
//    an amplitude input into +0), and a NaN deviation written as 0;
//  * kBgKeepNan: the same median, NaN deviations kept (the plain fast
//    path's fallback on a row shorter than the window);
//  * fast path (kBgFast, no flags, visibilities): K1's edge fills and
//    fast_median, NaN propagating through the network.
// A tile whose cells, halo included, all lie inside the row and hold no NaN
// has every member of every window present (n = FF_WIDTH): its general
// paths pick rank kHalf twice, which FF_NET_FAST, the shorter network, sorts
// into place, with no count, no +inf fill and no rank select: 0.261 ms a
// 1008-row slab of the 32k dump, 45% of its bound, where every window on the
// general path took 0.385 ms.
// K1's own median counts members by edges or by != +inf, which differ on a
// NaN or a genuine +inf amplitude, so the general path counts NaN here.
constexpr int kBgGeneral = 0;
constexpr int kBgFast = 1;
constexpr int kBgKeepNan = 2;
constexpr int kBgTC = 64;                 // channels a tile: two groups of a warp's lanes
constexpr int kBgWarps = 8;               // a CTA's warps, each a row at a time
constexpr int kBgThreads = 32 * kBgWarps;
constexpr int kBgTR = 64;                 // rows a tile
constexpr int kBgLd = kBgTR + 1;          // words from a channel to the next: odd, so no conflicts
constexpr int kBgChans = kBgTC + 2 * kHalf;  // channels in shared memory, the halo included
constexpr int kBgLoads = 8;               // loads a thread keeps in flight
constexpr int kBgMaxWidth = 255;          // the widest window a tile takes

struct BgParams {
  int channels;
  int rows;
  long long in_stride;    // elements (pairs or amplitudes) from a channel to the next
  long long flag_stride;  // bytes from a channel's FULL flags to the next
};

// The median of a window of n members present from its picked ranks (NaN where n = 0).
__device__ __forceinline__ float bg_median(float v_lo, float v_hi, int n) {
  return n > 0 ? __fmul_rn(__fadd_rn(__fadd_rn(v_lo, v_hi), 0.f), 0.5f) : CUDART_NAN_F;
}

// The deviation of the channel whose members are at col[d * kBgLd],
// d = -kHalf .. kHalf (NaN: absent), on the general paths.
template <bool kZeroNan>
__device__ __forceinline__ float bg_masked_deviation(const float* col) {
  const float amp = col[0];
  int n = 0;
#ifdef FF_MEDIAN_COUNT
  const auto member = [col](int k) {
    const float x = col[(k - kHalf) * kBgLd];
    return x != x ? CUDART_INF_F : x;
  };
  for (int k = 0; k < FF_WIDTH; ++k) {
    const float x = col[(k - kHalf) * kBgLd];
    n += x == x;
  }
  const int lo_rank = (n - 1) >> 1;  // -1 where n = 0 selects nothing: 0
  const int hi_rank = n >> 1;
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
#else
  float w[FF_WIDTH];
#pragma unroll
  for (int k = 0; k < FF_WIDTH; ++k) {
    const float x = col[(k - kHalf) * kBgLd];
    const bool present = x == x;
    n += present;
    w[k] = present ? x : CUDART_INF_F;
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
#endif
  const float dev = __fsub_rn(amp, bg_median(v_lo, v_hi, n));
  return kZeroNan && dev != dev ? 0.f : dev;
}

#ifndef FF_MEDIAN_COUNT
// The general paths' deviation where every member is present (no NaN, all
// inside the row): n = FF_WIDTH, so both picked ranks are kHalf, which the
// fast path's shorter network sorts into place.
template <bool kZeroNan>
__device__ __forceinline__ float bg_full_deviation(const float* col) {
  float w[FF_WIDTH];
#pragma unroll
  for (int k = 0; k < FF_WIDTH; ++k) w[k] = col[(k - kHalf) * kBgLd];
  const float amp = w[kHalf];
  FF_NET_FAST(w);
  const float dev = __fsub_rn(amp, bg_median(w[kHalf], w[kHalf], FF_WIDTH));
  return kZeroNan && dev != dev ? 0.f : dev;
}
#endif

// The fast path's deviation of channel c, its members at col[d * kBgLd].
__device__ __forceinline__ float bg_fast_deviation(const float* col, int c, int C) {
#ifdef FF_MEDIAN_COUNT
  const auto get = [col, c](int j) { return col[(j - c) * kBgLd]; };
  return count_deviation<true, false>(get, c, C);
#else
  const bool interior = c >= kHalf && c + kHalf < C;
  float w[FF_WIDTH];
#pragma unroll
  for (int k = 0; k < FF_WIDTH; ++k) {
    const int d = k - kHalf;
    const int j = c + d;
    w[k] = interior || (j >= 0 && j < C) ? col[d * kBgLd] : edge_fill(c, d, C);
  }
  const float amp = w[kHalf];
  FF_NET_FAST(w);
  return __fsub_rn(amp, interior ? w[kHalf] : fast_median(w, c, C));
#endif
}

// kMode as K1's: 0 no flags, 1 FULL (a (channels, rows) u8 slab), 2 CHANNEL
// ((channels,) u8).  kAmp: `in` holds amplitudes, else (re, im) pairs.
template <int kMode, bool kAmp, int kPath>
__global__ void __launch_bounds__(kBgThreads)
    background_kernel(const void* __restrict__ in, const uint8_t* __restrict__ flags,
                      float* __restrict__ out, BgParams p) {
  extern __shared__ float amp_s[];  // [kBgChans][kBgLd]
  const int C = p.channels;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int c_base = blockIdx.x * kBgTC - kHalf;  // the channel at word 0
  const int r0 = blockIdx.y * kBgTR;
  constexpr int kCells = kBgChans * kBgTR;
  // The tile's amplitudes, NaN where absent: kBgLoads loads in flight a
  // thread.  `absent`: this thread stored a NaN in one of the tile's rows.
  bool absent = false;
  for (int i0 = 0; i0 < kCells; i0 += kBgLoads * kBgThreads) {
    float2 v[kBgLoads];
    uint8_t f[kBgLoads];
#pragma unroll
    for (int u = 0; u < kBgLoads; ++u) {
      const int i = i0 + u * kBgThreads + tid;
      const int c = c_base + i / kBgTR;
      const int r = r0 + i % kBgTR;
      v[u] = make_float2(CUDART_NAN_F, 0.f);
      f[u] = 0;
      if (i < kCells && c >= 0 && c < C && r < p.rows) {
        const long long at = c * p.in_stride + r;
        if (kAmp) {
          v[u].x = static_cast<const float*>(in)[at];
        } else {
          v[u] = static_cast<const float2*>(in)[at];
        }
        if (kMode == 1) f[u] = flags[c * p.flag_stride + r];
        if (kMode == 2) f[u] = flags[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kBgLoads; ++u) {
      const int i = i0 + u * kBgThreads + tid;
      if (i < kCells) {
        float a = kAmp ? v[u].x : amplitude(v[u]);
        if ((kAmp && a < 0.f) || f[u] != 0) a = CUDART_NAN_F;
        amp_s[(i / kBgTR) * kBgLd + i % kBgTR] = a;
        absent |= a != a && r0 + i % kBgTR < p.rows;
      }
    }
  }
  // Every member of every window of the tile present: its channels, halo
  // included, lie inside the row and hold no NaN.
  const bool full = !__syncthreads_or(absent);
  // A warp's lanes take 32 adjacent channels of a row, a group at a time.
  for (int x = threadIdx.x; x < kBgTC; x += 32) {
    const int c = blockIdx.x * kBgTC + x;
    if (c >= C) return;
    const float* col = amp_s + (x + kHalf) * kBgLd;
#ifndef FF_MEDIAN_COUNT
    if (kPath != kBgFast && full) {
      for (int rr = threadIdx.y; rr < kBgTR && r0 + rr < p.rows; rr += kBgWarps) {
        out[(size_t)(r0 + rr) * C + c] = bg_full_deviation<kPath == kBgGeneral>(col + rr);
      }
      continue;
    }
#endif
    for (int rr = threadIdx.y; rr < kBgTR && r0 + rr < p.rows; rr += kBgWarps) {
      const float dev = kPath == kBgFast ? bg_fast_deviation(col + rr, c, C)
                                         : bg_masked_deviation<kPath == kBgGeneral>(col + rr);
      out[(size_t)(r0 + rr) * C + c] = dev;
    }
  }
}

template <int kMode, bool kAmp, int kPath>
int bg_launch(const void* in, const uint8_t* flags, float* out, const BgParams& p,
              cudaStream_t s) {
  const size_t smem = (size_t)kBgChans * kBgLd * sizeof(float);
  if (int err = set_smem(background_kernel<kMode, kAmp, kPath>, smem)) return err;
  const dim3 grid((p.channels + kBgTC - 1) / kBgTC, (p.rows + kBgTR - 1) / kBgTR);
  background_kernel<kMode, kAmp, kPath><<<grid, dim3(32, kBgWarps), smem, s>>>(in, flags, out, p);
  return (int)cudaGetLastError();
}

template <bool kAmp>
int bg_launch_mode(int mode, const void* in, const uint8_t* flags, float* out, const BgParams& p,
                   cudaStream_t s) {
  switch (mode) {
    case 0: return bg_launch<0, kAmp, kBgGeneral>(in, flags, out, p, s);
    case 1: return bg_launch<1, kAmp, kBgGeneral>(in, flags, out, p, s);
    default: return bg_launch<2, kAmp, kBgGeneral>(in, flags, out, p, s);
  }
}

// The wide-row path's grid: SMs x the CTAs of `kernel` that fit one SM.
template <typename Kernel>
int wide_ctas(Kernel kernel) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
          cudaSuccess) {
    return 0;
  }
  return sms * per_sm;
}

// K1's instance of kT threads at `channels`: its launch configuration, or
// its launch over `rows` rows in flag mode `mode`.  A row's runs must fit a
// u64 mask (ceil(C / kT) <= 64).
template <int kT>
bool k1_takes(int channels) {
  return channels >= 1 && runs::run_length<kT>(channels) <= 64;
}

template <int kT>
int k1_launch_config(int channels, int* threads, long long* smem_bytes_out, int* ctas_per_sm) {
  if (!k1_takes<kT>(channels) || channels > runs::max_channels()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = runs::smem_bytes<kT>(channels);
  int err = set_smem(flagger_kernel<0, kT>, smem);
  if (!err) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, flagger_kernel<0, kT>,
                                                             kT, smem);
  }
  *threads = kT;
  *smem_bytes_out = (long long)smem;
  return err;
}

template <int kMode, int kT>
int k1_launch_mode(const float2* v, const uint8_t* f, uint8_t* o, int rows, const Params& p,
                   cudaStream_t s) {
  const size_t smem = runs::smem_bytes<kT>(p.channels);
  if (int err = set_smem(flagger_kernel<kMode, kT>, smem)) return err;
  flagger_kernel<kMode, kT><<<rows, kT, smem, s>>>(v, f, o, p);
  return (int)cudaGetLastError();
}

template <int kT>
int k1_launch(int mode, const float2* v, const uint8_t* f, uint8_t* o, int rows, const Params& p,
              cudaStream_t s) {
  if (!k1_takes<kT>(p.channels)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0: return k1_launch_mode<0, kT>(v, f, o, rows, p, s);
    case 1: return k1_launch_mode<1, kT>(v, f, o, rows, p, s);
    default: return k1_launch_mode<2, kT>(v, f, o, rows, p, s);
  }
}

}  // namespace

extern "C" {

// The largest channel count K1 and K2 take (a row in the run layout fits
// one CTA's shared memory on the current device; 0 on error).
int ff_max_channels(void) { return runs::max_channels(); }

const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1's launch configuration at `channels` in its instance of `block`
// threads a CTA (flagger_kernel<0, block>; the caller's rule picks
// `block`): threads per CTA, dynamic shared memory, and the CTAs that fit
// one SM at once.
int ff_launch_config(int channels, int block, int* threads, long long* smem_bytes_out,
                     int* ctas_per_sm) {
  switch (block) {
    case 128: return k1_launch_config<128>(channels, threads, smem_bytes_out, ctas_per_sm);
    case 256: return k1_launch_config<256>(channels, threads, smem_bytes_out, ctas_per_sm);
    case 512: return k1_launch_config<512>(channels, threads, smem_bytes_out, ctas_per_sm);
    case 1024: return k1_launch_config<1024>(channels, threads, smem_bytes_out, ctas_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1 over `rows` rows of planar (re, im) float32 pairs, (rows, channels, 2),
// in CTAs of `block` threads (128, 256, 512 or 1024, with runs of
// ceil(channels / block) <= 64 channels; the caller's rule picks it).
// mode 0: in_flags unused; 1: (rows, channels) u8; 2: (channels,) u8.
// Rows up to ff_max_channels() (a longer row's shared memory cannot be
// set) and windows up to ff_max_in_place_width(); the rest take
// ff_flagger_wide.  Returns a cudaError_t; 0 when the launch was accepted.
int ff_flagger(const void* vis, const void* in_flags, int mode, void* out, int rows,
               int channels, float n_sigma, const float* scales, int n_windows,
               int flag_value, int block, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value, true);
  if (err) return err;
  if (rows < 1 || mode < 0 || mode > 2 || (mode != 0 && in_flags == nullptr) ||
      !runs::kInPlaceMedian) {
    return (int)cudaErrorInvalidValue;
  }
  const float2* v = static_cast<const float2*>(vis);
  const uint8_t* f = static_cast<const uint8_t*>(in_flags);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: return k1_launch<128>(mode, v, f, o, rows, p, s);
    case 256: return k1_launch<256>(mode, v, f, o, rows, p, s);
    case 512: return k1_launch<512>(mode, v, f, o, rows, p, s);
    case 1024: return k1_launch<1024>(mode, v, f, o, rows, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// BG over a (channels, rows) slab `in` of planar (re, im) float32 pairs, or
// of float32 amplitudes where is_amplitude, channel c's rows from element
// c * in_stride: the (rows, channels) float32 deviations into `out`.  mode
// as ff_flagger's: 0, or 1 with (channels, rows) u8 flags from byte
// c * flag_stride, or 2 with (channels,) u8 flags.  path: 0 the general
// median (NaN deviations written as 0), 1 the fast path (mode 0 and pairs
// only, channels >= the width), 2 the general median keeping NaN (mode 0
// and pairs only).
int ff_background(const void* in, const void* flags, int mode, int is_amplitude, int path,
                  void* out, int channels, int rows, long long in_stride,
                  long long flag_stride, void* stream) {
  if (channels < 1 || rows < 1 || (rows + kBgTR - 1) / kBgTR > 65535 || mode < 0 || mode > 2 ||
      (mode != 0 && flags == nullptr) || path < 0 || path > 2 ||
      (path != kBgGeneral && (mode != 0 || is_amplitude)) ||
      (path == kBgFast && channels < FF_WIDTH) || FF_WIDTH > kBgMaxWidth) {
    return (int)cudaErrorInvalidValue;
  }
  const BgParams p{channels, rows, in_stride, flag_stride};
  const uint8_t* f = static_cast<const uint8_t*>(flags);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_amplitude) return bg_launch_mode<true>(mode, in, f, o, p, s);
  if (path == kBgFast) return bg_launch<0, false, kBgFast>(in, f, o, p, s);
  if (path == kBgKeepNan) return bg_launch<0, false, kBgKeepNan>(in, f, o, p, s);
  return bg_launch_mode<false>(mode, in, f, o, p, s);
}

// K2 over (rows, channels) float32 deviations.
int ff_madnz_threshold(const void* dev, void* out, int rows, int channels, float n_sigma,
                       const float* scales, int n_windows, int flag_value, void* stream) {
  if (channels > runs::max_channels()) return (int)cudaErrorInvalidValue;
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value);
  if (err) return err;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = runs::smem_bytes(channels);
  if ((err = set_smem(madnz_threshold_kernel, smem))) return err;
  madnz_threshold_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dev), static_cast<uint8_t*>(out), p);
  return (int)cudaGetLastError();
}

// The widest window ff_flagger takes.
int ff_max_in_place_width(void) { return runs::kMaxInPlaceWidth; }

// The wide-row path's grid, in CTAs (0 on error), and the scratch bytes it
// needs per CTA at `channels`: the caller allocates ctas x that.
int ff_wide_ctas(void) {
  const int k1 = wide_ctas(flagger_wide_kernel<0>);
  const int k2 = wide_ctas(madnz_threshold_wide_kernel);
  return k1 < k2 ? k1 : k2;
}
long long ff_wide_row_bytes(int channels) { return (long long)wide_row_bytes(channels); }

// K1 on the wide-row path, any channel count and width: the arguments of
// ff_flagger, and `scratch` of `ctas` x ff_wide_row_bytes(channels) bytes,
// `ctas` at most ff_wide_ctas().
int ff_flagger_wide(const void* vis, const void* in_flags, int mode, void* out, int rows,
                    int channels, float n_sigma, const float* scales, int n_windows,
                    int flag_value, void* scratch, int ctas, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value, true);
  if (err) return err;
  if (rows < 1 || ctas < 1 || mode < 0 || mode > 2 || (mode != 0 && in_flags == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = rows < ctas ? rows : ctas;
  const float2* v = static_cast<const float2*>(vis);
  const uint8_t* f = static_cast<const uint8_t*>(in_flags);
  uint8_t* o = static_cast<uint8_t*>(out);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: flagger_wide_kernel<0><<<grid, kThreads, 0, s>>>(v, f, o, sc, rows, p); break;
    case 1: flagger_wide_kernel<1><<<grid, kThreads, 0, s>>>(v, f, o, sc, rows, p); break;
    default: flagger_wide_kernel<2><<<grid, kThreads, 0, s>>>(v, f, o, sc, rows, p); break;
  }
  return (int)cudaGetLastError();
}

// K2 on the wide-row path, any channel count; scratch as for ff_flagger_wide.
int ff_madnz_threshold_wide(const void* dev, void* out, int rows, int channels, float n_sigma,
                            const float* scales, int n_windows, int flag_value, void* scratch,
                            int ctas, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value, true);
  if (err) return err;
  if (rows < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  const int grid = rows < ctas ? rows : ctas;
  madnz_threshold_wide_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dev), static_cast<uint8_t*>(out),
      static_cast<unsigned char*>(scratch), rows, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
