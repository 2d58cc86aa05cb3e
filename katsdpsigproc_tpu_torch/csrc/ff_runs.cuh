// Device code of K1, the fused 1-D flagger, in the run layout
// (fused_flagger.cu::flagger_kernel), whose rank search and SumThreshold
// K2 also runs (fused_flagger.cu::madnz_threshold_kernel).
//
// Replaces katsdpsigproc_tpu/models/rfi/pallas_flagger.py::_flagger_body.
// What bounds it: bytes.  9 B per visibility of traffic (8 B of planar
// pairs in, 1 B of flags out), 0.710 ms for the 32768 x 8064 dump at
// 3.35 TB/s.  The row never leaves shared memory, so what it spends beyond
// that is on-chip work.  On an H100 SXM at 700 W the channel-strided
// design this layout replaced (thread t owning channels t, t + 1024, ...
// of a row held as C x 4 B of deviations and C x 1 B of flags; it is in
// the repository's history) spent it as SumThreshold 5.3 ms, median 4.0,
// rank search 2.2, load + store 1.2 per dump.  K1's stage, rank-search and
// median-member probes (K11, K13, K9) and the roofline skeleton K10 run on
// this layout.
//
// One CTA per row, as there, but of kT threads, the fewest of 128, 256,
// 512 and 1024 whose rank search holds the row in registers (kRankRegs
// channels a thread; fused_flagger.py::k1_threads), and 1024 / kT CTAs to
// an SM.  A 4096-channel row takes 128 threads, eight rows to an SM, where
// one 1024-thread CTA spent a 32768-channel row's rank rounds and barriers
// on it with nothing to overlap them.  What changes:
//
//  * Row layout.  Amplitudes sit at word c; deviations at word
//    phys(c) = c + (c >> 5), one pad word per 32 channels.  A warp reading
//    32 consecutive channels (amplitude, rank search, median stores) and a
//    warp whose lanes each read their own run of 32 channels (SumThreshold)
//    both touch 32 distinct banks.  The median reads the amplitudes with
//    unaligned offsets, conflict-free only unpadded, so it reads them
//    unpadded and writes the deviations padded, one 1024-channel tile at a
//    time from the top down, 1024 / kT channels a thread: a tile's stores
//    land at phys(c) >= c + 32 past its base, above every amplitude a lower
//    tile still reads.  No halo, and one barrier per tile instead of two.
//  * Median.  The comparators are PTX min.NaN.f32 / max.NaN.f32 (sm_80+),
//    one instruction each where nan_min/nan_max take three or four (two
//    compares, an OR, a select), with the jnp.minimum/jnp.maximum
//    semantics: NaN if either input is.  They differ from nan_min/nan_max
//    in two ways, and neither can reach the flags, K1's only output:
//      - the NaN they return is the canonical one.  Downstream only
//        NaN-ness is ever tested: a NaN deviation fails every compare of
//        the rank search and of SumThreshold, whatever its payload;
//      - min.f32 orders -0 below +0, where nan_min returns its second
//        operand for equal zeros.  The network only sees amplitudes, which
//        are never -0 (the root of a sum of squares, +0 at least), +inf
//        where flagged and the +-inf edge fills.
//    Tiles clear of both row edges load their members with no edge test
//    and take rank kHalf as the median.
//  * SumThreshold.  Thread t owns the contiguous run of R = ceil(C / kT)
//    channels from tR (32 at 32768, and at 4096 in 128 threads) and keeps
//    their flags as a bit mask in a u64 register.  Window sums are built in
//    registers by doubling, s_2m[c] = s_m[c] + s_m[c + m], which is the
//    Kogge-Stone tree order of the reference,
//    s8 = ((x0+x1)+(x2+x3))+((x4+x5)+(x6+x7)), so every sum is bit for bit
//    the reference's.  A chunk of kChunk window starts loads kChunk + W - 1
//    deviations once, where the strided design loaded W deviations and W flag
//    bytes per start; the flags past the run come from the next thread's
//    published mask.  Dilation is shift-OR doubling of the hit mask, d_2m =
//    d_m | d_m << m, plus the previous thread's last W - 1 hits, where the
//    strided design read W flag bytes per channel.  Two barriers per window
//    (publish the flags, publish the hits) instead of four.  Windows wider
//    than 2**kFastLog, or rows whose runs are shorter than W - 1 (the chunk
//    would need flags and hits of runs beyond the neighbours), take a plainer
//    path that sums and dilates channel by channel from the published masks,
//    with the same barriers.  The flags go out channel-strided from the masks,
//    so a warp stores 32 adjacent bytes.
//  * Rank search.  Each thread keeps |dev| of its first 32 strided channels
//    (all of a row of up to 32 kT) in registers across the 31 rounds, where
//    the strided design loaded and took fabsf of them from shared memory
//    every round, and a round's block reduction reads the 32 warp partials
//    with one load a lane and a warp reduction instead of 32 loads a thread.
//  * Shared memory: 4.125 B per channel plus 16 KiB of masks, against 5 B
//    per channel, so the channel limit rises (max_channels).

#pragma once

#include "ff_device.cuh"  // kThreads, Params, amplitude, block reductions, rank target

// The selection networks of ff_network.h, expanded below this point, run on
// one-instruction NaN-propagating min/max.  The templates of ff_device.cuh
// were expanded above with nan_min/nan_max.
#undef FF_CE_BOTH
#undef FF_CE_MIN
#undef FF_CE_MAX
#define FF_CE_BOTH(w, i, j)           \
  {                                   \
    const float a_ = (w)[i];          \
    const float b_ = (w)[j];          \
    (w)[i] = runs::min_nan(a_, b_);   \
    (w)[j] = runs::max_nan(a_, b_);   \
  }
#define FF_CE_MIN(w, i, j) \
  { (w)[i] = runs::min_nan((w)[i], (w)[j]); }
#define FF_CE_MAX(w, i, j) \
  { (w)[j] = runs::max_nan((w)[i], (w)[j]); }

namespace {
namespace runs {

using u64 = unsigned long long;

constexpr int kChunk = 8;     // window starts per register chunk
constexpr int kFastLog = 3;   // windows up to 2**kFastLog are summed in registers

// Every function below takes the CTA's threads as its template parameter
// kT, 1024 (kThreads) unless given: K1 picks 128, 256, 512 or 1024 by the
// row's length (fused_flagger.py::k1_threads); K2, the probes and the cost
// probes use the default.
template <int kT>
constexpr int kStrideOf = kT + kT / 32;  // phys(c + kT) - phys(c)
constexpr int kStride = kStrideOf<kThreads>;

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__host__ __device__ inline int phys(int c) { return c + (c >> 5); }
template <int kT = kThreads>
__host__ __device__ inline int run_length(int c) {
  return (c + kT - 1) / kT;
}

// The median's tile: kTile channels whatever the CTA's size (see
// kMaxInPlaceWidth below), kTile / kT of them a thread.
constexpr int kTile = 1024;

// Shared memory: the row (amplitudes unpadded, then deviations padded, with
// room for the kChunk - 2 channels a last chunk reads past C), the flag
// masks and the hit masks (one u64 per thread each), the reduction partials
// (two banks of one int a warp), and below 1024 threads the median's
// staging words (one a channel of a tile).
__host__ __device__ inline size_t masks_offset(int c) {
  return ((size_t)phys(c + kChunk) * sizeof(float) + 15) & ~(size_t)15;
}
template <int kT>
constexpr size_t kTailBytesOf = 2 * kT * sizeof(u64) + 2 * (kT / 32) * sizeof(int) +
                                (kT < kTile ? kTile * sizeof(float) : 0);
constexpr size_t kTailBytes = kTailBytesOf<kThreads>;
template <int kT = kThreads>
__host__ inline size_t smem_bytes(int c) {
  return masks_offset(c) + kTailBytesOf<kT>;
}

// The largest channel count whose row fits one CTA's shared memory on the
// current device, and whose runs fit a u64 mask (0 on error).
int max_channels() {
  int device = 0;
  int optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess) {
    return 0;
  }
  const int fit = (int)((optin - (long long)kTailBytes) / 4 * 32 / 33);
  int c = fit < 64 * kThreads ? fit : 64 * kThreads;  // a run must fit a u64 mask
  while (c > 0 && smem_bytes(c) > (size_t)optin) --c;
  return c;
}

// The widest window whose members the top-down tiles below never
// overwrite before they are read: a tile's stores land at phys(base) >=
// base + 32, and the tile below reads up to base - 1 + kHalf.  Wider
// windows take the wide-row path (fused_flagger.cu).  A tile is kTile
// channels whatever the CTA's size: a tile of 128 would leave a margin of 4
// words.
constexpr int kMaxInPlaceWidth = 65;
constexpr bool kInPlaceMedian = FF_WIDTH <= kMaxInPlaceWidth;
static_assert(kTile / 32 >= kMaxInPlaceWidth / 2, "a tile's stores clear the tile below");

// One tile of the median, the kTile channels from `base`: dev_of(c, lo),
// the deviation of channel c in the step of kT channels from lo, for each
// of this thread's kTile / kT channels, then, behind the barrier after
// which no window of the tile reads an amplitude, each written at word
// phys(c).  A thread keeps its one channel in a register at 1024 threads
// and its several in `stage` below (its own words, so no barrier guards
// them): the wide windows' members already fill the registers.
template <int kT, typename DevOf>
__device__ __forceinline__ void median_tile(float* buf, float* stage, int base, int C,
                                            DevOf dev_of) {
  constexpr int kPer = kTile / kT;
  static_assert(kPer * kT == kTile, "a tile is whole steps of kT channels");
  float d = 0.f;
#pragma unroll 1  // one window's members in registers at a time
  for (int u = 0; u < kPer; ++u) {
    const int lo = base + u * kT;
    const int c = lo + threadIdx.x;
    const float v = c < C ? dev_of(c, lo) : 0.f;
    if constexpr (kPer == 1) {
      d = v;
    } else {
      stage[u * kT + threadIdx.x] = v;
    }
  }
  // The stores reach no amplitude a lower tile reads: phys(base) >=
  // base + 32 > base + kHalf.
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int c = base + u * kT + threadIdx.x;
    if constexpr (kPer > 1) d = stage[u * kT + threadIdx.x];
    if (c < C) buf[phys(c)] = d;
  }
}

#ifdef FF_MEDIAN_COUNT
// The median of a window too wide for registers: count_deviation's ranks
// from the members in shared memory, by the same top-down tiles as below.
template <bool kFast, bool kUseFlags, int kT = kThreads>
__device__ void median_to_deviations(float* buf, int C, float* stage = nullptr) {
  const auto get = [buf](int j) { return buf[j]; };
  const auto dev_of = [&](int c, int) { return count_deviation<kFast, kUseFlags>(get, c, C); };
  for (int base = (C - 1) / kTile * kTile; base >= 0; base -= kTile) {
    median_tile<kT>(buf, stage, base, C, dev_of);
  }
  __syncthreads();
}
#else
// The deviation of channel c from the amplitudes at words [0, C) (+inf
// where flagged).  kFast and kUseFlags as in ff_device.cuh's
// median_to_deviations, whose arithmetic this repeats; `interior`: the
// window lies inside the row, so its members need no edge test and rank
// kHalf is the median.
template <bool kFast, bool kUseFlags>
__device__ __forceinline__ float tile_deviation(const float* buf, int c, int C, bool interior) {
  float w[FF_WIDTH];
  if (interior) {
#pragma unroll
    for (int k = 0; k < FF_WIDTH; ++k) w[k] = buf[c + k - kHalf];
  } else {
#pragma unroll
    for (int k = 0; k < FF_WIDTH; ++k) {
      const int d = k - kHalf;
      const int j = c + d;
      w[k] = (j < 0 || j >= C) ? (kFast ? edge_fill(c, d, C) : CUDART_INF_F) : buf[j];
    }
  }
  const float amp = w[kHalf];
  if (kFast) {
    FF_NET_FAST(w);
    return __fsub_rn(amp, interior ? w[kHalf] : fast_median(w, c, C));
  }
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
  return amp == CUDART_INF_F ? 0.f : __fsub_rn(amp, med);
}

// Median background over the amplitudes at words [0, C) (+inf where
// flagged), written as deviations at words phys(c), a tile of kTile
// channels at a time from the top down (median_tile), each step's windows
// clear of both edges loading their members with no edge test.  `stage`:
// kTile words of shared memory below 1024 threads.
template <bool kFast, bool kUseFlags, int kT = kThreads>
__device__ void median_to_deviations(float* buf, int C, float* stage = nullptr) {
  const auto dev_of = [&](int c, int lo) {
    const bool interior = kFast && lo >= kHalf && lo + kT + kHalf <= C;
    return tile_deviation<kFast, kUseFlags>(buf, c, C, interior);
  };
  for (int base = (C - 1) / kTile * kTile; base >= 0; base -= kTile) {
    median_tile<kT>(buf, stage, base, C, dev_of);
  }
  __syncthreads();
}
#endif  // FF_MEDIAN_COUNT

// Block-wide sum (max) of one value per thread, every thread receiving it.
// As ff_device.cuh's block_sum: warp partials in one of two banks of kT / 32
// behind one barrier.  Then each warp reduces the partials with one load a
// lane and one warp reduction, where block_sum loads all of them a thread;
// lanes at or past the CTA's warps read 0.
template <int kT, typename T>
__device__ __forceinline__ T warp_partial(const T* b) {
  constexpr int kW = kT / 32;
  static_assert(kW >= 1 && kW <= 32, "one partial per lane at most");
  const int lane = threadIdx.x & 31;
  return kW == 32 || lane < kW ? b[lane] : T(0);
}

template <int kT = kThreads>
__device__ __forceinline__ int block_sum32(int v, int* red, int& bank) {
  v = __reduce_add_sync(0xffffffffu, v);
  int* b = red + bank * (kT / 32);
  if ((threadIdx.x & 31) == 0) b[threadIdx.x >> 5] = v;
  __syncthreads();
  bank ^= 1;
  return __reduce_add_sync(0xffffffffu, warp_partial<kT>(b));
}

template <int kT = kThreads>
__device__ __forceinline__ unsigned block_max32(unsigned v, int* red, int& bank) {
  v = __reduce_max_sync(0xffffffffu, v);
  unsigned* b = reinterpret_cast<unsigned*>(red) + bank * (kT / 32);
  if ((threadIdx.x & 31) == 0) b[threadIdx.x >> 5] = v;
  __syncthreads();
  bank ^= 1;
  return __reduce_max_sync(0xffffffffu, warp_partial<kT>(b));
}

// The |dev| values a thread keeps in registers for the rank search: those
// of channels t + kT j, j < kRankRegs (all of a row up to kRankRegs * kT
// channels).
constexpr int kRankRegs = 32;

// The MAD noise of ff_device.cuh's mad_noise, bit for bit, over the padded
// deviations (pallas_flagger.py::_madnz_band, radix 1).  Thread t takes
// channels c = t + kT j at word phys(c): the first kRankRegs from
// registers, loaded once (+inf past C: no count, zero or maximum below
// takes it, as no candidate exceeds +inf), the rest from shared memory each
// round.  The counts stay float compares, a < cand: a candidate's bits may
// form a NaN, which counts nothing, where an integer compare of the bits
// would count every finite value.  Every count and maximum is an integer
// over the row's channels, so the result does not depend on kT.
template <int kT = kThreads>
__device__ float mad_noise(const float* dev, int* red, int& bank, int C) {
  constexpr int kS = kStrideOf<kT>;
  const int rest = threadIdx.x + kRankRegs * kT;  // the first channel not in registers
  float a[kRankRegs];
  int zeros = 0;
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) {
    const int c = threadIdx.x + j * kT;
    a[j] = c < C ? fabsf(dev[phys(c)]) : CUDART_INF_F;
    zeros += a[j] == 0.f;
  }
  for (int c = rest, p = phys(rest); c < C; c += kT, p += kS) {
    zeros += fabsf(dev[p]) == 0.f;
  }
  const RankTarget t = rank_target(C, block_sum32<kT>(zeros, red, bank));
  unsigned cur = 0;
  int r_cur = 0;  // count(|dev| < cur): 0 for cur = 0
  for (int i = 0; i < 31; ++i) {
    const unsigned test = cur | (1u << (30 - i));
    const float cand = __uint_as_float(test);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kRankRegs; ++j) cnt += a[j] < cand;
    for (int c = rest, p = phys(rest); c < C; c += kT, p += kS) {
      cnt += fabsf(dev[p]) < cand;
    }
    cnt = block_sum32<kT>(cnt, red, bank);
    if (cnt <= t.target) {
      cur = test;
      r_cur = cnt;
    }
  }
  // Halfway, the median averages the result with the largest |dev| below it.
  const float result = __uint_as_float(cur);
  unsigned below = 0;  // bits of the largest |dev| < result, or of +0
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) {
    if (a[j] < result) below = max(below, __float_as_uint(a[j]));
  }
  for (int c = rest, p = phys(rest); c < C; c += kT, p += kS) {
    const float x = fabsf(dev[p]);
    if (x < result) below = max(below, __float_as_uint(x));
  }
  const float prev = __uint_as_float(block_max32<kT>(below, red, bank));
  const float med =
      (t.halfway && r_cur == t.target) ? __fmul_rn(__fadd_rn(result, prev), 0.5f) : result;
  return __fmul_rn(1.4826f, med);
}

// SumThreshold.  A run's state: c0 = tR, its first channel; R, its length;
// `own`, the flags of its channels so far (bit k: channel c0 + k).
struct Run {
  int t;
  int c0;
  int R;
};

// 32 flag bits from run bit p (< R): the run's own, then the next run's.
__device__ __forceinline__ unsigned flag_bits(u64 own, u64 next, int p, int R) {
  const int s = R - p;  // 1..64
  return (unsigned)((own >> p) | (s < 64 ? next << s : 0ull));
}

// Levels 0 .. L - 1 of the doubling, s_2m[i] = s_m[i] + s_m[i + m] with
// m = 2**level, in place (s_m[i + m] is read before it is overwritten).
// Each level's m is a template constant: nvcc unrolls an inner loop before
// the loop around it, so a bound on a loop variable m (or a loop stepping
// m *= 2) leaves a runtime index into s[], which then lives in local memory.
template <int L, int N>
__device__ __forceinline__ void double_up(float (&s)[N]) {
  if constexpr (L > 0) {
    double_up<L - 1>(s);
    constexpr int m = 1 << (L - 1);
#pragma unroll
    for (int i = 0; i + 2 * m <= N; ++i) s[i] = __fadd_rn(s[i], s[i + m]);
  }
}

// Hits of the windows of 2**L starting in the run, summed in registers: a
// chunk of kChunk starts loads its kChunk + W - 1 clamped values once and
// doubles them up to W.  Needs W - 1 <= R, so that only the next run's
// flags are read.
template <int L>
__device__ __forceinline__ u64 run_hits(const float* dev, const Run& r, int last, u64 own,
                                        u64 next, float thr, float thr_w) {
  constexpr int W = 1 << L;
  constexpr int N = kChunk + W - 1;
  u64 hits = 0;
  for (int k0 = 0; k0 < r.R && r.c0 + k0 <= last; k0 += kChunk) {
    const unsigned f = flag_bits(own, next, k0, r.R);
    float s[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = dev[phys(r.c0 + k0 + i)];  // at most C + kChunk - 2
      s[i] = ((f >> i) & 1u) ? thr : d;
    }
    double_up<L>(s);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int k = k0 + i;
      if (s[i] > thr_w && k < r.R && r.c0 + k <= last) hits |= 1ull << k;
    }
  }
  return hits;
}

// Bit j of the masks published per run (mask[q], bit b: channel qR + b),
// stepped channel by channel without a division per step.
struct BitCursor {
  int q;
  int b;
  __device__ BitCursor(int c, int R) : q(c / R), b(c - (c / R) * R) {}
  __device__ bool get(const u64* mask) const { return (mask[q] >> b) & 1ull; }
  __device__ void step(int R) {
    if (++b == R) {
      b = 0;
      ++q;
    }
  }
};

// The plainer path: each window of 2**L starting in the run summed in tree
// order from the deviations and the published flags (any width).
__device__ u64 hits_any(const float* dev, const u64* flags, const Run& r, int last, int L,
                        float thr, float thr_w) {
  u64 hits = 0;
  for (int k = 0; k < r.R && r.c0 + k <= last; ++k) {
    const int c = r.c0 + k;
    float stack[kMaxWindows + 1];
    int top = 0;
    BitCursor cur(c, r.R);
    for (int j = 0; j < (1 << L); ++j) {
      float v = cur.get(flags) ? thr : dev[phys(c + j)];
      for (int m = j; m & 1; m >>= 1) v = __fadd_rn(stack[--top], v);
      stack[top++] = v;
      cur.step(r.R);
    }
    if (stack[0] > thr_w) hits |= 1ull << k;
  }
  return hits;
}

// Flag c if any window starting in [c - W + 1, c] hit, from the published hits.
__device__ u64 dilate_any(const u64* hits, const Run& r, int C, int W, int last) {
  u64 d = 0;
  for (int k = 0; k < r.R && r.c0 + k < C; ++k) {
    const int c = r.c0 + k;
    const int lo = max(c - W + 1, 0);
    const int hi = min(c, last);
    BitCursor cur(lo, r.R);
    bool hit = false;
    for (int j = lo; j <= hi && !hit; ++j) {
      hit = cur.get(hits);
      cur.step(r.R);
    }
    if (hit) d |= 1ull << k;
  }
  return d;
}

// The run's flags from its hits `h` and the previous run's hits `prev`
// (W - 1 <= R): a hit at c flags [c, c + W - 1].
__device__ __forceinline__ u64 dilate_run(u64 h, u64 prev, int W, int R) {
  u64 d = h;
  for (int m = 1; m < W; m *= 2) d |= d << m;
  if (W > 1) {
    // Bit i of p: a hit at c0 - (W - 1) + i, which flags run bits 0..i.
    const unsigned p = (unsigned)(prev >> (R - (W - 1)));
    if (p) d |= (2ull << (31 - __clz(p))) - 1;
  }
  return d;
}

// SumThreshold on the padded deviations of one row against n_sigma * noise
// (pallas_flagger.py::_threshold_sum_band); writes the row's flags.  Runs
// of R = ceil(C / kT) channels, at most 64; window sums are defined on
// channels, not runs, so the flags do not depend on kT.
template <int kT = kThreads>
__device__ void sum_threshold(const float* dev, u64* flag_masks, u64* hit_masks, float noise,
                              uint8_t* out, const Params& p) {
  const int C = p.channels;
  const Run r{(int)threadIdx.x, (int)threadIdx.x * run_length<kT>(C), run_length<kT>(C)};
  const bool active = r.c0 < C;
  const u64 run_mask = r.R >= 64 ? ~0ull : (1ull << r.R) - 1;
  const float base = __fmul_rn(p.n_sigma, noise);
  u64 own = 0;
  for (int w = 0; w < p.n_windows; ++w) {
    const int W = 1 << w;
    const float thr = __fmul_rn(base, p.scales[w]);
    const float thr_w = __fmul_rn(thr, (float)W);
    const int last = C - W;  // full windows start at c <= last
    const bool fast = w <= kFastLog && W - 1 <= r.R;
    // Reads of the previous window's masks ended before its second barrier.
    flag_masks[r.t] = own;
    __syncthreads();
    u64 h = 0;
    if (active) {
      if (fast) {
        const u64 next = r.t + 1 < kT ? flag_masks[r.t + 1] : 0;
        switch (w) {
          case 0: h = run_hits<0>(dev, r, last, own, next, thr, thr_w); break;
          case 1: h = run_hits<1>(dev, r, last, own, next, thr, thr_w); break;
          case 2: h = run_hits<2>(dev, r, last, own, next, thr, thr_w); break;
          default: h = run_hits<3>(dev, r, last, own, next, thr, thr_w); break;
        }
      } else {
        h = hits_any(dev, flag_masks, r, last, w, thr, thr_w);
      }
    }
    hit_masks[r.t] = h;
    __syncthreads();
    if (active) {
      const u64 d = fast ? dilate_run(h, r.t > 0 ? hit_masks[r.t - 1] : 0, W, r.R)
                         : dilate_any(hit_masks, r, C, W, last);
      own |= d & run_mask;
    }
  }
  // The flags out, channel-strided so that a warp stores 32 adjacent bytes.
  flag_masks[r.t] = own;
  __syncthreads();
  const uint8_t fv = (uint8_t)p.flag_value;
  const int dq = kT / r.R;
  const int db = kT - dq * r.R;
  BitCursor cur(r.t, r.R);
  for (int c = r.t; c < C; c += kT) {
    out[c] = cur.get(flag_masks) ? fv : 0;
    cur.q += dq;
    cur.b += db;
    if (cur.b >= r.R) {
      cur.b -= r.R;
      ++cur.q;
    }
  }
}

}  // namespace runs
}  // namespace
