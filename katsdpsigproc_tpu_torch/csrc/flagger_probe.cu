// Stage probes of the fused flagger K1 for Hopper (sm_90a), with a plain C
// ABI.  They replace the TPU probes of scripts/:
//   K11 stage_ablate.py::make_fn.kernel: K1 with one stage replaced by a
//       near-free stand-in (`no_median`, `no_rank`, `no_thresh`,
//       `skeleton`) beside the whole of it (`full`), so each stage's cost
//       is a difference of two times taken at K1's own occupancy;
//   K13 rankpair_ab.py::make.kernel: K1 with another rank search, bit for
//       bit K1: two bits per dependent round (`rank_pair`), the zeros count
//       riding the first round (`zeros_fold`), or K4's radix select
//       (`radix_select`);
//   K9  rollchain_ab.py::make.kernel: K1 with the median's 12 shifted
//       members built another way than by 12 shared-memory loads, bit for
//       bit K1: warp shuffles (`shfl_median`), or each thread's V
//       consecutive channels from V + 12 members loaded once as 16-byte
//       words (`window_median`, the TPU probe's roll-by-1 chains as the
//       card does them: member d of channel c + 1 is member d + 1 of c);
//   K12 deinterleave_probe.py::make.kernel: amplitudes from interleaved
//       (re, im) pairs (`amp_pairs`), baseline-major (rows, C, 2) as the
//       TPU probe reads them, or channel-major (C, rows, 2) read in place,
//       the main path's own input before its corner turn; and
//       `channel_major`, K1 with its load stage replaced by that in-place
//       read, flag for flag K1 on the corner-turned dump.
//
// What bounds them: what bounds K1 (fused_flagger.cu's header).  A probe
// measures only if its variants all run one machine, so each launches as
// the kernel it varies: kThreads = 1024 threads, one CTA per SM at 32768
// channels, and K1's dynamic shared memory:
//  * K9, K11 and K13 are K1 itself, on K1's run layout (ff_runs.cuh,
//    runs::smem_bytes): `full` is K1's pipeline, and each other variant
//    changes the one stage it names, so a difference of two times is that
//    stage's cost in the K1 that runs.  K1 itself gains no knob;
//  * K12 runs at K1's launch too, its row through K1's amplitude words.
//    Channel-major, the row's pairs are `rows` pairs apart, so one CTA per
//    row would read 8 B of each 32-B sector.  Instead a thread-block
//    cluster of kG consecutive rows reads together: CTA k of the cluster
//    loads channels [kC/G, (k+1)C/G) of all kG rows, kG pairs a channel
//    (one 32-B sector at kG = 4, as 16-B loads, 8 in flight a thread),
//    takes the amplitudes and stores each into its row's CTA's amplitude
//    words by distributed shared memory; after the cluster's barrier each
//    CTA writes (K12) or flags (`channel_major`) its own row.  The cluster
//    sizes 1 (no cluster: one CTA per row, 8 pairs in flight a thread),
//    2, 4 and 8 are template instances of both, chosen at the launch.  A
//    cluster's CTAs must run at once on SMs of one GPC: on the H100's 132
//    SMs, 66 clusters of 2 fit, 30 of 4 and 15 of 8 (120 SMs).
//
// Variants, with the stand-ins' semantics of stage_ablate.py:61-80 (there
// are no input flags, and C >= FF_WIDTH):
//   full          amplitude, median, MAD noise, SumThreshold: K1
//   no_median     median := amp * 0.5 (deviations written in place)
//   no_rank       noise := 1, so the base threshold is n_sigma
//   no_thresh     flag := dev > noise
//   skeleton      flag := amp > 1 (amplitude and store at K1's occupancy)
//   rank_pair     each round counts cur|hi, cur|lo and cur|hi|lo against
//                 the thread's 32 |dev| registers; one reduction of three
//                 ints behind one barrier: 15 pairs and one single bit, 16
//                 dependent rounds instead of 31 (the JAX rank_radix=2
//                 candidates; the TPU probe's `pair_i32` and `pair_f32`
//                 packings are one variant here)
//   zeros_fold    bit 30's candidate does not depend on the target, so its
//                 count rides the zeros pass, both packed in one word
//                 (rankpair_ab.py via pallas_flagger.py:374-377): 31
//                 reductions instead of 32
//   radix_select  K4's radix select (percentile.cu) on the row's |dev| bit
//                 patterns: 8 + 8 + 8 + 7 bits a pass, a shared histogram of
//                 the digit of the keys still under the prefix, scanned by
//                 every warp alike: one barrier a pass, 4 instead of 31
//   shfl_median   K1's median tiles with an interior tile's members taken by
//                 __shfl_sync: one load a lane, and one more for the lanes
//                 at a warp's edge, where K1 loads 13
//   window_median K1's median on tiles of 1024 x kWindowV channels, a
//                 thread's kWindowV consecutive channels from one load of
//                 their members as float4 words, 1.25 loads a channel
//   channel_major K1 reading the channel-major dump (C, rows, 2) in place by
//                 K12's cluster read, in place of its load stage

#include <cooperative_groups.h>
#include <stdint.h>

#include "ff_runs.cuh"  // includes ff_device.cuh

static_assert(kHalf <= 15, "the probes take odd widths 3..31");

namespace {

enum Variant : int {
  kFull = 0,
  kNoMedian = 1,
  kNoRank = 2,
  kNoThresh = 3,
  kSkeleton = 4,
  kRankPair = 5,
  kZerosFold = 6,
  kRadixSelect = 7,
  kShflMedian = 8,
  kWindowMedian = 9,
  kChannelMajor = 10,
};

// K12's kernels (fp_amp_pairs).
enum AmpKernel : int {
  kAmpBaseline = 0,      // baseline-major (rows, C, 2)
  kAmpChannelMajor = 1,  // channel-major (C, rows, 2), a cluster of rows
};

// K12's in-place read: the amplitudes of the channel-major dump (C, rows,
// 2) into the amplitude words [0, C) of each row's CTA, which then holds
// its row as K1's load stage leaves it (fused_flagger.cu::flagger_kernel).
// kG consecutive rows form a cluster (kG = 1: no cluster, the CTA reads its
// own row); CTA k of the cluster reads channels [kC/G, (k+1)C/G) of the
// cluster's rows, 8 kG bytes a channel, as 16-byte loads where the
// cluster's rows all exist and lie 16-byte aligned, and stores each
// amplitude into its row's CTA by distributed shared memory.  Every
// thread keeps 8 loads in flight.  A CTA whose row does not exist (the
// grid is padded to whole clusters) reads for the rows that do.  Ends on
// a barrier of the cluster (the CTA).
template <int kG>
__device__ __forceinline__ void load_channel_major(const float2* __restrict__ vis, float* buf,
                                                   int rows, int C) {
  if constexpr (kG == 1) {
    constexpr int kU = 8;
    const size_t row = blockIdx.x;
    for (int c0 = threadIdx.x; c0 < C; c0 += kU * kThreads) {
      float2 x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * kThreads;
        if (c < C) x[u] = vis[(size_t)c * rows + row];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * kThreads;
        if (c < C) buf[c] = amplitude(x[u]);
      }
    }
    __syncthreads();
  } else {
    constexpr int kU = 16 / kG;  // channels a thread loads at once: 8 16-byte loads
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int k = (int)cluster.block_rank();
    const int r0 = (int)blockIdx.x - k;
    const int lo = (int)((long long)C * k / kG);
    const int hi = (int)((long long)C * (k + 1) / kG);
    const int n = min(kG, rows - r0);  // the cluster's rows that exist
    const bool vec = n == kG && (rows & 1) == 0 && (reinterpret_cast<uintptr_t>(vis) & 15) == 0;
    float* dst[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) dst[g] = cluster.map_shared_rank(buf, g);
    cluster.sync();  // every CTA of the cluster runs: its shared memory takes stores
    for (int c0 = lo + threadIdx.x; c0 < hi; c0 += kU * kThreads) {
      float2 x[kU][kG];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * kThreads;
        if (c >= hi) continue;
        const float2* src = vis + (size_t)c * rows + r0;
        if (vec) {
#pragma unroll
          for (int h = 0; h < kG / 2; ++h) {
            const float4 q = reinterpret_cast<const float4*>(src)[h];
            x[u][2 * h] = make_float2(q.x, q.y);
            x[u][2 * h + 1] = make_float2(q.z, q.w);
          }
        } else {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < n) x[u][g] = src[g];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * kThreads;
        if (c >= hi) continue;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (g < n) dst[g][c] = amplitude(x[u][g]);
        }
      }
    }
    cluster.sync();  // every amplitude of the cluster's rows is in place
  }
}

// K12 at K1's launch: the row's amplitudes through its amplitude words,
// read baseline-major (a CTA its own row) or channel-major (the cluster
// read above), then written out coalesced.
template <int kG, bool kChannelMajor>
__global__ void __launch_bounds__(kThreads, 1)
    amp_pairs_kernel(const float2* __restrict__ vis, float* __restrict__ out, int rows, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  const size_t row = blockIdx.x;
  if constexpr (kChannelMajor) {
    load_channel_major<kG>(vis, buf, rows, C);
    if ((int)row >= rows) return;
  } else {
    const float2* v = vis + row * C;
    for (int c = threadIdx.x; c < C; c += kThreads) buf[c] = amplitude(v[c]);
    __syncthreads();
  }
  float* o = out + row * C;
  for (int c = threadIdx.x; c < C; c += kThreads) o[c] = buf[c];
}
namespace runs {

constexpr unsigned kFull32 = 0xffffffffu;

// The flag masks double as the rank searches' scratch: SumThreshold first
// writes them after the rank search's last barrier (block_max32's).
//   rank_pair:    two banks of three counts per warp (192 words);
//   radix_select: the four passes' histograms, 256 + 256 + 256 + 128 words,
//                 cleared before the row's first barrier.
constexpr int kHistWords = 3 * 256 + 128;
static_assert(kHistWords <= kThreads && kHistWords * 4 <= kThreads * 8, "scratch in the masks");

// |dev| of channels t + 1024 j, j < kRankRegs, into registers (+inf past
// C, which no candidate counts), and the zeros among all of the thread's
// channels, as K1's mad_noise loads them.
__device__ __forceinline__ int load_abs(const float* dev, float (&a)[kRankRegs], int C) {
  int zeros = 0;
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) {
    const int c = threadIdx.x + j * kThreads;
    a[j] = c < C ? fabsf(dev[phys(c)]) : CUDART_INF_F;
    zeros += a[j] == 0.f;
  }
  for (int c = threadIdx.x + kRankRegs * kThreads, p = phys(c); c < C; c += kThreads, p += kStride) {
    zeros += fabsf(dev[p]) == 0.f;
  }
  return zeros;
}

// This thread's count of |dev| < cand, registers first, then the channels
// past them from shared memory.
__device__ __forceinline__ int count_below(const float* dev, const float (&a)[kRankRegs], int C,
                                           float cand) {
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) cnt += a[j] < cand;
  for (int c = threadIdx.x + kRankRegs * kThreads, p = phys(c); c < C; c += kThreads, p += kStride) {
    cnt += fabsf(dev[p]) < cand;
  }
  return cnt;
}

// K1's halfway rule, as at the end of mad_noise: `below` is this thread's
// largest |dev| bit pattern under the result.
__device__ __forceinline__ float noise_from(unsigned cur, int r_cur, unsigned below,
                                            RankTarget t, int* red, int& bank) {
  const float result = __uint_as_float(cur);
  const float prev = __uint_as_float(block_max32(below, red, bank));
  const float med =
      (t.halfway && r_cur == t.target) ? __fmul_rn(__fadd_rn(result, prev), 0.5f) : result;
  return __fmul_rn(1.4826f, med);
}

__device__ __forceinline__ float noise_below(const float* dev, const float (&a)[kRankRegs], int C,
                                             unsigned cur, int r_cur, RankTarget t, int* red,
                                             int& bank) {
  const float result = __uint_as_float(cur);
  unsigned below = 0;  // bits of the largest |dev| < result, or of +0
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) {
    if (a[j] < result) below = max(below, __float_as_uint(a[j]));
  }
  for (int c = threadIdx.x + kRankRegs * kThreads, p = phys(c); c < C; c += kThreads, p += kStride) {
    const float x = fabsf(dev[p]);
    if (x < result) below = max(below, __float_as_uint(x));
  }
  return noise_from(cur, r_cur, below, t, red, bank);
}

// K13 rank_pair.  A thread holds at most 32 + 20 channels (52310 at the
// limit), so its three counts fit 10-bit fields of one word; the warps'
// sums go to scratch as three ints each, behind one barrier.
__device__ float mad_noise_pair(const float* dev, int* part, int* red, int& bank, int C) {
  float a[kRankRegs];
  const RankTarget t = rank_target(C, block_sum32(load_abs(dev, a, C), red, bank));
  const int lane = threadIdx.x & 31;
  unsigned cur = 0;
  int r_cur = 0;
  for (int i = 0; i < 15; ++i) {
    const unsigned hi = 1u << (30 - 2 * i);
    const unsigned lo = hi >> 1;
    const float c_hi = __uint_as_float(cur | hi);
    const float c_lo = __uint_as_float(cur | lo);
    const float c_both = __uint_as_float(cur | hi | lo);
    unsigned packed = 0;
#pragma unroll
    for (int j = 0; j < kRankRegs; ++j) {
      packed += (a[j] < c_hi ? 1u : 0u) + (a[j] < c_lo ? 1u << 10 : 0u) +
                (a[j] < c_both ? 1u << 20 : 0u);
    }
    for (int c = threadIdx.x + kRankRegs * kThreads, p = phys(c); c < C;
         c += kThreads, p += kStride) {
      const float x = fabsf(dev[p]);
      packed += (x < c_hi ? 1u : 0u) + (x < c_lo ? 1u << 10 : 0u) + (x < c_both ? 1u << 20 : 0u);
    }
    int* b = part + (i & 1) * 3 * kWarps;
    const int w_hi = __reduce_add_sync(kFull32, (int)(packed & 1023u));
    const int w_lo = __reduce_add_sync(kFull32, (int)((packed >> 10) & 1023u));
    const int w_both = __reduce_add_sync(kFull32, (int)(packed >> 20));
    if (lane == 0) {
      b[threadIdx.x >> 5] = w_hi;
      b[kWarps + (threadIdx.x >> 5)] = w_lo;
      b[2 * kWarps + (threadIdx.x >> 5)] = w_both;
    }
    __syncthreads();  // the bank is rewritten two rounds on, after the next barrier
    const int n_hi = __reduce_add_sync(kFull32, b[lane]);
    const int n_lo = __reduce_add_sync(kFull32, b[kWarps + lane]);
    const int n_both = __reduce_add_sync(kFull32, b[2 * kWarps + lane]);
    // The low bit is tested against the prefix the high bit resolved.
    const bool take_hi = n_hi <= t.target;
    const int n_lo_eff = take_hi ? n_both : n_lo;
    if (take_hi) {
      cur |= hi;
      r_cur = n_hi;
    }
    if (n_lo_eff <= t.target) {
      cur |= lo;
      r_cur = n_lo_eff;
    }
  }
  const unsigned test = cur | 1u;  // bit 0 alone
  const int cnt = block_sum32(count_below(dev, a, C, __uint_as_float(test)), red, bank);
  if (cnt <= t.target) {
    cur = test;
    r_cur = cnt;
  }
  return noise_below(dev, a, C, cur, r_cur, t, red, bank);
}

// K13 zeros_fold.  Zeros in the low 16 bits, count(|dev| < 2.0f) (bit 30's
// candidate) in the high 16: each field is at most C <= 52310 < 2**16, so
// the unsigned sums wrap nowhere.
__device__ float mad_noise_zeros_fold(const float* dev, int* red, int& bank, int C) {
  const float cand30 = __uint_as_float(1u << 30);
  float a[kRankRegs];
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) {
    const int c = threadIdx.x + j * kThreads;
    a[j] = c < C ? fabsf(dev[phys(c)]) : CUDART_INF_F;
    packed += (a[j] == 0.f ? 1u : 0u) + (a[j] < cand30 ? 1u << 16 : 0u);
  }
  for (int c = threadIdx.x + kRankRegs * kThreads, p = phys(c); c < C; c += kThreads, p += kStride) {
    const float x = fabsf(dev[p]);
    packed += (x == 0.f ? 1u : 0u) + (x < cand30 ? 1u << 16 : 0u);
  }
  packed = (unsigned)block_sum32((int)packed, red, bank);  // REDUX and the adds wrap mod 2**32
  const RankTarget t = rank_target(C, (int)(packed & 0xffffu));
  const int c30 = (int)(packed >> 16);
  unsigned cur = 0;
  int r_cur = 0;
  if (c30 <= t.target) {
    cur = 1u << 30;
    r_cur = c30;
  }
  for (int i = 1; i < 31; ++i) {
    const unsigned test = cur | (1u << (30 - i));
    const int cnt = block_sum32(count_below(dev, a, C, __uint_as_float(test)), red, bank);
    if (cnt <= t.target) {
      cur = test;
      r_cur = cnt;
    }
  }
  return noise_below(dev, a, C, cur, r_cur, t, red, bank);
}

// K13 radix_select: K4's radix select (percentile.cu) of the one target.
// A key is the bit pattern of |dev|, whose unsigned order is the float
// order of the non-NaN values; NaN (and a slot past C) takes kNanKey,
// which no digit or prefix matches, as the binary search counts NaN below
// no candidate.
constexpr unsigned kNanKey = 0xffffffffu;
constexpr unsigned kInfKey = 0x7f800000u;
constexpr unsigned kEndState = 0x7fffffffu;

__device__ __forceinline__ unsigned abs_key(float d) {
  const unsigned b = __float_as_uint(d) & 0x7fffffffu;
  return b > kInfKey ? kNanKey : b;
}

// The bin of a histogram of kBins (256 or 128) bins where the running count
// passes `rank`: its digit, and the rank among the keys in it.  False when
// the histogram holds no more than `rank` keys.  A lane reads kBins / 32
// consecutive bins as 16-byte words (conflict-free: a quarter-warp's eight
// loads cover the 32 banks once), then one warp scan and a ballot.  Every
// warp reads the same histogram and reaches the same answer, so no barrier
// publishes it.
template <int kBins>
__device__ __forceinline__ bool select_bin(const unsigned* hist, int rank, unsigned& digit,
                                           int& rest) {
  constexpr int kPer = kBins / 32;
  const unsigned lane = threadIdx.x & 31;
  unsigned h[kPer];
  const uint4* q = reinterpret_cast<const uint4*>(hist) + lane * (kPer / 4);
#pragma unroll
  for (int v = 0; v < kPer / 4; ++v) {
    const uint4 x = q[v];
    h[4 * v] = x.x;
    h[4 * v + 1] = x.y;
    h[4 * v + 2] = x.z;
    h[4 * v + 3] = x.w;
  }
  unsigned s = 0;
#pragma unroll
  for (int b = 0; b < kPer; ++b) s += h[b];
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(kFull32, incl, off);
    if (lane >= (unsigned)off) incl += o;
  }
  const unsigned past = __ballot_sync(kFull32, incl > (unsigned)rank);
  if (past == 0) return false;
  unsigned run = incl - s;  // keys in the bins below this lane's
  unsigned d = 0;
  int r = 0;
  bool done = false;
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    if (!done && run + h[b] > (unsigned)rank) {
      d = lane * kPer + b;
      r = rank - (int)run;
      done = true;
    }
    run += h[b];
  }
  const int owner = __ffs(past) - 1;
  digit = __shfl_sync(kFull32, d, owner);
  rest = __shfl_sync(kFull32, r, owner);
  return true;
}

// Pass p >= 1: the digit (kShift, kBits) of every key whose bits above kHi
// equal `prefix`, counted into `hist` with shared atomics; one barrier;
// then the bin of `rank` extends the prefix.
template <int kHi, int kShift, int kBits>
__device__ __forceinline__ bool radix_pass(const float* dev, const unsigned (&k)[kRankRegs],
                                           unsigned* hist, int C, unsigned& prefix, int& rank) {
  constexpr unsigned kMask = (1u << kBits) - 1;
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) {
    if ((k[j] >> kHi) == prefix) atomicAdd(&hist[(k[j] >> kShift) & kMask], 1u);
  }
  for (int c = threadIdx.x + kRankRegs * kThreads, p = phys(c); c < C; c += kThreads, p += kStride) {
    const unsigned key = abs_key(dev[p]);
    if ((key >> kHi) == prefix) atomicAdd(&hist[(key >> kShift) & kMask], 1u);
  }
  __syncthreads();
  unsigned digit;
  int r;
  if (!select_bin<(1 << kBits)>(hist, rank, digit, r)) return false;
  prefix = (prefix << kBits) | digit;
  rank = r;
  return true;
}

// `hist` holds kHistWords zeroed words, published by a barrier since.
__device__ float mad_noise_radix(const float* dev, unsigned* hist, int* red, int& bank, int C) {
  // Pass 0 rides the zeros count: the exponent digit of every counted key.
  unsigned k[kRankRegs];
  int zeros = 0;
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) {
    const int c = threadIdx.x + j * kThreads;
    k[j] = c < C ? abs_key(dev[phys(c)]) : kNanKey;
    zeros += k[j] == 0u;
    if (k[j] != kNanKey) atomicAdd(&hist[k[j] >> 23], 1u);
  }
  for (int c = threadIdx.x + kRankRegs * kThreads, p = phys(c); c < C; c += kThreads, p += kStride) {
    const unsigned key = abs_key(dev[p]);
    zeros += key == 0u;
    if (key != kNanKey) atomicAdd(&hist[key >> 23], 1u);
  }
  // The zeros' barrier also publishes pass 0's histogram.
  const RankTarget t = rank_target(C, block_sum32(zeros, red, bank));
  unsigned prefix = 0;
  int rank = 0;
  // `found` is the same on every thread, so the passes' barriers are too.
  bool found = select_bin<256>(hist, t.target, prefix, rank);
  if (found) found = radix_pass<23, 15, 8>(dev, k, hist + 256, C, prefix, rank);
  if (found) found = radix_pass<15, 7, 8>(dev, k, hist + 512, C, prefix, rank);
  if (found) found = radix_pass<7, 0, 7>(dev, k, hist + 768, C, prefix, rank);
  // The search's end state: once the binary search accepts +inf, every
  // later candidate is a NaN pattern, counts nothing and is accepted, so a
  // key of +inf, or a target at or past the non-NaN count, ends at
  // 0x7fffffff, the last accepted count 0 (the candidate 0x7fffffff's).
  // Otherwise the last accepted candidate is the key itself, whose count
  // is the keys below it: the target less its rank within its own bin.
  const bool finite = found && prefix < kInfKey;
  const unsigned cur = finite ? prefix : kEndState;
  const int r_cur = finite ? t.target - rank : 0;
  const unsigned lim = finite ? prefix : 0u;  // no |dev| is below a NaN pattern
  unsigned below = 0;
#pragma unroll
  for (int j = 0; j < kRankRegs; ++j) {
    if (k[j] < lim) below = max(below, k[j]);
  }
  for (int c = threadIdx.x + kRankRegs * kThreads, p = phys(c); c < C; c += kThreads, p += kStride) {
    const unsigned key = abs_key(dev[p]);
    if (key < lim) below = max(below, key);
  }
  return noise_from(cur, r_cur, below, t, red, bank);
}

// ---- K9: the median's members built another way, bit for bit K1 ----
//
// Both variants keep K1's row (amplitudes unpadded at word c, deviations
// padded at phys(c)), its top-down tiles with one barrier each, and its
// network (FF_NET_FAST on min.NaN/max.NaN), so their flags are K1's.

// K1's median of channel c < C as its tiles take it that are not interior
// (runs::median_to_deviations<true, false>): members from the unpadded
// amplitudes, the +-inf parity fills past the row's edges.
__device__ __forceinline__ float edge_deviation(const float* buf, int c, int C) {
  float w[FF_WIDTH];
#pragma unroll
  for (int k = 0; k < FF_WIDTH; ++k) {
    const int d = k - kHalf;
    const int j = c + d;
    w[k] = (j < 0 || j >= C) ? edge_fill(c, d, C) : buf[j];
  }
  const float amp = w[kHalf];
  FF_NET_FAST(w);
  return __fsub_rn(amp, fast_median(w, c, C));
}

// K9 shfl_median: K1's tiles, an interior tile's members by shuffles.  A
// rotation by d serves every lane with one shuffle: the lanes whose member
// lies past the warp's edge read it from the source lane the rotation
// wraps to, which supplies its channel 32 away (`right` for d > 0, `left`
// for d < 0) instead of its own.  Those two are plain shared loads, the
// only ones besides `self`: c + 32 < C in an interior tile, and c - 32 >=
// base - kHalf >= 0 is still an amplitude, since a tile's stores land at
// phys(c) >= c + 32 past its base (ff_runs.cuh).  An interior tile is
// whole, so every lane of a warp takes part in every shuffle.
__device__ void median_to_deviations_shfl(float* buf, int C) {
  const int lane = threadIdx.x & 31;
  for (int base = (C - 1) / kThreads * kThreads; base >= 0; base -= kThreads) {
    const int c = base + threadIdx.x;
    const bool interior = base >= kHalf && base + kThreads + kHalf <= C;
    float dev = 0.f;
    if (interior) {
      const float self = buf[c];
      const float right = lane < kHalf ? buf[c + 32] : 0.f;
      const float left = lane >= 32 - kHalf ? buf[c - 32] : 0.f;
      float w[FF_WIDTH];
#pragma unroll
      for (int k = 0; k < FF_WIDTH; ++k) {
        const int d = k - kHalf;
        if (d == 0) {
          w[k] = self;
          continue;
        }
        const float give = d > 0 ? (lane < d ? right : self) : (lane >= 32 + d ? left : self);
        w[k] = __shfl_sync(kFull32, give, (lane + d) & 31);
      }
      FF_NET_FAST(w);
      dev = __fsub_rn(self, w[kHalf]);
    } else if (c < C) {
      dev = edge_deviation(buf, c, C);
    }
    __syncthreads();  // every window of this tile has read its members
    if (c < C) buf[phys(c)] = dev;
  }
  __syncthreads();
}

// K9 window_median: tiles of kThreads * kWindowV channels, thread t taking
// channels c0 .. c0 + kWindowV - 1, c0 = base + kWindowV t.  Its members,
// c0 - kHalf .. c0 + kWindowV - 1 + kHalf, come from one load of the
// aligned float4 words c0 - kPad .. c0 + kWindowV + kPad - 1 (kPad: kHalf
// rounded up to a word); member d of channel c + 1 is member d + 1 of
// channel c, so the kWindowV networks read registers.  At width 13 that
// is 5 loads for 4 channels where K1 makes 52.  Lane stride 16 B: a
// quarter-warp's eight 16-byte loads cover the 32 banks once.  The stores
// go one word at a time to phys(c): for word i of its run, lane l writes
// bank 4 (l mod 8) + l / 8 + i (+ a constant), each bank once a warp.
//
// In place, as K1's tiles: a tile reads only before its barrier and
// stores only after it.  Its stores land at phys(c) >= base + base / 32,
// and the tile below reads words below base + kPad; a tile above the
// lowest has base >= kThreads * kWindowV, so base / 32 >= 128 > kPad
// (kPad <= 16).  The lowest tile has no tile below it.  So the choice of
// path can be a thread's, not a tile's: a thread whose loads would leave
// the row (c0 < kPad, or c0 + kWindowV + kPad > C: near the row's two
// ends only) takes K1's per-channel path with the edge fills, and in
// every other thread each channel c has kHalf <= c <= C - 1 - kHalf,
// where K1's median is rank kHalf.  (Chosen by tile, as K1 chooses, the
// two end tiles would put a quarter of a 32768-channel row on the
// per-channel path.)
constexpr int kWindowV = 4;  // one float4 word a load

__device__ void median_to_deviations_window(float* buf, int C) {
  constexpr int kPad = (kHalf + kWindowV - 1) / kWindowV * kWindowV;
  constexpr int kWords = kWindowV + 2 * kPad;
  constexpr int kTile = kThreads * kWindowV;
  for (int base = (C - 1) / kTile * kTile; base >= 0; base -= kTile) {
    const int c0 = base + kWindowV * (int)threadIdx.x;
    float dev[kWindowV];
    if (c0 >= kPad && c0 + kWindowV + kPad <= C) {
      float x[kWords];
      const float4* q = reinterpret_cast<const float4*>(buf + c0 - kPad);
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const float4 f = q[i];
        x[4 * i] = f.x;
        x[4 * i + 1] = f.y;
        x[4 * i + 2] = f.z;
        x[4 * i + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < kWindowV; ++i) {
        float w[FF_WIDTH];
#pragma unroll
        for (int k = 0; k < FF_WIDTH; ++k) w[k] = x[kPad - kHalf + i + k];
        FF_NET_FAST(w);
        dev[i] = __fsub_rn(x[kPad + i], w[kHalf]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWindowV; ++i) dev[i] = c0 + i < C ? edge_deviation(buf, c0 + i, C) : 0.f;
    }
    __syncthreads();  // every window of this tile has read its members
#pragma unroll
    for (int i = 0; i < kWindowV; ++i) {
      if (c0 + i < C) buf[phys(c0 + i)] = dev[i];
    }
  }
  __syncthreads();
}

}  // namespace runs

// K9, K11 and K13: K1's flagger_kernel<0> (fused_flagger.cu) with the
// stage the variant names replaced, in K1's shared memory.
// `channel_major` replaces the load stage by K12's in-place read of the
// channel-major dump in clusters of kG rows, `rows` its rows; the other
// variants ignore kG and `rows`.
template <int kVariant, int kG = 1>
__global__ void __launch_bounds__(kThreads, 1)
    probe_kernel(const float2* __restrict__ vis, uint8_t* __restrict__ out, Params p, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.channels;
  float* buf = reinterpret_cast<float*>(smem);
  runs::u64* flag_masks = reinterpret_cast<runs::u64*>(smem + runs::masks_offset(C));
  runs::u64* hit_masks = flag_masks + kThreads;
  int* red = reinterpret_cast<int*>(hit_masks + kThreads);
  const size_t row = blockIdx.x;
  const float2* v = vis + row * C;
  uint8_t* o = out + row * C;
  const uint8_t fv = (uint8_t)p.flag_value;
  if constexpr (kVariant == kSkeleton) {
    for (int c = threadIdx.x; c < C; c += kThreads) o[c] = amplitude(v[c]) > 1.0f ? fv : 0;
    return;
  }
  unsigned* scratch = reinterpret_cast<unsigned*>(flag_masks);
  if constexpr (kVariant == kRadixSelect) {
    if (threadIdx.x < runs::kHistWords) scratch[threadIdx.x] = 0;
  }
  if constexpr (kVariant == kChannelMajor) {
    load_channel_major<kG>(vis, buf, rows, C);
    if ((int)row >= rows) return;
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float a = amplitude(v[c]);
      if constexpr (kVariant == kNoMedian) {
        buf[runs::phys(c)] = __fsub_rn(a, __fmul_rn(a, 0.5f));  // no reads: in place
      } else {
        buf[c] = a;
      }
    }
    __syncthreads();
  }
  if constexpr (kVariant == kShflMedian) {
    runs::median_to_deviations_shfl(buf, C);
  } else if constexpr (kVariant == kWindowMedian) {
    runs::median_to_deviations_window(buf, C);
  } else if constexpr (kVariant != kNoMedian) {
    // K1's branch, kept so that `full` compiles to K1's code; the probes
    // take C >= FF_WIDTH, so the masked path never runs.
    if (C >= FF_WIDTH) {
      runs::median_to_deviations<true, false>(buf, C);
    } else {
      runs::median_to_deviations<false, false>(buf, C);
    }
  }
  int bank = 0;
  float noise;
  if constexpr (kVariant == kNoRank) {
    noise = 1.0f;
  } else if constexpr (kVariant == kRankPair) {
    noise = runs::mad_noise_pair(buf, reinterpret_cast<int*>(scratch), red, bank, C);
  } else if constexpr (kVariant == kZerosFold) {
    noise = runs::mad_noise_zeros_fold(buf, red, bank, C);
  } else if constexpr (kVariant == kRadixSelect) {
    noise = runs::mad_noise_radix(buf, scratch, red, bank, C);
  } else {
    noise = runs::mad_noise(buf, red, bank, C);
  }
  if constexpr (kVariant == kNoThresh) {
    for (int c = threadIdx.x; c < C; c += kThreads) o[c] = buf[runs::phys(c)] > noise ? fv : 0;
  } else {
    runs::sum_threshold(buf, flag_masks, hit_masks, noise, o, p);
  }
}

// Calls f with the flag-producing kernel of `variant`.
template <typename F>
int with_probe_kernel(int variant, F&& f) {
  switch (variant) {
    case kFull: return f(probe_kernel<kFull>);
    case kNoMedian: return f(probe_kernel<kNoMedian>);
    case kNoRank: return f(probe_kernel<kNoRank>);
    case kNoThresh: return f(probe_kernel<kNoThresh>);
    case kSkeleton: return f(probe_kernel<kSkeleton>);
    case kRankPair: return f(probe_kernel<kRankPair>);
    case kZerosFold: return f(probe_kernel<kZerosFold>);
    case kRadixSelect: return f(probe_kernel<kRadixSelect>);
    case kShflMedian: return f(probe_kernel<kShflMedian>);
    case kWindowMedian: return f(probe_kernel<kWindowMedian>);
    case kChannelMajor: return f(probe_kernel<kChannelMajor>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Calls f with `channel_major` reading in clusters of `cluster` rows.
template <typename F>
int with_channel_major(int cluster, F&& f) {
  switch (cluster) {
    case 1: return f(probe_kernel<kChannelMajor, 1>);
    case 2: return f(probe_kernel<kChannelMajor, 2>);
    case 4: return f(probe_kernel<kChannelMajor, 4>);
    case 8: return f(probe_kernel<kChannelMajor, 8>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Calls f with K12's `kernel`, at a cluster of `cluster` rows where it
// reads channel-major.
template <typename F>
int with_amp_kernel(int kernel, int cluster, F&& f) {
  switch (kernel) {
    case kAmpBaseline: return f(amp_pairs_kernel<1, false>);
    case kAmpChannelMajor:
      switch (cluster) {
        case 1: return f(amp_pairs_kernel<1, true>);
        case 2: return f(amp_pairs_kernel<2, true>);
        case 4: return f(amp_pairs_kernel<4, true>);
        case 8: return f(amp_pairs_kernel<8, true>);
        default: return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch of a kernel at K1's CTA: `grid` CTAs, in clusters of
// `cluster` (1: none), each with `smem` bytes of dynamic shared memory.
cudaLaunchConfig_t cluster_config(int grid, int cluster, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// The grid of a read in clusters of `cluster` rows: padded to whole clusters.
int cluster_grid(int rows, int cluster) { return (rows + cluster - 1) / cluster * cluster; }

}  // namespace

extern "C" {

// As in fused_flagger.cu, so the wrappers share their checks: the run
// layout's channel limit, every probe's.
int ff_max_channels(void) { return runs::max_channels(); }

const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The launch configuration of `variant` at `channels`: threads per CTA,
// dynamic shared memory, and the CTAs that fit one SM at once.
int fp_launch_config(int variant, int channels, int* threads, long long* smem_bytes_out,
                     int* ctas_per_sm) {
  if (channels < FF_WIDTH || channels > runs::max_channels()) return (int)cudaErrorInvalidValue;
  const size_t smem = runs::smem_bytes(channels);
  const int err = with_probe_kernel(variant, [&](auto kernel) {
    int e = set_smem(kernel, smem);
    if (e) return e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, kThreads,
                                                              smem);
  });
  *threads = kThreads;
  *smem_bytes_out = (long long)smem;
  return err;
}

// A flag-producing probe over `rows` rows of planar (re, im) float32 pairs,
// (rows, channels, 2), to (rows, channels) u8; `channel_major` reads
// (channels, rows, 2) in clusters of `cluster` rows (1, 2, 4 or 8), which
// the other variants ignore.  Returns a cudaError_t; 0 when the launch
// was accepted.
int fp_probe(int variant, int cluster, const void* vis, void* out, int rows, int channels,
             float n_sigma, const float* scales, int n_windows, int flag_value, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value);
  if (err) return err;
  if (rows < 1 || channels < FF_WIDTH || channels > runs::max_channels()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = runs::smem_bytes(channels);
  const float2* v = static_cast<const float2*>(vis);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kChannelMajor) {
    err = with_channel_major(cluster, [&](auto kernel) {
      int e = set_smem(kernel, smem);
      if (e) return e;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(cluster_grid(rows, cluster), cluster, smem,
                                                    s, &attr);
      return (int)cudaLaunchKernelEx(&cfg, kernel, v, o, p, rows);
    });
    return err ? err : (int)cudaGetLastError();
  }
  err = with_probe_kernel(variant, [&](auto kernel) {
    int e = set_smem(kernel, smem);
    if (e) return e;
    kernel<<<rows, kThreads, smem, s>>>(v, o, p, rows);
    return 0;
  });
  return err ? err : (int)cudaGetLastError();
}

// K12's `kernel` launch configuration at `channels` (its cluster of
// `cluster` rows where it reads channel-major): the
// clusters that fit the device at once (0 where the kernel takes no
// cluster), threads per CTA, dynamic shared memory, CTAs that fit one SM.
int fp_amp_launch_config(int kernel, int cluster, int channels, int* clusters, int* threads,
                         long long* smem_bytes_out, int* ctas_per_sm) {
  if (channels < 1 || channels > runs::max_channels()) return (int)cudaErrorInvalidValue;
  const size_t smem = runs::smem_bytes(channels);
  const int err = with_amp_kernel(kernel, cluster, [&](auto k) {
    int e = set_smem(k, smem);
    if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, k, kThreads, smem);
    *clusters = 0;
    if (!e && kernel == kAmpChannelMajor && cluster > 1) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(cluster * 64, cluster, smem, nullptr, &attr);
      e = (int)cudaOccupancyMaxActiveClusters(clusters, k, &cfg);
    }
    return e;
  });
  *threads = kThreads;
  *smem_bytes_out = (long long)smem;
  return err;
}

// K12's `kernel` over (rows, channels) amplitudes; vis is (rows, channels,
// 2), or (channels, rows, 2) for the channel-major kernel, which reads in
// clusters of `cluster` rows (1, 2, 4 or 8).
int fp_amp_pairs(int kernel, int cluster, const void* vis, void* out, int rows, int channels,
                 void* stream) {
  if (rows < 1 || channels < 1 || channels > runs::max_channels()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = runs::smem_bytes(channels);
  const int g = kernel == kAmpChannelMajor ? cluster : 1;
  const float2* v = static_cast<const float2*>(vis);
  float* o = static_cast<float*>(out);
  const int err = with_amp_kernel(kernel, cluster, [&](auto k) {
    int e = set_smem(k, smem);
    if (e) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(cluster_grid(rows, g), g, smem,
                                                  static_cast<cudaStream_t>(stream), &attr);
    return (int)cudaLaunchKernelEx(&cfg, k, v, o, rows, channels);
  });
  return err ? err : (int)cudaGetLastError();
}

}  // extern "C"
