// Stage probes of the fused flagger K1 for Hopper (sm_90a), with a plain C
// ABI.  They replace the TPU probes of scripts/:
//   K11 stage_ablate.py::make_fn.kernel: K1 with one stage replaced by a
//       near-free stand-in (`no_median`, `no_rank`, `no_thresh`,
//       `skeleton`) beside the whole of it (`full`), so each stage's cost
//       is a difference of two times taken at K1's own occupancy;
//   K13 rankpair_ab.py::make.kernel: the rank search with two bits per
//       dependent stage (`rank_pair`), or with the zeros count riding the
//       first round (`zeros_fold`), bit for bit K1;
//   K9  rollchain_ab.py::make.kernel: the median's shifted members built
//       another way (`shfl_median`: warp shuffles), bit for bit K1;
//   K12 deinterleave_probe.py::make.kernel: amplitudes from interleaved
//       (re, im) pairs (`amp_pairs`), baseline-major (rows, C, 2) as the
//       TPU probe reads them, or channel-major (C, rows, 2) read in place,
//       the main path's own input before its corner turn.
//
// What bounds them: what bounds K1 (fused_flagger.cu's header).  A probe
// measures only if its variants all run one machine: every kernel here
// launches kThreads = 1024 threads with smem_bytes(C) of dynamic shared
// memory, the block and allocation of the strided layout (ff_device.cuh,
// the layout K1 and K2 had before the run layout, ff_runs.cuh), so one
// CTA runs per SM at 32768 channels whatever the variant uses of it.
// `full` is K1 in that layout, flag for flag the run layout's K1; only the
// stage a variant names differs, and K1 itself gains no knob.
//
// Variants, with the stand-ins' semantics of stage_ablate.py:61-80 (there
// are no input flags, and C >= FF_WIDTH):
//   full         amplitude, median, MAD noise, SumThreshold: K1
//   no_median    median := amp * 0.5
//   no_rank      noise := 1, so the base threshold is n_sigma
//   no_thresh    flag := dev > noise
//   skeleton     flag := amp > 1 (amplitude and store at K1's occupancy)
//   rank_pair    each pass counts cur|hi, cur|lo and cur|hi|lo with one
//                block reduction of three ints: 15 pairs and one single bit,
//                16 dependent stages instead of 31.  The TPU probe packs two
//                of the counts into one int32 (`pair_i32`) or float32
//                (`pair_f32`) reduce; on the card a block reduces three ints
//                behind one barrier, so the two packings are one variant.
//   zeros_fold   bit 30's candidate does not depend on the target, so its
//                count rides the zeros pass, both packed in one int
//                (rankpair_ab.py via pallas_flagger.py:374-377): 31 passes
//                over the row instead of 32.
//   shfl_median  the median's members within a warp come from __shfl_sync;
//                those across warps or tiles from shared memory and the
//                halo, as in K1.

#include "ff_device.cuh"

namespace {

enum Variant : int {
  kFull = 0,
  kNoMedian = 1,
  kNoRank = 2,
  kNoThresh = 3,
  kSkeleton = 4,
  kRankPair = 5,
  kZerosFold = 6,
  kShflMedian = 7,
  kAmpPairs = 8,              // baseline-major (rows, C, 2)
  kAmpPairsChannelMajor = 9,  // channel-major (C, rows, 2)
};

// K13 rank_pair.  The three counts of a pair share one pass and one
// barrier over double-banked partials, as K4 reduces its three targets.
__device__ float mad_noise_pair(const float* dev, int* red, int& bank, int C) {
  __shared__ int part[2][kWarps][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const RankTarget t = rank_target(C, block_sum(count_zeros(dev, C), red, bank));
  unsigned cur = 0;
  int r_cur = 0;
  for (int i = 0; i < 15; ++i) {
    const unsigned hi = 1u << (30 - 2 * i);
    const unsigned lo = 1u << (29 - 2 * i);
    const float c_hi = __uint_as_float(cur | hi);
    const float c_lo = __uint_as_float(cur | lo);
    const float c_both = __uint_as_float(cur | hi | lo);
    int n_hi = 0, n_lo = 0, n_both = 0;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float a = fabsf(dev[c]);
      n_hi += a < c_hi;
      n_lo += a < c_lo;
      n_both += a < c_both;
    }
    n_hi = __reduce_add_sync(0xffffffffu, n_hi);
    n_lo = __reduce_add_sync(0xffffffffu, n_lo);
    n_both = __reduce_add_sync(0xffffffffu, n_both);
    int(*b)[3] = part[i & 1];
    if (lane == 0) {
      b[warp][0] = n_hi;
      b[warp][1] = n_lo;
      b[warp][2] = n_both;
    }
    __syncthreads();
    n_hi = n_lo = n_both = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      n_hi += b[w][0];
      n_lo += b[w][1];
      n_both += b[w][2];
    }
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
  const int cnt = block_sum(count_less(dev, C, __uint_as_float(test)), red, bank);
  if (cnt <= t.target) {
    cur = test;
    r_cur = cnt;
  }
  return noise_from_rank(dev, red, bank, C, cur, r_cur, t);
}

// K13 zeros_fold.  Zeros in the low 16 bits, count(|dev| < 2.0f) (bit 30's
// candidate) in the high 16: each field is at most C < 2**16, so the
// unsigned sum wraps nowhere.
__device__ float mad_noise_zeros_fold(const float* dev, int* red, int& bank, int C) {
  const float cand30 = __uint_as_float(1u << 30);
  unsigned packed = 0;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float a = fabsf(dev[c]);
    packed += (a == 0.f) + ((unsigned)(a < cand30) << 16);
  }
  packed = block_sum(packed, red, bank);
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
    const int cnt = block_sum(count_less(dev, C, __uint_as_float(test)), red, bank);
    if (cnt <= t.target) {
      cur = test;
      r_cur = cnt;
    }
  }
  return noise_from_rank(dev, red, bank, C, cur, r_cur, t);
}

// K9 shfl_median: K1's fast-path median with the members within a warp
// taken by shuffles.  A rotation by d serves every lane with one shuffle:
// the lanes whose member lies past the warp's edge read it from the source
// lane the rotation wraps to, which supplies the value 32 channels away
// (`right` for d > 0, `left` for d < 0) instead of its own.  Those two are
// the only members read from shared memory or the halo, once per lane and
// tile.  Every lane takes part in every shuffle, past C included.
__device__ void median_to_deviations_shfl(float* buf, float* halo, int C) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < C; base += kThreads) {
    const int c = base + threadIdx.x;
    const bool in = c < C;
    const float self = in ? buf[c] : 0.f;
    float right = 0.f;  // channel c + 32, needed by lanes < kHalf
    float left = 0.f;   // channel c - 32, needed by lanes >= 32 - kHalf
    if (lane < kHalf && c + 32 < C) right = buf[c + 32];
    const int j_left = c - 32;
    if (lane >= 32 - kHalf && j_left >= 0 && j_left < C) {
      left = j_left < base ? halo[j_left - base + kHalf] : buf[j_left];
    }
    float w[FF_WIDTH];
#pragma unroll
    for (int k = 0; k < FF_WIDTH; ++k) {
      const int d = k - kHalf;
      if (d == 0) {
        w[k] = self;
        continue;
      }
      const float give = d > 0 ? (lane < d ? right : self) : (lane >= 32 + d ? left : self);
      const float x = __shfl_sync(0xffffffffu, give, (lane + d) & 31);
      const int j = c + d;
      w[k] = (j < 0 || j >= C) ? edge_fill(c, d, C) : x;
    }
    float dev = 0.f;
    if (in) {
      FF_NET_FAST(w);
      dev = __fsub_rn(self, fast_median(w, c, C));
    }
    __syncthreads();  // every window of this tile has read its members
    if (in) {
      if (threadIdx.x >= kThreads - kHalf) halo[threadIdx.x - (kThreads - kHalf)] = self;
      buf[c] = dev;
    }
    __syncthreads();
  }
}

// Every variant but the skeleton: K1's stages, with the variant's own in
// place of one of them.
template <int kVariant>
__device__ void flag_row(const float2* v, float* buf, uint8_t* flags, int* red, float* halo,
                         uint8_t* o, const Params& p) {
  const int C = p.channels;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float a = amplitude(v[c]);
    buf[c] = kVariant == kNoMedian ? __fsub_rn(a, __fmul_rn(a, 0.5f)) : a;
  }
  __syncthreads();
  if constexpr (kVariant == kShflMedian) {
    median_to_deviations_shfl(buf, halo, C);
  } else if constexpr (kVariant != kNoMedian) {
    median_to_deviations<true, false>(buf, halo, C);
  }
  int bank = 0;
  float noise;
  if constexpr (kVariant == kNoRank) {
    noise = 1.0f;
  } else if constexpr (kVariant == kRankPair) {
    noise = mad_noise_pair(buf, red, bank, C);
  } else if constexpr (kVariant == kZerosFold) {
    noise = mad_noise_zeros_fold(buf, red, bank, C);
  } else {
    noise = mad_noise(buf, red, bank, C);
  }
  if constexpr (kVariant == kNoThresh) {
    const uint8_t fv = (uint8_t)p.flag_value;
    for (int c = threadIdx.x; c < C; c += kThreads) o[c] = buf[c] > noise ? fv : 0;
  } else {
    sum_threshold_row(buf, flags, noise, o, p);
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads, 1)
    probe_kernel(const float2* __restrict__ vis, uint8_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.channels;
  const size_t row = blockIdx.x;
  const float2* v = vis + row * C;
  uint8_t* o = out + row * C;
  if constexpr (kVariant == kSkeleton) {
    const uint8_t fv = (uint8_t)p.flag_value;
    for (int c = threadIdx.x; c < C; c += kThreads) o[c] = amplitude(v[c]) > 1.0f ? fv : 0;
  } else {
    int* red = reinterpret_cast<int*>(smem + scratch_offset(C));
    flag_row<kVariant>(v, reinterpret_cast<float*>(smem), smem + flags_offset(C), red,
                       reinterpret_cast<float*>(red + 2 * kWarps), o, p);
  }
}

// K12.  One CTA per row writes the row's amplitudes; reading channel-major
// input, a warp's 32 loads are `rows` pairs apart.
template <bool kChannelMajor>
__global__ void __launch_bounds__(kThreads, 1)
    amp_pairs_kernel(const float2* __restrict__ vis, float* __restrict__ out, int rows, int C) {
  const size_t row = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float2 x = kChannelMajor ? vis[(size_t)c * rows + row] : vis[row * C + c];
    out[row * C + c] = amplitude(x);
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
    case kShflMedian: return f(probe_kernel<kShflMedian>);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int with_amp_kernel(int variant, F&& f) {
  switch (variant) {
    case kAmpPairs: return f(amp_pairs_kernel<false>);
    case kAmpPairsChannelMajor: return f(amp_pairs_kernel<true>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// As in fused_flagger.cu, so the wrappers share their checks.
int ff_max_channels(void) { return max_channels(); }

const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The launch configuration of `variant` at `channels`: threads per CTA,
// dynamic shared memory, and the CTAs that fit one SM at once.
int fp_launch_config(int variant, int channels, int* threads, long long* smem_bytes_out,
                     int* ctas_per_sm) {
  if (channels < FF_WIDTH || channels > max_channels()) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(channels);
  auto query = [&](auto kernel) {
    int err = set_smem(kernel, smem);
    if (err) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, kThreads,
                                                              smem);
  };
  const int err = variant < kAmpPairs ? with_probe_kernel(variant, query)
                                      : with_amp_kernel(variant, query);
  *threads = kThreads;
  *smem_bytes_out = (long long)smem;
  return err;
}

// A flag-producing probe over `rows` rows of planar (re, im) float32 pairs,
// (rows, channels, 2), to (rows, channels) u8.  Returns a cudaError_t; 0
// when the launch was accepted.
int fp_probe(int variant, const void* vis, void* out, int rows, int channels, float n_sigma,
             const float* scales, int n_windows, int flag_value, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value);
  if (err) return err;
  if (rows < 1 || channels < FF_WIDTH) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(channels);
  const float2* v = static_cast<const float2*>(vis);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = with_probe_kernel(variant, [&](auto kernel) {
    int e = set_smem(kernel, smem);
    if (e) return e;
    kernel<<<rows, kThreads, smem, s>>>(v, o, p);
    return 0;
  });
  return err ? err : (int)cudaGetLastError();
}

// K12 over (rows, channels) amplitudes; vis is (rows, channels, 2) when
// channel_major is 0, else (channels, rows, 2).
int fp_amp_pairs(const void* vis, int channel_major, void* out, int rows, int channels,
                 void* stream) {
  if (rows < 1 || channels < 1 || channels > max_channels()) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(channels);
  const float2* v = static_cast<const float2*>(vis);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_amp_kernel(channel_major ? kAmpPairsChannelMajor : kAmpPairs,
                                  [&](auto kernel) {
                                    int e = set_smem(kernel, smem);
                                    if (e) return e;
                                    kernel<<<rows, kThreads, smem, s>>>(v, o, rows, channels);
                                    return 0;
                                  });
  return err ? err : (int)cudaGetLastError();
}

}  // extern "C"
