// The op-inventory skeleton K10 for Hopper (sm_90a), with a plain C ABI.
// It replaces scripts/roofline_skeleton.py::skeleton_block (:64), run by
// `kernel` (:137, call :151) over the dump through the TPU's DMA block loop
// (K3): the roofline's op inventory (models/rfi/roofline.py::op_inventory),
// executed op for op on amplitudes, with none of the flagger's masks, valid
// counts or halfway corrections.  Here one launch covers every row.
//
// Per row of C float32 amplitudes x (skeleton_block :64-112):
//   a    = sqrt(min(x, 3) + x)
//   w    = a and its FF_WIDTH - 1 channel shifts by -half..half (wrapped),
//          the shifts by -half and -half + 1 replaced by 3 and 5 in the
//          row's upper half (the two parity-fill selects)
//   dev  = the selection network's rank `half` of w (FF_NET_FAST, the
//          network K1 runs) - a
//   r    = 0, then 32 rounds of r = count(dev < r) / 1024 (the rank carry)
//   s    = min(dev, 3) + r
//   flag = s > r, or any of the window-2, -4, -8 ladders of s (wrapped
//          sums, Kogge-Stone order) > r * 1.2
//   acc  = flag at c or at any of the 11 channels before it (the dilation's
//          6 shifts by -1, -1, -2, -1, -2, -4), times 0.5
//   out  = (uint8)(int)acc, which is 0 for every input.
// Because the output is always 0, the wrapper can also return the rank
// carry r of each row, and every check compares both.  The 0.5 is a kernel
// argument, so the compiler cannot prove the output constant and drop the
// work before it.
//
// What bounds it: operations.  The inventory's ~150 operations per
// element against 5 B of traffic (4 B in, 1 B out) put the op bound above
// the byte bound.  The design is K1's machine (ff_runs.cuh, the run
// layout) at K1's launch, so the skeleton's time prices K1's design: one
// CTA of kThreads threads per row, runs::smem_bytes of dynamic shared
// memory (one CTA per SM at 32768 channels), up to K1's channel limit.
//  * Amplitudes at word c (a coalesced read), replaced by deviations at
//    word phys(c) a tile of kThreads channels at a time from the top tile
//    down, one barrier a tile, as runs::median_to_deviations: a tile's
//    stores land at phys(c) >= c + 32 past its base, above every amplitude
//    a lower tile reads.  The wraps: the top tile reads channels
//    0 .. half - 1, which stay amplitudes until the lowest tile, the last,
//    stores; the lowest tile reads the row's last `half` channels, whose
//    words an upper tile's stores may already hold (at 32768 channels,
//    channel ~31775 stores to words 32762-32767), so they are copied into
//    `tail`, in the flag masks, before the first tile.
//  * The rank carry holds dev of channels t + 1024 j, j < kRankRegs, in
//    registers, and each round is one runs::block_sum32, as K1's mad_noise.
//  * The ladders: thread t owns the run of R = ceil(C / 1024) channels from
//    tR, as K1's SumThreshold, and builds s, then the window-2, -4, -8 sums
//    by doubling in registers a chunk of runs::kChunk starts at a time
//    (run_hits' structure; each s loaded once, wrapped mod C); the flags
//    are bits of a u64 mask.  s_2m[c] = s_m[c] + s_m[c + m] is exactly the
//    ladders' l2 = s0 + s1, l4 = l2 + (s2 + s3), l8 = l4 + ((s4 + s5) +
//    (s6 + s7)).
//  * The dilation is shift-OR doubling of the thread's mask plus the
//    previous run's last 11 flags (thread 0: the row's last 11, which a
//    short last run splits over two runs).  Rows whose runs are shorter
//    than 11 channels (C <= 10240) take a plainer path, channel by channel
//    from the published masks, as runs::dilate_any.
//  * The output goes out channel-strided from the masks, as K1's flags.

#include "ff_runs.cuh"  // ff_device.cuh, the run layout, K1's comparators

static_assert(kHalf <= 15, "K10 takes odd widths 3..31");

namespace {

constexpr float kC = 3.0f;
constexpr float kC2 = 5.0f;
constexpr int kRankRounds = 32;
constexpr int kReach = 11;  // the dilation flags c from a flag at c - 11 .. c

// A row holds at least a window and the dilation's reach, so a shifted
// channel wraps at most once.
constexpr int min_channels() { return FF_WIDTH > kReach + 1 ? FF_WIDTH : kReach + 1; }

// Deviations of the amplitudes at words [0, C) into words phys(c); `tail`
// holds the amplitudes of channels C - kHalf .. C - 1.
__device__ void deviations(float* buf, const float* tail, int C) {
  for (int base = (C - 1) / kThreads * kThreads; base >= 0; base -= kThreads) {
    const int c = base + threadIdx.x;
    const bool interior = base >= kHalf && base + kThreads + kHalf <= C;
    float dev = 0.f;
    if (c < C) {
      const float a = buf[c];
      const bool upper = c >= (C >> 1);
      float w[FF_WIDTH];
      w[0] = a;
#pragma unroll
      for (int k = 1; k < FF_WIDTH; ++k) {
        const int d = k <= kHalf ? k - 1 - kHalf : k - kHalf;
        const int j = c + d;
        float v = interior ? buf[j] : (j < 0 ? tail[j + kHalf] : buf[j >= C ? j - C : j]);
        if (k == 1 && upper) v = kC;
        if (k == 2 && upper) v = kC2;
        w[k] = v;
      }
      FF_NET_FAST(w);
      dev = __fsub_rn(w[kHalf], a);
    }
    __syncthreads();  // every window of this tile has read its members
    if (c < C) buf[runs::phys(c)] = dev;
  }
  __syncthreads();
}

// The rank carry: 32 rounds of r = count(dev < r) / 1024 (+inf past C
// counts nothing).
__device__ float rank_carry(const float* dev, int* red, int C) {
  float a[runs::kRankRegs];
#pragma unroll
  for (int j = 0; j < runs::kRankRegs; ++j) {
    const int c = threadIdx.x + j * kThreads;
    a[j] = c < C ? dev[runs::phys(c)] : CUDART_INF_F;
  }
  const int rest = threadIdx.x + runs::kRankRegs * kThreads;
  int bank = 0;
  float r = 0.f;
  for (int i = 0; i < kRankRounds; ++i) {
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < runs::kRankRegs; ++j) cnt += a[j] < r;
    for (int c = rest, p = runs::phys(rest); c < C; c += kThreads, p += runs::kStride) {
      cnt += dev[p] < r;
    }
    r = __fmul_rn((float)runs::block_sum32(cnt, red, bank), 1.0f / 1024.0f);
  }
  return r;
}

// The flags of the run's channels: s > r or a ladder > r12, bit k for
// channel c0 + k.
__device__ runs::u64 ladder_flags(const float* dev, int c0, int R, int C, float r, float r12) {
  constexpr int N = runs::kChunk + 7;  // the starts and the window of 8 past the last
  runs::u64 flags = 0;
  for (int k0 = 0; k0 < R && c0 + k0 < C; k0 += runs::kChunk) {
    float s[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      // j < C + N - 1: one wrap, into the row's words.  A start in the row
      // reads j < C + 7 <= 2 C; the others' values are unused.
      const int j = c0 + k0 + i;
      s[i] = __fadd_rn(fminf(dev[runs::phys(j >= C ? j - C : j)], kC), r);
    }
    unsigned f = 0;
#pragma unroll
    for (int i = 0; i < runs::kChunk; ++i) f |= (unsigned)(s[i] > r) << i;
#pragma unroll
    for (int i = 0; i + 2 <= N; ++i) s[i] = __fadd_rn(s[i], s[i + 1]);  // l2
#pragma unroll
    for (int i = 0; i < runs::kChunk; ++i) f |= (unsigned)(s[i] > r12) << i;
#pragma unroll
    for (int i = 0; i + 4 <= N; ++i) s[i] = __fadd_rn(s[i], s[i + 2]);  // l4
#pragma unroll
    for (int i = 0; i < runs::kChunk; ++i) f |= (unsigned)(s[i] > r12) << i;
#pragma unroll
    for (int i = 0; i + 8 <= N; ++i) s[i] = __fadd_rn(s[i], s[i + 4]);  // l8
#pragma unroll
    for (int i = 0; i < runs::kChunk; ++i) f |= (unsigned)(s[i] > r12) << i;
    const int n = min(R - k0, C - c0 - k0);  // starts in the run and the row
    if (n < runs::kChunk) f &= (1u << n) - 1;
    flags |= (runs::u64)f << k0;
  }
  return flags;
}

// Flag c of the published masks (mask[q], bit b: channel qR + b).
__device__ __forceinline__ bool mask_bit(const runs::u64* masks, int c, int R) {
  return (masks[c / R] >> (c % R)) & 1ull;
}

// The flags of channels c0 - 11 .. c0 - 1 (wrapped), bit i for c0 - 11 + i,
// from the published masks of runs of R >= 11 channels.
__device__ unsigned flags_before(const runs::u64* masks, int t, int R, int C) {
  constexpr unsigned kBits = (1u << kReach) - 1;
  if (t > 0) return (unsigned)(masks[t - 1] >> (R - kReach)) & kBits;  // a whole run
  const int last = (C - 1) / R;  // the row's last run, of L channels
  const int L = C - last * R;
  if (L >= kReach) return (unsigned)(masks[last] >> (L - kReach)) & kBits;
  const int m = kReach - L;  // from the run before it, a whole one
  return ((unsigned)(masks[last - 1] >> (R - m)) & ((1u << m) - 1)) |
         ((unsigned)masks[last] & ((1u << L) - 1)) << m;
}

__global__ void __launch_bounds__(kThreads, 1)
    skeleton_kernel(const float* __restrict__ amp, uint8_t* __restrict__ out,
                    float* __restrict__ rank_out, int C, float flag_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  runs::u64* flag_masks = reinterpret_cast<runs::u64*>(smem + runs::masks_offset(C));
  runs::u64* out_masks = flag_masks + kThreads;
  int* red = reinterpret_cast<int*>(out_masks + kThreads);
  // K1's shared memory, to the byte at its channel limit: `tail` lives in
  // the flag masks, which the ladders first write after the deviations.
  float* tail = reinterpret_cast<float*>(flag_masks);
  const size_t row = blockIdx.x;
  const float* x = amp + row * C;

  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float v = x[c];
    const float a = __fsqrt_rn(__fadd_rn(fminf(v, kC), v));
    buf[c] = a;
    if (c >= C - kHalf) tail[c - (C - kHalf)] = a;
  }
  __syncthreads();
  deviations(buf, tail, C);

  const float r = rank_carry(buf, red, C);
  if (rank_out != nullptr && threadIdx.x == 0) rank_out[row] = r;

  const int t = threadIdx.x;
  const int R = runs::run_length(C);
  const int c0 = t * R;
  const bool active = c0 < C;
  const runs::u64 h =
      active ? ladder_flags(buf, c0, R, C, r, __fmul_rn(r, 1.2f)) : 0;
  flag_masks[t] = h;
  __syncthreads();
  runs::u64 d = 0;
  if (active && R >= kReach) {
    runs::u64 d2 = h | h << 1;
    d2 |= d2 << 2;  // a flag at c reaches c .. c + 3
    d = d2 | d2 << 4 | d2 << 8;  // .. c + 11
    // Bit i of p: a flag at c0 - 11 + i, which reaches run bits 0 .. i.
    const unsigned p = flags_before(flag_masks, t, R, C);
    if (p) d |= (2ull << (31 - __clz(p))) - 1;
    d &= R >= 64 ? ~0ull : (1ull << R) - 1;
  } else if (active) {
    for (int k = 0; k < R && c0 + k < C; ++k) {
      bool hit = false;
      for (int j = 0; j <= kReach && !hit; ++j) {
        const int c = c0 + k - j;
        hit = mask_bit(flag_masks, c < 0 ? c + C : c, R);
      }
      if (hit) d |= 1ull << k;
    }
  }
  out_masks[t] = d;
  __syncthreads();
  // The output, channel-strided so that a warp stores 32 adjacent bytes.
  uint8_t* o = out + row * C;
  const int dq = kThreads / R;
  const int db = kThreads - dq * R;
  runs::BitCursor cur(t, R);
  for (int c = t; c < C; c += kThreads) {
    o[c] = (uint8_t)(int)__fmul_rn(cur.get(out_masks) ? 1.0f : 0.0f, flag_scale);
    cur.q += dq;
    cur.b += db;
    if (cur.b >= R) {
      cur.b -= R;
      ++cur.q;
    }
  }
}

}  // namespace

extern "C" {

// As in fused_flagger.cu, so the wrappers share their checks: K1's limit.
int ff_max_channels(void) { return runs::max_channels(); }

const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// How the skeleton launches at `channels`: threads per CTA, dynamic shared
// memory (K1's, runs::smem_bytes), and the CTAs that fit one SM at once.
int rs_launch_config(int channels, int* threads, long long* smem_out, int* ctas_per_sm) {
  if (channels < min_channels() || channels > runs::max_channels()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = runs::smem_bytes(channels);
  int err = set_smem(skeleton_kernel, smem);
  if (!err) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, skeleton_kernel,
                                                             kThreads, smem);
  }
  *threads = kThreads;
  *smem_out = (long long)smem;
  return err;
}

// The skeleton over (rows, channels) float32 amplitudes to (rows, channels)
// u8, and each row's rank carry to rank_out when it is not null.  Returns a
// cudaError_t; 0 when the launch was accepted.
int rs_skeleton(const void* amp, void* out, void* rank_out, int rows, int channels,
                float flag_scale, void* stream) {
  if (rows < 1 || channels < min_channels() || channels > runs::max_channels()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = runs::smem_bytes(channels);
  const int err = set_smem(skeleton_kernel, smem);
  if (err) return err;
  skeleton_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(amp), static_cast<uint8_t*>(out),
      static_cast<float*>(rank_out), channels, flag_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
