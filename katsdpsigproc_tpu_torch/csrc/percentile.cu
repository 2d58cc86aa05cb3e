// Per-row [min, max, p25, p75, p50] of positive float32 data for Hopper
// (sm_90a), with a plain C ABI.
//
// K4 `percentile5_radix_kernel` replaces the TPU kernel
//   katsdpsigproc_tpu/ops/percentile.py::_percentile5_kernel
// (a VMEM-resident row block: NaN-ignoring min and max, then the
// lower-element percentiles at ranks (n-1)//4, 3(n-1)//4 and (n-1)//2 by a
// 31-round bitwise search over the IEEE-754 bit pattern, all three targets
// per round).
//
// What bounds it on the card: bytes.  At 4000 x 5000 the input is 80 MB,
// 24 us at 3.35 TB/s; the radix select below does about 13 operations an
// element.  The design it replaced (in the repository's history) spent 31
// dependent rounds a row, each a pass over the row in shared memory, three
// count chains and a barrier: 0.417 ms on an H100 at 4000 x 5000, and at
// 64 x 4096 31 barrier round trips on 64 CTAs with 68 SMs idle.
//
// What the design does about it:
//  * Row in registers.  Each thread loads its share of the row once,
//    16 B at a time (a scalar head up to the first 16-byte boundary and a
//    scalar tail go to one extra slot of the first threads), into kPer
//    registers, kPer a template constant so that no runtime index sends
//    the array to local memory.  Rows wider than the register slots keep
//    their keys in shared memory, or, wider still, are read from device
//    memory every pass.
//  * Radix select instead of 31 binary rounds.  Each value becomes a
//    31-bit key whose order reproduces the search's count of x < candidate
//    exactly (search_key): NaN is never counted; x <= +0 (-0, negatives,
//    -inf) counts below every candidate, key 0; a positive x keeps its bit
//    pattern.  The three targets' keys are resolved 8 + 8 + 8 + 7 bits at a
//    time: each pass builds a shared-memory histogram of the digit of the
//    keys that still match each target's prefix, and warps 0-2 each scan
//    one target's histogram with one warp scan and a ballot.  Two barriers
//    a pass, eight a row, against 31.  The first pass, whose digit is the
//    exponent, counts all keys into one histogram for the three targets,
//    one shared atomic a key.  The few exponents of real data put many
//    lanes of a warp on one address, but aggregating equal digits first
//    (__match_any_sync) measured slower on the H100.
//  * The search's end state.  Once the search accepts +inf (0x7f800000),
//    every later candidate is a NaN pattern, counts nothing and is
//    accepted; so a target whose key is +inf, or whose rank lies beyond
//    the non-NaN count, gives the pattern 0x7fffffff.
//  * More threads per row when rows are few: below the SM count, one
//    1024-thread CTA per row; otherwise 256-thread CTAs, several per SM.
//
// Parity with the JAX kernel, bit for bit:
//  * NaN is absent: it is skipped by min and max and counts below no
//    candidate; the targets come from the column count, NaN included;
//  * counts are exact integers (the JAX kernel sums 0/1 in float32, which is
//    exact below 2**24 columns);
//  * a candidate is accepted when count(x < candidate) <= target;
//  * an all-NaN row gives min = +inf and max = -inf.
// The row is `row_stride` floats from the next (columns contiguous), so a
// column range is a view and never a copy.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

struct Targets {
  int t[3];  // p25, p75, p50 ranks
};

// ---- K4: the row's keys in registers ----

constexpr unsigned kNanKey = 0xffffffffu;  // never counted, matches no prefix
constexpr unsigned kInfKey = 0x7f800000u;  // +inf, the largest counted key
constexpr unsigned kEndState = 0x7fffffffu;
constexpr unsigned kNoPrefix = 0xffffffffu;  // a target beyond the non-NaN count

// The key whose unsigned order reproduces the search's count of
// x < candidate for every candidate that is not a NaN pattern.
__device__ __forceinline__ unsigned search_key(float x) {
  return x != x ? kNanKey : (x > 0.f ? __float_as_uint(x) : 0u);
}

__device__ __forceinline__ void min_max(float v, float& mn, float& mx) {
  if (v < mn) mn = v;  // false for NaN
  if (v > mx) mx = v;
}

// A row's keys in kPer registers a thread plus one extra slot, loaded as
// float4s from the first 16-byte boundary; the scalar head before it and
// the tail after the last whole float4 (at most 3 + 3 values) go to the
// extra slot of threads 0..5.  Needs n <= kThreads * kPer.
template <int kThreads, int kPer>
struct RegisterKeys {
  static_assert(kPer % 4 == 0, "float4 slots");
  unsigned k[kPer];
  unsigned extra;

  __device__ __forceinline__ void load(const float* row, int n, float& mn, float& mx) {
    const int head = min((int)((16u - ((unsigned)(uintptr_t)row & 15u)) & 15u) >> 2, n);
    const int nvec = (n - head) >> 2;
    const int tail0 = head + 4 * nvec;
    const float4* body = reinterpret_cast<const float4*>(row + head);
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      const int v = j * kThreads + threadIdx.x;
      if (v < nvec) {
        const float4 q = body[v];
        min_max(q.x, mn, mx);
        min_max(q.y, mn, mx);
        min_max(q.z, mn, mx);
        min_max(q.w, mn, mx);
        k[4 * j] = search_key(q.x);
        k[4 * j + 1] = search_key(q.y);
        k[4 * j + 2] = search_key(q.z);
        k[4 * j + 3] = search_key(q.w);
      } else {
        k[4 * j] = k[4 * j + 1] = k[4 * j + 2] = k[4 * j + 3] = kNanKey;
      }
    }
    const int t = threadIdx.x;
    const int e = t < head ? t : tail0 + (t - head);  // head, then tail
    extra = kNanKey;
    if (e < n && t < head + (n - tail0)) {
      const float x = row[e];
      min_max(x, mn, mx);
      extra = search_key(x);
    }
  }

  // f(key) for every slot, in the same order on every lane of a warp.
  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) f(k[j]);
    f(extra);
  }
};

// A row too wide for the registers: its keys in shared memory (kShared)
// or recomputed from device memory on every pass.  Every lane of a warp
// runs the same iterations (keys past n are kNanKey).
template <int kThreads, bool kShared>
struct MemoryKeys {
  const float* row;
  unsigned* keys;  // dynamic shared memory, n words (kShared)
  int n;

  __device__ __forceinline__ void load(const float* r, int count, float& mn, float& mx) {
    row = r;
    n = count;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float x = row[i];
      min_max(x, mn, mx);
      if (kShared) keys[i] = search_key(x);
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + threadIdx.x;
      f(i < n ? (kShared ? keys[i] : search_key(row[i])) : kNanKey);
    }
  }
};

// The radix passes: (shift, bits) of each digit, from the top.
constexpr int kPasses = 4;
__host__ __device__ constexpr int pass_shift(int p) {
  return p == 0 ? 23 : p == 1 ? 15 : p == 2 ? 7 : 0;
}
__host__ __device__ constexpr int pass_bits(int p) { return p == 3 ? 7 : 8; }

struct RadixShared {
  unsigned hist0[256];                 // pass 0, the three targets' one histogram
  unsigned hist[kPasses - 1][3][256];  // passes 1..3, one per target
  unsigned prefix[3];                    // each target's key digits so far
  int rank[3];                           // its rank among the keys of that prefix
  float minmax[32][2];                   // warp partials
};

// Warp `w`'s min and max into sh, lane 0 writing.
__device__ __forceinline__ void warp_min_max(float mn, float mx, float (*partials)[2]) {
  for (int off = 16; off > 0; off >>= 1) {
    const float omn = __shfl_xor_sync(0xffffffffu, mn, off);
    const float omx = __shfl_xor_sync(0xffffffffu, mx, off);
    if (omn < mn) mn = omn;
    if (omx > mx) mx = omx;
  }
  if ((threadIdx.x & 31) == 0) {
    partials[threadIdx.x >> 5][0] = mn;
    partials[threadIdx.x >> 5][1] = mx;
  }
}

// The row's min and max from the warp partials, by one lane.
__device__ __forceinline__ void write_min_max(float (*partials)[2], int warps, float* out,
                                              int rows) {
  float mn = partials[0][0];
  float mx = partials[0][1];
  for (int w = 1; w < warps; ++w) {
    if (partials[w][0] < mn) mn = partials[w][0];
    if (partials[w][1] > mx) mx = partials[w][1];
  }
  out[blockIdx.x] = mn;
  out[(long long)rows + blockIdx.x] = mx;
}

// One warp picks the digit of the bin holding rank `rank` in a histogram of
// kBins bins: kBins / 32 consecutive bins a lane, a warp scan of the lanes'
// sums and a ballot of the lanes whose inclusive sum passes the rank.
// Returns false when the histogram holds no more than `rank` keys.
template <int kBins>
__device__ __forceinline__ bool select_digit(const unsigned* hist, int rank, unsigned& digit,
                                             int& rest) {
  constexpr int kPerLane = kBins / 32;
  const unsigned lane = threadIdx.x & 31;
  unsigned h[kPerLane];
  unsigned s = 0;
#pragma unroll
  for (int b = 0; b < kPerLane; ++b) {
    h[b] = hist[lane * kPerLane + b];
    s += h[b];
  }
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= (unsigned)off) incl += o;
  }
  const unsigned past = __ballot_sync(0xffffffffu, incl > (unsigned)rank);
  if (past == 0) return false;
  const unsigned owner = __ffs(past) - 1;
  unsigned run = incl - s;  // keys in the bins below this lane's
  unsigned d = 0;
  int r = 0;
  bool done = false;
#pragma unroll
  for (int b = 0; b < kPerLane; ++b) {
    if (!done && run + h[b] > (unsigned)rank) {
      d = lane * kPerLane + b;
      r = rank - (int)run;
      done = true;
    }
    run += h[b];
  }
  digit = __shfl_sync(0xffffffffu, d, owner);
  rest = __shfl_sync(0xffffffffu, r, owner);
  return true;
}

// Warp w < 3 resolves target w's digit of pass p and publishes the prefix
// and the rank within it; after the last pass it writes the percentile.
template <int p>
__device__ __forceinline__ void resolve(RadixShared& sh, const Targets& tg, float* out, int rows) {
  const int w = threadIdx.x >> 5;
  if (w >= 3) return;
  const unsigned prefix = p == 0 ? 0u : sh.prefix[w];
  const int rank = p == 0 ? tg.t[w] : sh.rank[w];
  unsigned digit = 0;
  int rest = -1;
  const unsigned* hist;
  if constexpr (p == 0) {
    hist = sh.hist0;
  } else {
    hist = sh.hist[p - 1][w];
  }
  const bool found =
      prefix != kNoPrefix && select_digit<(1 << pass_bits(p))>(hist, rank, digit, rest);
  const unsigned next = found ? (prefix << pass_bits(p)) | digit : kNoPrefix;
  if ((threadIdx.x & 31) == 0) {
    if (p < kPasses - 1) {
      sh.prefix[w] = next;
      sh.rank[w] = rest;
    } else {
      // The search's end state: +inf, or no key at the rank, gives 0x7fffffff.
      const unsigned bits = (!found || next >= kInfKey) ? kEndState : next;
      out[(2LL + w) * rows + blockIdx.x] = __uint_as_float(bits);
    }
  }
}

// Pass p >= 1: count the digit of every key still under a target's prefix.
template <int p, class Keys>
__device__ __forceinline__ void count_pass(const Keys& keys, RadixShared& sh) {
  constexpr int kHi = pass_shift(p - 1);
  constexpr int kShift = pass_shift(p);
  constexpr unsigned kMask = (1u << pass_bits(p)) - 1;
  const unsigned p0 = sh.prefix[0], p1 = sh.prefix[1], p2 = sh.prefix[2];
  unsigned* h0 = sh.hist[p - 1][0];
  unsigned* h1 = sh.hist[p - 1][1];
  unsigned* h2 = sh.hist[p - 1][2];
  keys.each([&](unsigned k) {
    const unsigned top = k >> kHi;  // never a prefix for kNanKey
    const unsigned d = (k >> kShift) & kMask;
    if (top == p0) atomicAdd(&h0[d], 1u);
    if (top == p1) atomicAdd(&h1[d], 1u);
    if (top == p2) atomicAdd(&h2[d], 1u);
  });
}

template <int kThreads, class Keys>
__device__ __forceinline__ void radix_row(Keys& keys, RadixShared& sh, const float* row, int n,
                                          Targets tg, float* out, int rows) {
  unsigned* hist = &sh.hist0[0];  // hist0, then hist
  for (int i = threadIdx.x; i < 256 + (kPasses - 1) * 3 * 256; i += kThreads) hist[i] = 0;
  float mn = CUDART_INF_F;
  float mx = -CUDART_INF_F;
  keys.load(row, n, mn, mx);
  __syncthreads();  // the histograms are clear (and a shared row's keys stored)

  // Pass 0: the exponent digit of every counted key.
  const unsigned lane = threadIdx.x & 31;
  keys.each([&](unsigned k) {
    const unsigned d = k >> 23;  // 511 for kNanKey
    if (d < 256) atomicAdd(&sh.hist0[d], 1u);
  });
  warp_min_max(mn, mx, sh.minmax);
  __syncthreads();
  if ((threadIdx.x >> 5) == 3 && lane == 0) write_min_max(sh.minmax, kThreads / 32, out, rows);
  resolve<0>(sh, tg, out, rows);
  __syncthreads();
  count_pass<1>(keys, sh);
  __syncthreads();
  resolve<1>(sh, tg, out, rows);
  __syncthreads();
  count_pass<2>(keys, sh);
  __syncthreads();
  resolve<2>(sh, tg, out, rows);
  __syncthreads();
  count_pass<3>(keys, sh);
  __syncthreads();
  resolve<3>(sh, tg, out, rows);
}

// K4.  kPer > 0: the row in kPer registers a thread; 0: its keys in
// shared memory; -1: read from device memory every pass.
template <int kThreads, int kPer>
__global__ void __launch_bounds__(kThreads)
    percentile5_radix_kernel(const float* __restrict__ src, long long row_stride, int n,
                             Targets tg, float* __restrict__ out, int rows) {
  __shared__ RadixShared sh;
  const float* row = src + (long long)blockIdx.x * row_stride;
  if constexpr (kPer > 0) {
    RegisterKeys<kThreads, kPer> keys;
    radix_row<kThreads>(keys, sh, row, n, tg, out, rows);
  } else {
    extern __shared__ unsigned row_keys[];
    MemoryKeys<kThreads, kPer == 0> keys{row, row_keys, n};
    radix_row<kThreads>(keys, sh, row, n, tg, out, rows);
  }
}

// ---- Launch ----

constexpr int kFewThreads = 256;    // a row's CTA when rows fill the SMs
constexpr int kManyThreads = 1024;  // when they do not
constexpr int kFewMaxPer = 32;      // register slots a thread at 256 threads
constexpr int kManyMaxPer = 16;     // and at 1024 (64 registers a thread)

// Dynamic shared memory a row's keys may take on the current device, in
// bytes, for `kernel`.
template <typename Kernel>
int shared_budget(Kernel kernel, int* bytes) {
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *bytes = optin - (int)attr.sharedSizeBytes;
  return 0;
}

// The widest row K4's shared-memory path holds.
int max_shared_columns(int* cols) {
  int bytes = 0;
  const int err = shared_budget(percentile5_radix_kernel<kManyThreads, 0>, &bytes);
  if (!err) *cols = bytes / (int)sizeof(unsigned);
  return err;
}

// The current device's SM count, asked once per device: a launch at
// 64 x 4096 takes the host longer than the card.
int sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int cached[kDevices];  // 0 until asked; a race writes the same value
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < kDevices && cached[device] > 0) {
    *sms = cached[device];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (device < kDevices) cached[device] = *sms;
  return 0;
}

// K4's launch shape for `rows` rows of `n` columns: threads per CTA and
// register slots a thread (0: keys in shared memory; -1: device memory).
int launch_shape(int rows, int n, int* threads, int* per) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  if (rows >= sms && n <= kFewThreads * kFewMaxPer) {
    *threads = kFewThreads;
    *per = n <= kFewThreads * 24 ? ((n + 4 * kFewThreads - 1) / (4 * kFewThreads)) * 4 : 32;
    return 0;
  }
  *threads = kManyThreads;
  if (n <= kManyThreads * kManyMaxPer) {
    *per = ((n + 4 * kManyThreads - 1) / (4 * kManyThreads)) * 4;
    return 0;
  }
  int cols = 0;
  const int e = max_shared_columns(&cols);
  if (e) return e;
  *per = n <= cols ? 0 : -1;
  return 0;
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const float* s, long long stride, int rows,
           int n, Targets tg, float* o, cudaStream_t st) {
  if (smem > 0) {
    const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
    if (err) return err;
  }
  kernel<<<rows, threads, smem, st>>>(s, stride, n, tg, o, rows);
  return (int)cudaGetLastError();
}

// K4 at the shape launch_shape picks.
int run(const float* s, long long stride, int rows, int n, Targets tg, float* o, cudaStream_t st) {
  int threads = 0;
  int per = 0;
  int err = launch_shape(rows, n, &threads, &per);
  if (err) return err;
  const size_t smem = per == 0 ? (size_t)n * sizeof(unsigned) : 0;
#define PC_CASE(T, P)          \
  if (threads == T && per == P) \
    return launch(percentile5_radix_kernel<T, P>, T, smem, s, stride, rows, n, tg, o, st);
  PC_CASE(256, 4)
  PC_CASE(256, 8)
  PC_CASE(256, 12)
  PC_CASE(256, 16)
  PC_CASE(256, 20)
  PC_CASE(256, 24)
  PC_CASE(256, 32)
  PC_CASE(1024, 4)
  PC_CASE(1024, 8)
  PC_CASE(1024, 12)
  PC_CASE(1024, 16)
  PC_CASE(256, 0)
  PC_CASE(1024, 0)
  PC_CASE(1024, -1)
#undef PC_CASE
  return (int)cudaErrorInvalidConfiguration;
}

// `launch` with `device` current, the caller's device restored after.
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

Targets targets(int n) {
  Targets tg;
  tg.t[0] = (n - 1) / 4;
  tg.t[1] = (int)((3LL * (n - 1)) / 4);
  tg.t[2] = (n - 1) / 2;
  return tg;
}

}  // namespace

extern "C" {

const char* pc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The widest row (in columns) whose keys K4 holds in shared memory on the
// current device; wider rows are read from device memory every pass.  0 on
// error.
int pc_max_shared_columns(void) {
  int cols = 0;
  return max_shared_columns(&cols) ? 0 : cols;
}

// K4's launch shape for (rows, n): threads per CTA and register slots a
// thread, 0 for keys in shared memory, -1 for device memory.
int pc_launch_shape(int rows, int n, int* threads, int* per_thread) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return launch_shape(rows, n, threads, per_thread);
}

// out (5, rows) float32 = [min, max, p25, p75, p50] of each row of src, a
// (rows, n) float32 array on CUDA device `device` whose rows are
// `row_stride` floats apart; the entry makes `device` current for the
// launch.  Returns a cudaError_t; 0 when the launch was accepted.
int pc_percentile5(int device, const void* src, long long row_stride, int rows, int n, void* out,
                   void* stream) {
  if (rows < 1 || n < 1 || row_stride < n) return (int)cudaErrorInvalidValue;
  const Targets tg = targets(n);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int { return run(s, row_stride, rows, n, tg, o, st); });
}

}  // extern "C"
