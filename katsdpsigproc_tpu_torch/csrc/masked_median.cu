// The 2-D flagger's masked medians for Hopper (sm_90a), with a plain C ABI:
// every chunk of every population of a call in one launch.
//
// It replaces no Pallas kernel.  In the JAX package the medians
// (katsdpsigproc_tpu/models/rfi/twodflag.py::_masked_median_axis0) are
// XLA's bitwise rank search (find_rank_float).  The port's plain version
// (twodflag.masked_median_plain) sorts each population with its masked
// entries as NaN and gathers the two central values: per chunk ~20 eager
// kernels (a `where`, the permuted copy the sort makes contiguous, the sort
// with its int64 index payload, counts, two gathers, compares), 34 calls and
// ~680 kernels a calibrator-scan batch (2016 x 75 x 1024, 8 chunks), whose
// sorts (radixSortKVInPlace, DeviceSegmentedRadixSortKernel) were 22% of a
// scan's device time.
//
// What bounds it on the card: bytes.  Each sample is read once, 4 B of data
// and 1 B of flags; a full-size population of that batch is 0.78 GB, 0.23 ms
// at 3.35 TB/s.  The selection is integer compares on keys held in shared
// memory.  On an H100 a full-size population takes 1.2-1.5 ms, 5-6x the
// bytes' bound (PERF.md, row MM).
//
// What the design does about it:
//  * No sort, no sorted intermediate, no index payload.  Each value becomes
//    a 32-bit key whose unsigned order is the plain version's sort order
//    (key_of: negative floats inverted, positive ones with the sign bit set,
//    -0 as +0, a valid NaN above +inf, a masked entry above that), and the
//    key of rank k = n // 2 is selected by a radix-4 search of counts: from
//    the highest bit in which the population's least and greatest keys
//    differ, two bits a round, count the keys below three candidate
//    prefixes and keep the quarter that holds rank k; stop when it holds
//    one key.  |noise| settles in 7 rounds for 75 values, 11 for 9,600.  A
//    last pass takes the least key at or above the prefix (rank k) and the
//    greatest below it: rank k - 1 where exactly k keys lie below rank k,
//    else rank k itself (a tie).  Histograms of 8-bit digits would take 256
//    counters a population, which a thread that owns a line has no room
//    for; a bit a round (twice the rounds) measured 1-3% slower.
//  * Short lines take a thread (median_lines_kernel).  A warp owns 32
//    neighbouring lines of one chunk, lane by lane, across the axis of least
//    stride; it stages their keys in shared memory (position q of lane l at
//    word 33 q + l) with every global read a warp-wide run, along the line
//    or across the lines, whichever is contiguous, 8 loads a thread in
//    flight (read_keys); then each lane selects in its own line.  Lines up
//    to kLineMax positions (48 KB for one warp).
//  * Long populations take a CTA (median_block_kernel): a chunk of a line,
//    or a chunk of the lines of a baseline together (rows x chunk, the 2-D
//    background's 75 x 128 = 9,600 values), its keys in shared memory (up
//    to kBlockSharedMax, 224 KB), else read again from device memory at
//    every round.  Counts are summed by warp reductions and one barrier a
//    round.
//  * Chunks along the line in one launch, up to kMaxChunks.
//
// Parity with the plain version, bit for bit: the same order statistics;
// the halfway mean (upper + lower) * 0.5 in float32 (__fadd_rn,
// __fmul_rn) where n is even and lower < upper, else upper; the empty value
// where n is 0; a NaN at rank k reads as 0x7fc00000 and a zero as +0, as
// the plain version reads them.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

constexpr int kMaxChunks = 128;

// One launch (twodflag._MmArgs mirrors it).  Axes (outer, column, line,
// row): a population is the positions chunk_ends[c] <= line <
// chunk_ends[c + 1] of every row of one (outer, column); the result is
// out[c, outer, column].  Strides in elements.
struct MmArgs {
  const float* data;             // by sd
  const unsigned char* flags;    // nonzero where flagged, by sf
  float* out;                    // (chunk, outer, column) by so
  long long sd[4], sf[4];
  long long so[3];
  int n[4];
  int n_chunks;
  int chunk_ends[kMaxChunks + 1];  // 0 <= ends[0] <= ... <= ends[n_chunks] <= n[2]
  int take_abs;                    // select among |x|
  float empty_value;               // the result where no entry is valid
};

namespace {

constexpr unsigned kMasked = 0xffffffffu;  // a flagged entry: never counted, ranks last
constexpr unsigned kNanKey = 0xfffffffeu;  // a valid NaN: above +inf (0xff800000)
constexpr unsigned kZeroKey = 0x80000000u;
constexpr int kPitch = 33;                 // words a position of a warp's 32 lines takes
constexpr int kLineMax = 48 * 1024 / (4 * kPitch);  // 372 positions: one warp's 48 KB
constexpr int kLineWarpsMax = 8;
constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kBlockSharedMax = 56 * 1024;  // keys: 224 KB, beside the reductions' words

__device__ __forceinline__ unsigned key_of(float x, bool flagged, bool take_abs) {
  if (flagged) return kMasked;
  if (take_abs) x = fabsf(x);
  if (x != x) return kNanKey;
  if (x == 0.0f) return kZeroKey;
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  if (key >= kNanKey) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// What a population's keys give: n valid entries, m of them not NaN; their
// least and greatest keys below kNanKey.
struct Stats {
  int n, m;
  unsigned kmin, kmax;
};

__device__ __forceinline__ void add_key(Stats& s, unsigned key) {
  s.n += key != kMasked;
  if (key < kNanKey) {
    ++s.m;
    s.kmin = min(s.kmin, key);
    s.kmax = max(s.kmax, key);
  }
}

// The search's state: rank k lies in [lo, lo + 2^(bit + 1)), which holds
// `in` keys, with `below` keys under lo.
struct Search {
  unsigned lo;
  int bit, below, in;
};

__device__ __forceinline__ Search start(const Stats& s) {
  const unsigned d = s.kmin ^ s.kmax;
  const int top = d ? 31 - __clz(d) : -1;
  // the prefix the two share (2u << 31 is 0, so top 31 leaves none)
  const unsigned lo = top < 0 ? s.kmin : s.kmin & ~((2u << top) - 1u);
  return {lo, top, 0, s.m};
}

// One round of two bits: c1, c2 and c3 keys lie below the candidates lo +
// (1, 2, 3) * step, step = 2^(bit - 1) (1 at bit 0, where the second and
// third candidates lie past the interval and so hold every key in it).
__device__ __forceinline__ unsigned step_of(const Search& q) {
  return 1u << max(q.bit - 1, 0);
}

__device__ __forceinline__ void narrow(Search& q, int k, int c1, int c2, int c3) {
  const unsigned step = step_of(q);
  const int total = q.below + q.in;  // the keys below the interval's end
  if (k < c1) {
    q.in = c1 - q.below;
  } else if (k < c2) {
    q.in = c2 - c1;
    q.below = c1;
    q.lo += step;
  } else if (k < c3) {
    q.in = c3 - c2;
    q.below = c2;
    q.lo += 2 * step;
  } else {
    q.in = total - c3;
    q.below = c3;
    q.lo += 3 * step;
  }
  q.bit -= 2;
}

// The median from the stats, the search's end and the last pass's least key
// at or above lo (u) and greatest below it (mx).
__device__ __forceinline__ float finish(const Stats& s, const Search& q, unsigned u, unsigned mx,
                                        float empty) {
  if (s.n == 0) return empty;
  const int k = s.n >> 1;
  if (k >= s.m) return __uint_as_float(0x7fc00000u);  // rank k is a NaN
  const float upper = value_of(u);
  if (s.n & 1) return upper;
  const float lower = q.below == k ? value_of(mx) : upper;
  return lower < upper ? __fmul_rn(__fadd_rn(upper, lower), 0.5f) : upper;
}

// Loads in flight a thread before its first key is stored: a store to
// shared memory between two loads holds the second back, and a line's warp
// with one load at a time read 0.5 TB/s.  On an H100, 8 took the time
// median from 1.56 to 1.16-1.21 ms, 16 (103 registers) to 1.25-1.33; a
// CTA's 256 threads gained nothing from batches of 8 or 16.
constexpr int kLineBatch = 8;
constexpr int kBlockBatch = 1;

// fn(a, b, key) for the items first, first + stride, ... below size of a
// grid of n_fast x (size / n_fast) positions, item i at (a, b) = (i %
// n_fast, i / n_fast), whose value is d[a * sd_fast + b * sd_slow] and flag
// f[a * sf_fast + b * sf_slow]; one division, then kBatch loads at a time
// held in registers.
template <int kBatch, typename F>
__device__ __forceinline__ void read_keys(const float* __restrict__ d,
                                          const unsigned char* __restrict__ f, long long sd_fast,
                                          long long sd_slow, long long sf_fast, long long sf_slow,
                                          int n_fast, int size, int first, int stride,
                                          bool take_abs, F&& fn) {
  if (first >= size) return;
  int a = first % n_fast, b = first / n_fast;
  const int da = stride % n_fast, db = stride / n_fast;
  auto next = [&](int& p, int& q) {
    p += da;
    q += db;
    if (p >= n_fast) {
      p -= n_fast;
      ++q;
    }
  };
  for (int i0 = first; i0 < size; i0 += kBatch * stride) {
    float x[kBatch];
    unsigned char g[kBatch];
    int a0 = a, b0 = b;  // the batch's first position, replayed for the keys
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i0 + j * stride < size) {
        x[j] = __ldg(d + a * sd_fast + b * sd_slow);
        g[j] = __ldg(f + a * sf_fast + b * sf_slow);
      }
      next(a, b);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i0 + j * stride < size) fn(a0, b0, key_of(x[j], g[j] != 0, take_abs));
      next(a0, b0);
    }
  }
}

// ---- short lines: a thread a line ----

// Lane `lane`'s line: its keys at ks[q * kPitch], q < len.
__device__ float line_median(const unsigned* __restrict__ ks, int len, float empty) {
  Stats s{0, 0, 0xffffffffu, 0u};
  for (int q = 0; q < len; ++q) add_key(s, ks[q * kPitch]);
  const int k = s.n >> 1;
  Search q = start(s);
  if (k < s.m) {
    while (q.bit >= 0 && q.in > 1) {
      const unsigned step = step_of(q);
      const unsigned m1 = q.lo + step, m2 = m1 + step, m3 = m2 + step;
      int c1 = 0, c2 = 0, c3 = 0;
#pragma unroll 8
      for (int p = 0; p < len; ++p) {
        const unsigned key = ks[p * kPitch];
        c1 += key < m1;
        c2 += key < m2;
        c3 += key < m3;
      }
      narrow(q, k, c1, c2, c3);
    }
  }
  unsigned u = 0xffffffffu, mx = 0u;
#pragma unroll 8
  for (int p = 0; p < len; ++p) {
    const unsigned key = ks[p * kPitch];
    if (key >= q.lo) u = min(u, key);
    else mx = max(mx, key);
  }
  return finish(s, q, u, mx, empty);
}

// A warp a tile: 32 neighbouring columns of one (chunk, outer); tiles with
// the column tile fastest.
__global__ void __launch_bounds__(kLineWarpsMax * 32) median_lines_kernel(const MmArgs a,
                                                                          int col_tiles,
                                                                          int rows) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tile >= (long long)col_tiles * a.n[0] * a.n_chunks) return;
  unsigned* ks = smem + (threadIdx.x >> 5) * kPitch * rows;
  const int c0 = (int)(tile % col_tiles) * 32;
  const int outer = (int)(tile / col_tiles % a.n[0]);
  const int chunk = (int)(tile / col_tiles / a.n[0]);
  const int lo = a.chunk_ends[chunk], len = a.chunk_ends[chunk + 1] - lo;
  const int nc = min(32, a.n[1] - c0);
  const float* d = a.data + outer * a.sd[0] + c0 * a.sd[1] + lo * a.sd[2];
  const unsigned char* f = a.flags + outer * a.sf[0] + c0 * a.sf[1] + lo * a.sf[2];
  const bool take_abs = a.take_abs != 0;
  if (llabs(a.sd[2]) < llabs(a.sd[1])) {  // along the line: a warp reads 32 positions
    read_keys<kLineBatch>(d, f, a.sd[2], a.sd[1], a.sf[2], a.sf[1], len, nc * len, lane, 32,
                          take_abs,
                          [&](int q, int col, unsigned key) { ks[q * kPitch + col] = key; });
  } else if (lane < nc) {  // across the lines: a warp reads 32 columns
    read_keys<kLineBatch>(d + lane * a.sd[1], f + lane * a.sf[1], a.sd[2], 0, a.sf[2], 0, len,
                          len, 0, 1, take_abs,
                          [&](int q, int, unsigned key) { ks[q * kPitch + lane] = key; });
  }
  __syncwarp();
  if (lane < nc) {
    a.out[chunk * a.so[0] + outer * a.so[1] + (long long)(c0 + lane) * a.so[2]] =
        line_median(ks + lane, len, a.empty_value);
  }
}

// ---- long populations: a CTA a population ----

// The population's keys, from shared memory or read again from device
// memory: positions (line, row) of a chunk, the axis of least stride
// fastest, a thread's every kBlockThreads-th.
template <bool kShared>
struct BlockKeys {
  unsigned* keys;  // kShared
  const float* d;
  const unsigned char* f;
  long long sd_fast, sd_slow, sf_fast, sf_slow;
  int n_fast, size;
  bool take_abs;

  // fn(i, key) for each of the thread's keys, read from device memory.
  template <typename F>
  __device__ __forceinline__ void read(F&& fn) const {
    read_keys<kBlockBatch>(d, f, sd_fast, sd_slow, sf_fast, sf_slow, n_fast, size, threadIdx.x,
              kBlockThreads, take_abs,
              [&](int p, int r, unsigned key) { fn(r * n_fast + p, key); });
  }

  template <typename F>
  __device__ __forceinline__ void each(F&& fn) const {
    if (kShared) {
      for (int i = threadIdx.x; i < size; i += kBlockThreads) fn(keys[i]);
    } else {
      read([&](int, unsigned key) { fn(key); });
    }
  }
};

// The sums over the CTA of c1, c2 and c3, by every thread; `words` holds
// 3 x kBlockWarps words that no thread reads until the barrier after the
// next call's.
__device__ __forceinline__ void block_sums(int& c1, int& c2, int& c3, int (*words)[kBlockWarps]) {
  c1 = (int)__reduce_add_sync(0xffffffffu, (unsigned)c1);
  c2 = (int)__reduce_add_sync(0xffffffffu, (unsigned)c2);
  c3 = (int)__reduce_add_sync(0xffffffffu, (unsigned)c3);
  if ((threadIdx.x & 31) == 0) {
    words[0][threadIdx.x >> 5] = c1;
    words[1][threadIdx.x >> 5] = c2;
    words[2][threadIdx.x >> 5] = c3;
  }
  __syncthreads();
  c1 = c2 = c3 = 0;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    c1 += words[0][w];
    c2 += words[1][w];
    c3 += words[2][w];
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kBlockThreads) median_block_kernel(const MmArgs a) {
  extern __shared__ unsigned smem[];
  __shared__ int sums[2][3][kBlockWarps];
  __shared__ unsigned bounds[4][kBlockWarps];
  long long id = blockIdx.x;
  const int col = (int)(id % a.n[1]);
  id /= a.n[1];
  const int outer = (int)(id % a.n[0]);
  const int chunk = (int)(id / a.n[0]);
  const int lo = a.chunk_ends[chunk], len = a.chunk_ends[chunk + 1] - lo;
  const bool line_fast = llabs(a.sd[2]) <= llabs(a.sd[3]);
  const BlockKeys<kShared> keys{
      smem, a.data + outer * a.sd[0] + (long long)col * a.sd[1] + lo * a.sd[2],
      a.flags + outer * a.sf[0] + (long long)col * a.sf[1] + lo * a.sf[2],
      a.sd[line_fast ? 2 : 3], a.sd[line_fast ? 3 : 2], a.sf[line_fast ? 2 : 3],
      a.sf[line_fast ? 3 : 2], line_fast ? len : a.n[3], len * a.n[3], a.take_abs != 0};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  Stats s{0, 0, 0xffffffffu, 0u};
  keys.read([&](int i, unsigned key) {
    if (kShared) smem[i] = key;
    add_key(s, key);
  });
  s.kmin = __reduce_min_sync(0xffffffffu, s.kmin);
  s.kmax = __reduce_max_sync(0xffffffffu, s.kmax);
  if (lane == 0) {
    bounds[0][warp] = s.kmin;
    bounds[1][warp] = s.kmax;
  }
  int unused = 0;
  block_sums(s.n, s.m, unused, sums[0]);  // its barrier publishes the bounds and the keys
  for (int w = 0; w < kBlockWarps; ++w) {
    s.kmin = min(s.kmin, bounds[0][w]);
    s.kmax = max(s.kmax, bounds[1][w]);
  }

  const int k = s.n >> 1;
  Search q = start(s);
  if (k < s.m) {
    for (int r = 1; q.bit >= 0 && q.in > 1; ++r) {
      const unsigned step = step_of(q);
      const unsigned m1 = q.lo + step, m2 = m1 + step, m3 = m2 + step;
      int c1 = 0, c2 = 0, c3 = 0;
      keys.each([&](unsigned key) {
        c1 += key < m1;
        c2 += key < m2;
        c3 += key < m3;
      });
      block_sums(c1, c2, c3, sums[r & 1]);
      narrow(q, k, c1, c2, c3);
    }
  }
  unsigned u = 0xffffffffu, mx = 0u;
  keys.each([&](unsigned key) {
    if (key >= q.lo) u = min(u, key);
    else mx = max(mx, key);
  });
  u = __reduce_min_sync(0xffffffffu, u);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    bounds[2][warp] = u;
    bounds[3][warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kBlockWarps; ++w) {
      u = min(u, bounds[2][w]);
      mx = max(mx, bounds[3][w]);
    }
    a.out[chunk * a.so[0] + outer * a.so[1] + (long long)col * a.so[2]] =
        finish(s, q, u, mx, a.empty_value);
  }
}

int check(const MmArgs* a) {
  if (!a || a->n[0] < 1 || a->n[1] < 1 || a->n[2] < 0 || a->n[3] < 1 || a->n_chunks < 1 ||
      a->n_chunks > kMaxChunks) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->chunk_ends[0] < 0 || a->chunk_ends[a->n_chunks] > a->n[2]) {
    return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < a->n_chunks; ++c) {
    if (a->chunk_ends[c + 1] < a->chunk_ends[c]) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int launch(const MmArgs* a, cudaStream_t stream) {
  int err = check(a);
  if (err) return err;
  int longest = 0;
  for (int c = 0; c < a->n_chunks; ++c) {
    longest = std::max(longest, a->chunk_ends[c + 1] - a->chunk_ends[c]);
  }
  if (a->n[3] == 1 && longest <= kLineMax) {
    const int rows = std::max(longest, 1);
    const long long warp_bytes = 4LL * kPitch * rows;
    const int warps = (int)std::min<long long>(kLineWarpsMax, 48 * 1024 / warp_bytes);
    const long long col_tiles = (a->n[1] + 31) / 32;
    const long long tiles = col_tiles * a->n[0] * a->n_chunks;
    const long long blocks = (tiles + warps - 1) / warps;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    median_lines_kernel<<<(unsigned)blocks, warps * 32, (size_t)(warps * warp_bytes), stream>>>(
        *a, (int)col_tiles, rows);
    return (int)cudaGetLastError();
  }
  const long long blocks = (long long)a->n[1] * a->n[0] * a->n_chunks;
  if (blocks > INT_MAX || (long long)longest * a->n[3] > INT_MAX) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const long long size = (long long)longest * a->n[3];
  if (size <= kBlockSharedMax) {
    const size_t bytes = (size_t)std::max(size, 1LL) * 4;
    if (bytes > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(median_block_kernel<true>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err) return err;
    }
    median_block_kernel<true><<<(unsigned)blocks, kBlockThreads, bytes, stream>>>(*a);
  } else {
    median_block_kernel<false><<<(unsigned)blocks, kBlockThreads, 0, stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The masked median of every chunk chunk_ends[0] .. chunk_ends[n_chunks] of
// every population, on the current device.  Returns a cudaError_t; 0 when
// the launch was accepted.
int mm_masked_median(const MmArgs* args, void* stream) {
  return launch(args, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
