// The 2-D flagger's SumThreshold window chain for Hopper (sm_90a), with a
// plain C ABI: every window of every chunk of a line in one launch.
//
// It replaces no Pallas kernel.  In the JAX package the chain
// (katsdpsigproc_tpu/models/rfi/twodflag.py::_sum_threshold1d) is XLA's.
// The port's plain version (twodflag.sum_threshold_plain) is eager
// PyTorch: per chunk and window two clamping `where`s, w - 1 shifted adds,
// two compares and two dilations of w - 1 ORs, each a full pass over the
// chunk's padded lines.  The 2-D path holds its data baselines innermost,
// so every one of them is a strided view: ~1,890 non-vectorised kernels a
// calibrator-scan batch (2016 x 75 x 1024, windows 1, 2, 4, 8, 8 chunks in
// frequency), most over 1-byte bools.
//
// What bounds it on the card: operations, then bytes.  The flags must be
// the plain version's bit for bit, so each window sum stays its w members
// added in ascending offset (no running sum), each compare is a rounded
// product, and each division one IEEE division.  Its device memory is 5 B
// a sample (4 read, 1 written), 0.77 GB an axis of that batch, 0.23 ms at
// 3.35 TB/s.  On an H100 both axes of that batch take 5.4-5.7 ms (106 ms
// eager), 12x the bytes' bound; four loads in flight a thread instead of
// one did not move it, so the loads do not set its pace (PERF.md, row ST).
//
// What the design does about it:
//  * A CTA owns 32 lines across the axis of least stride (the baselines on
//    this path), so every load and store is a warp-wide run, and one
//    chunk's padded range of them, or a tile of it.  It loads the data once
//    into shared memory (position x of line c at word 33 x + c, so that a
//    warp reading one position of 32 lines, or 32 positions of one line,
//    hits 32 banks) and runs every window there; it writes (fpos | fneg)
//    over its outputs once.
//  * fpos and fneg are bit masks in shared memory, 8 positions a 16-bit
//    word (fpos in the low byte), and so are a window's hits.  A thread
//    takes 8 consecutive window starts of one line: it reads their 8 + w - 1
//    members once each, clamped as it reads them, and adds each to every sum
//    whose window holds it, in ascending offset; then it dilates 8
//    positions from the hits by the latest hit before each.  Two barriers
//    a window.
//  * A chunk's outputs depend on its padded range only, and a window's
//    flags reach w - 1 positions beyond the hits that set them, so a tile
//    of outputs needs a halo of sum(w - 1) positions on each side (within
//    the padded range) for its bits to be the whole range's.  The launch
//    takes the padded range whole where it fits the 324 rows that 48 KB of
//    shared memory holds (a calibrator scan's 75 dumps and 142-channel
//    chunks), else even tiles of it that do.  It refuses windows whose halo
//    leaves no room in 324 rows (sum(w - 1) of 162 or more) on a longer
//    range; twodflag.sum_threshold_cuda refuses them before it launches.
//
// Parity: adds __fadd_rn, products __fmul_rn, the threshold's division
// __fdiv_rn by float32(rho ** log2(w)) computed on the host, as the plain
// version's tensor ops on the card; NaN and inf propagate and compare as
// there.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

constexpr int kMaxWindows = 32;
constexpr int kMaxChunks = 128;

// One launch (twodflag._StArgs mirrors it).  Axes (outer, line, column):
// the line is the axis SumThreshold runs along, the column the axis a
// CTA's 32 lines lie across.  Strides in elements.
struct StArgs {
  const float* data;       // (outer, line, column) by sd
  const float* threshold;  // each chunk's threshold0, (outer, column) by st, chunks st_chunk apart
                           // (the first, chunk_ends[0]'s)
  unsigned char* out;      // bool (outer, line, column) by so
  long long sd[3], so[3], st[3];  // st[1] is unused
  long long st_chunk;
  int n[3];
  int n_chunks;
  int chunk_ends[kMaxChunks + 1];  // 0 <= ends[0] <= ... <= ends[n_chunks] <= n[1]
  int n_windows;
  int windows[kMaxWindows];
  float divisors[kMaxWindows];  // float32(rho ** log2(w)); 1 for w = 1
  float inv_w[kMaxWindows];     // float32(1 / w)
};

namespace {

constexpr int kCols = 32;                // lines a CTA owns
constexpr int kPitch = kCols + 1;        // words a position of the data takes
constexpr int kGroup = 8;                // window starts (and positions) a thread takes
constexpr int kMaxThreads = 1024;

// Shared memory for windows of up to `rows` positions: the data with
// kGroup - 1 positions of slack that the last group's unused sums read,
// the flag words (one group of slack) and the hit words.
__host__ __device__ constexpr long long groups(long long rows) {
  return (rows + kGroup - 1) / kGroup;
}

__host__ __device__ constexpr long long data_words(long long rows) {
  return (rows + kGroup - 1) * kPitch;
}

// Dynamic shared memory: each line's threshold0, then the data, the flag
// words and the hit words.
constexpr long long smem_bytes(long long rows) {
  return (kCols + data_words(rows)) * 4 + (2 * groups(rows) + 1) * kCols * 2;
}

// The rows a CTA's 48 KB of shared memory (without opting in) holds
// (twodflag.ST_MAX_ROWS mirrors it).
constexpr int kMaxRows = 324;
static_assert(smem_bytes(kMaxRows) <= 48 * 1024 && smem_bytes(kMaxRows + 1) > 48 * 1024,
              "kMaxRows is the most rows 48 KB holds");

// Member q of a window: the data at position q, clamped by the flags so far.
__device__ __forceinline__ float member(const float* __restrict__ xs,
                                        const uint16_t* __restrict__ fl, int q, int col,
                                        float th, float nth) {
  float x = xs[q * kPitch + col];
  const unsigned f = (unsigned)fl[(q >> 3) * kCols + col] >> (q & 7);
  if ((f & 1u) && x > th) x = th;
  if ((f & 0x100u) && x < nth) x = nth;
  return x;
}

// The hit bits of the window starts i0 .. i0 + 7 (those below n_out): bit m
// where sum * inv_w > th, bit 8 + m where sum * -inv_w > th.  Member j of the
// 8 + w - 1 is added to the sums m with 0 <= j - m < w, j ascending, so each
// sum takes its members in ascending offset.
__device__ __forceinline__ unsigned window_hits(const float* __restrict__ xs,
                                                const uint16_t* __restrict__ fl, int col, int i0,
                                                int n_out, int w, float th, float inv_w) {
  const float nth = -th;
  float acc[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float c = member(xs, fl, i0 + j, col, th, nth);
#pragma unroll
    for (int m = 0; m <= j; ++m) {
      if (m == j) {
        acc[m] = c;
      } else if (j - m < w) {
        acc[m] = __fadd_rn(acc[m], c);
      }
    }
  }
  for (int j = kGroup; j < w; ++j) {
    const float c = member(xs, fl, i0 + j, col, th, nth);
#pragma unroll
    for (int m = 0; m < kGroup; ++m) acc[m] = __fadd_rn(acc[m], c);
  }
  for (int j = max(kGroup, w); j <= w + kGroup - 2; ++j) {
    const float c = member(xs, fl, i0 + j, col, th, nth);
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      if (j - m < w) acc[m] = __fadd_rn(acc[m], c);
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    if (i0 + m < n_out) {
      if (__fmul_rn(acc[m], inv_w) > th) bits |= 1u << m;
      if (__fmul_rn(acc[m], -inv_w) > th) bits |= 0x100u << m;
    }
  }
  return bits;
}

// The positions 8g .. 8g + 7 that a hit of the window of `w` covers: bit b
// where a positive hit lies in [8g + b - w + 1, 8g + b], bit 8 + b for a
// negative one.
__device__ __forceinline__ unsigned dilate(const uint16_t* __restrict__ hits, int col, int g,
                                           int w) {
  constexpr int kNone = -(1 << 30);
  int lastp = kNone, lastn = kNone;
  const int reach = kGroup * g - w + 1;  // the earliest hit that reaches the group
  for (int gg = g - 1; gg >= 0 && kGroup * gg + kGroup - 1 >= reach &&
                       (lastp == kNone || lastn == kNone); --gg) {
    const unsigned h = hits[gg * kCols + col];
    if (lastp == kNone && (h & 0xffu)) lastp = kGroup * gg + 31 - __clz(h & 0xffu);
    if (lastn == kNone && (h >> 8)) lastn = kGroup * gg + 31 - __clz(h >> 8);
  }
  const unsigned h = hits[g * kCols + col];
  unsigned out = 0;
#pragma unroll
  for (int b = 0; b < kGroup; ++b) {
    const int j = kGroup * g + b;
    if (h >> b & 1u) lastp = j;
    if (h >> (8 + b) & 1u) lastn = j;
    if (j - lastp < w) out |= 1u << b;
    if (j - lastn < w) out |= 0x100u << b;
  }
  return out;
}

// CTA (column tile, outer, tile of a chunk, chunk), the column tile fastest.
__global__ void __launch_bounds__(kMaxThreads) sum_threshold_kernel(const StArgs a, int col_tiles,
                                                                    int tiles, int tile, int halo,
                                                                    int wmax, int rows) {
  extern __shared__ float sm[];
  float* t0s = sm;
  float* xs = sm + kCols;
  uint16_t* fl = reinterpret_cast<uint16_t*>(xs + data_words(rows));
  uint16_t* hits = fl + (groups(rows) + 1) * kCols;

  long long id = blockIdx.x;
  const int c0 = (int)(id % col_tiles) * kCols;
  id /= col_tiles;
  const int o = (int)(id % a.n[0]);
  id /= a.n[0];
  const int t = (int)(id % tiles);
  const int chunk = (int)(id / tiles);
  const int lo = a.chunk_ends[chunk], hi = a.chunk_ends[chunk + 1];
  const int t0 = lo + t * tile;
  if (t0 >= hi) return;  // a zero-length chunk, or a shorter chunk's spare tile
  const int t1 = min(hi, t0 + tile);
  const int plo = max(lo - wmax + 1, 0), phi = min(hi + wmax - 1, a.n[1]);
  const int p = phi - plo;
  const int wlo = max(plo, t0 - halo), whi = min(phi, t1 + halo);
  const int len = whi - wlo;
  const int g_len = (int)groups(len);
  const int nc = min(kCols, a.n[2] - c0);
  const bool line_fast = llabs(a.sd[1]) < llabs(a.sd[2]);
  const int span = len + kGroup - 1;

  for (int i = threadIdx.x; i < span * kCols; i += blockDim.x) {
    const int col = line_fast ? i / span : i % kCols;
    const int q = line_fast ? i % span : i / kCols;
    float v = 0.0f;
    if (q < len && col < nc) v = a.data[o * a.sd[0] + (long long)(wlo + q) * a.sd[1] +
                                        (long long)(c0 + col) * a.sd[2]];
    xs[q * kPitch + col] = v;
  }
  for (int i = threadIdx.x; i < (g_len + 1) * kCols; i += blockDim.x) fl[i] = 0;
  if (threadIdx.x < kCols) {
    const int col = threadIdx.x;
    t0s[col] = col < nc ? a.threshold[chunk * a.st_chunk + o * a.st[0] +
                                      (long long)(c0 + col) * a.st[2]]
                        : __int_as_float(0x7f800000);
  }
  __syncthreads();

  for (int k = 0; k < a.n_windows; ++k) {
    const int w = a.windows[k];
    if (w > p || w > len) continue;  // a tile's window holds every w <= p (the halo)
    const int n_out = len - w + 1;
    for (int item = threadIdx.x; item < g_len * kCols; item += blockDim.x) {
      const int col = item % kCols, g = item / kCols;
      unsigned bits = 0;
      if (kGroup * g < n_out) {
        const float th = __fdiv_rn(t0s[col], a.divisors[k]);
        bits = window_hits(xs, fl, col, kGroup * g, n_out, w, th, a.inv_w[k]);
      }
      hits[item] = (uint16_t)bits;
    }
    __syncthreads();
    for (int item = threadIdx.x; item < g_len * kCols; item += blockDim.x) {
      fl[item] |= (uint16_t)dilate(hits, item % kCols, item / kCols, w);
    }
    __syncthreads();
  }

  const int out0 = t0 - wlo, n_outs = t1 - t0;
  for (int i = threadIdx.x; i < n_outs * kCols; i += blockDim.x) {
    const int col = line_fast ? i / n_outs : i % kCols;
    const int q = out0 + (line_fast ? i % n_outs : i / kCols);
    if (col >= nc) continue;
    const unsigned f = (unsigned)fl[(q >> 3) * kCols + col] >> (q & 7);
    a.out[o * a.so[0] + (long long)(wlo + q) * a.so[1] + (long long)(c0 + col) * a.so[2]] =
        (f & 0x101u) ? 1 : 0;
  }
}

int check(const StArgs* a) {
  if (!a || a->n[0] < 1 || a->n[1] < 1 || a->n[2] < 1 || a->n_chunks < 1 ||
      a->n_chunks > kMaxChunks || a->n_windows < 1 || a->n_windows > kMaxWindows) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->chunk_ends[0] < 0 || a->chunk_ends[a->n_chunks] > a->n[1]) {
    return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < a->n_chunks; ++c) {
    if (a->chunk_ends[c + 1] < a->chunk_ends[c]) return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < a->n_windows; ++k) {
    if (a->windows[k] < 1) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int launch(const StArgs* a, cudaStream_t stream) {
  int err = check(a);
  if (err) return err;
  int wmax = 0;
  long long halo = 0;  // sum(w - 1): how far an edge's error can reach inwards
  for (int k = 0; k < a->n_windows; ++k) {
    wmax = std::max(wmax, a->windows[k]);
    halo += a->windows[k] - 1;
  }
  int longest = 0, padded = 0;  // the longest chunk, and the longest padded range
  for (int c = 0; c < a->n_chunks; ++c) {
    const int lo = a->chunk_ends[c], hi = a->chunk_ends[c + 1];
    longest = std::max(longest, hi - lo);
    if (hi > lo) {
      padded = std::max(padded, std::min(hi + wmax - 1, a->n[1]) - std::max(lo - wmax + 1, 0));
    }
  }
  int tile = longest, tiles = 1, rows = padded;
  if (padded > kMaxRows) {  // even tiles of each chunk, each with its halo
    const long long step = kMaxRows - 2 * halo;
    if (step < 1) return (int)cudaErrorInvalidValue;
    tiles = (int)((longest + step - 1) / step);
    tile = (longest + tiles - 1) / tiles;
    rows = (int)std::min((long long)padded, tile + 2 * halo);
  }
  const long long col_tiles = (a->n[2] + kCols - 1) / kCols;
  const long long blocks = col_tiles * a->n[0] * tiles * a->n_chunks;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int threads = (int)std::min((long long)kMaxThreads, kCols * groups(rows));
  sum_threshold_kernel<<<(unsigned)blocks, threads, (size_t)smem_bytes(rows), stream>>>(
      *a, (int)col_tiles, tiles, tile, (int)std::min(halo, (long long)INT_MAX), wmax, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* st_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// SumThreshold's window chain over chunks chunk_ends[0] .. chunk_ends[n_chunks]
// of every line, on the current device.  Returns a cudaError_t; 0 when the
// launch was accepted.
int st_sum_threshold(const StArgs* args, void* stream) {
  return launch(args, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
