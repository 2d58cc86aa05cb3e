// The 2-D flagger's masked Gaussian filter for Hopper (sm_90a), with a plain
// C ABI: each axis's repeated box sums in one sweep through shared memory.
//
// It replaces no Pallas kernel.  In the JAX package the filter
// (katsdpsigproc_tpu/models/rfi/twodflag.py::masked_gaussian_filter, by
// _box_gaussian_filter) is lax.reduce_window, which XLA computes.  The
// port's plain version (twodflag.masked_gaussian_filter_plain) is eager
// PyTorch: per axis a zero pad of passes * r, then per pass a pad, a clone
// and 2r full-tensor adds, a crop and one division.  On a calibrator scan's
// batch (2016 x 75 x 1024, r = 10 in time and 8 in frequency) that streams
// the stacked data and weight planes, the time axis padded from 75 to 155
// dumps, 144 times: ~0.26 s a call even at an H100's full memory rate.
//
// What bounds it on the card: the ordered adds, then bytes.  The result
// must be the plain version's bit for bit, so each box output stays the
// sum of its 2r + 1 members added in ascending offset (no running sum, no
// reassociation, no FMA): 2r adds an output, `passes` passes, two planes,
// ~55 G adds for that batch on the outputs the crop can reach, 1.6 ms at
// 33.5e12 float32 adds a second.  Its device memory is ~25 B a sample
// (data 4 and flags 1 read; the two planes between the axes, 8 written and
// 8 read; the quotient 4 written): 3.9 GB, 1.2 ms at 3.35 TB/s.
//
// What the design does about it:
//  * One kernel an axis.  A CTA loads its lines' window (the line, or a
//    tile of it with a halo of passes * r on each side, zero outside the
//    data, as the plain version pads) into shared memory once, runs every
//    pass there between two buffers, and writes the cropped, divided
//    result once.  The first kernel forms where(flags, 0, data) and the
//    weight as it loads; the last writes where(fw == 0, NaN, fd / fw), so
//    neither the stacked planes nor their pads are ever stored.
//  * Pass k computes only the outputs the later passes read, (passes - k)
//    * r beyond the crop, so no member of a box ever lies outside the
//    window: no bounds test inside the sums.
//  * A thread computes K consecutive outputs of a pass (K = 8, or 4 and 2
//    at radii below 4): it reads each of their K + 2r members once from
//    shared memory and adds it to every output whose box holds it, in
//    ascending offset.  So a member load serves up to K adds, and the
//    adds, not shared memory, set the pace.
//  * Two layouts of a line.  box_strided_kernel takes a line across the
//    contiguous axis (the time axis; the frequency axis of a baseline-
//    innermost batch, as the flagger's averaged data is): a CTA owns 16
//    neighbouring lines of both planes, so every load and store of device
//    memory is a 64-byte run, and a warp's 32 lanes are its 16 lines of
//    both planes, whose buffers lie 16 banks apart.  box_rows_kernel takes a
//    line along the contiguous axis: a CTA owns one line of both planes,
//    position x at word x + x / K, so lanes whose outputs lie K apart hit
//    distinct banks.  The wrapper picks the kernel from the strides, keeps
//    the planes between the axes in the data's own layout and writes the
//    result contiguous, as the plain version does: across the baselines
//    that costs the last kernel scattered 4-byte stores (+0.1 ms a
//    calibrator-scan call on an H100), and saves the flagger's later eager
//    steps far more than that (28 ms a batch there; PERF.md, section 6).
//  * The launch picks the tile: as many outputs along the line as fit 48 KB
//    of shared memory a CTA, the line's tiles made even (one tile of a
//    calibrator scan's 75 dumps, nine of 114 of its 1024 channels across
//    the contiguous axis).  Where not one output fits (a box radius above
//    ~22 across the contiguous axis) the tile fills the card's opt-in
//    maximum, and the kernel opts in to it once per kernel instance and
//    device in a process.
//
// Parity: the adds are __fadd_rn and the divisions __fdiv_rn (IEEE, as the
// plain version's tensor divisions on the card), one division per axis by
// float32((2r + 1) ** passes), computed on the host; NaN and inf propagate
// through the adds as they do there.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// One launch (twodflag._BoxArgs mirrors it; outside the anonymous namespace,
// since the C functions take it).  Strides are in elements, in the kernel's
// axis order: (outer, line, column) for box_strided_kernel, (outer, outer,
// line) for box_rows_kernel.
struct BoxArgs {
  const float* data;             // form: the data
  const unsigned char* flags;    // form: its flags (bool or uint8)
  const float* planes_in;        // otherwise: the filled and weight planes
  float* out;                    // the quotient, or the two planes
  long long sd[3], sg[3], si[3], so[3];  // strides of data, flags, planes_in, out
  long long plane_in, plane_out;  // plane strides of planes_in and out (planes)
  int n[3];                      // extents
  int radius;                    // box radius; 0 runs no pass and divides by nothing
  int passes;
  int group;                     // K, consecutive outputs a thread computes
  int form;                      // read data and flags (1) or planes_in (0)
  int quotient;                  // write the quotient (1) or the planes (0)
  float divisor;                 // float32((2r + 1) ** passes)
};

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;                  // lines a box_strided_kernel CTA owns, each plane
constexpr int kDefaultSmem = 48 * 1024;    // a CTA's shared memory without opting in
constexpr unsigned kTorchNaN = 0x7fc00000u;  // torch.nan as float32

// Shared-memory words of one plane's buffer for a window of `window`
// positions, with K - 1 positions of slack that the last group's unused
// outputs read.  Strided: 16 lines a position, padded to 16 words mod 32,
// so the two planes of a buffer lie 16 banks apart.  Rows: x at x + x / K.
__host__ __device__ inline long long strided_words(long long window, int k) {
  return ((window + k - 1) * kCols + 31) / 32 * 32 + 16;
}

__host__ __device__ inline long long rows_words(long long window, int k) {
  const long long n = window + k - 1;
  return n + (n - 1) / k;
}

struct StridedAt {
  int col;
  __device__ int operator()(int x) const { return x * kCols + col; }
};

template <int K>
struct RowsAt {
  __device__ int operator()(int x) const { return x + (int)((unsigned)x / K); }
};

// Outputs o0 .. o0 + min(K, n_out) - 1 of one box pass: out[o] = in[o - r] +
// in[o - r + 1] + ... + in[o + r], added in that order.  Member j of the
// K + 2r the group reads is added to the outputs m with 1 <= j - m <= 2r, j
// ascending, so each output takes its members in ascending offset.
// Requires K <= 2r + 1.
template <int K, class At>
__device__ __forceinline__ void box_outputs(const float* __restrict__ in,
                                            float* __restrict__ out, At at, int o0, int n_out,
                                            int r) {
  const int base = o0 - r;
  float w[K], acc[K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    w[m] = in[at(base + m)];
    acc[m] = w[m];
  }
#pragma unroll
  for (int j = 1; j < K; ++j) {
#pragma unroll
    for (int m = 0; m < j; ++m) acc[m] = __fadd_rn(acc[m], w[j]);
  }
  for (int j = K; j <= 2 * r; ++j) {
    const float x = in[at(base + j)];
#pragma unroll
    for (int m = 0; m < K; ++m) acc[m] = __fadd_rn(acc[m], x);
  }
#pragma unroll
  for (int j = 1; j < K; ++j) {
    const float x = in[at(base + 2 * r + j)];
#pragma unroll
    for (int m = j; m < K; ++m) acc[m] = __fadd_rn(acc[m], x);
  }
#pragma unroll
  for (int m = 0; m < K; ++m) {
    if (m < n_out) out[at(o0 + m)] = acc[m];
  }
}

// The filled and weight values at index (i0, i1, i2) of the kernel's axes.
__device__ __forceinline__ void load_pair(const BoxArgs& a, long long i0, long long i1,
                                          long long i2, float& f, float& w) {
  if (a.form) {
    const bool flagged = a.flags[i0 * a.sg[0] + i1 * a.sg[1] + i2 * a.sg[2]] != 0;
    f = flagged ? 0.0f : a.data[i0 * a.sd[0] + i1 * a.sd[1] + i2 * a.sd[2]];
    w = flagged ? 0.0f : 1.0f;
  } else {
    const long long k = i0 * a.si[0] + i1 * a.si[1] + i2 * a.si[2];
    f = a.planes_in[k];
    w = a.planes_in[k + a.plane_in];
  }
}

// Divide a cropped pair and write it: the planes, or the quotient.
__device__ __forceinline__ void store_pair(const BoxArgs& a, long long i0, long long i1,
                                           long long i2, float f, float w) {
  if (a.radius > 0) {
    f = __fdiv_rn(f, a.divisor);
    w = __fdiv_rn(w, a.divisor);
  }
  const long long k = i0 * a.so[0] + i1 * a.so[1] + i2 * a.so[2];
  if (a.quotient) {
    a.out[k] = w == 0.0f ? __uint_as_float(kTorchNaN) : __fdiv_rn(f, w);
  } else {
    a.out[k] = f;
    a.out[k + a.plane_out] = w;
  }
}

// Lines across the contiguous axis.  Axes (outer, line, column); CTA
// (outer, column tile, line tile), the outer index fastest.
template <int K>
__global__ void __launch_bounds__(kThreads) box_strided_kernel(const BoxArgs a, int tile,
                                                               int col_tiles) {
  extern __shared__ float sm[];
  const int r = a.radius;
  const int passes = r > 0 ? a.passes : 0;
  const int ext = passes * r;
  long long id = blockIdx.x;
  const int o = (int)(id % a.n[0]);
  id /= a.n[0];
  const int c0 = (int)(id % col_tiles) * kCols;
  const int x0 = (int)(id / col_tiles) * tile;
  const int nx = min(tile, a.n[1] - x0);
  const int nc = min(kCols, a.n[2] - c0);
  const int window = nx + 2 * ext;
  const int words = (int)strided_words(tile + 2 * ext, K);

  for (int i = threadIdx.x; i < window * kCols; i += kThreads) {
    const int c = i % kCols, x = i / kCols;
    const int line = x0 - ext + x;
    float f = 0.0f, w = 0.0f;
    if (c < nc && line >= 0 && line < a.n[1]) load_pair(a, o, line, c0 + c, f, w);
    sm[x * kCols + c] = f;
    sm[words + x * kCols + c] = w;
  }
  __syncthreads();

  int u = 0;
  for (int k = 1; k <= passes; ++k) {
    const int n_out = window - 2 * k * r;
    const int groups = (n_out + K - 1) / K;
    const float* in = sm + 2 * u * words;
    float* out = sm + 2 * (u ^ 1) * words;
    for (int item = threadIdx.x; item < groups * 2 * kCols; item += kThreads) {
      const int c = item % kCols;
      const int p = (item / kCols) & 1;
      const int g = item / (2 * kCols);
      box_outputs<K>(in + p * words, out + p * words, StridedAt{c}, k * r + g * K,
                     n_out - g * K, r);
    }
    __syncthreads();
    u ^= 1;
  }

  const float* fin = sm + 2 * u * words;
  for (int i = threadIdx.x; i < nx * kCols; i += kThreads) {
    const int c = i % kCols, x = i / kCols;
    if (c >= nc) continue;
    const int at = (ext + x) * kCols + c;
    store_pair(a, o, x0 + x, c0 + c, fin[at], fin[words + at]);
  }
}

// Lines along the contiguous axis.  Axes (outer, outer, line); CTA (outer
// 0, outer 1, line tile), outer 1 fastest.
template <int K>
__global__ void __launch_bounds__(kThreads) box_rows_kernel(const BoxArgs a, int tile, int) {
  extern __shared__ float sm[];
  const RowsAt<K> at;
  const int r = a.radius;
  const int passes = r > 0 ? a.passes : 0;
  const int ext = passes * r;
  long long id = blockIdx.x;
  const int o1 = (int)(id % a.n[1]);
  id /= a.n[1];
  const int o0 = (int)(id % a.n[0]);
  const int x0 = (int)(id / a.n[0]) * tile;
  const int nx = min(tile, a.n[2] - x0);
  const int window = nx + 2 * ext;
  const int words = (int)rows_words(tile + 2 * ext, K);

  for (int i = threadIdx.x; i < window; i += kThreads) {
    const int line = x0 - ext + i;
    float f = 0.0f, w = 0.0f;
    if (line >= 0 && line < a.n[2]) load_pair(a, o0, o1, line, f, w);
    sm[at(i)] = f;
    sm[words + at(i)] = w;
  }
  __syncthreads();

  int u = 0;
  for (int k = 1; k <= passes; ++k) {
    const int n_out = window - 2 * k * r;
    const int groups = (n_out + K - 1) / K;
    const float* in = sm + 2 * u * words;
    float* out = sm + 2 * (u ^ 1) * words;
    for (int item = threadIdx.x; item < 2 * groups; item += kThreads) {
      const int p = item / groups;
      const int g = item - p * groups;
      box_outputs<K>(in + p * words, out + p * words, at, k * r + g * K, n_out - g * K, r);
    }
    __syncthreads();
    u ^= 1;
  }

  const float* fin = sm + 2 * u * words;
  for (int i = threadIdx.x; i < nx; i += kThreads) {
    const int w = at(ext + i);
    store_pair(a, o0, o1, x0 + i, fin[w], fin[words + w]);
  }
}

using Kernel = void (*)(const BoxArgs, int, int);

// Opt the kernel in to `optin` bytes of shared memory, once per kernel
// instance and device in this process.
int allow_smem(Kernel kernel, int slot, int device, int optin) {
  static unsigned long long opted[6];
  if (device >= 64) return (int)cudaErrorInvalidValue;
  if (opted[slot] >> device & 1ull) return 0;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (!err) opted[slot] |= 1ull << device;
  return err;
}

int group_slot(int group) { return group == 8 ? 0 : group == 4 ? 1 : group == 2 ? 2 : -1; }

int check(const BoxArgs* a) {
  if (!a || a->n[0] < 1 || a->n[1] < 1 || a->n[2] < 1 || a->passes < 1 || a->radius < 0 ||
      group_slot(a->group) < 0 || (a->radius > 0 && a->group > 2 * a->radius + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)a->passes * a->radius > INT_MAX / 4) return (int)cudaErrorInvalidValue;
  return 0;
}

long long smem_bytes(int rows, long long window, int group) {
  return 2 * 2 * (long long)sizeof(float) *
         (rows ? rows_words(window, group) : strided_words(window, group));
}

// The outputs along a line of `n` a CTA computes, its window tile + 2 * ext:
// as many as `budget` bytes of shared memory hold, the line's tiles made
// even.  0 where not one output fits.
int choose_tile(int rows, int n, int ext, int group, long long budget) {
  if (smem_bytes(rows, 1 + 2LL * ext, group) > budget) return 0;
  int lo = 1, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (smem_bytes(rows, mid + 2LL * ext, group) <= budget) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int tiles = (n + lo - 1) / lo;
  return (n + tiles - 1) / tiles;
}

int launch(const BoxArgs* a, int rows, cudaStream_t stream) {
  int err = check(a);
  if (err) return err;
  const int line = rows ? 2 : 1;
  const int ext = a->radius > 0 ? a->passes * a->radius : 0;
  int tile = choose_tile(rows, a->n[line], ext, a->group, kDefaultSmem);
  int device = 0, optin = 0;
  if (!tile) {  // a window of one output needs more than 48 KB
    err = (int)cudaGetDevice(&device);
    if (!err) err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                                device);
    if (err) return err;
    tile = choose_tile(rows, a->n[line], ext, a->group, optin);
    if (!tile) return (int)cudaErrorInvalidValue;
  }
  const long long line_tiles = (a->n[line] + tile - 1) / tile;
  const long long col_tiles = rows ? 1 : (a->n[2] + kCols - 1) / kCols;
  const long long blocks =
      (long long)a->n[0] * (rows ? a->n[1] : col_tiles) * line_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)smem_bytes(rows, tile + 2LL * ext, a->group);
  const int slot = group_slot(a->group);
  Kernel kernel;
  switch (a->group) {
    case 8: kernel = rows ? box_rows_kernel<8> : box_strided_kernel<8>; break;
    case 4: kernel = rows ? box_rows_kernel<4> : box_strided_kernel<4>; break;
    default: kernel = rows ? box_rows_kernel<2> : box_strided_kernel<2>; break;
  }
  if (optin) {
    err = allow_smem(kernel, rows * 3 + slot, device, optin);
    if (err) return err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(*a, tile, (int)col_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One axis of the masked Gaussian filter by box_strided_kernel on the current
// device.  Returns a cudaError_t; 0 when the launch was accepted.
int bf_box_strided(const BoxArgs* args, void* stream) {
  return launch(args, 0, static_cast<cudaStream_t>(stream));
}

// The same by box_rows_kernel.
int bf_box_rows(const BoxArgs* args, void* stream) {
  return launch(args, 1, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
