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
// the byte bound.  The design is the machine of the strided layout
// (ff_device.cuh, K2's strided design's and K1's stage probes'), so the
// skeleton's time stands beside theirs: one CTA of kThreads threads per row with the row
// resident in that layout's dynamic shared memory (5 B per channel: values, then
// flag bytes), so one CTA per SM at 32768 channels.  A channel shift is a
// read of a neighbour in shared memory; the amplitudes are replaced in
// place by the deviations a tile of kThreads channels at a time behind a
// barrier, with the previous tile's last `half` amplitudes in a halo and
// the row's first `half` in `head` for the shifts that wrap.  The ladders
// are each channel's window sums from its eight neighbours, the same
// additions in the same order as the shifted adds.

#include "ff_device.cuh"

namespace {

constexpr float kC = 3.0f;
constexpr float kC2 = 5.0f;
constexpr int kRankRounds = 32;

// A row holds at least a window and the dilation's reach (11), so a
// shifted channel wraps at most once.
constexpr int min_channels() { return FF_WIDTH > 12 ? FF_WIDTH : 12; }

__device__ __forceinline__ int wrapped(int j, int C) { return j < 0 ? j + C : (j >= C ? j - C : j); }

// The amplitude at channel j (wrapped), while tile `base` replaces
// amplitudes by deviations: from `buf` at or after `base`, else from the
// halo (the previous tile's last kHalf) or from `head` (the row's first
// kHalf, reached by a wrap from the end of the row).
__device__ __forceinline__ float amp_at(const float* buf, const float* halo, const float* head,
                                        int j, int base) {
  if (j >= base) return buf[j];
  if (j >= base - kHalf) return halo[j - base + kHalf];
  return head[j];
}

__device__ void deviations(float* buf, float* halo, float* head, int C) {
  for (int base = 0; base < C; base += kThreads) {
    const int c = base + threadIdx.x;
    float a = 0.f;
    float dev = 0.f;
    if (base == 0 && threadIdx.x < kHalf) head[threadIdx.x] = buf[threadIdx.x];
    if (c < C) {
      float w[FF_WIDTH];
      a = buf[c];
      w[0] = a;
      const bool upper = c >= (C >> 1);
#pragma unroll
      for (int k = 1; k < FF_WIDTH; ++k) {
        const int d = k <= kHalf ? k - 1 - kHalf : k - kHalf;
        float v = amp_at(buf, halo, head, wrapped(c + d, C), base);
        if (k == 1 && upper) v = kC;
        if (k == 2 && upper) v = kC2;
        w[k] = v;
      }
      FF_NET_FAST(w);
      dev = __fsub_rn(w[kHalf], a);
    }
    __syncthreads();  // every window of this tile has read its members
    if (c < C) {
      if (threadIdx.x >= kThreads - kHalf) halo[threadIdx.x - (kThreads - kHalf)] = a;
      buf[c] = dev;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    skeleton_kernel(const float* __restrict__ amp, uint8_t* __restrict__ out,
                    float* __restrict__ rank_out, int C, float flag_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float head[16];
  float* buf = reinterpret_cast<float*>(smem);
  uint8_t* flags = smem + flags_offset(C);
  int* red = reinterpret_cast<int*>(smem + scratch_offset(C));
  float* halo = reinterpret_cast<float*>(red + 2 * kWarps);
  const size_t row = blockIdx.x;
  const float* x = amp + row * C;
  uint8_t* o = out + row * C;

  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float v = x[c];
    buf[c] = __fsqrt_rn(__fadd_rn(fminf(v, kC), v));
  }
  __syncthreads();
  deviations(buf, halo, head, C);

  int bank = 0;
  float r = 0.f;
  for (int i = 0; i < kRankRounds; ++i) {
    int count = 0;
    for (int c = threadIdx.x; c < C; c += kThreads) count += buf[c] < r;
    r = __fmul_rn((float)block_sum(count, red, bank), 1.0f / 1024.0f);
  }
  if (rank_out != nullptr && threadIdx.x == 0) rank_out[row] = r;

  const float r12 = __fmul_rn(r, 1.2f);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = __fadd_rn(fminf(buf[wrapped(c + k, C)], kC), r);
    const float l2 = __fadd_rn(s[0], s[1]);
    const float l4 = __fadd_rn(l2, __fadd_rn(s[2], s[3]));
    const float l8 = __fadd_rn(l4, __fadd_rn(__fadd_rn(s[4], s[5]), __fadd_rn(s[6], s[7])));
    flags[c] = (s[0] > r) | (l2 > r12) | (l4 > r12) | (l8 > r12);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    uint8_t hit = 0;
#pragma unroll
    for (int t = 0; t < 12; ++t) hit |= flags[wrapped(c - t, C)];
    o[c] = (uint8_t)(int)__fmul_rn(hit ? 1.0f : 0.0f, flag_scale);
  }
}

}  // namespace

extern "C" {

// As in fused_flagger.cu, so the wrappers share their checks.
int ff_max_channels(void) { return max_channels(); }

const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// How the skeleton launches at `channels`: threads per CTA, dynamic shared
// memory (K1's, smem_bytes), and the CTAs that fit one SM at once.
int rs_launch_config(int channels, int* threads, long long* smem_out, int* ctas_per_sm) {
  if (channels < min_channels() || channels > max_channels()) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(channels);
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
  if (rows < 1 || channels < min_channels() || channels > max_channels()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(channels);
  const int err = set_smem(skeleton_kernel, smem);
  if (err) return err;
  skeleton_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(amp), static_cast<uint8_t*>(out),
      static_cast<float*>(rank_out), channels, flag_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
