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
// (8 B planar read, 1 B flag write; K2 reads 4 B of deviations), about
// 0.7 ms for the 32768 x 8064 dump at 3.35 TB/s.  The row never leaves
// shared memory, so the limit is on-chip work: 31 dependent block-wide
// count reductions per row (each a full pass over the row in shared memory
// plus two barriers' worth of latency), the 13-member selection network per
// channel, and the window ladders.
//
// What the design does about it: one CTA of 1024 threads owns a whole row
// (C x 4 B of deviations + C x 1 B of flags in dynamic shared memory, so
// 160 KiB at 32768 channels), reads each visibility once and writes each
// flag once.  The deviations overwrite the amplitudes in place, one tile of
// 1024 channels at a time, with a small halo holding the amplitudes that
// the next tile's windows still need.  Each block-wide reduction is a warp
// `__reduce_*_sync` plus one barrier over a double-banked partials buffer.
// Faster variants (prefetching the next row, fewer reduction rounds) are
// later work; this is the simple, exact version.
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
// from katsdpsigproc_tpu_torch.ops.rank.selection_network for the width.

// The device functions live in ff_device.cuh, shared with K1's stage
// probes (flagger_probe.cu).

#include "ff_device.cuh"

namespace {

// K1.  kMode 0: no input flags; 1: FULL (rows, C) u8; 2: CHANNEL (C,) u8.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    flagger_kernel(const float2* __restrict__ vis, const uint8_t* __restrict__ in_flags,
                   uint8_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.channels;
  float* buf = reinterpret_cast<float*>(smem);
  uint8_t* flags = smem + flags_offset(C);
  int* red = reinterpret_cast<int*>(smem + scratch_offset(C));
  float* halo = reinterpret_cast<float*>(red + 2 * kWarps);
  const size_t row = blockIdx.x;

  const float2* v = vis + row * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a = amplitude(v[c]);
    if (kMode == 1 && in_flags[row * C + c] != 0) a = CUDART_INF_F;
    if (kMode == 2 && in_flags[c] != 0) a = CUDART_INF_F;
    buf[c] = a;
  }
  __syncthreads();
  if (kMode == 0 && C >= FF_WIDTH) {
    median_to_deviations<true, false>(buf, halo, C);
  } else {
    median_to_deviations<false, kMode != 0>(buf, halo, C);
  }
  madnz_threshold_row(buf, flags, red, out + row * C, p);
}

// K2.
__global__ void __launch_bounds__(kThreads, 1)
    madnz_threshold_kernel(const float* __restrict__ dev, uint8_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.channels;
  float* buf = reinterpret_cast<float*>(smem);
  uint8_t* flags = smem + flags_offset(C);
  int* red = reinterpret_cast<int*>(smem + scratch_offset(C));
  const size_t row = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += kThreads) buf[c] = dev[row * C + c];
  __syncthreads();
  madnz_threshold_row(buf, flags, red, out + row * C, p);
}

}  // namespace

extern "C" {

// The largest channel count whose row fits one CTA's shared memory on the
// current device (0 on error).
int ff_max_channels(void) { return max_channels(); }

const char* ff_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1's launch configuration at `channels` (flagger_kernel<0>): threads per
// CTA, dynamic shared memory, and the CTAs that fit one SM at once.  K1's
// stage probes are held to it.
int ff_launch_config(int channels, int* threads, long long* smem_bytes_out, int* ctas_per_sm) {
  if (channels < 1 || channels > max_channels()) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(channels);
  int err = set_smem(flagger_kernel<0>, smem);
  if (!err) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, flagger_kernel<0>,
                                                             kThreads, smem);
  }
  *threads = kThreads;
  *smem_bytes_out = (long long)smem;
  return err;
}

// K1 over `rows` rows of planar (re, im) float32 pairs, (rows, channels, 2).
// mode 0: in_flags unused; 1: (rows, channels) u8; 2: (channels,) u8.
// Returns a cudaError_t; 0 when the launch was accepted.
int ff_flagger(const void* vis, const void* in_flags, int mode, void* out, int rows,
               int channels, float n_sigma, const float* scales, int n_windows,
               int flag_value, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value);
  if (err) return err;
  if (rows < 1 || mode < 0 || mode > 2 || (mode != 0 && in_flags == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(channels);
  const float2* v = static_cast<const float2*>(vis);
  const uint8_t* f = static_cast<const uint8_t*>(in_flags);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      if ((err = set_smem(flagger_kernel<0>, smem))) return err;
      flagger_kernel<0><<<rows, kThreads, smem, s>>>(v, f, o, p);
      break;
    case 1:
      if ((err = set_smem(flagger_kernel<1>, smem))) return err;
      flagger_kernel<1><<<rows, kThreads, smem, s>>>(v, f, o, p);
      break;
    default:
      if ((err = set_smem(flagger_kernel<2>, smem))) return err;
      flagger_kernel<2><<<rows, kThreads, smem, s>>>(v, f, o, p);
      break;
  }
  return (int)cudaGetLastError();
}

// K2 over (rows, channels) float32 deviations.
int ff_madnz_threshold(const void* dev, void* out, int rows, int channels, float n_sigma,
                       const float* scales, int n_windows, int flag_value, void* stream) {
  Params p;
  int err = make_params(&p, channels, n_sigma, scales, n_windows, flag_value);
  if (err) return err;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(channels);
  if ((err = set_smem(madnz_threshold_kernel, smem))) return err;
  madnz_threshold_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dev), static_cast<uint8_t*>(out), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
