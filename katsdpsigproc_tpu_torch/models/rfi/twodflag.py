"""2-D (time-frequency) SumThreshold flagger.

Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py``, the reference's
production CPU flagger, function by function under the JAX names.  The
algorithm (reference twodflag.py:894-913) is the JAX module's:

1. average the data in frequency by ``average_freq``;
2. flag a time-median spectrum to catch faintly contaminated channels;
3. derive a smooth 2-D background per frequency chunk (iterative masked
   Gaussian by repeated box filters, Getreuer 2013);
4. SumThreshold the background-subtracted data in time and frequency with
   per-chunk noise estimates;
5. extend flags in time and frequency and fully flag over-flagged rows
   and columns.

The JAX module maps ``_get_baseline_flags`` over baselines with
``jax.vmap``; here every private stage takes the JAX function's arguments
with a leading baseline axis (the axis ``vmap`` maps), so an ``axis``
argument names the per-baseline axis as in JAX (0 time, 1 frequency) and
the tensor axis is one more.  The filters (:func:`_box_sum_axis`,
:func:`_box_gaussian_filter`, :func:`masked_gaussian_filter`) are the
exception: as in JAX they take a sigma or an axis for every dimension, and
the callers give the baseline axis sigma 0.

No Pallas kernel lies on this path (XLA computes all of it in the JAX
package).  It is PyTorch on the caller's device, but for three stages that
run as hand-written kernels on a CUDA tensor and as their plain versions,
whose bits they equal, on the CPU:

* the masked Gaussian filter: :func:`masked_gaussian_filter` runs the two
  kernels of ``csrc/box_filter.cu`` (one sweep through shared memory an
  axis, :func:`masked_gaussian_filter_cuda`), or the eager box filters
  (:func:`masked_gaussian_filter_plain`);
* SumThreshold's window chain: :func:`_sum_threshold1d` runs the kernel of
  ``csrc/sum_threshold.cu`` (every window of up to 128 chunks in one
  launch, :func:`sum_threshold_cuda`), or the eager chain
  (:func:`sum_threshold_plain`);
* the masked medians (the time median, the backgrounds' and the noise
  estimates' medians of ``|x|``): :func:`masked_median` runs the kernel of
  ``csrc/masked_median.cu`` (a radix select of every chunk of up to 128
  in one launch, :func:`masked_median_cuda`), or a sort
  (:func:`masked_median_plain`).

The background's NaN interpolation, the frequency average and the finish
are eager PyTorch on either device.  The float32 arithmetic is
the JAX module's, operation for operation, on the CPU and on the card
alike (``tests/rfi/twodflag_oracle.py:14-42`` lists the conventions):

* window sums (the box filter's and SumThreshold's) and the frequency
  average are ordered float32 adds in ascending offset, never a library
  reduction, whose order differs between devices;
* the medians are exact order statistics with the halfway mean of
  ``np.median``, bit for bit the JAX module's rank search
  (:func:`_masked_median_axis0`);
* constants the JAX module forms in Python doubles are rounded once to
  float32 on the host (:func:`_f32`);
* complex amplitudes are XLA's (:func:`...utils.numerics.complex_abs`);
* a division by a constant is one IEEE division (:func:`_div`), on the
  card too, where PyTorch would multiply by the constant's reciprocal.

:meth:`SumThresholdFlagger.get_flags` takes a cube in host memory or a
tensor.  A tensor gives a tensor of flags on the device the flagger ran
on, written batch by batch with no round trip to the host, so a scan held
on the card stays there and the call returns once its work is queued.
On a CUDA device the baselines of a batch are as many as a fixed budget
of the card's memory holds, or a share of its free memory where that is
less (:func:`batch_baselines`); on the CPU 16.

While a ``torch.profiler`` session records, the host's work is recorded
as spans (:func:`...utils.profiling.annotate`): ``ksp.twod.get_flags``
the whole call, ``ksp.twod.batch`` each batch (keyed by its first
baseline), and inside a batch ``ksp.twod.average``, ``ksp.twod.spectrum``
(time median, its background, SumThreshold in frequency),
``ksp.twod.background`` (the 2-D background), ``ksp.twod.sum_threshold.time``,
``ksp.twod.sum_threshold.freq`` and ``ksp.twod.finish`` (combine, dilate
and un-average; then the NaN flags, a second span of that name).
:data:`batches` counts the calls, batches and baselines of
:meth:`~SumThresholdFlagger.get_flags`; :data:`box_filters` the calls of
:func:`masked_gaussian_filter` by route, :data:`sum_thresholds` the window
chains of :func:`_sum_threshold1d` by route, :data:`medians` the calls of
:func:`masked_median` by route, :data:`launches` each kernel's launches.
"""

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import MAD_NORMAL
from ...utils import numerics, profiling

# The calls of SumThresholdFlagger.get_flags since the counts were last
# reset, and the batches and baselines they flagged.
batches = {"calls": 0, "batches": 0, "baselines": 0}
# The calls of masked_gaussian_filter since the counts were last reset, by
# route: "kernel" (a CUDA tensor, csrc/box_filter.cu) and "plain" (the CPU).
box_filters = {"kernel": 0, "plain": 0}
# The calls of _sum_threshold1d's window chain since the counts were last
# reset, by route: "kernel" (a CUDA tensor, csrc/sum_threshold.cu) and
# "plain" (the CPU).
sum_thresholds = {"kernel": 0, "plain": 0}
# The calls of masked_median since the counts were last reset, by route:
# "kernel" (a CUDA tensor, csrc/masked_median.cu) and "plain" (the CPU).
medians = {"kernel": 0, "plain": 0}
# Launches of each kernel since the counts were last reset; its wrapper adds
# one where it launches, and nowhere else.
launches = {"box_strided": 0, "box_rows": 0, "sum_threshold": 0, "median": 0}

# The card's memory a batch takes at its peak, per baseline: the caching
# allocator's peak over a batch less what it held before, on an H100 at 8
# to 3000 dumps and 256 to 32768 channels.  Per channel it is the larger of
# two stages' peaks: BATCH_BYTES_PER_SAMPLE a dump (82.0-83.1 measured),
# and, where the dumps are few, the box filter along time, which holds
# three float32 data-and-weight pairs padded by 8r, 10r and 8r dumps (r its
# box radius) beside the rest of the batch: BATCH_BYTES_PER_DUMP a dump
# and BATCH_BYTES_PER_RADIUS a unit of r (313.6 B a sample measured at 8
# dumps and r = 10, 3.8 times the many dumps' figure).
BATCH_BYTES_PER_SAMPLE = 84
BATCH_BYTES_PER_DUMP = 53
BATCH_BYTES_PER_RADIUS = 210
# The card's memory a batch may take.  At a calibrator scan's 75 x 1024 x
# 8064 that is 2016 baselines a batch, 4 batches a scan, 16,680 kernels and
# 4.10-4.13 s a scan on an H100 (against 4.19-4.65 s at 1008, and
# 4.08-4.09 s at 4032, which takes 37.8 GB at its peak).
BATCH_BYTES = 15 << 30
# The share of the card's free memory a batch may take where that is less,
# which leaves the rest to what the caller holds beside the flagger.
BATCH_MEMORY_SHARE = 0.5
# A divisor of the baselines down to this share below the largest batch
# that fits is taken in its place, so that every batch has one shape.
BATCH_DIVISOR_SLACK = 0.25
# The baselines of a batch on the CPU.
CPU_BATCH = 16


def _f32(value: float) -> float:
    """`value` rounded to float32, as JAX rounds a Python scalar against a float32 array.

    The result is a Python float that float32 holds exactly, so PyTorch's
    float32 arithmetic with it rounds once, as XLA's does.
    """
    return float(np.float32(value))


def _div(x, divisor: float):
    """``x / divisor`` as one IEEE division on every device.

    On a CUDA device PyTorch multiplies by the reciprocal where the
    divisor is a host scalar (a Python number), which differs from the
    division in the last bit of many quotients; a divisor on `x`'s device
    is divided by.
    """
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def _asbool(data):
    """View/convert flag data to bool (``katsdpsigproc_tpu/models/rfi/twodflag.py::_asbool``)."""
    return data if data.dtype == torch.bool else data != 0


def _masked_median_axis0(data, valid, *, empty_value):
    """Median along axis 0 of the entries where `valid`, else `empty_value`.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_masked_median_axis0``
    (tensor axis 1, below the baseline axis).  The two central values of
    an even count are averaged in float32, ``(upper + lower) * 0.5``, as
    np.median does.  Returns ``data.shape[:1] + data.shape[2:]``.  It is
    :func:`masked_median` of one chunk, the trailing axes as one.

    The JAX function takes the order statistics by the bitwise rank search
    (``find_rank_float(..., radix_bits=4)``), which on a TPU avoids a
    sorted intermediate.  The two give the same bits: the rank search
    returns the sorted value of the target rank, averaged with its
    predecessor exactly when the predecessor is smaller, and so do both
    routes here (``tests/test_torch_twodflag.py`` holds them to each other
    on ties, zeros, infinities and masked entries).
    """
    out_shape = data.shape[:1] + data.shape[2:]
    n_b, n = data.shape[:2]
    lines = math.prod(data.shape[2:])
    med = masked_median(data.reshape(n_b, n, lines), ~valid.reshape(n_b, n, lines),
                        np.array([0, n]), empty_value=empty_value)
    return med[0].reshape(out_shape)


def masked_median(data, flags, chunks, *, empty_value, take_abs=False, blocks=False):
    """The median of each chunk of the unflagged entries of (B, N, M) `data`.

    A population is the positions ``chunks[c] <= n < chunks[c + 1]`` of a
    line (b, :, m) where `flags` is clear, or with `blocks` those of every
    line of baseline b together; of ``|data|`` with `take_abs`.  Its median
    is the order statistic at rank ``k = n // 2`` of its ``n`` entries,
    averaged in float32 with rank ``k - 1`` where ``n`` is even and that is
    less, ``(upper + lower) * 0.5``, and `empty_value` where ``n`` is 0.  A
    NaN entry ranks above +inf and reads as the canonical NaN; -0 ranks and
    reads as +0.  Returns (chunks, B, M) float32, or (chunks, B, 1) with
    `blocks`.

    A CUDA tensor goes to the kernel (:func:`masked_median_cuda`) or the
    call raises; a tensor on the CPU takes the sort
    (:func:`masked_median_plain`).  The two give the same bits.
    """
    if data.device.type == "cuda":
        return masked_median_cuda(data, flags, chunks, empty_value=empty_value,
                                  take_abs=take_abs, blocks=blocks)
    medians["plain"] += 1
    return masked_median_plain(data, flags, chunks, empty_value=empty_value,
                               take_abs=take_abs, blocks=blocks)


def masked_median_plain(data, flags, chunks, *, empty_value, take_abs=False, blocks=False):
    """The plain PyTorch version of the median kernel: a sort of each chunk.

    Masked entries become NaN, which sorts last; the two central values are
    gathered from the sorted chunk.  Every NaN is made the canonical NaN
    and -0 is made +0 first, so that the result does not depend on the
    order the sort leaves equal keys in.
    """
    n_b, _, n_m = data.shape
    parts = []
    for lo, hi in zip(chunks[:-1], chunks[1:]):
        lo, hi = int(lo), int(hi)
        if hi == lo:
            parts.append(torch.full((n_b, 1 if blocks else n_m), empty_value, dtype=data.dtype,
                                    device=data.device))
            continue
        d, f = data[:, lo:hi], flags[:, lo:hi]
        if blocks:
            d, f = d.reshape(n_b, -1, 1), f.reshape(n_b, -1, 1)
        if take_abs:
            d = torch.abs(d)
        valid = ~_asbool(f)
        vals = torch.where(valid & ~torch.isnan(d), d + 0.0, torch.nan)
        ordered = torch.sort(torch.movedim(vals, 1, -1), dim=-1).values
        n = torch.sum(valid, dim=1, dtype=torch.int32)
        k = (n // 2).to(torch.int64)[..., None]
        upper = torch.gather(ordered, -1, k)[..., 0]
        lower = torch.gather(ordered, -1, (k - 1).clamp(min=0))[..., 0]
        med = torch.where(((n & 1) == 0) & (lower < upper), (upper + lower) * 0.5, upper)
        parts.append(torch.where(n > 0, med, empty_value))
    return torch.stack(parts)


# The chunks csrc/masked_median.cu takes a launch.
MM_MAX_CHUNKS = 128


def masked_median_axes(shape, strides, blocks: bool) -> tuple:
    """The kernel's (outer, column, line, row) axes of a (B, N, M) input; None is an axis of 1.

    The line is axis 1.  With `blocks` the rows are axis 2 and the columns
    the baselines; else there are no rows, and the column, across which a
    warp owns 32 lines, is the other axis of least stride (never one of
    size 1 where the other is longer).
    """
    if blocks:
        return (None, 0, 1, 2)
    col = min((2, 0), key=lambda a: (shape[a] == 1, abs(strides[a])))
    return (2 - col, col, 1, None)


class _MmArgs(ctypes.Structure):
    """``MmArgs`` of ``csrc/masked_median.cu``."""

    _fields_ = [
        ("data", ctypes.c_void_p), ("flags", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("sd", ctypes.c_longlong * 4), ("sf", ctypes.c_longlong * 4),
        ("so", ctypes.c_longlong * 3), ("n", ctypes.c_int * 4), ("n_chunks", ctypes.c_int),
        ("chunk_ends", ctypes.c_int * (MM_MAX_CHUNKS + 1)), ("take_abs", ctypes.c_int),
        ("empty_value", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def _mm_library() -> ctypes.CDLL:
    from ...utils import kernels

    lib = kernels.load("masked_median", ["masked_median.cu"], {})
    lib.mm_error_string.argtypes = [ctypes.c_int]
    lib.mm_error_string.restype = ctypes.c_char_p
    lib.mm_masked_median.argtypes = [ctypes.POINTER(_MmArgs), ctypes.c_void_p]
    lib.mm_masked_median.restype = ctypes.c_int
    return lib


def _mm_args(data, flags, chunks, out, *, empty_value, take_abs, blocks) -> _MmArgs:
    """The kernel's :class:`_MmArgs` for :func:`masked_median_cuda`'s checked arguments;
    `out` the (chunks, B, M or 1) result of these chunks."""
    axes = masked_median_axes(tuple(data.shape), data.stride(), blocks)
    # out's axes: (chunk, outer, column), each an axis of the (B, N, M) input
    out_axes = {0: 1, 2: 2}

    def along(t):
        return (ctypes.c_longlong * 4)(*(0 if a is None else t.stride(a) for a in axes))

    so = [out.stride(0)] + [0 if a is None else out.stride(out_axes[a]) for a in axes[:2]]
    return _MmArgs(
        data=data.data_ptr(), flags=flags.data_ptr(), out=out.data_ptr(),
        sd=along(data), sf=along(flags), so=(ctypes.c_longlong * 3)(*so),
        n=(ctypes.c_int * 4)(*(1 if a is None else data.shape[a] for a in axes)),
        n_chunks=len(chunks) - 1,
        chunk_ends=(ctypes.c_int * (MM_MAX_CHUNKS + 1))(*chunks),
        take_abs=int(take_abs), empty_value=empty_value,
    )


def masked_median_cuda(data, flags, chunks, *, empty_value, take_abs=False, blocks=False):
    """:func:`masked_median_plain` of a CUDA tensor by the kernel of ``csrc/masked_median.cu``.

    `data` float32 (B, N, M) on one card, `flags` bool or uint8 of its
    shape on the same card, any strides; `chunks` from 0 to N, not
    decreasing.  It raises on what the kernel does not take, before it
    launches.  One launch for each :data:`MM_MAX_CHUNKS` chunks; the
    result is contiguous.
    """
    if not (isinstance(data, torch.Tensor) and isinstance(flags, torch.Tensor)):
        raise TypeError("data and flags must be tensors")
    if data.dtype != torch.float32 or flags.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"the median kernel takes float32 data and bool or uint8 flags; got "
                        f"{data.dtype} and {flags.dtype}")
    if data.ndim != 3 or flags.shape != data.shape:
        raise ValueError(f"the median kernel takes (B, N, M) data and flags of its shape; got "
                         f"{tuple(data.shape)} and {tuple(flags.shape)}")
    chunks = [int(c) for c in np.asarray(chunks).ravel()]
    if (len(chunks) < 2 or chunks[0] != 0 or chunks[-1] != data.shape[1]
            or any(b < a for a, b in zip(chunks, chunks[1:]))):
        raise ValueError(f"the median kernel takes chunks from 0 to {data.shape[1]}, not "
                         f"decreasing; got {chunks}")
    longest = max(b - a for a, b in zip(chunks, chunks[1:]))
    if max(data.shape) >= 2 ** 31 or longest * (data.shape[2] if blocks else 1) >= 2 ** 31:
        raise ValueError(f"the median kernel takes axes and populations below 2**31; got "
                         f"{tuple(data.shape)}")
    if data.device.type != "cuda" or flags.device != data.device:
        raise ValueError(f"the median kernel takes data and flags on one card; got "
                         f"{data.device} and {flags.device}")
    n_b, _, n_m = data.shape
    out = torch.empty((len(chunks) - 1, n_b, 1 if blocks else n_m), dtype=torch.float32,
                      device=data.device)
    medians["kernel"] += 1
    if out.numel() == 0:
        return out
    with torch.cuda.device(data.device):
        lib = _mm_library()
        stream = torch.cuda.current_stream(data.device).cuda_stream
        for c0 in range(0, len(chunks) - 1, MM_MAX_CHUNKS):
            c1 = min(c0 + MM_MAX_CHUNKS, len(chunks) - 1)
            args = _mm_args(data, flags, chunks[c0:c1 + 1], out[c0:c1],
                            empty_value=empty_value, take_abs=take_abs, blocks=blocks)
            err = lib.mm_masked_median(ctypes.byref(args), stream)
            if err != 0:
                raise RuntimeError(f"masked_median launch failed: cudaError {err} "
                                   f"({lib.mm_error_string(err).decode()})")
            launches["median"] += 1
    return out


def _average_freq(in_data, in_flags, factor: int):
    """Amplitude, NaN-flagging, zeroing, frequency averaging, transpose.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_average_freq``:
    (time, freq, bl) -> baseline-major (bl, time, ceil(freq/factor))
    float32 data plus bool flags marking fully flagged bins.  The sum over
    each bin's `factor` channels is ordered adds (see the module notes).
    """
    if in_data.is_complex():
        amp = numerics.complex_abs(in_data)  # XLA's |z|
    else:
        amp = torch.abs(in_data).to(torch.float32)
    good = (~_asbool(in_flags)) & ~torch.isnan(amp)
    vals = torch.where(good, amp, 0.0)
    n_time, n_freq, n_bl = amp.shape
    a_freq = -(-n_freq // factor)
    pad = a_freq * factor - n_freq
    if pad:
        vals = torch.nn.functional.pad(vals, (0, 0, 0, pad))
        good = torch.nn.functional.pad(good, (0, 0, 0, pad))
    vals = vals.reshape(n_time, a_freq, factor, n_bl)
    sums = vals[:, :, 0]
    for k in range(1, factor):
        sums = sums + vals[:, :, k]
    counts = good.reshape(n_time, a_freq, factor, n_bl).sum(dim=2, dtype=torch.int32)
    avg = torch.where(counts > 0, sums / counts.to(torch.float32), 0.0)
    flags = counts == 0
    return torch.movedim(avg, -1, 0), torch.movedim(flags, -1, 0)


def _time_median(data, flags):
    """Per-channel median of unflagged values over time; all-flagged channels
    give 0 and a flag (``katsdpsigproc_tpu/models/rfi/twodflag.py::_time_median``)."""
    med = masked_median(data, flags, np.array([0, data.shape[1]]), empty_value=0.0)[0]
    out_flags = torch.all(flags, dim=1)
    return med[:, None], out_flags[:, None]


def _median_abs(data, flags):
    """Median of |data| over non-flagged entries, NaN if none, per baseline
    (``katsdpsigproc_tpu/models/rfi/twodflag.py::_median_abs``)."""
    n_bl = data.shape[0]
    if data.ndim != 3:
        data, flags = data.reshape(n_bl, -1, 1), flags.reshape(n_bl, -1, 1)
    return masked_median(data, flags, np.array([0, data.shape[1]]), empty_value=torch.nan,
                         take_abs=True, blocks=True)[0, :, 0]


def _median_abs_axis0(data, flags):
    """Median of |data| along axis 0 over non-flagged entries, NaN if none,
    keeping axis 0 as size 1 (``katsdpsigproc_tpu/models/rfi/twodflag.py::_median_abs_axis0``)."""
    return masked_median(data, flags, np.array([0, data.shape[1]]), empty_value=torch.nan,
                         take_abs=True)[0][:, None]


def _fill_hillis(data, idx0, *, reverse: bool):
    """Nearest-non-NaN fill along the last axis by Hillis-Steele log shifts.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_fill_hillis``,
    which shifts along axis -2 (TPU sublanes); the result does not depend
    on the axis.  Returns (values, indices): per position, the value and
    the index of the nearest non-NaN element at or before (at or after
    when `reverse`); NaN / -1 where none exists.
    """
    n = data.shape[-1]
    v = data
    iv = torch.where(torch.isnan(data), -1, idx0)
    d = 1
    while d < n:
        if reverse:
            sv = torch.nn.functional.pad(v[..., d:], (0, d), value=torch.nan)
            si = torch.nn.functional.pad(iv[..., d:], (0, d), value=-1)
        else:
            sv = torch.nn.functional.pad(v[..., :-d], (d, 0), value=torch.nan)
            si = torch.nn.functional.pad(iv[..., :-d], (d, 0), value=-1)
        take = torch.isnan(v)
        v = torch.where(take, sv, v)
        iv = torch.where(take, si, iv)
        d *= 2
    return v, iv


def _linearly_interpolate_nans1d(data):
    """Replace NaNs by linear interpolation along the last axis.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_linearly_interpolate_nans1d``:
    extrapolation repeats the first/last valid value, all-NaN rows become
    0.  The interpolation is ``v_fwd + float32(idx - fwd) * (v_bwd - v_fwd)
    / span``, in that order.
    """
    if data.ndim == 1:
        return _linearly_interpolate_nans1d(data[None])[0]
    n = data.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=data.device).expand(data.shape)
    v_fwd, fwd = _fill_hillis(data, idx, reverse=False)
    v_bwd, bwd = _fill_hillis(data, idx, reverse=True)
    has_fwd = fwd >= 0
    has_bwd = bwd >= 0
    span = torch.clamp(bwd - fwd, min=1).to(data.dtype)
    interp = v_fwd + (idx - fwd).to(data.dtype) * (v_bwd - v_fwd) / span
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return torch.where(~torch.isnan(data), data, torch.where(
        has_fwd & has_bwd, interp, torch.where(has_fwd, v_fwd, torch.where(has_bwd, v_bwd, zero))
    ))


def _linearly_interpolate_nans(data):
    """Per-row interpolation across frequency
    (``katsdpsigproc_tpu/models/rfi/twodflag.py::_linearly_interpolate_nans``)."""
    return _linearly_interpolate_nans1d(data)


def _box_radii(sigma, passes: int) -> np.ndarray:
    """Quantized box radius per axis (``katsdpsigproc_tpu/models/rfi/twodflag.py::_box_radii``)."""
    sigma = np.asarray(sigma, np.float64)
    return (0.5 * np.sqrt(12.0 * sigma**2 / passes + 1)).astype(np.int64)


def _box_sum_axis(x, r: int, axis: int):
    """Centred window sum of width 2r+1 along `axis`, zero padding.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_box_sum_axis``
    (``lax.reduce_window``, which CPU XLA computes as ordered adds): the
    window's members are added in ascending offset.
    """
    n = x.shape[axis]
    pad = [0, 0] * (x.ndim - axis - 1) + [r, r]
    padded = torch.nn.functional.pad(x, pad)
    out = padded.narrow(axis, 0, n).clone()
    for j in range(1, 2 * r + 1):
        out += padded.narrow(axis, j, n)
    return out


def _box_gaussian_filter(data, sigma, passes: int = 4):
    """Approximate Gaussian filter by repeated boxcars (Getreuer 2013).

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_box_gaussian_filter``:
    zero outside the boundary, `sigma` one value per axis, the radius
    quantized as the reference quantizes it; each axis is extended by the
    full support of its passes, summed, cropped and divided once by
    ``float32((2r + 1) ** passes)``.
    """
    sigma = np.asarray(sigma)
    if sigma.shape[0] != data.ndim:
        raise ValueError("sigma has wrong number of elements")
    r = _box_radii(sigma, passes)
    out = data
    for axis in range(data.ndim):
        ra = int(r[axis])
        if ra > 0:
            ext = ra * passes
            pad = [0, 0] * (out.ndim - axis - 1) + [ext, ext]
            out = torch.nn.functional.pad(out, pad)
            for _ in range(passes):
                out = _box_sum_axis(out, ra, axis)
            out = out.narrow(axis, ext, out.shape[axis] - 2 * ext)
            out = _div(out, _f32(float(2 * ra + 1) ** passes))
    return out


def masked_gaussian_filter(data, flags, sigma, passes: int = 4):
    """Gaussian filter ignoring flagged values.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::masked_gaussian_filter``:
    positions whose Gaussian support holds no unflagged data become NaN.
    `sigma` has one value per axis of `data`.  A CUDA tensor goes to the
    box-filter kernels (:func:`masked_gaussian_filter_cuda`) or the call
    raises; a tensor on the CPU takes their plain version
    (:func:`masked_gaussian_filter_plain`).  The two give the same bits.
    The kernels take less than the plain version: float32 data only, 1 to
    3 axes, and a sigma that gives the third axis from the end (the
    baselines) box radius 0.  The plain version, like the JAX function,
    also takes float64, more axes and a radius on every axis; the card
    route raises on those (the flagger's calls give none of them).
    """
    if data.device.type == "cuda":
        return masked_gaussian_filter_cuda(data, flags, sigma, passes)
    box_filters["plain"] += 1
    return masked_gaussian_filter_plain(data, flags, sigma, passes)


def masked_gaussian_filter_plain(data, flags, sigma, passes: int = 4):
    """The plain PyTorch version of the box-filter kernels: eager box filters.

    The data and weight planes are filtered as one stacked array, the
    stack axis with radius 0 (:func:`_box_gaussian_filter`).
    """
    weight = (~flags).to(data.dtype)
    filled = torch.where(flags, 0.0, data)
    both = torch.stack([filled, weight])
    sigma_all = np.concatenate([[0.0], np.asarray(sigma, np.float64)])
    fboth = _box_gaussian_filter(both, sigma_all, passes)
    fd, fw = fboth[0], fboth[1]
    return torch.where(fw == 0, torch.nan, fd / fw)


class BoxStep(NamedTuple):
    """One axis of the box-filter kernels on a (B, T, F) tensor (:func:`box_filter_plan`)."""

    axis: int  # 1 time, 2 frequency
    radius: int  # 0 runs no pass and divides by nothing
    extended: int  # the line with the passes' support: n + 2 * passes * radius
    divisor: float  # float32((2 * radius + 1) ** passes)
    forms_weights: bool  # reads the data and flags (the first step), else the planes
    writes_quotient: bool  # writes where(fw == 0, NaN, fd / fw) (the last step), else the planes
    group: int  # consecutive outputs of a pass a thread computes


def _box_group(radius: int) -> int:
    """The outputs a kernel thread computes together: at most 2r + 1, and 8 from r = 4."""
    return 8 if radius >= 4 else 4 if radius >= 2 else 2


def box_filter_plan(shape, sigma, passes: int = 4) -> list:
    """The kernels' steps for a (B, T, F) `shape` at `sigma` (one value per axis).

    One :class:`BoxStep` per axis of non-zero radius, time before
    frequency, as :func:`_box_gaussian_filter` takes them; the first forms
    the weights, the last writes the quotient.  With both radii 0 one
    frequency step of radius 0 does both.  Raises unless the baseline axis
    has radius 0.
    """
    if len(shape) != 3 or len(sigma) != 3:
        raise ValueError("the box-filter kernels take (B, T, F) and a sigma per axis")
    radii = [int(r) for r in _box_radii(sigma, passes)]
    if radii[0]:
        raise ValueError("the box-filter kernels filter no baseline axis: sigma[0] must give r = 0")
    axes = [axis for axis in (1, 2) if radii[axis]] or [2]
    return [BoxStep(axis=axis, radius=radii[axis],
                    extended=int(shape[axis]) + 2 * passes * radii[axis],
                    divisor=_f32(float(2 * radii[axis] + 1) ** passes),
                    forms_weights=i == 0, writes_quotient=i == len(axes) - 1,
                    group=_box_group(radii[axis]))
            for i, axis in enumerate(axes)]


def box_kernel_axes(shape, strides, axis: int):
    """The kernel for a step along `axis` of a (B, T, F) input, and its axis order.

    A line along the contiguous axis goes to ``box_rows`` (axes (outer,
    outer, line)); any other to ``box_strided``, whose CTA owns neighbouring
    lines along the other axis of least stride (axes (outer, line, column)).
    """
    others = [a for a in (0, 1, 2) if a != axis]
    if strides[axis] == 1 and shape[axis] > 1:
        return "box_rows", (others[0], others[1], axis)
    col = min(reversed(others), key=lambda a: (shape[a] == 1, abs(strides[a])))
    return "box_strided", (others[0] + others[1] - col, axis, col)


class _BoxArgs(ctypes.Structure):
    """``BoxArgs`` of ``csrc/box_filter.cu``."""

    _fields_ = [
        ("data", ctypes.c_void_p), ("flags", ctypes.c_void_p),
        ("planes_in", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("sd", ctypes.c_longlong * 3), ("sg", ctypes.c_longlong * 3),
        ("si", ctypes.c_longlong * 3), ("so", ctypes.c_longlong * 3),
        ("plane_in", ctypes.c_longlong), ("plane_out", ctypes.c_longlong),
        ("n", ctypes.c_int * 3), ("radius", ctypes.c_int), ("passes", ctypes.c_int),
        ("group", ctypes.c_int), ("form", ctypes.c_int),
        ("quotient", ctypes.c_int), ("divisor", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def _box_library() -> ctypes.CDLL:
    from ...utils import kernels

    lib = kernels.load("box_filter", ["box_filter.cu"], {})
    lib.bf_error_string.argtypes = [ctypes.c_int]
    lib.bf_error_string.restype = ctypes.c_char_p
    for name in ("bf_box_strided", "bf_box_rows"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_BoxArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _box_args(step: BoxStep, passes: int, data, flags, planes, out):
    """The kernel and its :class:`_BoxArgs` for `step` of the filter of (B, T, F) `data`.

    `planes` holds the two planes between the steps (None for one step),
    `out` the quotient.
    """
    src = data if step.forms_weights else planes[0]
    dst = out if step.writes_quotient else planes[0]
    shape = tuple(out.shape)
    kernel, order = box_kernel_axes(shape, src.stride(), step.axis)

    def strides(t):
        return (ctypes.c_longlong * 3)(*(t.stride(a) for a in order))

    return kernel, _BoxArgs(
        data=data.data_ptr(), flags=flags.data_ptr(),
        planes_in=0 if step.forms_weights else planes.data_ptr(), out=dst.data_ptr(),
        sd=strides(data), sg=strides(flags), si=strides(src), so=strides(dst),
        plane_in=out.numel(), plane_out=out.numel(),
        n=(ctypes.c_int * 3)(*(shape[a] for a in order)),
        radius=step.radius, passes=passes, group=step.group, form=int(step.forms_weights), quotient=int(step.writes_quotient),
        divisor=step.divisor,
    )


def masked_gaussian_filter_cuda(data, flags, sigma, passes: int = 4):
    """:func:`masked_gaussian_filter` of a CUDA tensor by the box-filter kernels.

    `data` float32 and `flags` bool or uint8 of its shape, on one card, of
    1 to 3 axes, any strides; a third axis from the end (the baselines)
    takes sigma 0.  One launch per axis of non-zero radius
    (:func:`box_filter_plan`), by the data's layout
    (:func:`box_kernel_axes`).  The planes between the axes take the
    data's layout; the result is contiguous, as the plain version's is
    (the flagger's later steps run faster on it: on an H100 a calibrator
    scan's batch took 0.313 s against 0.341 s with the result in the
    data's layout).
    """
    if not (isinstance(data, torch.Tensor) and isinstance(flags, torch.Tensor)):
        raise TypeError("data and flags must be tensors")
    if data.dtype != torch.float32 or flags.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"the box-filter kernels take float32 data and bool or uint8 flags; "
                        f"got {data.dtype} and {flags.dtype}")
    if data.device.type != "cuda" or flags.device != data.device:
        raise ValueError(f"the box-filter kernels take data and flags on one card; got "
                         f"{data.device} and {flags.device}")
    if flags.shape != data.shape or not 1 <= data.ndim <= 3:
        raise ValueError(f"data and flags must share a shape of 1 to 3 axes; got "
                         f"{tuple(data.shape)} and {tuple(flags.shape)}")
    sigma = np.asarray(sigma, np.float64)
    if sigma.shape != (data.ndim,):
        raise ValueError("sigma has wrong number of elements")
    if passes < 1:
        raise ValueError("the box-filter kernels run at least one pass")
    if max(data.shape, default=0) >= 2 ** 31:
        raise ValueError(f"the box-filter kernels take axes below 2**31; got {tuple(data.shape)}")
    lead = (None,) * (3 - data.ndim)
    data3, flags3 = data[lead], flags[lead]
    steps = box_filter_plan(data3.shape, np.concatenate([np.zeros(len(lead)), sigma]), passes)
    out = torch.empty(data3.shape, dtype=data.dtype, device=data.device)
    box_filters["kernel"] += 1
    if out.numel() == 0:
        return out.reshape(data.shape)
    planes = None
    if len(steps) > 1:  # two planes in the data's layout (dense where the data is)
        strides = torch.empty_like(data3).stride()
        planes = torch.empty_strided((2,) + tuple(out.shape), (out.numel(),) + strides,
                                     dtype=out.dtype, device=out.device)
    with torch.cuda.device(data.device):
        lib = _box_library()
        stream = torch.cuda.current_stream(data.device).cuda_stream
        for step in steps:
            kernel, args = _box_args(step, passes, data3, flags3, planes, out)
            err = getattr(lib, f"bf_{kernel}")(ctypes.byref(args), stream)
            if err != 0:
                raise RuntimeError(f"{kernel} launch failed: cudaError {err} "
                                   f"({lib.bf_error_string(err).decode()})")
            launches[kernel] += 1
    return out.reshape(data.shape)


def _get_background2d(data, flags, iterations: int, spike_width, reject_threshold,
                      freq_chunk_ends: np.ndarray):
    """Iteratively masked smooth background.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_get_background2d``:
    Gaussian widths shrink linearly from ``iterations * spike_width`` down
    to ``spike_width``; outliers beyond ``reject_threshold`` MAD-sigmas
    (per frequency chunk) are masked each iteration.  The threshold's
    scale ``MAD_NORMAL * reject_threshold`` is formed in double and
    rounded once.
    """
    spike_width = np.asarray(spike_width, np.float64)
    scale = _f32(MAD_NORMAL * reject_threshold)
    spans = [(c, int(hi) - int(lo)) for c, (lo, hi)
             in enumerate(zip(freq_chunk_ends[:-1], freq_chunk_ends[1:])) if hi > lo]
    for extend_factor in range(iterations, 0, -1):
        sigma = np.concatenate([[0.0], extend_factor * spike_width])
        background = masked_gaussian_filter(data, flags, sigma)
        # |residual| in (B, T, F) order, so that each chunk of a baseline is
        # rows of neighbouring values for the median kernel; every chunk's
        # _median_abs in one call
        residual = torch.empty(data.shape, dtype=data.dtype, device=data.device)
        torch.abs(torch.sub(data, background, out=residual), out=residual)
        med = masked_median(residual.transpose(1, 2), flags.contiguous().transpose(1, 2),
                            freq_chunk_ends, empty_value=torch.nan, blocks=True)[:, :, 0]
        threshold = med * scale  # (chunks, B)
        # each chunk's threshold over its frequencies, (B, 1, F), by views
        # (no index tensor to copy to the card)
        spread = torch.cat([threshold[c, :, None].expand(-1, width) for c, width in spans], 1)
        # NaN residuals (under existing flags) compare False: unflagged.
        flags = flags | (residual > spread[:, None, :])
    background = masked_gaussian_filter(data, flags, np.concatenate([[0.0], spike_width]))
    return _linearly_interpolate_nans(background).to(torch.float32)


def _dilate_full_windows(sum_flags, window: int, out_len: int):
    """OR each full-window outlier over the samples it covers, along axis 0.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_dilate_full_windows``:
    ``sum_flags`` has length ``out_len - window + 1`` along axis 0 (one per
    full window); result[i] = any window [k, k + window - 1] holding i.
    """
    pad = [0, 0] * (sum_flags.ndim - 2) + [window - 1, window - 1]
    padded = torch.nn.functional.pad(sum_flags, pad)
    out = padded[:, :out_len]
    for j in range(1, window):
        out = out | padded[:, j:out_len + j]
    return out


def _sum_threshold1d(data, flags, windows, outlier_nsigma, rho, chunks: np.ndarray):
    """SumThreshold along axis 0 of (N, M) with per-chunk noise estimates.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_sum_threshold1d``:
    per chunk, an MAD noise estimate over the chunk
    (:func:`_chunk_thresholds`), then the window chain: for each window
    size, clamp previously flagged samples to +-threshold, compare
    full-window means (ordered sums times ``float32(1 / window)``) against
    the falloff-scaled threshold, and dilate outlier windows; positive and
    negative excursions are tracked apart.  Chunks overlap by
    ``max(windows) - 1`` samples.  The chain of a CUDA tensor runs the
    kernel of ``csrc/sum_threshold.cu`` (:func:`sum_threshold_cuda`, one
    launch for up to 128 chunks), or the call raises; on the CPU it is its
    plain version
    (:func:`sum_threshold_plain`).  The two give the same bits.
    """
    threshold = _chunk_thresholds(data, flags, outlier_nsigma, chunks)
    if data.device.type == "cuda":
        return sum_threshold_cuda(data, threshold, windows, rho, chunks)
    sum_thresholds["plain"] += 1
    return sum_threshold_plain(data, threshold, windows, rho, chunks)


def _chunk_thresholds(data, flags, outlier_nsigma, chunks: np.ndarray):
    """Each chunk's ``threshold0`` of (B, N, M) `data`: (chunks, B, M) float32.

    ``float32(outlier_nsigma * MAD_NORMAL)`` times the median of ``|data|``
    over the chunk's unflagged samples of each line, inf where it has none
    (and for a zero-length chunk, whose value nothing reads).
    """
    scale = _f32(outlier_nsigma * MAD_NORMAL)
    # a zero-length chunk (freq_chunks > channels) has no entries: NaN, so inf
    threshold0 = masked_median(data, flags, chunks, empty_value=torch.nan, take_abs=True)
    return torch.where(torch.isnan(threshold0), torch.inf, threshold0 * scale)


def _window_constants(windows, rho) -> tuple:
    """Per window: the threshold's divisor ``float32(rho ** log2(w))`` (1 for w = 1)
    and ``float32(1 / w)``."""
    return ([_f32(rho ** math.log2(w)) if w > 1 else 1.0 for w in windows],
            [_f32(1.0 / w) for w in windows])


def sum_threshold_plain(data, threshold, windows, rho, chunks: np.ndarray):
    """The plain PyTorch version of the SumThreshold kernel: the eager window chain.

    `data` (B, N, M), `threshold` each chunk's ``threshold0``
    (:func:`_chunk_thresholds`); bool (B, N, M) flags.
    """
    n = data.shape[1]
    wmax = int(max(windows))
    divisors, inv_ws = _window_constants(windows, rho)
    out_parts = []
    for ci in range(len(chunks) - 1):
        lo, hi = int(chunks[ci]), int(chunks[ci + 1])
        if hi == lo:  # zero-length chunk (freq_chunks > channels)
            continue
        threshold0 = threshold[ci]  # (B, M)
        plo = max(lo - wmax + 1, 0)
        phi = min(hi + wmax - 1, n)
        pdata = data[:, plo:phi]
        p = phi - plo
        fpos = torch.zeros(pdata.shape, dtype=torch.bool, device=data.device)
        fneg = torch.zeros(pdata.shape, dtype=torch.bool, device=data.device)
        for window, divisor, inv_w in zip([int(w) for w in windows], divisors, inv_ws):
            if window > p:
                continue
            th = _div(threshold0, divisor)[:, None]  # (B, 1, M)
            clamped = torch.where(fpos & (pdata > th), th, pdata)
            clamped = torch.where(fneg & (clamped < -th), -th, clamped)
            sums = clamped[:, :p - window + 1].clone()
            for j in range(1, window):
                sums += clamped[:, j:p - window + 1 + j]
            fpos = fpos | _dilate_full_windows(sums * inv_w > th, window, p)
            fneg = fneg | _dilate_full_windows(sums * -inv_w > th, window, p)
        out_parts.append((fpos | fneg)[:, lo - plo:hi - plo])
    return torch.cat(out_parts, dim=1)


# The limits of csrc/sum_threshold.cu's arguments: windows and chunks a
# launch, and the rows of a chunk's padded range (or of a tile of it, with
# its halo of sum(w - 1) each side) that a CTA's 48 KB of shared memory holds.
ST_MAX_WINDOWS = 32
ST_MAX_CHUNKS = 128
ST_MAX_ROWS = 324


def sum_threshold_axes(shape, strides) -> tuple:
    """The kernel's axis order (outer, line, column) for (B, N, M) `shape` and `strides`.

    The line is axis 1; the column, across which a CTA owns 32 lines, is
    the other axis of least stride (never one of size 1 where the other is
    longer).
    """
    col = min((2, 0), key=lambda a: (shape[a] == 1, abs(strides[a])))
    return (2 - col, 1, col)


class _StArgs(ctypes.Structure):
    """``StArgs`` of ``csrc/sum_threshold.cu``."""

    _fields_ = [
        ("data", ctypes.c_void_p), ("threshold", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("sd", ctypes.c_longlong * 3), ("so", ctypes.c_longlong * 3),
        ("st", ctypes.c_longlong * 3), ("st_chunk", ctypes.c_longlong),
        ("n", ctypes.c_int * 3), ("n_chunks", ctypes.c_int),
        ("chunk_ends", ctypes.c_int * (ST_MAX_CHUNKS + 1)), ("n_windows", ctypes.c_int),
        ("windows", ctypes.c_int * ST_MAX_WINDOWS), ("divisors", ctypes.c_float * ST_MAX_WINDOWS),
        ("inv_w", ctypes.c_float * ST_MAX_WINDOWS),
    ]


@functools.lru_cache(maxsize=None)
def _st_library() -> ctypes.CDLL:
    from ...utils import kernels

    lib = kernels.load("sum_threshold", ["sum_threshold.cu"], {})
    lib.st_error_string.argtypes = [ctypes.c_int]
    lib.st_error_string.restype = ctypes.c_char_p
    lib.st_sum_threshold.argtypes = [ctypes.POINTER(_StArgs), ctypes.c_void_p]
    lib.st_sum_threshold.restype = ctypes.c_int
    return lib


def _st_args(data, threshold, windows, rho, chunks, out) -> _StArgs:
    """The kernel's :class:`_StArgs` for :func:`sum_threshold_cuda`'s checked arguments."""
    order = sum_threshold_axes(tuple(data.shape), data.stride())
    # threshold (chunks, B, M) as a (B, N, M) view whose line stride is 0
    t_strides = (threshold.stride(1), 0, threshold.stride(2))
    divisors, inv_ws = _window_constants(windows, rho)
    n_win, n_chunks = len(windows), len(chunks) - 1

    def along(strides):
        return (ctypes.c_longlong * 3)(*(strides[a] for a in order))

    return _StArgs(
        data=data.data_ptr(), threshold=threshold.data_ptr(), out=out.data_ptr(),
        sd=along(data.stride()), so=along(out.stride()), st=along(t_strides),
        st_chunk=threshold.stride(0), n=(ctypes.c_int * 3)(*(data.shape[a] for a in order)),
        n_chunks=n_chunks,
        chunk_ends=(ctypes.c_int * (ST_MAX_CHUNKS + 1))(*(int(c) for c in chunks)),
        n_windows=n_win, windows=(ctypes.c_int * ST_MAX_WINDOWS)(*windows),
        divisors=(ctypes.c_float * ST_MAX_WINDOWS)(*divisors),
        inv_w=(ctypes.c_float * ST_MAX_WINDOWS)(*inv_ws),
    )


def sum_threshold_cuda(data, threshold, windows, rho, chunks: np.ndarray):
    """:func:`sum_threshold_plain` of a CUDA tensor by the kernel of ``csrc/sum_threshold.cu``.

    `data` float32 (B, N, M) on one card, any strides; `threshold` float32
    (chunks, B, M) on the same card; `chunks` from 0 to N, not decreasing;
    at most :data:`ST_MAX_WINDOWS` windows, each at least 1.  Where a
    chunk's padded range passes :data:`ST_MAX_ROWS`, the kernel tiles it
    with a halo of ``sum(w - 1)`` each side, so the windows' halo must be
    below half of :data:`ST_MAX_ROWS`.  It raises ``ValueError`` on what
    the kernel does not take, before it launches.  One launch for each
    :data:`ST_MAX_CHUNKS` chunks; the flags take the data's layout.
    """
    if not (isinstance(data, torch.Tensor) and isinstance(threshold, torch.Tensor)):
        raise TypeError("data and threshold must be tensors")
    if data.dtype != torch.float32 or threshold.dtype != torch.float32:
        raise TypeError(f"the SumThreshold kernel takes float32 data and thresholds; got "
                        f"{data.dtype} and {threshold.dtype}")
    if data.ndim != 3:
        raise ValueError(f"the SumThreshold kernel takes (B, N, M) data; got {tuple(data.shape)}")
    chunks = [int(c) for c in np.asarray(chunks).ravel()]
    if (len(chunks) < 2 or chunks[0] != 0 or chunks[-1] != data.shape[1]
            or any(b < a for a, b in zip(chunks, chunks[1:]))):
        raise ValueError(f"the SumThreshold kernel takes chunks from 0 to {data.shape[1]}, "
                         f"not decreasing; got {chunks}")
    if threshold.shape != (len(chunks) - 1, data.shape[0], data.shape[2]):
        raise ValueError(f"threshold must be (chunks, B, M) = "
                         f"{(len(chunks) - 1, data.shape[0], data.shape[2])}; "
                         f"got {tuple(threshold.shape)}")
    windows = [int(w) for w in windows]
    if not 1 <= len(windows) <= ST_MAX_WINDOWS or min(windows) < 1:
        raise ValueError(f"the SumThreshold kernel takes 1 to {ST_MAX_WINDOWS} windows of at "
                         f"least 1; got {windows}")
    n, wmax, halo = data.shape[1], max(windows), sum(w - 1 for w in windows)
    padded = max((min(hi + wmax - 1, n) - max(lo - wmax + 1, 0)
                  for lo, hi in zip(chunks, chunks[1:]) if hi > lo), default=0)
    if padded > ST_MAX_ROWS and 2 * halo >= ST_MAX_ROWS:
        raise ValueError(f"the SumThreshold kernel tiles a padded chunk of {padded} positions "
                         f"in {ST_MAX_ROWS} rows with a halo of sum(w - 1) each side; windows "
                         f"{windows} (halo {halo}) leave no room")
    if max(data.shape) >= 2 ** 31:
        raise ValueError(f"the SumThreshold kernel takes axes below 2**31; got {tuple(data.shape)}")
    if data.device.type != "cuda" or threshold.device != data.device:
        raise ValueError(f"the SumThreshold kernel takes data and thresholds on one card; got "
                         f"{data.device} and {threshold.device}")
    out = torch.empty_like(data, dtype=torch.bool)
    sum_thresholds["kernel"] += 1
    if out.numel() == 0:
        return out
    with torch.cuda.device(data.device):
        lib = _st_library()
        stream = torch.cuda.current_stream(data.device).cuda_stream
        for c0 in range(0, len(chunks) - 1, ST_MAX_CHUNKS):
            c1 = min(c0 + ST_MAX_CHUNKS, len(chunks) - 1)
            args = _st_args(data, threshold[c0:c1], windows, rho, chunks[c0:c1 + 1], out)
            err = lib.st_sum_threshold(ctypes.byref(args), stream)
            if err != 0:
                raise RuntimeError(f"sum_threshold launch failed: cudaError {err} "
                                   f"({lib.st_error_string(err).decode()})")
            launches["sum_threshold"] += 1
    return out


def _sum_threshold(input_data, input_flags, axis: int, windows, outlier_nsigma, rho,
                   chunks: Optional[np.ndarray] = None):
    """Apply SumThreshold along `axis` (0 or 1) of each baseline's 2-D array
    (``katsdpsigproc_tpu/models/rfi/twodflag.py::_sum_threshold``)."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if chunks is None:
        chunks = np.array([0, input_data.shape[axis + 1]])
    windows = [int(w) for w in np.asarray(windows).ravel()]
    if not windows:
        return torch.zeros(input_data.shape, dtype=torch.bool, device=input_data.device)
    if axis == 0:
        return _sum_threshold1d(input_data, input_flags, windows, outlier_nsigma, rho, chunks)
    out = _sum_threshold1d(input_data.transpose(1, 2), input_flags.transpose(1, 2), windows,
                           outlier_nsigma, rho, chunks)
    return out.transpose(1, 2)


def _dilate_centred(flags, extend: int, axis: int):
    """Centred boolean dilation of width `extend` with edge clipping
    (``katsdpsigproc_tpu/models/rfi/twodflag.py::_dilate_centred``)."""
    if extend <= 1:
        return flags
    dim = axis + 1
    lo = -(extend // 2)
    n = flags.shape[dim]
    out = flags
    for delta in range(lo, lo + extend):
        if delta == 0 or abs(delta) >= n:
            continue
        # out[i] |= flags[i + delta] where i + delta lies inside the axis.
        if delta > 0:
            shifted = torch.cat([flags.narrow(dim, delta, n - delta),
                                 torch.zeros_like(flags.narrow(dim, 0, delta))], dim=dim)
        else:
            shifted = torch.cat([torch.zeros_like(flags.narrow(dim, 0, -delta)),
                                 flags.narrow(dim, 0, n + delta)], dim=dim)
        out = out | shifted
    return out


def _combine_flags(spec_flags, time_flags, freq_flags, time_extend: int):
    """Combine flag sources and smear in time
    (``katsdpsigproc_tpu/models/rfi/twodflag.py::_combine_flags``)."""
    flag = spec_flags | time_flags | freq_flags
    return _dilate_centred(flag, int(time_extend), axis=0)


def _unaverage_freq(flags, freq_extend: int, average_freq: int,
                    flag_all_time_frac, flag_all_freq_frac, orig_freq: int):
    """Replicate averaged flags, smear in frequency, and fully flag
    over-flagged rows and columns.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_unaverage_freq``.
    As in JAX, the integer counts are compared with float32 thresholds
    whose products are formed in double.
    """
    n_time = flags.shape[1]
    # Each flag repeated average_freq times along frequency, by a view (a
    # repeat_interleave can wait for the card to size its output).
    n_bl, a_freq = flags.shape[0], flags.shape[2]
    rep = flags[..., None].expand(n_bl, n_time, a_freq, average_freq)
    rep = rep.reshape(n_bl, n_time, a_freq * average_freq)[:, :, :orig_freq]
    dil = _dilate_centred(rep, int(freq_extend), axis=1)
    row_tot = torch.sum(dil, dim=2, dtype=torch.int32).to(torch.float32)
    col_tot = torch.sum(dil, dim=1, dtype=torch.int32).to(torch.float32)
    out = dil | (row_tot > _f32(flag_all_freq_frac * orig_freq))[:, :, None]
    out = out | (col_tot > _f32(n_time * flag_all_time_frac))[:, None, :]
    return out


def _get_baseline_flags(data, flags, *, outlier_nsigma, windows_time, windows_freq,
                        background_reject, background_iterations, spike_width_time,
                        spike_width_freq, time_extend, freq_extend, freq_chunk_ends,
                        average_freq, flag_all_time_frac, flag_all_freq_frac, rho,
                        orig_freq):
    """Flag a batch of baselines, (bl, time, freq)
    (``katsdpsigproc_tpu/models/rfi/twodflag.py::_get_baseline_flags``)."""
    # 1. median spectrum -> background -> SumThreshold in frequency
    with profiling.annotate("ksp.twod.spectrum"):
        spec_data, spec_flags = _time_median(data, flags)
        spec_background = _get_background2d(
            spec_data, spec_flags, background_iterations,
            np.array((0.0, spike_width_freq)), background_reject, freq_chunk_ends,
        )
        spec_data = spec_data - spec_background
        spec_flags = _sum_threshold(
            spec_data, spec_flags, 1, windows_freq, outlier_nsigma, rho, freq_chunk_ends
        )
        flags = flags | spec_flags

    # 2. 2-D background, subtract
    with profiling.annotate("ksp.twod.background"):
        background = _get_background2d(
            data, flags, background_iterations,
            np.array((spike_width_time, spike_width_freq)), background_reject, freq_chunk_ends,
        )
        data = data - background

    # 3. SumThreshold in time, then frequency (with time flags folded in)
    with profiling.annotate("ksp.twod.sum_threshold.time"):
        time_flags = _sum_threshold(data, flags, 0, windows_time, outlier_nsigma, rho)
        flags = flags | time_flags
    with profiling.annotate("ksp.twod.sum_threshold.freq"):
        freq_flags = _sum_threshold(
            data, flags, 1, windows_freq, outlier_nsigma, rho, freq_chunk_ends
        )

    # 4. combine + smear + un-average
    with profiling.annotate("ksp.twod.finish"):
        combined = _combine_flags(spec_flags, time_flags, freq_flags, time_extend)
        return _unaverage_freq(
            combined, freq_extend, average_freq, flag_all_time_frac, flag_all_freq_frac,
            orig_freq
        )


def batch_bytes(n_time: int, n_freq: int, time_radius: int) -> int:
    """The card's memory a batch takes at its peak per baseline of `n_time` x `n_freq`.

    `time_radius` is the box radius of the widest filter along time (see
    :data:`BATCH_BYTES_PER_SAMPLE` for the measurement behind the model).
    """
    return n_freq * max(BATCH_BYTES_PER_SAMPLE * n_time,
                        BATCH_BYTES_PER_DUMP * n_time + BATCH_BYTES_PER_RADIUS * time_radius)


def batch_baselines(n_time: int, n_freq: int, n_bl: int, time_radius: int,
                    free_bytes: int) -> int:
    """The baselines of a batch on a CUDA device with `free_bytes` of memory free.

    A batch takes :func:`batch_bytes` a baseline and may take
    :data:`BATCH_BYTES`, or :data:`BATCH_MEMORY_SHARE` of `free_bytes`
    where that is less; so many baselines fit, at least 1 and at most
    `n_bl`.  Where a divisor of `n_bl` lies within
    :data:`BATCH_DIVISOR_SLACK` below that, the largest such divisor is
    taken, so that every batch has one shape.
    """
    budget = min(BATCH_BYTES, BATCH_MEMORY_SHARE * free_bytes)
    fit = int(min(n_bl, max(1, budget // batch_bytes(n_time, n_freq, time_radius))))
    for size in range(fit, max(1, math.ceil(fit * (1 - BATCH_DIVISOR_SLACK))) - 1, -1):
        if n_bl % size == 0:
            return size
    return fit


def _free_bytes(device: torch.device) -> int:
    """The card's free memory: what CUDA reports free, and what PyTorch's allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def _as_tensor(array, device: torch.device) -> torch.Tensor:
    """`array` (numpy or tensor) on `device`, in float32/complex64 as JAX takes it without x64."""
    t = torch.as_tensor(array)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.complex128:
        t = t.to(torch.complex64)
    return t.to(device)


class SumThresholdFlagger:
    """Flagger that detects spikes in both frequency and time axes.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::SumThresholdFlagger``.
    It uses the SumThreshold method (Offringa, A., MNRAS, 405, 155-167,
    2010).  Parameters are those of the JAX class (and the reference,
    twodflag.py:951-984); see the module docstring for the algorithm.

    On a card every SumThreshold call runs the kernel of
    ``csrc/sum_threshold.cu`` (:func:`sum_threshold_cuda`), which takes
    at most :data:`ST_MAX_WINDOWS` windows an axis and, where a chunk of a
    line padded by ``max(w) - 1`` each side passes :data:`ST_MAX_ROWS`
    positions (3000 dumps; 32768 channels in 10 chunks), only windows
    whose ``sum(w - 1)`` is below half of it: [1, 2, 4, ..., 64] gives
    120 of at most 161.  :meth:`get_flags` on a card raises
    ``ValueError`` on other windows; on the CPU the plain chain takes any.
    """

    def __init__(self, outlier_nsigma=4.5, windows_time=[1, 2, 4, 8],
                 windows_freq=[1, 2, 4, 8], background_reject=2.0,
                 background_iterations=1, spike_width_time=12.5, spike_width_freq=10.0,
                 time_extend=3, freq_extend=3, freq_chunks=10, average_freq=1,
                 flag_all_time_frac=0.6, flag_all_freq_frac=0.8, rho=1.3):
        self.outlier_nsigma = outlier_nsigma
        self.windows_time = windows_time
        # Scale the frequency windows and remove duplicates (reference
        # twodflag.py:970-972).
        windows_freq = np.ceil(np.array(windows_freq, dtype=np.float32) / average_freq)
        self.windows_freq = np.unique(windows_freq.astype(np.int_))
        self.background_reject = background_reject
        self.background_iterations = background_iterations
        self.spike_width_time = spike_width_time
        self.spike_width_freq = spike_width_freq / average_freq
        self.time_extend = int(time_extend)
        self.freq_extend = int(freq_extend)
        self.freq_chunks = freq_chunks
        self.average_freq = int(average_freq)
        self.flag_all_time_frac = flag_all_time_frac
        self.flag_all_freq_frac = flag_all_freq_frac
        self.rho = rho
        self._impl_cache = {}

    def _impl(self, shape):
        """Shape-specialized implementation over a (T, F, BL) block of tensors.

        Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::SumThresholdFlagger._impl``:
        ``impl(in_data, in_flags)`` returns (T, F, BL) bool flags on the
        inputs' device.
        """
        if shape in self._impl_cache:
            return self._impl_cache[shape]
        n_time, n_freq, n_bl = shape
        averaged_channels = -(-n_freq // self.average_freq)
        freq_chunk_ends = np.linspace(0, averaged_channels, self.freq_chunks + 1).astype(np.int_)
        # Clip windows to the data extents (reference twodflag.py:1005-1007,
        # including its use of the *frequency* extent for windows_time).
        windows_time = np.array([w for w in self.windows_time if w <= n_freq], np.int_)
        windows_freq = np.array(
            [w for w in self.windows_freq if w <= averaged_channels], np.int_
        )

        per_baseline = functools.partial(
            _get_baseline_flags,
            outlier_nsigma=self.outlier_nsigma,
            windows_time=windows_time,
            windows_freq=windows_freq,
            background_reject=self.background_reject,
            background_iterations=self.background_iterations,
            spike_width_time=self.spike_width_time,
            spike_width_freq=self.spike_width_freq,
            time_extend=self.time_extend,
            freq_extend=self.freq_extend,
            freq_chunk_ends=freq_chunk_ends,
            average_freq=self.average_freq,
            flag_all_time_frac=self.flag_all_time_frac,
            flag_all_freq_frac=self.flag_all_freq_frac,
            rho=self.rho,
            orig_freq=n_freq,
        )

        def impl(in_data, in_flags):
            with profiling.annotate("ksp.twod.average"):
                avg_data, avg_flags = _average_freq(in_data, in_flags, self.average_freq)
            out = torch.movedim(per_baseline(avg_data, avg_flags), 0, -1)
            with profiling.annotate("ksp.twod.finish"):
                # For complex input the reference flags isnan(re)|isnan(im)
                # (twodflag.py:687); isnan(abs(x)) would miss e.g. inf+nan*j.
                if in_data.is_complex():
                    nan_in = torch.isnan(in_data.real) | torch.isnan(in_data.imag)
                else:
                    nan_in = torch.isnan(in_data)
                return out | nan_in

        self._impl_cache[shape] = impl
        return impl

    def get_flags_sharded(self, data, flags, mesh, axis_name: Optional[str] = None):
        """Multi-rank :meth:`get_flags`: baselines sharded over `mesh`.

        Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::SumThresholdFlagger.get_flags_sharded``.
        Every rank of `mesh` (a :mod:`...parallel.mesh` mesh) calls it with
        the full host cube and flags; each flags its shard of the baselines
        on its own device, with no collective, and the flags are gathered
        back to every rank.  `axis_name` selects the mesh dim to shard
        baselines over (default: the mesh's first dim); other dims
        replicate.  The baselines are padded to a multiple of the dim's
        size with copies of the last one, and the pad is cropped from the
        result.

        Returns
        -------
        (time, frequency, baseline) numpy bool flags, on every rank.
        """
        from ...parallel import mesh as pmesh

        if data.shape != flags.shape:
            raise ValueError("Shape mismatch")
        if len(data.shape) != 3:
            raise ValueError("data has wrong number of dimensions")
        axis_name = axis_name or mesh.mesh_dim_names[0]
        n_shards = pmesh.axis_size(mesh, axis_name)
        n_bl = data.shape[-1]
        pad = (-n_bl) % n_shards
        data, flags = np.asarray(data), np.asarray(flags)
        if pad:
            data = np.concatenate([data] + [data[..., -1:]] * pad, -1)
            flags = np.concatenate([flags] + [flags[..., -1:]] * pad, -1)
        spec = (None, None, axis_name)
        local = _as_tensor(pmesh.shard_with_spec(mesh, data, spec), pmesh.local_device(mesh))
        local_flags = pmesh.shard_with_spec(mesh, flags, spec)
        out = self._impl(tuple(local.shape))(local, local_flags)
        return pmesh.gather(mesh, out, spec).cpu().numpy()[..., :n_bl]

    def get_flags(self, data, flags, pool=None, chunk_size=None, is_multiprocess=None,
                  device=None):
        """Compute flags for a (time, frequency, baseline) cube.

        Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::SumThresholdFlagger.get_flags``.
        `pool` and `is_multiprocess` are accepted for the reference's API
        and ignored: the baselines of a chunk are one batch on the device.
        `chunk_size` bounds the baselines per batch: by default 16 on the
        CPU, and on a CUDA device as many as :func:`batch_baselines` finds
        room for.  `device` is where the flagger runs:
        by default the device of `data` where it is a CUDA tensor, else
        the card; ``"cpu"`` only when asked for; without a card and
        without ``"cpu"`` it raises.

        Returns
        -------
        (time, frequency, baseline) bool flags: a tensor on `device` where
        `data` is a tensor, else a numpy array.  For a tensor the call
        waits for nothing on the card: it returns once its work is queued.
        """
        with profiling.annotate("ksp.twod.get_flags"):
            if device is None:
                if isinstance(data, torch.Tensor) and data.is_cuda:
                    device = data.device
                elif not torch.cuda.is_available():
                    raise RuntimeError("no CUDA device: pass device='cpu' to run the 2-D flagger "
                                       "on the CPU")
                else:
                    device = "cuda"
            device = torch.device(device)
            if data.shape != flags.shape:
                raise ValueError("Shape mismatch")
            if len(data.shape) != 3:
                raise ValueError("data has wrong number of dimensions")
            n_time, n_freq, n_bl = data.shape
            if not chunk_size:
                if device.type == "cuda":
                    radius = int(_box_radii(self.background_iterations * self.spike_width_time, 4))
                    chunk_size = batch_baselines(n_time, n_freq, n_bl, radius, _free_bytes(device))
                else:
                    chunk_size = min(n_bl, CPU_BATCH)
            out = torch.empty(tuple(data.shape), dtype=torch.bool, device=device)
            batches["calls"] += 1
            for i in range(0, n_bl, chunk_size):
                chunk = slice(i, min(i + chunk_size, n_bl))
                with profiling.annotate("ksp.twod.batch", key=i):
                    block = _as_tensor(data[..., chunk], device)
                    block_flags = _as_tensor(flags[..., chunk], device)
                    impl = self._impl(tuple(block.shape))
                    out[..., chunk] = impl(block, block_flags)
                batches["batches"] += 1
                batches["baselines"] += chunk.stop - chunk.start
        return out if isinstance(data, torch.Tensor) else out.cpu().numpy()
