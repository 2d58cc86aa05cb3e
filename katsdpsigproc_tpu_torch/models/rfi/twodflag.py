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
package), so it is plain PyTorch on the caller's device.  Its float32
arithmetic is the JAX module's, operation for operation, on the CPU and
on the card alike (``tests/rfi/twodflag_oracle.py:14-42`` lists the
conventions):

* window sums (the box filter's and SumThreshold's) and the frequency
  average are ordered float32 adds in ascending offset, never a library
  reduction, whose order differs between devices;
* the medians are exact order statistics with the halfway mean of
  ``np.median``, bit for bit the JAX module's rank search
  (:func:`_masked_median_axis0`);
* constants the JAX module forms in Python doubles are rounded once to
  float32 on the host (:func:`_f32`);
* complex amplitudes are XLA's (:func:`...utils.numerics.complex_abs`).
"""

import functools
import math
from typing import Optional

import numpy as np
import torch

from . import MAD_NORMAL
from ...utils import numerics


def _f32(value: float) -> float:
    """`value` rounded to float32, as JAX rounds a Python scalar against a float32 array.

    The result is a Python float that float32 holds exactly, so PyTorch's
    float32 arithmetic with it rounds once, as XLA's does.
    """
    return float(np.float32(value))


def _asbool(data):
    """View/convert flag data to bool (``katsdpsigproc_tpu/models/rfi/twodflag.py::_asbool``)."""
    return data if data.dtype == torch.bool else data != 0


def _masked_median_axis0(data, valid, *, empty_value):
    """Median along axis 0 of the entries where `valid`, else `empty_value`.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::_masked_median_axis0``
    (tensor axis 1, below the baseline axis).  The two central values of
    an even count are averaged in float32, ``(upper + lower) * 0.5``, as
    np.median does.  Returns ``data.shape[:1] + data.shape[2:]``.

    The JAX function takes the order statistics by the bitwise rank search
    (``find_rank_float(..., radix_bits=4)``), which on a TPU avoids a
    sorted intermediate; here they come from a sort along the axis, with
    masked entries as NaN, which sorts last.  The two give the same bits:
    the rank search returns the sorted value of the target rank, averaged
    with its predecessor exactly when the predecessor is smaller, and so
    does this (``tests/test_torch_twodflag.py`` holds the two to each
    other on ties, zeros, infinities and masked entries).  A sort costs a
    tenth of the rank search's 8 rounds of 15 candidate counts on the CPU.
    """
    out_shape = data.shape[:1] + data.shape[2:]
    if data.shape[1] == 0:
        # Empty population (e.g. a zero-length frequency chunk when
        # freq_chunks > channels): every output is the empty value.
        return torch.full(out_shape, empty_value, dtype=data.dtype, device=data.device)
    vals = torch.where(valid, data, torch.nan)
    ordered = torch.sort(torch.movedim(vals, 1, -1), dim=-1).values
    n = torch.sum(valid, dim=1, dtype=torch.int32)
    k = (n // 2).to(torch.int64)[..., None]
    upper = torch.gather(ordered, -1, k)[..., 0]
    lower = torch.gather(ordered, -1, (k - 1).clamp(min=0))[..., 0]
    med = torch.where(((n & 1) == 0) & (lower < upper), (upper + lower) * 0.5, upper)
    return torch.where(n > 0, med, empty_value)


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
    med = _masked_median_axis0(data, ~flags, empty_value=0.0)
    out_flags = torch.all(flags, dim=1)
    return med[:, None], out_flags[:, None]


def _median_abs(data, flags):
    """Median of |data| over non-flagged entries, NaN if none, per baseline
    (``katsdpsigproc_tpu/models/rfi/twodflag.py::_median_abs``)."""
    n_bl = data.shape[0]
    flat = torch.abs(data).reshape(n_bl, -1, 1)
    valid = (~flags).reshape(n_bl, -1, 1)
    return _masked_median_axis0(flat, valid, empty_value=torch.nan)[:, 0]


def _median_abs_axis0(data, flags):
    """Median of |data| along axis 0 over non-flagged entries, NaN if none,
    keeping axis 0 as size 1 (``katsdpsigproc_tpu/models/rfi/twodflag.py::_median_abs_axis0``)."""
    return _masked_median_axis0(torch.abs(data), ~flags, empty_value=torch.nan)[:, None]


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
            out = out / _f32(float(2 * ra + 1) ** passes)
    return out


def masked_gaussian_filter(data, flags, sigma, passes: int = 4):
    """Gaussian filter ignoring flagged values.

    Port of ``katsdpsigproc_tpu/models/rfi/twodflag.py::masked_gaussian_filter``:
    positions whose Gaussian support holds no unflagged data become NaN.
    The data and weight planes are filtered as one stacked array, the
    stack axis with radius 0.  `sigma` has one value per axis of `data`.
    """
    weight = (~flags).to(data.dtype)
    filled = torch.where(flags, 0.0, data)
    both = torch.stack([filled, weight])
    sigma_all = np.concatenate([[0.0], np.asarray(sigma, np.float64)])
    fboth = _box_gaussian_filter(both, sigma_all, passes)
    fd, fw = fboth[0], fboth[1]
    return torch.where(fw == 0, torch.nan, fd / fw)


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
    for extend_factor in range(iterations, 0, -1):
        sigma = np.concatenate([[0.0], extend_factor * spike_width])
        background = masked_gaussian_filter(data, flags, sigma)
        new_flags = []
        for c in range(len(freq_chunk_ends) - 1):
            lo, hi = int(freq_chunk_ends[c]), int(freq_chunk_ends[c + 1])
            sub_residual = torch.abs(data[:, :, lo:hi] - background[:, :, lo:hi])
            threshold = _median_abs(sub_residual, flags[:, :, lo:hi]) * scale
            # NaN residuals (under existing flags) compare False: unflagged.
            new_flags.append(sub_residual > threshold[:, None, None])
        flags = flags | torch.cat(new_flags, dim=2)
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
    per chunk, an MAD noise estimate over the chunk, then for each window
    size: clamp previously flagged samples to +-threshold, compare
    full-window means (ordered sums times ``float32(1 / window)``) against
    the falloff-scaled threshold, and dilate outlier windows; positive and
    negative excursions are tracked apart.  Chunks overlap by
    ``max(windows) - 1`` samples.
    """
    n = data.shape[1]
    wmax = int(max(windows))
    scale = _f32(outlier_nsigma * MAD_NORMAL)
    out_parts = []
    for ci in range(len(chunks) - 1):
        lo, hi = int(chunks[ci]), int(chunks[ci + 1])
        if hi == lo:  # zero-length chunk (freq_chunks > channels)
            continue
        threshold0 = _median_abs_axis0(data[:, lo:hi], flags[:, lo:hi])[:, 0]  # (B, M)
        threshold0 = torch.where(torch.isnan(threshold0), torch.inf, threshold0 * scale)

        plo = max(lo - wmax + 1, 0)
        phi = min(hi + wmax - 1, n)
        pdata = data[:, plo:phi]
        p = phi - plo
        fpos = torch.zeros(pdata.shape, dtype=torch.bool, device=data.device)
        fneg = torch.zeros(pdata.shape, dtype=torch.bool, device=data.device)
        for window in [int(w) for w in windows]:
            if window > p:
                continue
            tf = _f32(rho ** math.log2(window)) if window > 1 else 1.0
            th = (threshold0 / tf)[:, None]  # (B, 1, M)
            clamped = torch.where(fpos & (pdata > th), th, pdata)
            clamped = torch.where(fneg & (clamped < -th), -th, clamped)
            sums = clamped[:, :p - window + 1].clone()
            for j in range(1, window):
                sums += clamped[:, j:p - window + 1 + j]
            inv_w = _f32(1.0 / window)
            fpos = fpos | _dilate_full_windows(sums * inv_w > th, window, p)
            fneg = fneg | _dilate_full_windows(sums * -inv_w > th, window, p)
        out_parts.append((fpos | fneg)[:, lo - plo:hi - plo])
    return torch.cat(out_parts, dim=1)


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
    rep = torch.repeat_interleave(flags, average_freq, dim=2)[:, :, :orig_freq]
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
    background = _get_background2d(
        data, flags, background_iterations,
        np.array((spike_width_time, spike_width_freq)), background_reject, freq_chunk_ends,
    )
    data = data - background

    # 3. SumThreshold in time, then frequency (with time flags folded in)
    time_flags = _sum_threshold(data, flags, 0, windows_time, outlier_nsigma, rho)
    flags = flags | time_flags
    freq_flags = _sum_threshold(
        data, flags, 1, windows_freq, outlier_nsigma, rho, freq_chunk_ends
    )

    # 4. combine + smear + un-average
    combined = _combine_flags(spec_flags, time_flags, freq_flags, time_extend)
    return _unaverage_freq(
        combined, freq_extend, average_freq, flag_all_time_frac, flag_all_freq_frac, orig_freq
    )


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
            avg_data, avg_flags = _average_freq(in_data, in_flags, self.average_freq)
            out = torch.movedim(per_baseline(avg_data, avg_flags), 0, -1)
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
        `chunk_size` bounds the baselines per batch (default 16).  `device`
        is where the flagger runs: the card by default, ``"cpu"`` only when
        asked for; without a card and without ``"cpu"`` it raises.

        Returns
        -------
        (time, frequency, baseline) numpy bool flags.
        """
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' to run the 2-D flagger "
                                   "on the CPU")
            device = "cuda"
        device = torch.device(device)
        if data.shape != flags.shape:
            raise ValueError("Shape mismatch")
        if len(data.shape) != 3:
            raise ValueError("data has wrong number of dimensions")
        n_bl = data.shape[-1]
        if not chunk_size:
            chunk_size = min(n_bl, 16)
        out = np.empty(tuple(data.shape), np.bool_)
        for i in range(0, n_bl, chunk_size):
            chunk = slice(i, min(i + chunk_size, n_bl))
            block = _as_tensor(data[..., chunk], device)
            block_flags = _as_tensor(flags[..., chunk], device)
            impl = self._impl(tuple(block.shape))
            out[..., chunk] = impl(block, block_flags).cpu().numpy()
        return out
