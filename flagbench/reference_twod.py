"""The plain reference of the 2-D flagger: what the flags of a calibrator scan must be.

Plain PyTorch, written from katsdpsigproc's ``rfi/twodflag.py``
(``SumThresholdFlagger``, the flagger katsdpcal runs on each scan) by way of
the loops of the repository's numpy oracle (``tests/rfi/twodflag_oracle.py``),
whose float32 conventions it takes.  It imports nothing of the program and
takes nothing the program made: it reads the scan and input flags the
benchmark made and computes every intermediate again.  Baselines are taken
in blocks, each the oracle's per-baseline loop made one pass over the block.

For each baseline's (time, channel) amplitudes, as the published algorithm
has it:

1. average in frequency by ``average_freq``, over unflagged, non-NaN samples;
2. the time-median spectrum, its smooth background, SumThreshold across it;
3. the 2-D background: a masked Gaussian filter by four box filters a
   dimension, whose outliers beyond ``background_reject`` MAD-sigmas of each
   frequency chunk are masked once before the last filter, the gaps filled
   by linear interpolation across frequency;
4. SumThreshold of the residual in time (one chunk) and in frequency (per
   chunk), windows of 1, 2, 4, 8 samples, each window's threshold
   ``outlier_nsigma * MAD_NORMAL * median(|residual|) / rho ** log2(window)``;
5. the flags smeared by ``time_extend`` in time and ``freq_extend`` in
   frequency, and whole rows and columns flagged past ``flag_all_freq_frac``
   and ``flag_all_time_frac``; NaN samples flagged.

Departures from the published algorithm, each noted at its place, are the
oracle's float32 conventions (the published code keeps float64
accumulators): box sums and window sums as ordered float32 adds in
ascending offset, one division per box-filtered dimension, thresholds as
float32 products, the interpolation ``v0 + float32(k) * (v1 - v0) / span``.
The amplitude of a complex sample is XLA's ``|z|`` (``max * sqrt(1 + r * r)``,
``r = min / max``), where the published code takes numpy's.

In float32 every operation is one IEEE float32 operation (a division by a
constant is a division on the card too, by a divisor on the card: PyTorch
multiplies by the reciprocal of a host scalar), so the result is exact.
``dtype=torch.bfloat16`` computes every stage in bfloat16 instead: the
benchmark's control, which must not pass.
"""

import numpy as np
import torch

from .reference import MAD_NORMAL, sqrt_rn

# Samples, (time, channel) of one baseline each, a block of baselines holds.
BLOCK_SAMPLES = 1 << 24


def _f32(value: float) -> float:
    """A constant rounded to float32 once, as the oracle forms it."""
    return float(np.float32(value))


def _divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor``, a division (not a product by the reciprocal) on every device."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def amplitude(vis: torch.Tensor, dtype) -> torch.Tensor:
    """``|vis|`` in `dtype`; for complex64 XLA's formula in float32.

    ``big * sqrt(float32(1 + r * r))`` with ``r = small / big`` over
    ``|re|`` and ``|im|``, ``1 + r * r`` taken in float64 (where ``r * r``
    is exact) and rounded once; 0 where both parts are 0, inf where either
    is infinite, NaN where either is NaN.  Departure: the published code
    takes numpy's ``abs``, the correctly rounded hypot.
    """
    if not vis.is_complex():
        return vis.abs().to(dtype)
    re = vis.real.abs().to(dtype)
    im = vis.imag.abs().to(dtype)
    if dtype != torch.float32:
        return torch.sqrt(re * re + im * im)
    big = torch.maximum(re, im)
    small = torch.minimum(re, im)
    r = (small / big).to(torch.float64)
    out = big * sqrt_rn((1.0 + r * r).to(torch.float32))
    out = torch.where(big == 0, 0.0, out)
    return torch.where(torch.isinf(re) | torch.isinf(im), torch.inf, out)


def average_freq(amp: torch.Tensor, flags: torch.Tensor, factor: int):
    """(bl, time, ceil(freq / factor)) averages and the bins with nothing to average.

    `amp` and `flags` are (bl, time, freq).  Each bin's sum adds its
    unflagged, non-NaN channels in ascending order (the oracle's loop).
    """
    n_bl, n_time, n_freq = amp.shape
    a_freq = -(-n_freq // factor)
    good = ~flags & ~torch.isnan(amp)
    total = amp.new_zeros((n_bl, n_time, a_freq))
    count = torch.zeros((n_bl, n_time, a_freq), dtype=torch.int32, device=amp.device)
    for k in range(factor):  # channel jout * factor + k of each bin, where it exists
        chans = torch.arange(k, n_freq, factor, device=amp.device)
        bins = chans.shape[0]
        take = good.index_select(2, chans)
        contrib = torch.where(take, amp.index_select(2, chans), 0.0)
        total[:, :, :bins] = total[:, :, :bins] + contrib
        count[:, :, :bins] += take.to(torch.int32)
    empty = count == 0
    avg = torch.where(empty, 0.0, total / count.clamp(min=1).to(amp.dtype))
    return avg, empty


def masked_median(values: torch.Tensor, valid: torch.Tensor, dim: int, empty: float):
    """``np.median`` of the `valid` entries along `dim` (the axis dropped), else `empty`.

    The entries are sorted with the invalid ones as +inf, after every
    valid one; an even count averages its two middle values,
    ``(lower + upper) / 2``, as ``np.median`` does.
    """
    n = valid.sum(dim=dim, keepdim=True)
    ranked = torch.sort(torch.where(valid, values, torch.inf), dim=dim).values
    size = values.shape[dim]
    k = n // 2
    upper = ranked.gather(dim, k.clamp(max=max(size - 1, 0)))
    lower = ranked.gather(dim, (k - 1).clamp(min=0))
    med = torch.where(n % 2 == 1, upper, (lower + upper) / 2)
    return torch.where(n > 0, med, empty).squeeze(dim)


def box_gaussian_filter(data: torch.Tensor, sigma) -> torch.Tensor:
    """The repeated-boxcar Gaussian of (bl, time, freq) `data`, zero outside, 4 passes.

    `sigma` is (time, freq).  Per dimension the box radius is
    ``int(0.5 * sqrt(12 * sigma ** 2 / 4 + 1))``; the dimension is
    extended by the passes' full support, summed four times by boxes of
    ``2r + 1`` (each sum ordered adds in ascending offset), cropped and
    divided once by ``float32((2r + 1) ** 4)``.  Departure: the published
    code keeps a float64 running sum.
    """
    passes = 4
    out = data
    for dim, s in zip((1, 2), sigma):
        r = int(0.5 * np.sqrt(12.0 * float(s) ** 2 / passes + 1))
        if r <= 0:
            continue
        ext = r * passes
        pad = [0, 0, ext, ext] if dim == 1 else [ext, ext]
        work = torch.nn.functional.pad(out, pad)
        n = work.shape[dim]
        for _ in range(passes):
            padded = torch.nn.functional.pad(work, [0, 0, r, r] if dim == 1 else [r, r])
            acc = padded.narrow(dim, 0, n)
            for j in range(1, 2 * r + 1):
                acc = acc + padded.narrow(dim, j, n)
            work = acc
        out = _divide(work.narrow(dim, ext, n - 2 * ext), _f32(float(2 * r + 1) ** passes))
    return out


def masked_gaussian_filter(data: torch.Tensor, flags: torch.Tensor, sigma) -> torch.Tensor:
    """The Gaussian of the unflagged data over the Gaussian of their weight; NaN where none."""
    weight = (~flags).to(data.dtype)
    filled = torch.where(flags, 0.0, data)
    fw = box_gaussian_filter(weight, sigma)
    fd = box_gaussian_filter(filled, sigma)
    return torch.where(fw == 0, torch.nan, fd / fw)


def interpolate_nans(data: torch.Tensor) -> torch.Tensor:
    """NaNs replaced along the last axis: linearly between the nearest values, else repeated.

    Between values at ``p < i < q``: ``v[p] + float32(i - p) * (v[q] - v[p])
    / float32(q - p)`` (departure: the published code precomputes a
    float64 gradient); before the first value or after the last, that
    value; a row of NaNs becomes 0.
    """
    n = data.shape[-1]
    nans = torch.isnan(data)
    idx = torch.arange(n, device=data.device).expand(data.shape)
    prev = torch.cummax(torch.where(nans, -1, idx), dim=-1).values
    nxt = torch.cummin(torch.where(nans, n, idx).flip(-1), dim=-1).values.flip(-1)
    has_prev, has_next = prev >= 0, nxt < n
    v_prev = data.gather(-1, prev.clamp(min=0))
    v_next = data.gather(-1, nxt.clamp(max=n - 1))
    span = (nxt - prev).clamp(min=1).to(data.dtype)
    between = v_prev + (idx - prev).to(data.dtype) * (v_next - v_prev) / span
    fill = torch.where(has_prev & has_next, between,
                       torch.where(has_prev, v_prev, torch.where(has_next, v_next, 0.0)))
    return torch.where(nans, fill, data)


def background2d(data, flags, iterations: int, spike_width, reject: float, chunk_ends):
    """The smooth background of (bl, time, freq) `data`, masking outliers per frequency chunk.

    For widths ``iterations * spike_width`` down to ``spike_width``: the
    masked Gaussian, and in each chunk the residuals beyond
    ``float32(median(|residual|)) * float32(MAD_NORMAL * reject)`` of the
    chunk's unflagged samples flagged; then the Gaussian at
    ``spike_width``, its NaNs interpolated across frequency.
    """
    flags = flags.clone()
    scale = _f32(MAD_NORMAL * reject)
    for factor in range(iterations, 0, -1):
        background = masked_gaussian_filter(data, flags, [factor * s for s in spike_width])
        for lo, hi in zip(chunk_ends[:-1], chunk_ends[1:]):
            lo, hi = int(lo), int(hi)
            if hi == lo:  # an empty chunk (more chunks than channels) flags nothing
                continue
            residual = (data[:, :, lo:hi] - background[:, :, lo:hi]).abs()
            n_bl = residual.shape[0]
            valid = ~flags[:, :, lo:hi]
            threshold = masked_median(residual.reshape(n_bl, -1).abs(),
                                      valid.reshape(n_bl, -1), 1, torch.nan) * scale
            flags[:, :, lo:hi] |= residual > threshold[:, None, None]  # NaN compares False
    background = masked_gaussian_filter(data, flags, list(spike_width))
    return interpolate_nans(background)


def _window_cover(hot: torch.Tensor, window: int, out_len: int) -> torch.Tensor:
    """Along dim 1: each of `out_len` samples flagged if a hot window of `window` covers it.

    A running count of hot window starts (the published code's cumulative
    sum): sample i is covered by starts i - window + 1 .. i.
    """
    padded = torch.nn.functional.pad(hot.to(torch.int32), [0, 0, window, window - 1])
    counts = torch.cumsum(padded, dim=1)
    return (counts[:, window:window + out_len] - counts[:, :out_len]) > 0


def sum_threshold_axis1(data, flags, windows, nsigma: float, rho: float, chunks):
    """SumThreshold along dim 1 of (bl, n, m), a noise estimate per chunk of dim 1.

    Per chunk: ``threshold0 = float32(median(|data|)) * float32(nsigma * MAD_NORMAL)``
    over the chunk's unflagged samples of each column (inf where none);
    the chunk is worked with ``max(windows) - 1`` samples of its
    neighbours on each side.  For each window: samples flagged so far
    (above, or below) are clamped to ``+-threshold``, where ``threshold =
    threshold0 / float32(rho ** log2(window))``; a window whose mean
    ``sum * float32(1 / window)`` (the sum ordered adds; departure: the
    published code differences a float64 cumulative sum) exceeds the
    threshold, or falls below its negative, flags every sample it covers.
    """
    n = data.shape[1]
    wmax = max(windows)
    scale = _f32(nsigma * MAD_NORMAL)
    out = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    for lo, hi in zip(chunks[:-1], chunks[1:]):
        lo, hi = int(lo), int(hi)
        if hi == lo:
            continue
        med = masked_median(data[:, lo:hi].abs(), ~flags[:, lo:hi], 1, torch.nan)
        threshold0 = torch.where(torch.isnan(med), torch.inf, med * scale)  # (bl, m)
        plo, phi = max(lo - wmax + 1, 0), min(hi + wmax - 1, n)
        part = data[:, plo:phi]
        p = phi - plo
        above = torch.zeros(part.shape, dtype=torch.bool, device=data.device)
        below = torch.zeros_like(above)
        for window in windows:
            if window > p:
                continue
            falloff = _f32(rho ** np.log2(window)) if window > 1 else 1.0
            th = _divide(threshold0, falloff)[:, None, :]
            clamped = torch.where(above & (part > th), th, part)
            clamped = torch.where(below & (clamped < -th), -th, clamped)
            n_win = p - window + 1
            sums = clamped[:, :n_win]
            for j in range(1, window):
                sums = sums + clamped[:, j:j + n_win]
            inv = _f32(1.0 / window)
            above |= _window_cover(sums * inv > th, window, p)
            below |= _window_cover(sums * -inv > th, window, p)
        out[:, lo:hi] = (above | below)[:, lo - plo:hi - plo]
    return out


def sum_threshold(data, flags, axis: int, windows, nsigma, rho, chunks=None):
    """SumThreshold of (bl, time, freq) along time (`axis` 0) or frequency (1)."""
    n = data.shape[1 + axis]
    chunks = [0, n] if chunks is None else list(chunks)
    windows = [int(w) for w in windows]
    if not windows:
        return torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    if axis == 0:
        return sum_threshold_axis1(data, flags, windows, nsigma, rho, chunks)
    return sum_threshold_axis1(data.transpose(1, 2), flags.transpose(1, 2), windows, nsigma,
                               rho, chunks).transpose(1, 2)


def smear(flags: torch.Tensor, extend: int, dim: int) -> torch.Tensor:
    """Each sample flagged if any in the centred run of `extend` along `dim` is, clipped at the edges."""
    if extend <= 1:
        return flags
    before = extend // 2
    after = extend - 1 - before
    pad = [0, 0, before, after] if dim == 1 else [before, after]
    counts = torch.cumsum(torch.nn.functional.pad(flags.to(torch.int32), pad), dim=dim)
    counts = torch.nn.functional.pad(counts, [0, 0, 1, 0] if dim == 1 else [1, 0])
    n = flags.shape[dim]
    return (counts.narrow(dim, extend, n) - counts.narrow(dim, 0, n)) > 0


def baseline_flags(data, flags, p: dict, chunk_ends, orig_freq: int) -> torch.Tensor:
    """(bl, time, orig_freq) flags of averaged (bl, time, freq) data and flags: steps 2-5."""
    spec, spec_flags = (masked_median(data, ~flags, 1, 0.0)[:, None],
                        flags.all(dim=1, keepdim=True))
    spec = spec - background2d(spec, spec_flags, p["background_iterations"],
                               (0.0, p["spike_width_freq"]), p["background_reject"], chunk_ends)
    spec_flags = sum_threshold(spec, spec_flags, 1, p["windows_freq"], p["outlier_nsigma"],
                               p["rho"], chunk_ends)
    flags = flags | spec_flags
    data = data - background2d(data, flags, p["background_iterations"],
                               (p["spike_width_time"], p["spike_width_freq"]),
                               p["background_reject"], chunk_ends)
    time_flags = sum_threshold(data, flags, 0, p["windows_time"], p["outlier_nsigma"], p["rho"])
    flags = flags | time_flags
    freq_flags = sum_threshold(data, flags, 1, p["windows_freq"], p["outlier_nsigma"], p["rho"],
                               chunk_ends)
    out = smear(spec_flags | time_flags | freq_flags, int(p["time_extend"]), 1)
    out = torch.repeat_interleave(out, p["average_freq"], dim=2)[:, :, :orig_freq]
    out = smear(out, int(p["freq_extend"]), 2)
    # Totals before any whole row or column is flagged.  A count exceeds a
    # float64 product exactly when it exceeds the product's floor.
    per_time = out.sum(dim=2, keepdim=True)
    per_chan = out.sum(dim=1, keepdim=True)
    n_time = out.shape[1]
    out = out | (per_time > int(np.floor(p["flag_all_freq_frac"] * orig_freq)))
    return out | (per_chan > int(np.floor(n_time * p["flag_all_time_frac"])))


def conditioned(flagger: dict, n_freq: int):
    """The flagger's parameters as the published ``get_flags`` conditions them, and the chunks.

    Frequency windows scaled by ``average_freq`` and made unique,
    ``spike_width_freq`` scaled, windows clipped to the data (the time
    windows by the *frequency* extent, as the published code does), the
    frequency chunks' ends by ``linspace``.
    """
    p = dict(outlier_nsigma=4.5, windows_time=[1, 2, 4, 8], windows_freq=[1, 2, 4, 8],
             background_reject=2.0, background_iterations=1, spike_width_time=12.5,
             spike_width_freq=10.0, time_extend=3, freq_extend=3, freq_chunks=10,
             average_freq=1, flag_all_time_frac=0.6, flag_all_freq_frac=0.8, rho=1.3)
    p.update(flagger)
    factor = int(p["average_freq"])
    a_freq = -(-n_freq // factor)
    wf = np.unique(np.ceil(np.array(p["windows_freq"], dtype=np.float32) / factor).astype(int))
    p["average_freq"] = factor
    p["windows_freq"] = [int(w) for w in wf if w <= a_freq]
    p["windows_time"] = [int(w) for w in p["windows_time"] if w <= n_freq]
    p["spike_width_freq"] = p["spike_width_freq"] / factor
    chunk_ends = np.linspace(0, a_freq, p["freq_chunks"] + 1).astype(int)
    return p, chunk_ends


def flag_block(vis: torch.Tensor, input_flags: torch.Tensor, flagger: dict,
               dtype=torch.float32) -> torch.Tensor:
    """(time, freq, bl) bool flags of a (time, freq, bl) block of a scan and its input flags."""
    n_freq = vis.shape[1]
    p, chunk_ends = conditioned(flagger, n_freq)
    amp = amplitude(vis, dtype).permute(2, 0, 1)
    avg, empty = average_freq(amp, input_flags.permute(2, 0, 1) != 0, p["average_freq"])
    out = baseline_flags(avg, empty, p, chunk_ends, n_freq).permute(1, 2, 0)
    if vis.is_complex():
        return out | torch.isnan(vis.real) | torch.isnan(vis.imag)
    return out | torch.isnan(vis)


def flag_scan(vis: torch.Tensor, input_flags: torch.Tensor, flagger: dict,
              dtype=torch.float32, block: int = None) -> torch.Tensor:
    """(time, freq, bl) bool flags of a (time, freq, bl) scan, `block` baselines at a time.

    `flagger` holds ``SumThresholdFlagger``'s parameters (its defaults
    where absent); `input_flags` is non-zero where a sample is flagged.
    The blocks hold :data:`BLOCK_SAMPLES` samples unless `block` is given.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_time, n_freq, n_bl = vis.shape
    block = block or max(1, BLOCK_SAMPLES // (n_time * n_freq))
    out = torch.empty(vis.shape, dtype=torch.bool, device=vis.device)
    for b0 in range(0, n_bl, block):
        part = slice(b0, min(b0 + block, n_bl))
        out[:, :, part] = flag_block(vis[:, :, part], input_flags[:, :, part], flagger, dtype)
    return out
