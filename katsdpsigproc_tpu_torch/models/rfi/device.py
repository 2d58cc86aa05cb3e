"""The RFI flagging stages as PyTorch tensor code.

Port of ``katsdpsigproc_tpu/models/rfi/device.py:50-565`` (the functional
stages and ``make_flagger_fn``; the stage templates and operation
framework come in a later port).  Every function takes and returns
tensors on the caller's device.

* **Background median filter**: a vectorized windowed median over the
  ``width`` shifted copies of the amplitude array, through the same
  min/max selection networks as the reference (:mod:`..ops.rank`).
  Flagged samples become NaN and drop out of the valid count.
* **MAD noise**: the bitwise IEEE-754 rank search of
  :func:`..ops.rank.median_non_zero`.
* **SumThreshold**: shifted-window sums in Kogge-Stone order and boolean
  dilations along the channel axis.

These stages are also the plain versions that the CUDA kernels of
:mod:`.fused_flagger` are held against.
"""

import enum
from typing import Optional

import numpy as np
import torch

from ...ops import rank as rank_ops
from . import MAD_NORMAL


class BackgroundFlags(enum.Enum):
    """Input-flag modes (``katsdpsigproc_tpu/models/rfi/device.py::BackgroundFlags``)."""

    NONE = 0
    CHANNEL = 1
    FULL = 2

    def __bool__(self):
        return self != BackgroundFlags.NONE


def masked_median_filter(amp, width: int, engine: str = "network",
                         edges_only: bool = False):
    """Centred windowed median along axis 0, NaN = absent, min_periods=1.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::masked_median_filter``.
    `amp` is (channels, ...) float32 with NaN marking flagged/absent
    samples.  Returns (median, valid_count) where `median` is NaN for
    windows with no valid samples; even valid counts average the two
    middle values.

    ``edges_only=True`` asserts `amp` itself is NaN-free, so members are
    absent only where the window truncates at the channel edges.  The
    pads are then a static alternating +-inf vector that pins the
    truncated-window median at the fixed sorted ranks ``width//2`` and
    ``width//2 + 1`` (the fast path of the fused kernel; bit-identical to
    the general path on NaN-free input).

    ``engine`` is ``"network"`` (a selection network over the +inf-masked
    members, then rank-indexed selection) or ``"count"`` (compare-count
    ranking, ties to the earlier position).
    """
    h = width // 2
    c = amp.shape[0]
    dev = amp.device
    trail = (1,) * (amp.ndim - 1)
    if edges_only and engine == "network" and width % 2 == 1 and c >= width:
        # An absent member's fill is -inf iff its out-of-range distance is
        # odd, which in pad coordinates is a static function of the pad
        # index: left pad p fills -inf iff (h - p) is odd, right pad q iff
        # (q + 1) is odd.
        inf = np.float32(np.inf)
        left = np.where((h - np.arange(h)) % 2 == 1, -inf, inf).astype(np.float32)
        right = np.where((np.arange(h) + 1) % 2 == 1, -inf, inf).astype(np.float32)
        bshape = (h,) + amp.shape[1:]
        padded = torch.cat([
            torch.from_numpy(left).to(dev).reshape((h,) + trail).expand(bshape),
            amp,
            torch.from_numpy(right).to(dev).reshape((h,) + trail).expand(bshape),
        ], dim=0)
        arrs = [padded[k:k + c] for k in range(width)]
        rank_ops.apply_selection_network(arrs, rank_ops.selection_network(width, (h, h + 1)))
        col = torch.arange(c, dtype=torch.int32, device=dev)
        k_abs = torch.clamp(h - col, min=0) + torch.clamp(col - (c - 1 - h), min=0)
        n = (width - k_abs).reshape((c,) + trail).expand(amp.shape)
        n_odd = ((k_abs & 1) == 0).reshape((c,) + trail)
        med = torch.where(n_odd, arrs[h], (arrs[h] + arrs[h + 1]) * 0.5)
        return med, n
    nan_pad = torch.full((h,) + amp.shape[1:], torch.nan, dtype=amp.dtype, device=dev)
    padded = torch.cat([nan_pad, amp, nan_pad], dim=0)
    win = [padded[k:k + c] for k in range(width)]
    nan = [torch.isnan(w) for w in win]
    n = sum((~m).to(torch.int32) for m in nan)
    lo = (n - 1) // 2
    hi = n // 2
    zero = torch.zeros(amp.shape, dtype=amp.dtype, device=dev)
    v_lo = zero
    v_hi = zero
    if engine == "network":
        arrs = [torch.where(m, torch.inf, w) for w, m in zip(win, nan)]
        # Only the lower half of the sort is ever selected (hi = n//2 <=
        # width//2), so run the network pruned to those outputs.  A
        # selected rank k < n holds a finite member; +inf is selected only
        # when n == 0, where the n > 0 guard below gives NaN anyway.
        rank_ops.apply_selection_network(
            arrs, rank_ops.selection_network(width, range(width // 2 + 1)))
        for k in range(width // 2 + 1):
            v_lo = v_lo + torch.where(lo == k, arrs[k], 0.0)
            v_hi = v_hi + torch.where(hi == k, arrs[k], 0.0)
    elif engine == "count":
        for j in range(width):
            # Stable rank of win[j] among valid members: NaN comparisons
            # are False, so invalid members never count; ties go to the
            # earlier position.
            r = torch.zeros(amp.shape, dtype=torch.int32, device=dev)
            for k in range(width):
                if k < j:
                    r = r + (win[k] <= win[j])
                elif k > j:
                    r = r + (win[k] < win[j])
            vj = torch.where(nan[j], 0.0, win[j])
            v_lo = v_lo + torch.where(~nan[j] & (r == lo), vj, 0.0)
            v_hi = v_hi + torch.where(~nan[j] & (r == hi), vj, 0.0)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    med = (v_lo + v_hi) * 0.5
    return torch.where(n > 0, med, torch.nan), n


def _sqrt_rn(x):
    """Correctly rounded float32 square root.

    PyTorch's vectorized CPU ``sqrt`` for float32 is not correctly rounded
    (about 0.7% of random inputs differ by one ulp), while XLA's and the
    CUDA kernel's ``sqrtf`` are; the float64 root rounded to float32 is
    the correctly rounded float32 root on every device.
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def amplitude(vis):
    """|vis| for complex or planar (trailing-pair float32) visibilities.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::amplitude``.
    ``re*re + im*im`` is rounded after each operation, as the CUDA kernel
    and the TPU kernel compute it.
    """
    if vis.is_complex():
        return vis.abs().to(torch.float32)
    if vis.shape[-1] == 2:
        re = vis[..., 0].to(torch.float32)
        im = vis[..., 1].to(torch.float32)
        return _sqrt_rn(re * re + im * im)
    raise TypeError("expected complex input or a trailing (re, im) pair axis")


def to_planar(vis, leading: bool = False):
    """Complex numpy array or tensor -> planar float32.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::to_planar``.
    ``leading=False`` gives the trailing (..., 2) layout (the planar image
    of interleaved complex64); ``leading=True`` gives (2, ...).
    """
    axis = 0 if leading else -1
    if isinstance(vis, np.ndarray):
        return np.stack([vis.real.astype(np.float32), vis.imag.astype(np.float32)], axis=axis)
    return torch.stack([vis.real.to(torch.float32), vis.imag.to(torch.float32)], dim=axis)


def background_median_filter(vis, flags, width: int, is_amplitude: bool,
                             use_flags: BackgroundFlags, engine: str = "network",
                             fast_path: Optional[bool] = None):
    """Deviations from a windowed-median background (channels, baselines).

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::background_median_filter``.
    Flagged inputs (and, for amplitude input, negative values) are
    excluded from the median and map to 0 in the output; elsewhere the
    output is ``amp - median(valid window)``.  Complex visibilities may be
    complex64 or planar (channels, baselines, 2) float32.

    ``fast_path`` (default on) takes the edge-fill fast path when there
    are no input flags and the input is not amplitudes; it is
    bit-identical to the general path on finite input.
    """
    if fast_path is None:
        fast_path = True
    if fast_path and not is_amplitude and use_flags == BackgroundFlags.NONE:
        amp = amplitude(vis)
        med, _ = masked_median_filter(amp, width, engine, edges_only=True)
        return (amp - med).to(torch.float32)
    if is_amplitude:
        amp = vis.to(torch.float32)
        invalid = amp < 0
    else:
        amp = amplitude(vis)
        invalid = torch.zeros(amp.shape, dtype=torch.bool, device=amp.device)
    if use_flags == BackgroundFlags.CHANNEL:
        invalid = invalid | (flags != 0)[:, None]
    elif use_flags == BackgroundFlags.FULL:
        invalid = invalid | (flags != 0)
    amp = torch.where(invalid, torch.nan, amp)
    med, _ = masked_median_filter(amp, width, engine)
    deviations = amp - med
    return torch.where(torch.isnan(deviations), 0.0, deviations).to(torch.float32)


def madnz(deviations_t, n_channels: Optional[int] = None, axis: int = -1,
          radix_bits: int = 4):
    """MAD noise per baseline from deviations, channels along `axis`.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::madnz``:
    ``MAD_NORMAL * median(nonzero |deviations|)`` by the exact rank
    search.  ``axis=-1`` takes (baselines, channels); ``axis=0`` the
    straight (channels, baselines) layout.  Every `radix_bits` gives the
    bit-identical median.
    """
    values = deviations_t.abs().to(torch.float32)
    med = rank_ops.median_non_zero(values, n_channels, axis=axis, radix_bits=radix_bits)
    return (MAD_NORMAL * med).to(torch.float32)


def _flags_u8(hot, flag_value: int):
    return hot.to(torch.uint8) * flag_value


def threshold_simple(deviations, noise, n_sigma: float, flag_value: int = 1, transposed=False):
    """Elementwise ``deviations > n_sigma * noise``.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::threshold_simple``.
    """
    noise_b = noise[:, None] if transposed else noise[None, :]
    return _flags_u8(deviations > n_sigma * noise_b, flag_value)


def threshold_sum(
    deviations_t,
    noise,
    n_sigma: float,
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    transposed: bool = True,
):
    """SumThreshold on deviations; channels along the last axis when
    `transposed` (baselines, channels), else along axis 0.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::threshold_sum``:
    full windows only; flagged samples are clamped to the current
    threshold; flags disperse over every sample covered by an outlier
    window.  Window sums are built in Kogge-Stone order,
    ``s8 = ((x0+x1)+(x2+x3))+((x4+x5)+(x6+x7))``, and each window's
    threshold scale is ``float32(threshold_falloff ** -w)`` with the power
    taken in double.
    """
    ax = deviations_t.ndim - 1 if transposed else 0
    channels = deviations_t.shape[ax]

    def sl(x, start, stop):
        return x.narrow(ax, start, stop - start)

    flags = torch.zeros(deviations_t.shape, dtype=torch.bool, device=deviations_t.device)
    base_threshold = (n_sigma * noise).to(torch.float32).unsqueeze(ax)
    for w in range(n_windows):
        window = 1 << w
        if window > channels:
            break
        threshold = base_threshold * float(np.float32(threshold_falloff ** -w))
        clamped = torch.where(flags, threshold, deviations_t)
        # sums[k] = sum(clamped[k : k + window]), k in [0, channels - window]
        sums = clamped
        length = channels
        done = 1
        while done < window:
            length -= done
            sums = sl(sums, 0, length) + sl(sums, done, length + done)
            done *= 2
        sum_flags = sums > threshold * window
        # flag[c] |= any(sum_flags[max(0, c-window+1) : min(c, channels-window) + 1])
        pad_shape = list(sum_flags.shape)
        pad_shape[ax] = window - 1
        pad = torch.zeros(pad_shape, dtype=torch.bool, device=sum_flags.device)
        new_flags = torch.cat([pad, sum_flags, pad], dim=ax)
        length = channels + window - 1
        done = 1
        while done < window:
            length -= done
            new_flags = sl(new_flags, 0, length) | sl(new_flags, done, length + done)
            done *= 2
        flags = flags | new_flags
    return _flags_u8(flags, flag_value)


def make_flagger_fn(
    width: int = 13,
    n_sigma: float = 11.0,
    is_amplitude: bool = False,
    use_flags: Optional[BackgroundFlags] = None,
    threshold: str = "sum",
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    baseline_block: Optional[int] = None,
    engine: str = "torch",
):
    """Build the single-device flagger ``fn(vis[, input_flags]) -> flags``.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::make_flagger_fn``
    on (channels, baselines[, 2]) input, channel-major throughout.

    ``engine="torch"`` (the counterpart of ``"xla"``) runs every stage as
    tensor code.  ``engine="hybrid"`` (threshold ``"sum"`` only) runs the
    background as tensor code, then MAD noise + SumThreshold in the CUDA
    kernel :func:`.fused_flagger.madnz_threshold` (its plain version for a
    tensor on the CPU).  ``baseline_block`` processes the baseline axis in
    column slabs of that many baselines to bound peak memory; the JAX
    package's four slab implementations work around TPU slicing costs and
    become this one loop.  The background runs its general path, as the
    JAX engines do by default (bit-identical to the fast path).
    """
    use_flags = BackgroundFlags.NONE if use_flags is None else use_flags
    if engine not in ("torch", "hybrid"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "hybrid" and threshold != "sum":
        raise ValueError("engine='hybrid' implements threshold='sum' only")
    if threshold not in ("sum", "simple"):
        raise ValueError(f"unknown threshold {threshold!r}")

    def block_fn(vis, input_flags=None):
        deviations = background_median_filter(
            vis, input_flags, width, is_amplitude, use_flags, fast_path=False)
        if engine == "hybrid":
            from . import fused_flagger

            flags_t = fused_flagger.madnz_threshold(
                deviations.transpose(0, 1).contiguous(), n_sigma=n_sigma,
                n_windows=n_windows, falloff=threshold_falloff, flag_value=flag_value)
            return flags_t.transpose(0, 1)
        noise = madnz(deviations, axis=0)
        if threshold == "simple":
            return threshold_simple(deviations, noise, n_sigma, flag_value, False)
        return threshold_sum(deviations, noise, n_sigma, n_windows, threshold_falloff,
                             flag_value, transposed=False)

    def flagger(vis, input_flags=None):
        c, b = vis.shape[:2]
        block = b if baseline_block is None else baseline_block
        out = torch.empty((c, b), dtype=torch.uint8, device=vis.device)
        for start in range(0, b, block):
            stop = min(start + block, b)
            f = input_flags
            if use_flags == BackgroundFlags.FULL and input_flags is not None:
                f = input_flags[:, start:stop]
            out[:, start:stop] = block_fn(vis[:, start:stop], f)
        return out

    return flagger
