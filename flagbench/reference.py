"""The plain reference of the 1-D flagger: what the flags of a dump must be.

Plain PyTorch, written from the algorithm of katsdpsigproc's ``rfi``
flagger as the configurations state it (background median, MAD noise,
SumThreshold), in sorts and shifted slices.  It imports nothing of the
program and takes nothing the program made: it reads the dump the
benchmark made and computes every intermediate again.  Rows are taken in
blocks, so a whole 32k-channel dump fits beside the program's state.

For a row of channel amplitudes ``a = sqrt(re * re + im * im)``:

1. Background: the median of the window of ``width`` channels centred on
   each channel, of the members inside the band and not masked by the
   channel flags; an even count averages its two middle values.  The
   deviation is ``a - median``, and 0 where the channel is masked.
2. Noise: ``MAD_NORMAL`` times the median of the row's non-zero absolute
   deviations (two middle values averaged where their count is even).
3. SumThreshold: for windows of 1, 2, 4, ... channels (``n_windows``),
   the threshold ``n_sigma * noise * falloff ** -w``; deviations already
   flagged count as the threshold; a window whose sum exceeds ``window``
   thresholds flags every channel it covers.  A window's sum is built by
   pairs, ``((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7))``, the
   order the algorithm fixes, so that float32 sums are reproducible.

In float32 the square root is the correctly rounded one (:func:`sqrt_rn`),
every other operation is one IEEE float32 operation, and nothing is fused,
so the result is exact.  ``dtype=torch.bfloat16`` computes every stage in
bfloat16 instead: the benchmark's control, which must not pass.
"""

import numpy as np
import torch

# MAD of a unit normal distribution's inverse: sigma = MAD_NORMAL * MAD.
MAD_NORMAL = 1.4826


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of float32 `x`.

    The float64 root rounded to float32, moved by one float32 step where
    an exact float64 comparison with the midpoints to its neighbours shows
    that it is not the correctly rounded root.
    """
    x64 = x.to(torch.float64)
    y = torch.sqrt(x64).to(torch.float32)
    inf = y.new_full((), torch.inf)
    up, down = torch.nextafter(y, inf), torch.nextafter(y, -inf)
    y64 = y.to(torch.float64)
    hi = (y64 + up.to(torch.float64)) * 0.5
    lo = ((y64 + down.to(torch.float64)) * 0.5).clamp(min=0.0)
    return torch.where(x64 > hi * hi, up, torch.where(x64 < lo * lo, down, y))


def amplitude(vis_rows: torch.Tensor, dtype) -> torch.Tensor:
    """(rows, channels) amplitudes of (rows, channels, 2) pairs, in `dtype`."""
    re = vis_rows[..., 0].to(dtype)
    im = vis_rows[..., 1].to(dtype)
    power = re * re + im * im
    return sqrt_rn(power) if dtype == torch.float32 else torch.sqrt(power)


def deviations(amp: torch.Tensor, width: int, channel_mask=None) -> torch.Tensor:
    """``amp`` less its windowed median background along the channels; 0 where masked."""
    if channel_mask is not None:
        amp = torch.where(channel_mask[None, :], torch.nan, amp)
    h = width // 2
    pad = amp.new_full((amp.shape[0], h), torch.nan)
    windows = torch.cat([pad, amp, pad], dim=1).unfold(1, width, 1)  # (rows, channels, width)
    ranked = torch.sort(windows, dim=-1).values  # NaN (absent) sorts last
    present = (~torch.isnan(windows)).sum(dim=-1, keepdim=True)
    low = ranked.gather(-1, ((present - 1) // 2).clamp(min=0))
    high = ranked.gather(-1, (present // 2).clamp(max=width - 1))
    median = torch.where(present > 0, (low + high) * 0.5, torch.nan)[..., 0]
    dev = amp - median
    return torch.where(torch.isnan(dev), 0.0, dev)


def noise(dev: torch.Tensor) -> torch.Tensor:
    """``MAD_NORMAL`` times each row's median of its non-zero ``|dev|``."""
    values = torch.sort(dev.abs(), dim=-1).values
    channels = values.shape[-1]
    zeros = (values == 0).sum(dim=-1, keepdim=True)
    upper = ((channels + zeros) // 2).clamp(max=channels - 1)
    a = values.gather(-1, upper)
    b = values.gather(-1, (upper - 1).clamp(min=0))
    even = (channels - zeros) % 2 == 0
    median = torch.where(even, (a + b) * 0.5, a)[..., 0]
    return MAD_NORMAL * median


def sum_threshold(dev: torch.Tensor, noise_: torch.Tensor, n_sigma: float, n_windows: int,
                  falloff: float) -> torch.Tensor:
    """(rows, channels) bool flags of SumThreshold over `dev` along the channels."""
    channels = dev.shape[-1]
    base = (n_sigma * noise_)[:, None]
    flags = torch.zeros(dev.shape, dtype=torch.bool, device=dev.device)
    for w in range(n_windows):
        window = 1 << w
        if window > channels:
            break
        threshold = base * float(np.float32(falloff ** -w))
        sums = torch.where(flags, threshold, dev)
        step = 1
        while step < window:
            sums = sums[:, :-step] + sums[:, step:]
            step *= 2
        hot = sums > threshold * window  # one per window start: channels - window + 1
        covered = torch.zeros_like(flags)
        for offset in range(window):
            covered[:, offset:offset + hot.shape[1]] |= hot
        flags |= covered
    return flags


def flag_rows(vis_rows: torch.Tensor, flagger: dict, channel_mask=None,
              dtype=torch.float32) -> torch.Tensor:
    """(rows, channels) uint8 flags of (rows, channels, 2) float32 visibilities."""
    dev = deviations(amplitude(vis_rows, dtype), flagger["width"], channel_mask)
    hot = sum_threshold(dev, noise(dev), flagger["n_sigma"], flagger["n_windows"],
                        flagger["falloff"])
    return hot.to(torch.uint8) * flagger["flag_value"]


def block_rows(channels: int, width: int, budget: int = 1 << 27) -> int:
    """Rows a block holds so that its sorted windows are about `budget` values."""
    return max(1, budget // (channels * width))


def flag_dump(vis: torch.Tensor, flagger: dict, channel_flags=None,
              dtype=torch.float32) -> torch.Tensor:
    """(rows, channels) uint8 flags of a channel-major (channels, rows, 2) dump.

    `channel_flags` is a (channels,) uint8 mask, non-zero where a channel
    is left out of the background, or None.
    """
    channels, rows = vis.shape[0], vis.shape[1]
    mask = None if channel_flags is None else channel_flags != 0
    out = torch.empty((rows, channels), dtype=torch.uint8, device=vis.device)
    step = block_rows(channels, flagger["width"])
    for r0 in range(0, rows, step):
        block = vis[:, r0:r0 + step].transpose(0, 1).contiguous()
        out[r0:r0 + step] = flag_rows(block, flagger, mask, dtype)
    return out
