"""The hybrid engine's background kernel on the CPU: its plain route, its checks, its arithmetic.

* ``fused_flagger.background_deviations`` of a CPU tensor is
  ``background_deviations_plain``: the plain background pass
  (``device.background_median_filter``) then ``transpose(0, 1).contiguous()``,
  bit for bit what the hybrid engine computed before the kernel, on every
  flag mode, both paths, visibilities and amplitudes, and slabs of a dump.
* Its checks raise ``ValueError`` or ``TypeError`` on what the kernel does
  not take, on the CPU as on the card; it launches nothing and counts
  nothing here.
* ``background_kernel``'s algorithm (``csrc/fused_flagger.cu``), mirrored
  in numpy: tiles of 64 channels x 64 rows with their halo in shared
  memory, a NaN member absent and +inf in its place, the ranks
  ``(n - 1) // 2`` and ``n // 2`` of the sorted members, their average
  taken from the picks plus +0, a NaN deviation written as 0 on the
  general path and kept on the fast path's fallback: bit for bit the plain
  background on NaN, +-inf, -0, negatives and denormals.

The card's tests are ``tests/test_torch_background_cuda.py``.
"""

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import device
from katsdpsigproc_tpu_torch.models.rfi import fused_flagger as ff

F = device.BackgroundFlags
MODES = {"none": F.NONE, "full": F.FULL, "channel": F.CHANNEL}
# The kernel's tile (kBgTC channels x kBgTR rows).
TILE_CHANNELS, TILE_ROWS = 64, 64


def _dump(channels, rows, seed, amplitude, special=True):
    """(channels, rows, 2) planar pairs or (channels, rows) amplitudes, and both flag forms."""
    rs = np.random.RandomState(seed)
    vis = rs.standard_normal((channels, rows, 2)).astype(np.float32)
    vis[rs.random_sample((channels, rows)) < 1 / 16] *= 40.0
    if amplitude:
        vis = np.abs(vis[..., 0]) * np.where(rs.random_sample((channels, rows)) < 0.1, -1, 1)
        vis = vis.astype(np.float32)
    if special:
        flat = vis.reshape(-1)
        for value in (np.nan, np.inf, -np.inf, -0.0, 1e-40, 1e-20, 0.0):
            flat[rs.randint(0, flat.size, max(1, flat.size // 50))] = value
    full = ((rs.random_sample((channels, rows)) < 0.1)
            * rs.randint(1, 3, (channels, rows))).astype(np.uint8)
    channel = (rs.random_sample(channels) < 0.2).astype(np.uint8)
    return torch.from_numpy(vis), torch.from_numpy(full), torch.from_numpy(channel)


def _assert_same_bits(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), "NaN at other places"
    bad = int((got.view(torch.int32) != want.view(torch.int32))[~nan].sum())
    assert bad == 0, f"{bad} deviations of {got.numel()} differ in their bits"


def _flags(mode, full, channel):
    return {"none": None, "full": full, "channel": channel}[mode]


@pytest.mark.parametrize("amplitude", [False, True], ids=["vis", "amp"])
@pytest.mark.parametrize("fast", [None, False, True], ids=["default", "general", "fast"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("channels,rows", [(1, 3), (12, 5), (13, 1), (99, 7), (300, 70)])
def test_the_plain_route_is_the_background_then_its_turn(channels, rows, mode, fast, amplitude):
    vis, full, channel = _dump(channels, rows, channels + rows, amplitude)
    flags = _flags(mode, full, channel)
    want = device.background_median_filter(vis, flags, 13, amplitude, MODES[mode],
                                           fast_path=fast).transpose(0, 1).contiguous()
    before = dict(ff.launches)
    got = ff.background_deviations(vis, flags, 13, amplitude, MODES[mode], fast_path=fast)
    assert ff.launches == before  # the plain version launches nothing
    assert got.is_contiguous() and got.shape == (rows, channels)
    _assert_same_bits(got, want)
    _assert_same_bits(ff.background_deviations_plain(vis, flags, 13, amplitude, MODES[mode],
                                                     fast_path=fast), want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_slab_of_a_dump(mode):
    """``vis[:, start:stop]`` and its FULL flags' slab, as the hybrid engine hands them over."""
    vis, full, channel = _dump(200, 96, 4, False)
    cols = slice(40, 72)
    flags = _flags(mode, full[:, cols], channel)
    want = device.background_median_filter(vis[:, cols].contiguous(), flags, 13, False,
                                           MODES[mode], fast_path=False).T
    _assert_same_bits(ff.background_deviations(vis[:, cols], flags, 13, False, MODES[mode],
                                               fast_path=False), want)


def test_what_the_kernel_does_not_take_raises():
    vis, full, channel = _dump(64, 8, 1, False, special=False)
    amp = vis[..., 0].abs()
    cases = [
        (ValueError, "odd", (vis, None, 12, False, F.NONE)),
        (ValueError, "odd", (vis, None, 1, False, F.NONE)),
        (ValueError, "odd", (vis, None, ff.BACKGROUND_MAX_WIDTH + 2, False, F.NONE)),
        (TypeError, "float32", (torch.view_as_complex(vis), None, 13, False, F.NONE)),
        (TypeError, "float32", (vis.double(), None, 13, False, F.NONE)),
        (ValueError, "channels, rows, 2", (vis[..., :1], None, 13, False, F.NONE)),
        (ValueError, "channels, rows", (vis, None, 13, True, F.NONE)),
        (TypeError, "BackgroundFlags", (vis, None, 13, False, None)),
        (ValueError, "needs a flags tensor", (vis, None, 13, False, F.FULL)),
        (TypeError, "uint8", (vis, full.int(), 13, False, F.FULL)),
        (ValueError, "shape", (vis, full, 13, False, F.CHANNEL)),
        (ValueError, "shape", (amp, channel, 13, True, F.FULL)),
        (TypeError, "tensor", (vis.numpy(), None, 13, False, F.NONE)),
    ]
    for error, match, args in cases:
        with pytest.raises(error, match=match):
            ff.background_deviations(*args)
    assert ff.BACKGROUND_MAX_WIDTH == 255  # csrc/fused_flagger.cu's kBgMaxWidth


def test_bool_flags_are_taken():
    vis, full, _ = _dump(50, 9, 2, False)
    _assert_same_bits(ff.background_deviations(vis, full != 0, 13, False, F.FULL),
                      ff.background_deviations(vis, full, 13, False, F.FULL))


def test_the_hybrid_engine_on_the_cpu_launches_nothing():
    vis, _, _ = _dump(128, 20, 3, False, special=False)
    before = dict(ff.launches)
    flags = device.make_flagger_fn(13, 11.0, engine="hybrid", baseline_block=8)(vis)
    assert flags.shape == (128, 20) and ff.launches == before


def _mirror(vis, flags, width, amplitude, mode, keep_nan):
    """``background_kernel``'s general paths in numpy, tile by tile: (rows, channels)."""
    h = width // 2
    vis = vis.numpy()
    amp = vis if amplitude else np.sqrt((vis[..., 0] * vis[..., 0]
                                         + vis[..., 1] * vis[..., 1]).astype(np.float32))
    amp = amp.astype(np.float32)
    invalid = amp < 0 if amplitude else np.zeros(amp.shape, bool)
    if mode == "full":
        invalid |= flags.numpy() != 0
    elif mode == "channel":
        invalid |= (flags.numpy() != 0)[:, None]
    amp = np.where(invalid, np.float32(np.nan), amp)
    channels, rows = amp.shape
    out = np.empty((rows, channels), np.float32)
    for c0 in range(0, channels, TILE_CHANNELS):
        for r0 in range(0, rows, TILE_ROWS):
            # The tile in shared memory, NaN past the row's edges.
            tile = np.full((TILE_CHANNELS + 2 * h, TILE_ROWS), np.nan, np.float32)
            lo_c, hi_c = max(c0 - h, 0), min(c0 + TILE_CHANNELS + h, channels)
            r1 = min(r0 + TILE_ROWS, rows)
            tile[lo_c - (c0 - h):hi_c - (c0 - h), :r1 - r0] = amp[lo_c:hi_c, r0:r1]
            n_c = min(TILE_CHANNELS, channels - c0)
            members = np.stack([tile[k:k + n_c, :r1 - r0] for k in range(width)])
            present = ~np.isnan(members)
            n = present.sum(axis=0)
            ranked = np.sort(np.where(present, members, np.float32(np.inf)), axis=0)
            v_lo, v_hi = (np.where(r >= 0, np.take_along_axis(
                ranked, np.maximum(r, 0)[None], axis=0)[0], np.float32(0))
                for r in ((n - 1) // 2, n // 2))
            with np.errstate(invalid="ignore", over="ignore"):
                med = np.where(n > 0, ((v_lo + v_hi) + np.float32(0)) * np.float32(0.5),
                               np.float32(np.nan))
                dev = members[h] - med
            if not keep_nan:
                dev = np.where(np.isnan(dev), np.float32(0), dev)
            out[r0:r1, c0:c0 + n_c] = dev.T
    return torch.from_numpy(out)


@pytest.mark.parametrize("amplitude", [False, True], ids=["vis", "amp"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("channels,rows", [(1, 3), (12, 5), (45, 70), (130, 129)])
def test_the_kernels_general_path_mirrored_in_numpy(channels, rows, mode, amplitude):
    vis, full, channel = _dump(channels, rows, 3 * channels + rows, amplitude)
    flags = _flags(mode, full, channel)
    want = ff.background_deviations(vis, flags, 13, amplitude, MODES[mode], fast_path=False)
    _assert_same_bits(_mirror(vis, flags, 13, amplitude, mode, keep_nan=False), want)


@pytest.mark.parametrize("width", [3, 13, 51])
def test_the_fast_paths_fallback_keeps_nan(width):
    """``fast_path`` on a row shorter than the window: the general median, NaN deviations kept."""
    vis, _, _ = _dump(width - 1, 6, width, False)
    want = ff.background_deviations(vis, None, width, False, F.NONE, fast_path=True)
    assert bool(torch.isnan(want).any())
    _assert_same_bits(_mirror(vis, None, width, False, "none", keep_nan=True), want)


def test_a_signed_zero_median_is_positive():
    """Amplitudes -0 and +0: the median's picks are summed into zeros, so a -0 median is +0,
    and -0 less it stays -0."""
    amp = torch.tensor([[-0.0], [-0.0], [-0.0], [0.0], [3.0]], dtype=torch.float32)
    got = ff.background_deviations(amp, None, 3, True, F.NONE)
    _assert_same_bits(got, _mirror(amp, None, 3, True, "none", keep_nan=False))
    assert got.view(torch.int32)[0, 0] == torch.tensor(-0.0).view(torch.int32)
