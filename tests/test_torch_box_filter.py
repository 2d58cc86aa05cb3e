"""The box-filter kernels' plan and route (``twodflag.masked_gaussian_filter``), on the CPU.

The kernels (``csrc/box_filter.cu``) run only on a card
(``tests/test_torch_box_filter_cuda.py`` holds them to the plain version
there, bit for bit).  Here:

* a tensor on the CPU takes the plain version and counts under "plain";
* the wrapper's pure-Python plan (radii, extended lines, divisors, which
  step forms the weights and which writes the quotient, the thread's
  group of outputs) agrees with ``_box_radii`` and the plain version;
* the kernels' algorithm written out in PyTorch (each line tiled with a
  halo of passes * r, each pass only on the outputs the later passes read,
  the crop and one division a step) gives the plain version's bits;
* the layouts pick the kernels;
* the wrapper refuses what the kernels do not take.

This file imports no jax.
"""

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import twodflag

SIGMAS = [(0.0, 12.5, 10.0), (0.0, 0.0, 10.0), (0.0, 3.5, 0.0), (0.0, 0.0, 4.0),
          (0.0, 2.0, 1.0), (0.0, 0.0, 0.0), (0.0, 40.0, 40.0)]


def _cube(seed, shape, flag_frac=0.1, special=False):
    rs = np.random.RandomState(seed)
    data = (3.0 * np.abs(rs.standard_normal(shape)) + rs.uniform(0, 2, shape)).astype(np.float32)
    flags = rs.random_sample(shape) < flag_frac
    if special:
        flat = data.reshape(-1)
        flat[rs.choice(flat.size, 4)] = np.nan
        flat[rs.choice(flat.size, 3)] = np.inf
        flat[rs.choice(flat.size, 3)] = -0.0
        flags[..., shape[-1] // 2] = True  # a column all flagged
        flags[..., shape[-2] // 2, :] = True  # a row all flagged
    return torch.from_numpy(data), torch.from_numpy(flags)


def _bits_equal(got, want):
    got, want = got.contiguous().numpy(), want.contiguous().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _kernel_algorithm(data, flags, sigma, tile, passes=4):
    """The kernels' steps in plain PyTorch, each line in tiles of `tile` outputs.

    A tile's window is its outputs with a halo of passes * r on each side,
    zero outside the line; pass k keeps the (passes - k) * r outputs beyond
    the tile that the later passes read, so the last pass leaves the tile
    cropped; then one division.  The first step forms the planes, the last
    writes the quotient.
    """
    steps = twodflag.box_filter_plan(data.shape, sigma, passes)
    planes = [torch.where(flags, 0.0, data), (~flags).to(torch.float32)]
    for step in steps:
        n, r, ax = data.shape[step.axis], step.radius, step.axis
        ext = passes * r if r else 0
        for p, plane in enumerate(planes):
            pad = [0, 0] * (2 - ax) + [ext, ext]
            line = torch.nn.functional.pad(plane, pad)  # zero outside the line
            pieces = []
            for x0 in range(0, n, tile):
                nx = min(tile, n - x0)
                cur = line.narrow(ax, x0, nx + 2 * ext)
                for _ in range(passes if r else 0):
                    m = cur.shape[ax] - 2 * r
                    nxt = cur.narrow(ax, 0, m).clone()
                    for j in range(1, 2 * r + 1):
                        nxt += cur.narrow(ax, j, m)
                    cur = nxt
                assert cur.shape[ax] == nx
                pieces.append(twodflag._div(cur, step.divisor) if r else cur)
            planes[p] = torch.cat(pieces, dim=ax)
    fd, fw = planes
    return torch.where(fw == 0, torch.nan, fd / fw)


def test_a_cpu_tensor_takes_the_plain_route(monkeypatch):
    monkeypatch.setattr(twodflag, "box_filters", {"kernel": 0, "plain": 0})
    data, flags = _cube(1, (3, 20, 40))
    sigma = np.array(SIGMAS[0])
    got = twodflag.masked_gaussian_filter(data, flags, sigma)
    assert twodflag.box_filters == {"kernel": 0, "plain": 1}
    _bits_equal(got, twodflag.masked_gaussian_filter_plain(data, flags, sigma))
    twodflag.masked_gaussian_filter(data[0], flags[0], sigma[1:])
    assert twodflag.box_filters == {"kernel": 0, "plain": 2}


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("shape", [(2016, 75, 1024), (2016, 1, 1024), (4, 3000, 64)])
def test_the_plan_agrees_with_box_radii(shape, sigma):
    steps = twodflag.box_filter_plan(shape, sigma)
    radii = twodflag._box_radii(np.array(sigma), 4)
    assert radii[0] == 0
    want_axes = [axis for axis in (1, 2) if radii[axis]] or [2]
    assert [s.axis for s in steps] == want_axes
    for i, step in enumerate(steps):
        r = int(radii[step.axis])
        assert step.radius == r
        assert step.extended == shape[step.axis] + 8 * r
        assert step.divisor == np.float32(float(2 * r + 1) ** 4)
        assert step.forms_weights == (i == 0) and step.writes_quotient == (i == len(steps) - 1)
        assert 2 <= step.group <= max(2, 2 * r + 1) and step.group in (2, 4, 8)


def test_the_plan_of_a_calibrator_scan():
    """The cell's 2-D background: r 10 in time (155 dumps), 8 in frequency (1088 channels)."""
    time, freq = twodflag.box_filter_plan((2016, 75, 1024), (0.0, 12.5, 10.0))
    assert (time.axis, time.radius, time.extended, time.divisor) == (1, 10, 155, 194481.0)
    assert (freq.axis, freq.radius, freq.extended, freq.divisor) == (2, 8, 1088, 83521.0)
    assert time.forms_weights and not time.writes_quotient
    assert freq.writes_quotient and not freq.forms_weights
    (spectrum,) = twodflag.box_filter_plan((2016, 1, 1024), (0.0, 0.0, 10.0))
    assert spectrum.forms_weights and spectrum.writes_quotient and spectrum.radius == 8


def test_the_plan_refuses_a_baseline_radius():
    with pytest.raises(ValueError, match="baseline"):
        twodflag.box_filter_plan((4, 5, 6), (3.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="sigma per axis"):
        twodflag.box_filter_plan((5, 6), (1.0, 1.0))


@pytest.mark.parametrize("shape, sigma, tile, special", [
    ((3, 75, 100), (0.0, 12.5, 10.0), 100, False),  # one tile a line
    ((2, 5, 1024), (0.0, 12.5, 10.0), 114, False),  # a calibrator scan's nine tiles of channels
    ((3, 75, 100), (0.0, 12.5, 10.0), 7, True),
    ((2, 1, 300), (0.0, 0.0, 10.0), 64, False),
    ((1, 30, 45), (0.0, 3.5, 0.0), 4, False),
    ((1, 30, 45), (0.0, 0.0, 4.0), 9, True),
    ((1, 30, 45), (0.0, 2.0, 1.0), 5, False),
    ((1, 30, 45), (0.0, 0.0, 0.0), 16, True),
    ((2, 4, 50), (0.0, 12.5, 10.0), 3, True),  # fewer dumps than r
    ((2, 40, 33), (0.0, 40.0, 6.0), 11, False),
    ((1, 300, 20), (0.0, 12.5, 10.0), 64, True),  # a last tile of 44 dumps
])
def test_the_kernel_algorithm_gives_the_plain_bits(shape, sigma, tile, special):
    data, flags = _cube(2, shape, special=special)
    want = twodflag.masked_gaussian_filter_plain(data, flags, np.array(sigma))
    _bits_equal(_kernel_algorithm(data, flags, np.array(sigma), tile), want)


def test_the_kernel_algorithm_at_three_passes():
    data, flags = _cube(3, (2, 20, 30), special=True)
    sigma = np.array((0.0, 6.0, 6.0))
    want = twodflag.masked_gaussian_filter_plain(data, flags, sigma, passes=3)
    _bits_equal(_kernel_algorithm(data, flags, sigma, 6, passes=3), want)


def test_the_layout_picks_the_kernel():
    shape = (2016, 75, 1024)
    contiguous = (75 * 1024, 1024, 1)
    baselines_inner = (1, 1024 * 2016, 2016)  # the flagger's averaged data
    assert twodflag.box_kernel_axes(shape, contiguous, 1) == ("box_strided", (0, 1, 2))
    assert twodflag.box_kernel_axes(shape, contiguous, 2) == ("box_rows", (0, 1, 2))
    assert twodflag.box_kernel_axes(shape, baselines_inner, 1) == ("box_strided", (2, 1, 0))
    assert twodflag.box_kernel_axes(shape, baselines_inner, 2) == ("box_strided", (1, 2, 0))
    # a spectrum: (B, 1, F); a size-1 axis is never a CTA's columns
    assert twodflag.box_kernel_axes((2016, 1, 1024), (1024, 1024, 1), 2) == ("box_rows", (0, 1, 2))
    assert twodflag.box_kernel_axes((1, 30, 45), (1350, 45, 1), 1) == ("box_strided", (0, 1, 2))
    assert twodflag.box_kernel_axes((5, 30, 1), (30, 1, 1), 2) == ("box_strided", (0, 2, 1))


@pytest.mark.parametrize("make, error", [
    (lambda d, f: (d, f), ValueError),  # CPU tensors
    (lambda d, f: (d.double(), f), TypeError),
    (lambda d, f: (d.numpy(), f), TypeError),
])
def test_the_cuda_wrapper_refuses_what_the_kernels_do_not_take(make, error):
    data, flags = _cube(4, (2, 5, 6))
    with pytest.raises(error):
        twodflag.masked_gaussian_filter_cuda(*make(data, flags), np.zeros(3))
