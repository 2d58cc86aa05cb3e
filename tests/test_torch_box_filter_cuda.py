"""The box-filter kernels (``csrc/box_filter.cu``) against their plain version, on a card.

``twodflag.masked_gaussian_filter`` of a CUDA tensor runs the kernels;
``twodflag.masked_gaussian_filter_plain`` (the eager box filters) runs on
the same card tensors.  Exact: the same float32 bits, NaN in the same
places.  Every test here is marked ``cuda`` and skips where CUDA is
unavailable.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_box_filter_cuda.py -q
"""

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import twodflag

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cube(cuda, seed, shape, layout="contiguous", special=False):
    """(B, T, F) float32 data and bool flags on the card, in `layout`."""
    rs = np.random.RandomState(seed)
    data = (3.0 * np.abs(rs.standard_normal(shape)) + rs.uniform(0, 2, shape)).astype(np.float32)
    flags = rs.random_sample(shape) < 0.1
    if special:
        flat = data.reshape(-1)
        flat[rs.choice(flat.size, 6)] = np.nan  # unflagged NaN, inf and -0
        flat[rs.choice(flat.size, 4)] = np.inf
        flat[rs.choice(flat.size, 4)] = -np.inf
        flat[rs.choice(flat.size, 6)] = -0.0
        flags[..., shape[-1] // 2] = True  # a column all flagged: fw == 0, NaN
        flags[..., shape[-2] // 2, :] = True  # a row all flagged
    data, flags = torch.from_numpy(data).to(cuda), torch.from_numpy(flags).to(cuda)
    if layout == "baselines_inner":  # as the flagger's averaged data lies
        data = data.movedim(0, -1).contiguous().movedim(-1, 0)
        flags = flags.movedim(0, -1).contiguous().movedim(-1, 0)
    return data, flags


def _bits_equal(got, want):
    got, want = got.cpu().contiguous().numpy(), want.cpu().contiguous().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _both_routes(data, flags, sigma, passes=4):
    sigma = np.asarray(sigma, np.float64)
    got = twodflag.masked_gaussian_filter(data, flags, sigma, passes)
    torch.cuda.synchronize()
    want = twodflag.masked_gaussian_filter_plain(data, flags, sigma, passes)
    _bits_equal(got, want)
    return got


CASES = [
    ((8, 75, 1024), (0.0, 12.5, 10.0)),  # the calibrator scan's 2-D background
    ((8, 1, 1024), (0.0, 0.0, 10.0)),  # its spectrum
    ((3, 4, 64), (0.0, 12.5, 10.0)),  # fewer dumps than r
    ((2, 3000, 48), (0.0, 12.5, 10.0)),  # chip_smoke's 3000 dumps: 30 tiles in time
    ((5, 20, 1000), (0.0, 12.5, 10.0)),  # channels not a multiple of 16
    ((17, 30, 45), (0.0, 2.0, 1.0)),  # baselines not a multiple of 16
    ((2, 4, 32768), (0.0, 12.5, 10.0)),  # 32k channels: tiles of the line
    ((3, 20, 70), (0.0, 40.0, 40.0)),  # r = 34: a window above 48 KB
]


@pytest.mark.parametrize("layout", ["contiguous", "baselines_inner"])
@pytest.mark.parametrize("shape, sigma", CASES)
def test_kernels_equal_the_plain_route(cuda, shape, sigma, layout):
    data, flags = _cube(cuda, 1, shape, layout)
    got = _both_routes(data, flags, sigma)
    assert got.is_contiguous()  # as the plain version's result


@pytest.mark.parametrize("layout", ["contiguous", "baselines_inner"])
@pytest.mark.parametrize("shape, sigma", [((6, 75, 300), (0.0, 12.5, 10.0)),
                                          ((4, 40, 64), (0.0, 3.5, 0.0)),
                                          ((4, 40, 64), (0.0, 0.0, 4.0))])
def test_nan_inf_and_all_flagged_lines(cuda, shape, sigma, layout):
    data, flags = _cube(cuda, 2, shape, layout, special=True)
    got = _both_routes(data, flags, sigma)
    assert torch.isnan(got).any() and torch.isfinite(got).any()


@pytest.mark.parametrize("sigma", [(3.5, 0.0), (0.0, 4.0), (2.0, 1.0), (0.0, 0.0),
                                   (12.5, 10.0)])
def test_two_axes_as_the_cpu_tests_take_them(cuda, sigma):
    data, flags = _cube(cuda, 3, (1, 30, 45), special=True)
    _both_routes(data[0], flags[0], sigma)
    _both_routes(data[0, 0], flags[0, 0], sigma[1:])  # one axis


def test_flags_in_another_layout_and_a_strided_view(cuda):
    data, flags = _cube(cuda, 4, (6, 40, 160))
    inner, _ = _cube(cuda, 4, (6, 40, 160), "baselines_inner")
    _both_routes(inner, flags, (0.0, 5.0, 7.0))
    _both_routes(data[:, :, ::2], flags[:, :, ::2], (0.0, 5.0, 7.0))
    _both_routes(data, flags.to(torch.uint8) != 0, (0.0, 5.0, 7.0))


def test_three_passes(cuda):
    data, flags = _cube(cuda, 5, (4, 30, 90), special=True)
    _both_routes(data, flags, (0.0, 6.0, 6.0), passes=3)


def test_each_call_counts_its_route_and_launches(cuda, monkeypatch):
    monkeypatch.setattr(twodflag, "box_filters", {"kernel": 0, "plain": 0})
    monkeypatch.setattr(twodflag, "launches", {"box_strided": 0, "box_rows": 0})
    contiguous, flags = _cube(cuda, 6, (4, 20, 64))
    inner, inner_flags = _cube(cuda, 6, (4, 20, 64), "baselines_inner")
    twodflag.masked_gaussian_filter(contiguous, flags, np.array((0.0, 12.5, 10.0)))
    assert twodflag.launches == {"box_strided": 1, "box_rows": 1}  # time, then frequency
    twodflag.masked_gaussian_filter(inner, inner_flags, np.array((0.0, 12.5, 10.0)))
    assert twodflag.launches == {"box_strided": 3, "box_rows": 1}  # both across the baselines
    twodflag.masked_gaussian_filter(contiguous[:, :1], flags[:, :1], np.array((0.0, 0.0, 10.0)))
    assert twodflag.launches == {"box_strided": 3, "box_rows": 2}  # a spectrum: one launch
    assert twodflag.box_filters == {"kernel": 3, "plain": 0}
    twodflag.masked_gaussian_filter(contiguous.cpu(), flags.cpu(), np.array((0.0, 12.5, 10.0)))
    assert twodflag.box_filters == {"kernel": 3, "plain": 1}
    torch.cuda.synchronize()


def test_the_flagger_takes_the_kernels(cuda, monkeypatch):
    monkeypatch.setattr(twodflag, "box_filters", {"kernel": 0, "plain": 0})
    rs = np.random.RandomState(7)
    scan = torch.from_numpy((rs.standard_normal((30, 64, 8)) + 4).astype(np.float32)).to(cuda)
    flagger = twodflag.SumThresholdFlagger()
    flagger.get_flags(scan, torch.zeros(scan.shape, dtype=torch.uint8, device=cuda))
    torch.cuda.synchronize()
    assert twodflag.box_filters["kernel"] == 4 and twodflag.box_filters["plain"] == 0


def test_the_wrapper_raises_on_what_the_kernels_do_not_take(cuda):
    data, flags = _cube(cuda, 8, (2, 5, 6))
    sigma = np.zeros(3)
    with pytest.raises(TypeError):
        twodflag.masked_gaussian_filter(data.double(), flags, sigma)
    with pytest.raises(TypeError):
        twodflag.masked_gaussian_filter(data, flags.float(), sigma)
    with pytest.raises(ValueError):
        twodflag.masked_gaussian_filter(data, flags.cpu(), sigma)
    with pytest.raises(ValueError):
        twodflag.masked_gaussian_filter(data, flags[:1], sigma)
    with pytest.raises(ValueError, match="baseline"):
        twodflag.masked_gaussian_filter(data, flags, np.array((3.0, 1.0, 1.0)))
    with pytest.raises(ValueError, match="sigma"):
        twodflag.masked_gaussian_filter(data, flags, np.zeros(2))
    with pytest.raises(ValueError):
        twodflag.masked_gaussian_filter(data[None], flags[None], np.zeros(4))
