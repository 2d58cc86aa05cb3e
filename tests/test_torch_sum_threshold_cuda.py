"""The SumThreshold kernel (``csrc/sum_threshold.cu``) against its plain version, on a card.

``twodflag._sum_threshold`` of a CUDA tensor runs the kernel, one launch a
call; ``twodflag.sum_threshold_plain`` (the eager window chain) runs on the
same card tensors with the same noise estimates.  Exact: the same flags,
bit for bit.  Every test here is marked ``cuda`` and skips where CUDA is
unavailable.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sum_threshold_cuda.py -q
"""

import re

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import twodflag

pytestmark = pytest.mark.cuda

WINDOWS = [1, 2, 4, 8]
WIDE_WINDOWS = [1, 2, 4, 8, 16, 32, 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _residual(cuda, seed, shape, layout="baselines_inner", special=False):
    """(B, T, F) float32 residual-like data with outliers both ways, and bool flags, on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_b, n_t, n_f = shape
    inner = (n_t, n_f, n_b) if layout == "baselines_inner" else shape
    data = torch.randn(inner, device=cuda, generator=g)
    spikes = torch.rand(inner, device=cuda, generator=g) < 0.02
    scale = torch.rand(inner, device=cuda, generator=g) * 40 - 15
    data = torch.where(spikes, data * scale, data)
    flags = torch.rand(inner, device=cuda, generator=g) < 0.05
    if special:
        flat = data.view(-1)
        n = flat.numel()
        picks = torch.randint(0, n, (30,), device=cuda, generator=g)
        flat[picks[:10]] = torch.nan
        flat[picks[10:20]] = torch.inf
        flat[picks[20:]] = -torch.inf
    if layout == "baselines_inner":
        data, flags = data.permute(2, 0, 1), flags.permute(2, 0, 1)
    if special:
        flags[0] = True  # a baseline all flagged: thresholds inf
    return data, flags


def _both_routes(data, flags, axis, windows, n_chunks=None, launches=1):
    """The kernel's flags of one ``_sum_threshold`` call, checked against the plain chain's."""
    n = data.shape[axis + 1]
    chunks = np.linspace(0, n, n_chunks + 1).astype(np.int_) if n_chunks else None
    before = dict(twodflag.launches)
    got = twodflag._sum_threshold(data, flags, axis, windows, 4.5, 1.3, chunks)
    torch.cuda.synchronize()
    ran = {k: twodflag.launches[k] - before[k] for k in before}
    chunks = np.array([0, n]) if chunks is None else chunks
    # the noise estimates: one launch of the median kernel for each 128 chunks
    medians = -(-(len(chunks) - 1) // twodflag.MM_MAX_CHUNKS)
    assert ran == {"box_strided": 0, "box_rows": 0, "sum_threshold": launches, "median": medians}
    lines, line_flags = (data, flags) if axis == 0 else (data.transpose(1, 2),
                                                         flags.transpose(1, 2))
    threshold = twodflag._chunk_thresholds(lines, line_flags, 4.5, chunks)
    want = twodflag.sum_threshold_plain(lines, threshold, windows, 1.3, chunks)
    want = want if axis == 0 else want.transpose(1, 2)
    assert got.shape == want.shape and got.dtype == torch.bool
    mismatches = int((got != want).sum())
    assert mismatches == 0, f"{mismatches} of {want.numel()} flags differ ({int(want.sum())} set)"
    assert want.any() and not want.all()
    return got


@pytest.mark.parametrize("axis, n_chunks", [(0, None), (1, 8)])
def test_a_calibrator_scan_batch(cuda, axis, n_chunks):
    """2016 baselines x 75 dumps x 1024 channels, baselines innermost, as the flagger holds it."""
    data, flags = _residual(cuda, 1, (2016, 75, 1024))
    _both_routes(data, flags, axis, WINDOWS, n_chunks)


def test_a_calibrator_scan_spectrum(cuda):
    data, flags = _residual(cuda, 2, (2016, 1, 1024), layout="contiguous", special=True)
    _both_routes(data, flags, 1, WINDOWS, 8)


@pytest.mark.parametrize("windows", [WINDOWS, WIDE_WINDOWS])
@pytest.mark.parametrize("shape, axis, n_chunks, layout", [
    ((4, 3000, 64), 0, None, "baselines_inner"),  # 3000 dumps: tiles of the line
    ((16, 3000, 40), 0, None, "contiguous"),
    ((2, 4, 32768), 1, 10, "baselines_inner"),  # 32768 channels, 10 chunks of 3277
    ((3, 5, 32768), 1, 10, "contiguous"),
    ((8, 75, 1024), 0, None, "contiguous"),
    ((8, 75, 1024), 1, 8, "contiguous"),
    ((40, 75, 300), 1, 8, "baselines_inner"),  # baselines not a multiple of 32
])
def test_lines_tiles_and_layouts(cuda, shape, axis, n_chunks, layout, windows):
    data, flags = _residual(cuda, 3, shape, layout)
    _both_routes(data, flags, axis, windows, n_chunks)


@pytest.mark.parametrize("windows", [WINDOWS, WIDE_WINDOWS])
@pytest.mark.parametrize("axis, n_chunks", [(0, None), (1, 8), (1, 10)])
def test_nan_inf_and_all_flagged_lines(cuda, axis, n_chunks, windows):
    data, flags = _residual(cuda, 4, (70, 75, 512), special=True)
    _both_routes(data, flags, axis, windows, n_chunks)


def test_short_lines_and_zero_length_chunks(cuda):
    data, flags = _residual(cuda, 5, (33, 6, 5), special=True)
    _both_routes(data, flags, 0, WINDOWS)  # windows longer than the line
    got = twodflag._sum_threshold(data, flags, 1, WINDOWS, 4.5, 1.3, np.array([0, 0, 2, 2, 5]))
    threshold = twodflag._chunk_thresholds(data.transpose(1, 2), flags.transpose(1, 2), 4.5,
                                           np.array([0, 0, 2, 2, 5]))
    want = twodflag.sum_threshold_plain(data.transpose(1, 2), threshold, WINDOWS, 1.3,
                                        np.array([0, 0, 2, 2, 5]))
    assert torch.equal(got, want.transpose(1, 2))


@pytest.mark.parametrize("n_chunks, launches", [(128, 1), (129, 2), (300, 3)])
def test_more_chunks_than_a_launch_takes(cuda, n_chunks, launches):
    data, flags = _residual(cuda, 9, (40, 20, 1500), special=True)
    _both_routes(data, flags, 1, WINDOWS, n_chunks, launches)


def test_windows_in_no_order(cuda):
    data, flags = _residual(cuda, 6, (64, 40, 90), special=True)
    _both_routes(data, flags, 1, [8, 3, 1, 5], 3)


def test_the_flagger_takes_the_kernel(cuda, monkeypatch):
    monkeypatch.setattr(twodflag, "sum_thresholds", {"kernel": 0, "plain": 0})
    monkeypatch.setattr(twodflag, "launches", {"box_strided": 0, "box_rows": 0,
                                               "sum_threshold": 0, "median": 0})
    g = torch.Generator(device=cuda).manual_seed(7)
    scan = torch.randn((30, 64, 8), dtype=torch.complex64, device=cuda, generator=g) + 4
    flags = torch.zeros(scan.shape, dtype=torch.uint8, device=cuda)
    flagger = twodflag.SumThresholdFlagger()
    got = flagger.get_flags(scan, flags, chunk_size=4)  # two batches
    torch.cuda.synchronize()
    assert twodflag.sum_thresholds == {"kernel": 6, "plain": 0}
    assert twodflag.launches["sum_threshold"] == 6
    want = flagger.get_flags(scan.cpu().numpy(), flags.cpu().numpy(), device="cpu")
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_the_flagger_refuses_windows_whose_halo_leaves_no_room(cuda):
    g = torch.Generator(device=cuda).manual_seed(10)
    scan = torch.randn((400, 256, 2), dtype=torch.complex64, device=cuda, generator=g) + 4
    flags = torch.zeros(scan.shape, dtype=torch.uint8, device=cuda)
    wide = twodflag.SumThresholdFlagger(windows_time=[2 ** k for k in range(8)])  # halo 247
    with pytest.raises(ValueError, match="leave no room"):
        wide.get_flags(scan, flags)
    flagger = twodflag.SumThresholdFlagger(windows_time=WIDE_WINDOWS)  # halo 120
    got = flagger.get_flags(scan, flags)
    want = flagger.get_flags(scan.cpu().numpy(), flags.cpu().numpy(), device="cpu")
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_the_kernel_spills_nothing(cuda):
    from katsdpsigproc_tpu_torch.utils import kernels

    twodflag._st_library()
    log = kernels.build_info[kernels.build_key("sum_threshold", ["sum_threshold.cu"], {})]["log"]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    assert spills and all(s == ("0", "0") for s in spills), log


def test_the_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    data, flags = _residual(cuda, 8, (2, 12, 3), layout="contiguous")
    threshold = torch.ones((2, 2, 3), device=cuda)
    chunks = np.array([0, 6, 12])
    with pytest.raises(ValueError, match="one card"):
        twodflag.sum_threshold_cuda(data, threshold.cpu(), WINDOWS, 1.3, chunks)
    with pytest.raises(TypeError):
        twodflag.sum_threshold_cuda(data.double(), threshold, WINDOWS, 1.3, chunks)
    with pytest.raises(ValueError, match="chunks"):
        twodflag.sum_threshold_cuda(data, threshold, WINDOWS, 1.3, np.array([0, 6, 11]))
    with pytest.raises(ValueError, match="threshold"):
        twodflag.sum_threshold_cuda(data, threshold[:1], WINDOWS, 1.3, chunks)
    out = twodflag.sum_threshold_cuda(data, threshold, WINDOWS, 1.3, chunks)
    torch.cuda.synchronize()
    assert out.shape == data.shape and out.dtype == torch.bool
