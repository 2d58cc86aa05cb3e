"""The masked-median kernel (``csrc/masked_median.cu``) against its plain version, on a card.

``twodflag.masked_median`` of a CUDA tensor runs the kernel, one launch a
call of up to 128 chunks; ``twodflag.masked_median_plain`` (a sort of each
chunk) runs on the same card tensors.  Exact: the same bits.  Every test
here is marked ``cuda`` and skips where CUDA is unavailable.  This file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_masked_median_cuda.py -q
"""

import re

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import twodflag

pytestmark = pytest.mark.cuda

B, T, F = 2016, 75, 1024
CHUNKS8 = np.linspace(0, F, 9).astype(np.int_)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cube(cuda, seed, shape, layout="baselines_inner", special=False, flag_frac=0.05):
    """(B, T, F) residual-like float32 data and bool flags on the card, in `layout`."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_b, n_t, n_f = shape
    inner = (n_t, n_f, n_b) if layout == "baselines_inner" else shape
    data = torch.randn(inner, device=cuda, generator=g)
    flags = torch.rand(inner, device=cuda, generator=g) < flag_frac
    if special:  # ties, signed zeros, infinities, NaN with and without a payload
        flat = data.view(-1)
        picks = torch.randint(0, flat.numel(), (6, max(1, flat.numel() // 40)), device=cuda,
                              generator=g)
        flat[picks[0]] = 0.0
        flat[picks[1]] = -0.0
        flat[picks[2]] = torch.inf
        flat[picks[3]] = -torch.inf
        flat[picks[4]] = torch.nan
        flat.view(torch.int32)[picks[5]] = -4194303  # 0xffc00001
        flat[picks[5, : picks.shape[1] // 2]] = 1.0  # ties
    if layout == "baselines_inner":
        data, flags = data.permute(2, 0, 1), flags.permute(2, 0, 1)
    if special:
        flags[0] = True  # a baseline all flagged
        flags[1, :, :3] = True
    return data, flags


def _both_routes(data, flags, chunks, launches=1, **kw):
    """The kernel's medians of one call, checked bit for bit against the plain version's."""
    before = dict(twodflag.launches)
    got = twodflag.masked_median(data, flags, chunks, **kw)
    torch.cuda.synchronize()
    ran = {k: twodflag.launches[k] - before[k] for k in before}
    assert ran == {"box_strided": 0, "box_rows": 0, "sum_threshold": 0, "median": launches}
    want = twodflag.masked_median_plain(data, flags, chunks, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous()
    differ = got.view(torch.int32) != want.view(torch.int32)
    assert not bool(differ.any()), (f"{int(differ.sum())} of {want.numel()} medians differ: "
                                    f"{got[differ][:8].tolist()} against {want[differ][:8].tolist()}")
    return got


@pytest.mark.parametrize("special", [False, True])
def test_a_calibrator_scan_batch(cuda, special):
    """The flagger's populations of a batch, in the layouts it holds them in."""
    data, flags = _cube(cuda, 1, (B, T, F), special=special)
    # the time median and the time thresholds: lines of 75, baselines innermost
    _both_routes(data, flags, np.array([0, T]), empty_value=0.0)
    _both_routes(data, flags, np.array([0, T]), empty_value=np.nan, take_abs=True)
    # the frequency thresholds: 8 chunks of 128 along frequency
    _both_routes(data.transpose(1, 2), flags.transpose(1, 2), CHUNKS8, empty_value=np.nan,
                 take_abs=True)
    # the 2-D background: each chunk of a baseline's 75 x 128, on a (B, T, F) residual
    residual, dense_flags = data.contiguous(), flags.contiguous()
    _both_routes(residual.transpose(1, 2), dense_flags.transpose(1, 2), CHUNKS8,
                 empty_value=np.nan, take_abs=True, blocks=True)
    # frequency lines along the contiguous axis
    _both_routes(residual.transpose(1, 2), dense_flags.transpose(1, 2), CHUNKS8,
                 empty_value=np.nan, take_abs=True)
    # the spectrum, (B, 1, F) contiguous: its background and its thresholds
    spectrum, spectrum_flags = residual[:, :1].contiguous(), dense_flags[:, :1].contiguous()
    for blocks in (False, True):
        _both_routes(spectrum.transpose(1, 2), spectrum_flags.transpose(1, 2), CHUNKS8,
                     empty_value=np.nan, take_abs=True, blocks=blocks)


@pytest.mark.parametrize("take_abs", [False, True])
@pytest.mark.parametrize("shape, layout, chunks, blocks", [
    ((40, 3000, 64), "baselines_inner", [0, 3000], False),  # long lines: a CTA a line
    ((16, 373, 40), "contiguous", [0, 373], False),  # one past the line path's 372
    ((16, 372, 40), "contiguous", [0, 372], False),
    ((6, 200, 300), "contiguous", [0, 100, 200], True),  # 30,000 keys: past 48 KB of keys
    ((3, 1000, 80), "contiguous", [0, 1000], True),  # 80,000 keys: read at every round
    ((70, 9, 33), "baselines_inner", [0, 0, 4, 4, 9], False),  # zero-length chunks
    ((70, 9, 33), "baselines_inner", [0, 0, 4, 4, 9], True),
    ((33, 1, 5), "contiguous", [0, 1], False),  # n of 0 or 1
    ((33, 2, 5), "contiguous", [0, 2], False),
])
def test_lines_blocks_and_edges(cuda, shape, layout, chunks, blocks, take_abs):
    data, flags = _cube(cuda, 3, shape, layout, special=True, flag_frac=0.3)
    for empty in (0.0, np.nan):
        _both_routes(data, flags, np.array(chunks), empty_value=empty, take_abs=take_abs,
                     blocks=blocks)


@pytest.mark.parametrize("n_chunks, launches", [(128, 1), (129, 2), (300, 3)])
def test_more_chunks_than_a_launch_takes(cuda, n_chunks, launches):
    data, flags = _cube(cuda, 9, (40, 20, 1500), special=True)
    chunks = np.linspace(0, 1500, n_chunks + 1).astype(np.int_)
    _both_routes(data.transpose(1, 2), flags.transpose(1, 2), chunks, launches,
                 empty_value=np.nan, take_abs=True)


def test_uint8_flags_and_views(cuda):
    data, flags = _cube(cuda, 5, (64, 40, 90), special=True)
    _both_routes(data[:, 5:35, ::2], flags[:, 5:35, ::2].to(torch.uint8), np.array([0, 30]),
                 empty_value=0.0)


def test_the_flagger_sorts_nothing(cuda, monkeypatch):
    """``get_flags`` on a card takes every median on the kernel, six launches a batch."""
    monkeypatch.setattr(twodflag, "medians", {"kernel": 0, "plain": 0})
    monkeypatch.setattr(twodflag, "launches", {"box_strided": 0, "box_rows": 0,
                                               "sum_threshold": 0, "median": 0})
    g = torch.Generator(device=cuda).manual_seed(7)
    scan = torch.randn((30, 64, 8), dtype=torch.complex64, device=cuda, generator=g) + 4
    flags = (torch.rand(scan.shape, device=cuda, generator=g) < 0.05).to(torch.uint8)
    flagger = twodflag.SumThresholdFlagger(freq_chunks=8)
    want = flagger.get_flags(scan.cpu().numpy(), flags.cpu().numpy(), device="cpu")
    twodflag.medians.update(kernel=0, plain=0)

    def no_sort(*args, **kwargs):
        raise AssertionError("torch.sort on the card's path")

    monkeypatch.setattr(torch, "sort", no_sort)
    got = flagger.get_flags(scan, flags, chunk_size=4)  # two batches
    torch.cuda.synchronize()
    assert twodflag.medians == {"kernel": 12, "plain": 0}
    assert twodflag.launches["median"] == 12
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_the_kernel_spills_nothing(cuda):
    from katsdpsigproc_tpu_torch.utils import kernels

    twodflag._mm_library()
    log = kernels.build_info[kernels.build_key("masked_median", ["masked_median.cu"], {})]["log"]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    assert len(spills) >= 3 and all(s == ("0", "0") for s in spills), log


def test_the_kernel_has_no_local_memory(cuda):
    """No ``LDL``/``STL`` in the SASS: no array indexed at run time lives in local memory."""
    import shutil
    import subprocess

    from katsdpsigproc_tpu_torch.utils import kernels

    twodflag._mm_library()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    key = kernels.build_key("masked_median", ["masked_median.cu"], {})
    sass = subprocess.run([cuobjdump, "-sass", str(kernels.BUILD_DIR / key / "libmasked_median.so")],
                          capture_output=True, text=True, check=True).stdout
    assert "median_lines_kernel" in sass and "median_block_kernel" in sass
    assert not re.search(r"\b(LDL|STL)\b", sass)


def test_the_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    data, flags = _cube(cuda, 8, (2, 12, 3), layout="contiguous")
    with pytest.raises(ValueError, match="one card"):
        twodflag.masked_median_cuda(data, flags.cpu(), [0, 12], empty_value=0.0)
    with pytest.raises(TypeError):
        twodflag.masked_median_cuda(data.double(), flags, [0, 12], empty_value=0.0)
    with pytest.raises(ValueError, match="chunks"):
        twodflag.masked_median_cuda(data, flags, [0, 6, 11], empty_value=0.0)
    out = twodflag.masked_median_cuda(data, flags, [0, 6, 12], empty_value=0.0)
    torch.cuda.synchronize()
    assert out.shape == (2, 2, 3) and out.dtype == torch.float32
