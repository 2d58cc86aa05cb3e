"""The hybrid engine's background kernel (``fused_flagger.background_deviations``) on a card.

``background_deviations`` of CUDA tensors runs ``csrc/fused_flagger.cu``'s
``background_kernel``, one launch a call; it is held to the plain
background pass, ``device.background_median_filter(...).transpose(0, 1)``,
on the same card tensors: float32 values bit for bit (``view(torch.int32)``),
NaN as NaN-ness.  Rows of 1 and 3, and 1008-row slabs at a column offset
of an 8064-row dump (read where they lie); channels on both sides of the
window and of the kernel's 64-channel tiles; every flag mode, both
``fast_path`` values, visibilities and amplitudes, with NaN, +-inf, -0,
negatives and denormals in the inputs.  Then the hybrid engine on the
card: one background launch a slab, and K1's flags.  Every test here is
marked ``cuda`` and skips where CUDA is unavailable.  This file imports no
jax::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_background_cuda.py -q
"""

import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import device
from katsdpsigproc_tpu_torch.models.rfi import fused_flagger as ff

pytestmark = pytest.mark.cuda

F = device.BackgroundFlags
CHANNELS = (1, 5, 12, 13, 99, 1037, 4097, 32768)
MODES = {"none": F.NONE, "full": F.FULL, "channel": F.CHANNEL}
DUMP_ROWS, SLAB, SLAB_START = 8064, 1008, 3 * 1008


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _dump(cuda, channels, rows, seed, amplitude, special=True, nan=True):
    """(channels, rows, 2) planar pairs, or (channels, rows) amplitudes, and both flag forms.

    `special`: NaN, +-inf, -0, denormals and zeros at 1/50 of the values each; without
    `nan`, no value that leaves a member absent (NaN, and for amplitudes -inf or negative).
    """
    g = torch.Generator(device=cuda).manual_seed(seed)
    vis = torch.randn((channels, rows, 2), device=cuda, generator=g)
    spikes = torch.rand((channels, rows), device=cuda, generator=g) < 1 / 16
    vis[spikes] *= 40.0
    if amplitude:
        vis = vis[..., 0].abs() * torch.where(
            torch.rand((channels, rows), device=cuda, generator=g) < 0.1 * nan, -1.0, 1.0)
    if special:
        flat = vis.view(-1)
        n = max(1, flat.numel() // 50)
        picks = torch.randint(0, flat.numel(), (7, n), device=cuda, generator=g)
        flat[picks[0]] = torch.nan if nan else 2.0
        flat[picks[1]] = torch.inf
        flat[picks[2]] = -torch.inf if nan or not amplitude else torch.inf
        flat[picks[3]] = -0.0
        flat[picks[4]] = 1e-40  # a denormal
        flat[picks[5]] = 1e-20  # its square is one
        flat[picks[6]] = 0.0
    full = ((torch.rand((channels, rows), device=cuda, generator=g) < 0.1)
            * torch.randint(1, 3, (channels, rows), device=cuda, generator=g)).to(torch.uint8)
    channel = (torch.rand((channels,), device=cuda, generator=g) < 0.2).to(torch.uint8)
    return vis, full, channel


def _assert_same_bits(got, want):
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert got.is_contiguous()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), "NaN at other places"
    bad = int((got.view(torch.int32) != want.view(torch.int32))[~nan].sum())
    assert bad == 0, f"{bad} deviations of {got.numel()} differ in their bits"


def _check(vis, full, channel, mode, fast, amplitude, width=13):
    flags = {"none": None, "full": full, "channel": channel}[mode]
    use = MODES[mode]
    want = device.background_median_filter(vis, flags, width, amplitude, use,
                                           fast_path=fast).transpose(0, 1)
    before = ff.launches["background"]
    got = ff.background_deviations(vis, flags, width, amplitude, use, fast_path=fast)
    torch.cuda.synchronize()
    assert ff.launches["background"] == before + 1
    assert got.shape == (vis.shape[1], vis.shape[0]) and got.device == vis.device
    _assert_same_bits(got, want)
    return got


@pytest.mark.parametrize("amplitude", [False, True], ids=["vis", "amp"])
@pytest.mark.parametrize("fast", [False, True], ids=["general", "fast"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("channels", CHANNELS)
def test_short_slabs_match_the_plain_background(cuda, channels, rows, mode, fast, amplitude):
    vis, full, channel = _dump(cuda, channels, rows, channels * 7 + rows, amplitude)
    _check(vis, full, channel, mode, fast, amplitude)


@pytest.mark.parametrize("amplitude", [False, True], ids=["vis", "amp"])
@pytest.mark.parametrize("fast", [False, True], ids=["general", "fast"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("channels", [13, 1037, 32768])
def test_a_slab_of_a_dump_read_where_it_lies(cuda, channels, mode, fast, amplitude):
    """The cell's slab, ``vis[:, start:stop]`` of an 8064-row dump, and its FULL flags' slab."""
    vis, full, channel = _dump(cuda, channels, DUMP_ROWS, channels + 11, amplitude)
    cols = slice(SLAB_START, SLAB_START + SLAB)
    slab = vis[:, cols]
    assert not slab.is_contiguous()
    got = _check(slab, full[:, cols], channel, mode, fast, amplitude)
    assert got.any()


@pytest.mark.parametrize("amplitude", [False, True], ids=["vis", "amp"])
@pytest.mark.parametrize("fast", [False, True], ids=["general", "fast"])
@pytest.mark.parametrize("channels,rows", [(99, 3), (1037, 70), (32768, 1008)])
def test_windows_with_every_member_present(cuda, channels, rows, fast, amplitude):
    """No member absent: the tiles inside the row take the general path's shortcut (every
    member present), on +-inf, -0, denormals and zeros; then one NaN in one tile."""
    vis, _, _ = _dump(cuda, channels, rows, channels + rows, amplitude, nan=False)
    _check(vis, None, None, "none", fast, amplitude)
    vis[channels // 2, rows // 2] = torch.nan
    _check(vis, None, None, "none", fast, amplitude)


def test_finite_noise_takes_the_same_deviations_on_both_paths(cuda):
    """On finite visibilities the fast path's deviations are the general path's."""
    vis, _, _ = _dump(cuda, 4097, 64, 5, False, special=False)
    general = _check(vis, None, None, "none", False, False)
    fast = _check(vis, None, None, "none", True, False)
    _assert_same_bits(fast, general)


@pytest.mark.parametrize("width", [3, 49, 51])
@pytest.mark.parametrize("fast", [False, True], ids=["general", "fast"])
def test_other_widths(cuda, width, fast):
    """Both sides of the switch from networks in registers to counted ranks (49)."""
    for channels in (width - 1, width, 300):
        vis, full, _ = _dump(cuda, channels, 5, width * 3 + channels, False)
        _check(vis, full, None, "none", fast, False, width)
        _check(vis, full, None, "full", fast, False, width)


def test_bool_flags_and_a_copied_layout(cuda):
    vis, full, channel = _dump(cuda, 300, 40, 8, False)
    want = _check(vis, full, channel, "full", False, False)
    strided = vis.permute(1, 0, 2).contiguous().permute(1, 0, 2)  # rows not dense: copied
    got = ff.background_deviations(strided, full != 0, 13, False, F.FULL, fast_path=False)
    _assert_same_bits(got, want)


def test_what_the_kernel_does_not_take_raises(cuda):
    vis, full, _ = _dump(cuda, 64, 8, 1, False, special=False)
    with pytest.raises(ValueError, match="odd"):
        ff.background_deviations(vis, None, 12, False, F.NONE)
    with pytest.raises(TypeError, match="float32"):
        ff.background_deviations(torch.view_as_complex(vis), None, 13, False, F.NONE)
    with pytest.raises(TypeError, match="float32"):
        ff.background_deviations(vis.double(), None, 13, False, F.NONE)
    with pytest.raises(ValueError, match="on cpu"):
        ff.background_deviations(vis, full.cpu(), 13, False, F.FULL)
    with pytest.raises(TypeError, match="uint8"):
        ff.background_deviations(vis, full.int(), 13, False, F.FULL)


def test_an_empty_slab_launches_nothing(cuda):
    before = ff.launches["background"]
    got = ff.background_deviations(torch.zeros((0, 8, 2), device=cuda), None, 13, False, F.NONE)
    assert got.shape == (8, 0) and ff.launches["background"] == before


def test_the_hybrid_engine_launches_the_kernel_once_a_slab(cuda):
    """The hybrid engine on a 32768 x 64 dump: one background and one K2 launch a slab
    of 16 rows, no eager background, and K1's flags."""
    vis, _, _ = _dump(cuda, 32768, 64, 3, False, special=False)
    vis[:, :, 0][torch.rand((32768, 64), device=cuda) < 1 / 64] += 60.0
    fn = device.make_flagger_fn(13, 11.0, engine="hybrid", baseline_block=16)
    before = dict(ff.launches)
    got = fn(vis)
    torch.cuda.synchronize()
    assert ff.launches["background"] == before["background"] + 4
    assert ff.launches["madnz_threshold"] == before["madnz_threshold"] + 4
    k1 = ff.flag_dump(vis.transpose(0, 1))
    assert got.any() and torch.equal(got.transpose(0, 1), k1)
