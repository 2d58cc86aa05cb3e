"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where CUDA is unavailable.
This file imports no jax, so it also runs on a machine without it; there
the JAX package's test configuration must not be loaded:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: exact on every uint8 mask and float32 result (the kernels
round each operation as the plain versions do), except K8's ``reduce``
chain, whose row sums are taken in another order (rtol 1e-6).
"""

import asyncio

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.examples import triple, triple_pallas
from katsdpsigproc_tpu_torch.models.rfi import device, fused_flagger as ff
from katsdpsigproc_tpu_torch.ops import percentile as pct, transpose as tr
from katsdpsigproc_tpu_torch.scripts import (examples_ab, k2_ab, k4_ab, percentiletest,
                                             transposetest)
from katsdpsigproc_tpu_torch.test import test_accel
from katsdpsigproc_tpu_torch.utils import regions

from .test_torch_test_support import run_plugin

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _dump(channels, rows, seed):
    rs = np.random.RandomState(seed)
    vis_t = rs.standard_normal((rows, channels, 2)).astype(np.float32)
    spikes = rs.random_sample((rows, channels)) < 1.0 / 32.0
    vis_t[spikes] *= 40.0
    flags = ((rs.random_sample((rows, channels)) < 1.0 / 16.0) * 2).astype(np.uint8)
    return torch.from_numpy(vis_t), torch.from_numpy(flags)


@pytest.mark.parametrize("channels,rows", [(99, 8), (300, 8), (2048, 6), (32768, 2)])
@pytest.mark.parametrize("mode", ["none", "full", "channel"])
def test_flagger_matches_plain(cuda, channels, rows, mode):
    vis_t, flags = _dump(channels, rows, seed=channels + rows)
    vis_t, flags = vis_t.to(cuda), flags.to(cuda)
    kw = {"none": {}, "full": {"input_flags": flags},
          "channel": {"channel_flags": flags[0].contiguous()}}[mode]
    got = ff.flag_transposed(vis_t, **kw)
    want = ff.flag_transposed_plain(vis_t, **kw)
    assert got.device == vis_t.device and got.any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_windows,flag_value", [(1, 1), (4, 2), (6, 3), (9, 1)])
def test_madnz_threshold_matches_plain(cuda, n_windows, flag_value):
    vis_t, _ = _dump(1000, 8, seed=n_windows)
    vis_t = vis_t.to(cuda)
    dev_t = device.background_median_filter(
        vis_t.transpose(0, 1), None, 13, False, device.BackgroundFlags.NONE).T.contiguous()
    dev_t[3, 200:230] += 0.8  # a broad, weak feature only the wide windows catch
    kw = dict(n_sigma=11.0, n_windows=n_windows, falloff=1.2, flag_value=flag_value)
    assert torch.equal(ff.madnz_threshold(dev_t, **kw), ff.madnz_threshold_plain(dev_t, **kw))


def test_nan_row_propagates_like_jax(cuda):
    vis_t, _ = _dump(300, 4, seed=1)
    vis_t[1, 17, 0] = float("nan")
    vis_t[2, 0, 1] = float("nan")
    vis_t = vis_t.to(cuda)
    assert torch.equal(ff.flag_transposed(vis_t), ff.flag_transposed_plain(vis_t))


def test_launch_counter_moves(cuda):
    vis_t, _ = _dump(256, 4, seed=2)
    vis_t = vis_t.to(cuda)
    before = dict(ff.launches)
    flags = ff.flag_dump(vis_t)
    ff.madnz_threshold(torch.zeros((4, 256), device=cuda))
    device.make_flagger_fn(engine="hybrid", baseline_block=2)(vis_t.transpose(0, 1))
    torch.cuda.synchronize()
    assert ff.launches["flagger"] == before["flagger"] + 1
    assert ff.launches["madnz_threshold"] == before["madnz_threshold"] + 1 + 2
    assert flags.device == vis_t.device


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    vis_t = torch.zeros((4, 64, 2), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ff.flag_transposed(vis_t.double())
    with pytest.raises(TypeError, match="float32"):
        ff.madnz_threshold(torch.zeros((4, 64), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="on cpu"):
        ff.flag_transposed(vis_t, torch.zeros((4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="odd"):
        ff.flag_transposed(vis_t, width=34)
    with pytest.raises(NotImplementedError, match="leading"):
        ff.flag_dump(vis_t, layout="leading")
    with pytest.raises(ValueError, match="rank_radix"):
        ff.flag_transposed(vis_t, rank_radix=8)
    with pytest.raises(ValueError, match="rank_radix"):
        ff.madnz_threshold(torch.zeros((4, 64), device=cuda), rank_radix=0)


def test_strided_input_is_corner_turned_by_k5(cuda):
    """The JAX callers' swapaxes of a channel-major dump: K5 turns it, then
    K1 (or K2) runs, and the flags equal those of the contiguous copy."""
    from katsdpsigproc_tpu_torch.ops import transpose as tr

    vis_t, flags = _dump(1500, 40, seed=5)
    vis = vis_t.transpose(0, 1).contiguous().to(cuda)  # (C, rows, 2), channel-major
    flags_c = flags.T.contiguous().to(cuda)  # (C, rows)
    want = ff.flag_dump(vis.transpose(0, 1).contiguous())
    want_full = ff.flag_dump(vis.transpose(0, 1).contiguous(), flags_c.T.contiguous())
    before = (tr.launches["transpose"], ff.launches["flagger"])
    got = ff.flag_dump(vis.transpose(0, 1))
    got_full = ff.flag_transposed(vis.transpose(0, 1), flags_c.T)
    torch.cuda.synchronize()
    assert tr.launches["transpose"] == before[0] + 3  # vis, vis and the flags
    assert ff.launches["flagger"] == before[1] + 2
    assert torch.equal(got, want) and got.any()
    assert torch.equal(got_full, want_full)
    # Any other strided layout is copied, and gives the same flags.
    wide = vis_t.to(cuda).repeat(1, 1, 2)  # (rows, C, 4): pairs 8 B apart in 16
    before = tr.launches["transpose"]
    assert torch.equal(ff.flag_dump(wide[..., :2]), want)
    assert tr.launches["transpose"] == before
    dev_c = torch.from_numpy(np.random.RandomState(6).standard_normal((1500, 40)).astype(
        np.float32)).to(cuda)  # (C, rows)
    dev_c[700:703] += 30.0
    before = tr.launches["transpose"]
    got = ff.madnz_threshold(dev_c.T)
    torch.cuda.synchronize()
    assert tr.launches["transpose"] == before + 1
    assert torch.equal(got, ff.madnz_threshold(dev_c.T.contiguous())) and got.any()


# K1 at the edges of its run layout: a run of R = ceil(C / 1024) channels
# per thread, runs shorter than a window (C <= 1024 (W - 2)), a last run
# cut short (1025, 4097), whole runs of 32 (32768), the channel limit.
_EDGE_CHANNELS = (1, 13, 99, 257, 1023, 1024, 1025, 4097, 32768, "limit")


@pytest.mark.parametrize("channels", _EDGE_CHANNELS)
@pytest.mark.parametrize("mode", ["none", "full", "channel"])
def test_k1_at_run_layout_edges_matches_plain_and_full(cuda, channels, mode):
    fp = _probe()
    if channels == "limit":
        channels = ff.max_channels()
    vis_t, flags = _dump(channels, 3, seed=channels)
    if mode == "none" and channels >= 13:
        vis_t[2, channels // 2, 0] = float("nan")  # a NaN row, through the fast median
    vis_t, flags = vis_t.to(cuda), flags.to(cuda)
    kw = {"none": {}, "full": {"input_flags": flags},
          "channel": {"channel_flags": flags[0].contiguous()}}[mode]
    for n_windows, flag_value in ((4, 1), (6, 3)):
        got = ff.flag_transposed(vis_t, **kw, n_windows=n_windows, flag_value=flag_value)
        want = ff.flag_transposed_plain(vis_t, **kw, n_windows=n_windows, flag_value=flag_value)
        assert torch.equal(got, want), (n_windows, int((got != want).sum()))
    if mode == "none" and channels >= 13:
        # K11's `full` runs K1's code; `strided_full` is K1 in the strided
        # layout, flag for flag, where that layout holds the row
        assert torch.equal(fp.probe(vis_t, "full"), ff.flag_transposed(vis_t))
        if channels <= fp.max_channels("strided_full"):
            assert torch.equal(fp.probe(vis_t, "strided_full"), ff.flag_transposed(vis_t))


@pytest.mark.parametrize("channels", _EDGE_CHANNELS)
@pytest.mark.parametrize("kind", ["dump", "adversarial"])
def test_k2_at_run_layout_edges_matches_plain_and_strided(cuda, channels, kind):
    """K2 in K1's run layout at K1's edge shapes, on the deviations of a
    dump and on deviations K1 never makes, against its plain version and,
    where the strided layout holds the row, its strided design."""
    if channels == "limit":
        channels = ff.max_channels()
    if kind == "dump":
        vis_t, _ = _dump(channels, 8, seed=channels)
        dev_t = device.background_median_filter(
            vis_t.to(cuda).transpose(0, 1), None, 13, False,
            device.BackgroundFlags.NONE).T.contiguous()
    else:
        dev_t = torch.from_numpy(k2_ab.adversarial_deviations(8, channels, channels)).to(cuda)
    for kw in ({}, {"n_sigma": 5.0, "n_windows": 6, "flag_value": 3}):
        got = ff.madnz_threshold(dev_t, **kw)
        assert torch.equal(got, ff.madnz_threshold_plain(dev_t, **kw)), kw
        if channels <= ff._library(13).ff_strided_max_channels():
            assert torch.equal(got, k2_ab.strided(dev_t, **kw)), kw


# Rows longer than the run layout holds take the wide-row path: just past
# the limit, a u64 mask's 65536 channels and one past it, and twice that.
_WIDE_CHANNELS = ("limit+1", 65536, 65537, 131072)


@pytest.mark.parametrize("channels", _WIDE_CHANNELS)
@pytest.mark.parametrize("mode", ["none", "full", "channel"])
def test_k1_wide_rows_match_plain(cuda, channels, mode):
    """K1 on the wide-row path in every flag mode, with a NaN in a row and a
    row of +inf amplitudes where there are no input flags (with them, K1
    and the JAX kernel take +inf as flagged and NaN as present, the plain
    version the other way), and the launch counted as a wide one."""
    if channels == "limit+1":
        channels = ff.max_channels() + 1
    vis_t, flags = _dump(channels, 3, seed=channels % 1000)
    if mode == "none":
        vis_t[1, channels // 2, 0] = float("nan")
        vis_t[2, ::7, 1] = float("inf")
    vis_t, flags = vis_t.to(cuda), flags.to(cuda)
    kw = {"none": {}, "full": {"input_flags": flags},
          "channel": {"channel_flags": flags[0].contiguous()}}[mode]
    before = dict(ff.wide_launches)
    for n_windows, flag_value in ((4, 1), (6, 3)):
        got = ff.flag_transposed(vis_t, **kw, n_windows=n_windows, flag_value=flag_value)
        want = ff.flag_transposed_plain(vis_t, **kw, n_windows=n_windows, flag_value=flag_value)
        assert torch.equal(got, want), (n_windows, int((got != want).sum()))
        assert got[0].any()
    assert ff.wide_launches["flagger"] == before["flagger"] + 2


@pytest.mark.parametrize("channels", _WIDE_CHANNELS)
@pytest.mark.parametrize("kind", ["dump", "adversarial"])
def test_k2_wide_rows_match_plain(cuda, channels, kind):
    """K2 on the wide-row path, on a dump's deviations and on NaN, +-inf, -0,
    denormal and zero deviations."""
    if channels == "limit+1":
        channels = ff.max_channels() + 1
    if kind == "dump":
        vis_t, _ = _dump(channels, 4, seed=channels % 1000)
        dev_t = device.background_median_filter(
            vis_t.to(cuda).transpose(0, 1), None, 13, False,
            device.BackgroundFlags.NONE).T.contiguous()
    else:
        dev_t = torch.from_numpy(k2_ab.adversarial_deviations(8, channels, 7)).to(cuda)
    before = ff.wide_launches["madnz_threshold"]
    for kw in ({}, {"n_sigma": 5.0, "n_windows": 6, "flag_value": 3}):
        got = ff.madnz_threshold(dev_t, **kw)
        want = ff.madnz_threshold_plain(dev_t, **kw)
        assert torch.equal(got, want), (kw, int((got != want).sum()))
    assert ff.wide_launches["madnz_threshold"] == before + 2


# Widths on both sides of the switch from a network over registers to
# counting ranks from shared memory (REGISTER_MAX_WIDTH), the widest the
# run layout's in-place median takes, and one on the wide-row path.
@pytest.mark.parametrize("width", [33, 35, 49, 51, 63, 101])
@pytest.mark.parametrize("channels", [40, 300, 1025, 4097])
@pytest.mark.parametrize("mode", ["none", "full", "channel"])
def test_k1_wide_windows_match_plain(cuda, width, channels, mode):
    vis_t, flags = _dump(channels, 4, seed=width + channels)
    if mode == "none" and channels >= width:  # NaN through the fast median only (ROADMAP)
        vis_t[3, channels // 3, 1] = float("nan")
    vis_t, flags = vis_t.to(cuda), flags.to(cuda)
    kw = {"none": {}, "full": {"input_flags": flags},
          "channel": {"channel_flags": flags[0].contiguous()}}[mode]
    before = ff.wide_launches["flagger"]
    got = ff.flag_transposed(vis_t, **kw, width=width)
    want = ff.flag_transposed_plain(vis_t, **kw, width=width)
    assert torch.equal(got, want), int((got != want).sum())
    assert ff.wide_launches["flagger"] == before + (width > ff.IN_PLACE_MAX_WIDTH)


def test_k1_channel_limit_and_launch(cuda):
    """The run layout (K1's and K2's) holds more channels than the strided
    layout's launch, at one CTA of 1024 threads per SM on the dump."""
    k1, strided = ff.launch_config(32768), ff.strided_launch_config(32768)
    assert ff.max_channels() >= 46425
    assert k1["threads"] == strided["threads"] == 1024
    assert k1["ctas_per_sm"] == strided["ctas_per_sm"] == 1
    assert k1["smem_bytes"] < strided["smem_bytes"]


def test_resource_waits_for_a_tensor_from_a_side_stream(cuda):
    """A tensor written on a side stream, handed on with ready([t]): the next
    holder's wait_events() returns only once that stream's work is done."""
    from katsdpsigproc_tpu_torch.utils import resource

    async def main():
        res = resource.Resource(None)
        first, second = res.acquire(), res.acquire()
        t = torch.zeros(1 << 20, device=cuda)
        side = torch.cuda.Stream(cuda)
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            torch.cuda._sleep(500_000_000)  # about a quarter of a second of cycles
            t.add_(1.0)
            written = torch.cuda.Event()
            written.record(side)
        first.ready([t])
        await second.wait_events()
        return written.query()

    assert asyncio.run(main())


# K4 (percentile5) and K5 (transpose): exact against their plain versions.


def _k4_designs_equal_plain(x):
    """K4, its measurement builds and the original design against the plain version, bit for bit."""
    from katsdpsigproc_tpu_torch.ops import percentile as pct

    want = pct.percentile5_plain(x).view(torch.int32)
    assert torch.equal(pct.percentile5_cuda(x).view(torch.int32), want)
    for name in k4_ab.BUILDS:
        assert torch.equal(k4_ab.build(x, name).view(torch.int32), want), name


@pytest.mark.parametrize("rows,cols", [(37, 7), (37, 241), (37, 500), (64, 4096), (3, 60000)])
def test_percentile5_matches_plain(cuda, rows, cols):
    rs = np.random.RandomState(rows + cols)
    x = rs.uniform(0.01, 100.0, (rows, cols)).astype(np.float32)
    x[1, ::5] = np.nan
    x[2] = np.nan
    _k4_designs_equal_plain(torch.from_numpy(x).to(cuda))


# K4's paths: rows below and above the SM count (1024- and 256-thread CTAs),
# each width of register slots, and the shared- and device-memory paths.
@pytest.mark.parametrize("rows,cols", [(20, 1), (20, 2), (20, 3), (20, 7), (20, 4096),
                                       (20, 4097), (200, 5), (200, 5000), (200, 6145),
                                       (200, 8192), (200, 8193), (20, 16384), (20, 16385),
                                       (4, "shared"), (4, "shared+1")])
def test_percentile5_adversarial_rows_at_path_edges(cuda, rows, cols):
    from katsdpsigproc_tpu_torch.ops import percentile as pct

    if cols in ("shared", "shared+1"):
        cols = pct.max_shared_columns() + (cols == "shared+1")
    x = torch.from_numpy(k4_ab.adversarial_rows(rows, cols, rows + cols)).to(cuda)
    _k4_designs_equal_plain(x)


def test_percentile5_launch_shapes(cuda):
    from katsdpsigproc_tpu_torch.ops import percentile as pct

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cols = pct.max_shared_columns()
    assert pct.launch_shape(4000, 5000) == (256, 20)
    assert pct.launch_shape(sms, 8192) == (256, 32)
    assert pct.launch_shape(sms, 8193) == (1024, 12)
    assert pct.launch_shape(64, 4096) == (1024, 4)
    assert pct.launch_shape(sms - 1, 5000) == (1024, 8)
    assert pct.launch_shape(4, 16384) == (1024, 16)
    assert pct.launch_shape(4, 16385) == (1024, 0)
    assert pct.launch_shape(4, cols) == (1024, 0) and pct.launch_shape(4, cols + 1) == (1024, -1)
    assert 50000 < cols < 60000  # 65536 columns take the device-memory path


@pytest.mark.parametrize("lo,hi", [(100, 4100), (1, 4998), (3, 4), (2, 4999)])
def test_percentile5_column_range_view_with_row_stride(cuda, lo, hi):
    """A view of columns [lo, hi) of 5000-column rows: the row stride exceeds
    the row, and the rows start on and off 16-byte boundaries."""
    x = torch.from_numpy(k4_ab.adversarial_rows(300, 5000, seed=lo)).to(cuda)
    _k4_designs_equal_plain(x[:, lo:hi])
    _k4_designs_equal_plain(x[:40, lo:hi])


def test_percentile5_column_range_view_and_count(cuda):
    from katsdpsigproc_tpu_torch.ops import percentile as pct

    x = torch.from_numpy(np.abs(np.random.RandomState(3).standard_normal((50, 300))).astype(
        np.float32)).to(cuda)
    before = pct.launches["percentile5"]
    op = pct.Percentile5Template(None, 300, True, tuning={"engine": "cuda"}).instantiate(
        None, (50, 300), (13, 277))
    got = op(src=x)["dest"]
    torch.cuda.synchronize()
    assert pct.launches["percentile5"] == before + 1
    assert torch.equal(got, pct.percentile5_plain(x[:, 13:277].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        pct.percentile5_cuda(x.T)
    with pytest.raises(TypeError, match="float32"):
        pct.percentile5_cuda(x.double())


@pytest.mark.parametrize("shape", [(53, 7), (73, 521), (130, 260), (1, 33), (33, 1)])
@pytest.mark.parametrize("kind", ["float32", "uint8", "complex64", "planar"])
def test_transpose_matches_plain(cuda, shape, kind):
    from katsdpsigproc_tpu_torch.ops import transpose as tr

    rs = np.random.RandomState(sum(shape))
    if kind == "planar":
        x = rs.uniform(0, 100, shape + (2,)).astype(np.float32)
    elif kind == "complex64":
        x = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    else:
        x = rs.uniform(0, 100, shape).astype(kind)
    x = torch.from_numpy(x).to(cuda)
    assert torch.equal(tr.transpose_cuda(x), tr.transpose_plain(x))


class _FailingLibrary:
    """Stands in for a kernel library whose every launch returns an error."""

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda err: b"injected failure"
        return lambda *args: 98  # cudaErrorInvalidDeviceFunction


@pytest.mark.parametrize("which", ["percentile5", "transpose"])
def test_search_raises_when_the_kernel_fails(cuda, which, monkeypatch, tmp_path):
    """A cuda candidate that fails to launch raises out of the tuner's
    search; it is not skipped in favour of a plain engine, and nothing is
    saved."""
    from katsdpsigproc_tpu_torch.ops import percentile as pct, transpose as tr
    from katsdpsigproc_tpu_torch.utils import backend

    db = tmp_path / "tuning.json"
    monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(db))
    module = pct if which == "percentile5" else tr
    monkeypatch.setattr(module, "_library", lambda: _FailingLibrary())
    ctx = backend.DeviceContext(cuda)
    with pytest.raises(RuntimeError, match=f"{which} launch failed"):
        if which == "percentile5":
            pct.Percentile5Template(ctx, 64, True)  # no record: searched
        else:
            tr.TransposeTemplate(ctx, "uint8")  # no record: searched
    assert not db.exists()


def test_transpose_row_stride_and_errors(cuda):
    from katsdpsigproc_tpu_torch.ops import transpose as tr

    x = torch.arange(40 * 70, dtype=torch.float32, device=cuda).reshape(40, 70)
    view = x[:, 5:60]
    assert torch.equal(tr.transpose_cuda(view), view.T.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tr.transpose_cuda(x.T)
    with pytest.raises(TypeError, match="byte"):
        tr.transpose_cuda(x.half())


# K1's stage probes (K9, K11, K12, K13): exact against their plain versions
# and, for the bit-exact variants, against K1.


def _probe():
    from katsdpsigproc_tpu_torch.models.rfi import flagger_probe

    return flagger_probe


@pytest.mark.parametrize("channels,rows", [(99, 8), (300, 8), (2048, 6), (32768, 2)])
@pytest.mark.parametrize("variant", ["full", "no_median", "no_rank", "no_thresh", "skeleton",
                                     "rank_pair", "zeros_fold", "shfl_median", "radix_select",
                                     "strided_full", "radix_match_any", "window_median",
                                     "channel_major"])
def test_probe_matches_plain(cuda, variant, channels, rows):
    fp = _probe()
    vis_t, _ = _dump(channels, rows, seed=channels + rows)
    vis_t = vis_t.to(cuda)
    got = fp.probe(vis_t, variant)
    assert got.device == vis_t.device
    assert torch.equal(got, fp.probe_plain(vis_t, variant))
    if variant in fp.EXACT:
        assert torch.equal(got, ff.flag_transposed(vis_t))


@pytest.mark.parametrize("channels", [13, 1023, 1025, 2080])
def test_exact_probes_match_k1_at_tile_edges(cuda, channels):
    """1023/1025/2080 channels put warp and tile edges beside the median's
    reach, where shfl_median and window_median switch between their own
    members and K1's per-channel path."""
    fp = _probe()
    vis_t, _ = _dump(channels, 5, seed=channels)
    vis_t = vis_t.to(cuda)
    for width in (w for w in (5, 13, 31) if w <= channels):  # the probes take C >= width
        k1 = ff.flag_transposed(vis_t, width=width)
        for variant in fp.EXACT:
            assert torch.equal(fp.probe(vis_t, variant, width=width), k1), (variant, width)


@pytest.mark.parametrize("channels", _EDGE_CHANNELS[1:])  # the probes take C >= width
def test_run_layout_probes_at_k1s_edges(cuda, channels):
    """K9, K11 and K13 at K1's run-layout edge shapes and its channel limit,
    widths 5, 13 and 31, rows holding NaN and +inf: every variant equals its
    plain version, and the bit-exact ones K1.  For window_median's
    4096-channel tiles, 4097 and 32768 put a row's last channels in a tile
    of their own and at a tile's end, 1023-1025 in one partial tile."""
    fp = _probe()
    if channels == "limit":
        channels = ff.max_channels()
    vis_t, _ = _dump(channels, 5, seed=channels + 1)
    vis_t[1, channels // 2, 0] = float("nan")  # NaN through the median
    vis_t[2] = torch.tensor([1.0, 0.0])  # deviations 0, and +inf at every third
    vis_t[2, ::3, 0] = float("inf")  # channel: the noise's target lies on +inf
    vis_t[3, ::4, 1] = float("nan")  # every deviation NaN: the target past the count
    vis_t[4, ::5] = float("inf")  # +inf deviations above a finite target
    vis_t = vis_t.to(cuda)
    for width in (w for w in (5, 13, 31) if w <= channels):
        k1 = ff.flag_transposed(vis_t, width=width)
        for variant in fp.RUN_LAYOUT + fp.MEASUREMENT:
            got = fp.probe(vis_t, variant, width=width)
            want = fp.probe_plain(vis_t, variant, width=width)
            assert torch.equal(got, want), (variant, width, int((got != want).sum()))
            if variant in fp.EXACT:
                assert torch.equal(got, k1), (variant, width)


@pytest.mark.parametrize("channels,rows", [(99, 8), (2048, 6), (32768, 3)])
def test_amp_pairs_matches_plain(cuda, channels, rows):
    fp = _probe()
    vis_t, _ = _dump(channels, rows, seed=rows)
    vis_t = vis_t.to(cuda)
    vis_c = vis_t.transpose(0, 1).contiguous()
    want = fp.amp_pairs_plain(vis_t)
    assert torch.equal(fp.amp_pairs(vis_t).view(torch.int32), want.view(torch.int32))
    assert torch.equal(fp.amp_pairs(vis_c, channel_major=True).view(torch.int32),
                       want.view(torch.int32))


# K12 and `channel_major` at cluster edges: 1, 3 and 5 rows leave a
# cluster part empty (and 3 and 5 are odd: no 16-byte loads), 8064 rows
# are the dump's; channels 1 and 13 split unevenly over a cluster's CTAs.
_K12_SHAPES = ([(r, c) for r in (1, 3, 5) for c in (1, 13, 1024, 32768, "limit")]
               + [(8064, c) for c in (1, 13, 1024)])


@pytest.mark.parametrize("rows,channels", _K12_SHAPES)
def test_k12_builds_match_plain_bit_for_bit(cuda, rows, channels):
    fp = _probe()
    if channels == "limit":
        channels = ff.max_channels()
    vis_t, _ = _dump(channels, rows, seed=rows + 3)
    vis_t[0, channels // 2] = torch.tensor([float("inf"), float("nan")])
    vis_t = vis_t.to(cuda)
    vis_c = vis_t.transpose(0, 1).contiguous()
    want = fp.amp_pairs_plain(vis_t).view(torch.int32)
    before = dict(fp.cluster_launches)
    for g in fp.CLUSTERS:
        got = fp.amp_pairs(vis_c, channel_major=True, cluster=g)
        assert torch.equal(got.view(torch.int32), want), g
    assert all(fp.cluster_launches[g] == before[g] + 1 for g in fp.CLUSTERS)
    assert torch.equal(fp.amp_pairs(vis_t).view(torch.int32), want)
    if channels <= fp.max_channels("amp_pairs_strided"):
        assert torch.equal(fp.amp_pairs_strided(vis_c, channel_major=True).view(torch.int32),
                           want)
        assert torch.equal(fp.amp_pairs_strided(vis_t).view(torch.int32), want)


@pytest.mark.parametrize("rows,channels", [(r, c) for r, c in _K12_SHAPES if c != 1])
def test_channel_major_matches_k1(cuda, rows, channels):
    """K1 reading the channel-major dump in place: flag for flag K1 on the
    corner-turned dump, with NaN and +inf rows, read from the transposed
    view of the dump (in place) and from a contiguous baseline-major copy."""
    fp = _probe()
    if channels == "limit":
        channels = ff.max_channels()
    vis_t, _ = _dump(channels, rows, seed=rows + 4)
    vis_t[0, channels // 2, 0] = float("nan")
    if rows > 2:
        vis_t[2, ::3, 1] = float("inf")
    vis_c = vis_t.transpose(0, 1).contiguous().to(cuda)  # (C, rows, 2)
    k1 = ff.flag_transposed(vis_c.transpose(0, 1).contiguous())
    before = fp.launches["channel_major"]
    for g in fp.CLUSTERS:
        assert torch.equal(fp.probe(vis_c.transpose(0, 1), "channel_major", cluster=g), k1), g
    assert torch.equal(fp.probe(vis_c.transpose(0, 1).contiguous(), "channel_major"), k1)
    assert fp.launches["channel_major"] == before + len(fp.CLUSTERS) + 1


def test_k12_clusters_fit_the_card(cuda):
    """Every cluster of K12's channel-major read launches at K1's CTA, and
    at least one cluster fits the card at a time."""
    fp = _probe()
    k1 = ff.launch_config(32768)
    for g in fp.CLUSTERS:
        cfg = fp.amp_launch_config(32768, channel_major=True, cluster=g)
        assert {k: cfg[k] for k in k1} == k1, (g, cfg)
        assert (cfg["clusters"] >= 1) == (g > 1), (g, cfg)


def test_probes_launch_as_k1_does(cuda):
    """K9, K11 and K13 launch as K1 does, on its run layout: 1024 threads and
    K1's dynamic shared memory (151840 B at 32768 channels) at every size,
    and at 32768 channels one CTA per SM (at 128 channels the registers
    set the occupancy, and they differ by variant)."""
    fp = _probe()
    for channels in (128, 32768):
        k1 = ff.launch_config(channels)
        assert k1["threads"] == 1024, k1
        if channels == 32768:
            assert k1["ctas_per_sm"] == 1 and k1["smem_bytes"] == 151840, k1
        for variant in fp.RUN_LAYOUT + fp.MEASUREMENT + ("amp_pairs",):
            cfg = fp.launch_config(variant, channels)
            if channels == 32768:
                assert cfg == k1, (variant, cfg, k1)
            else:
                assert cfg["threads"] == k1["threads"], (variant, cfg, k1)
                assert cfg["smem_bytes"] == k1["smem_bytes"], (variant, cfg, k1)


def test_strided_probes_launch_as_k2s_strided_design_does(cuda):
    """`strided_full` and K12's earlier design launch as K2's strided design
    does (the strided layout), one CTA per SM at 32768 channels."""
    fp = _probe()
    for channels in (128, 32768):
        strided = ff.strided_launch_config(channels)
        assert strided["threads"] == 1024, strided
        if channels == 32768:
            assert strided["ctas_per_sm"] == 1, strided
        for variant in fp.STRIDED + ("amp_pairs_strided",):
            cfg = fp.launch_config(variant, channels)
            if channels == 32768:
                assert cfg == strided, (variant, cfg, strided)
            else:
                assert cfg["threads"] == strided["threads"], (variant, cfg, strided)
                assert cfg["smem_bytes"] == strided["smem_bytes"], (variant, cfg, strided)


def test_probe_launch_counts_and_errors(cuda):
    fp = _probe()
    vis_t, _ = _dump(256, 4, seed=3)
    vis_t = vis_t.to(cuda)
    before = dict(fp.launches)
    fp.probe(vis_t, "rank_pair")
    fp.amp_pairs(vis_t)
    torch.cuda.synchronize()
    assert fp.launches["rank_pair"] == before["rank_pair"] + 1
    assert fp.launches["amp_pairs"] == before["amp_pairs"] + 1
    with pytest.raises(ValueError, match="width"):
        fp.probe(vis_t[:, :12].contiguous(), "full")
    with pytest.raises(ValueError, match="contiguous"):
        fp.probe(torch.zeros((64, 4, 2), device=cuda).transpose(0, 1), "full")
    with pytest.raises(ValueError, match="contiguous"):
        fp.amp_pairs(torch.zeros((64, 4, 2), device=cuda).transpose(0, 1))
    # Each layout's own limit: K9, K11, K13 and K12 take K1's, `strided_full`
    # and K12's earlier design the strided one.
    run_limit, strided_limit = ff.max_channels(), fp.max_channels("strided_full")
    assert fp.max_channels("skeleton") == run_limit > 50000 > strided_limit
    assert fp.max_channels("shfl_median") == fp.max_channels("window_median") == run_limit
    assert fp.max_channels("amp_pairs") == fp.max_channels("channel_major") == run_limit
    assert fp.max_channels("amp_pairs_strided") == strided_limit
    for variant in ("skeleton", "radix_select") + fp.MEDIANS:
        with pytest.raises(ValueError, match="limit"):
            fp.probe(torch.zeros((1, run_limit + 1, 2), device=cuda), variant)
    for variant in fp.STRIDED:
        with pytest.raises(ValueError, match="limit"):
            fp.probe(torch.zeros((1, strided_limit + 1, 2), device=cuda), variant)
    with pytest.raises(ValueError, match="limit"):
        fp.amp_pairs_strided(torch.zeros((1, strided_limit + 1, 2), device=cuda))
    with pytest.raises(ValueError, match="limit"):
        fp.amp_pairs(torch.zeros((1, run_limit + 1, 2), device=cuda))


def test_time_fn_times_the_card(cuda):
    from katsdpsigproc_tpu_torch.utils import profiling

    x = torch.ones((4096, 4096), device=cuda)
    ms = profiling.time_fn(lambda: x @ x, iters=3)
    medians, samples = profiling.time_interleaved({"mm": lambda: x @ x, "add": lambda: x + x},
                                                  reps=3, iters=2)
    assert 0 < medians["add"] < medians["mm"] and 0 < ms
    assert len(samples["mm"]) == 3


# A template built without a context runs on the card, as the JAX package's
# run on JAX's default device.


def test_templates_without_a_context_run_on_the_card(cuda):
    from katsdpsigproc_tpu_torch.ops import fill
    from katsdpsigproc_tpu_torch.utils import backend

    assert backend.context_device(None) == cuda
    op = fill.FillTemplate(None, np.float32).instantiate(None, (4, 5))
    op.set_value(2)
    op.ensure_all_bound()
    op()
    assert op.buffer("data").device == cuda
    template = device.FlaggerDeviceTemplate(
        device.BackgroundMedianFilterDeviceTemplate(None, 13, tuning={"engine": "network"}),
        device.NoiseEstMADTDeviceTemplate(None, 1024, tuning={"radix_bits": 4}),
        device.ThresholdSumDeviceTemplate(None))
    vis_t, _ = _dump(300, 8, seed=4)
    vis = torch.view_as_complex(vis_t.transpose(0, 1).contiguous()).to(cuda)  # (300, 8)
    flags = template.instantiate(None, 300, 8, threshold_args={"n_sigma": 11.0})(vis=vis)["flags"]
    assert flags.device == cuda
    assert torch.equal(flags.T, ff.flag_transposed(vis_t.to(cuda)))


# The tutorial kernels K6 (Triton) and K7 (CUDA C++): exact against x * 3
# and data * scale, each product rounded once.


TILE = triple_pallas.TILE  # K6's elements a program


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4 * 256, (1 << 20) + 3,
                               TILE - 1, TILE, TILE + 1, 3 * TILE + 5])
def test_triple_kernel_matches_plain(cuda, n):
    x = torch.from_numpy(np.random.RandomState(n).standard_normal(n).astype(np.float32)).to(cuda)
    before = triple_pallas.launches["triple"]
    got = triple_pallas.triple(x)
    torch.cuda.synchronize()
    assert triple_pallas.launches["triple"] == before + 1
    want = triple_pallas.triple_plain(x)
    assert got.device == cuda and torch.equal(got, want)
    # The A/B's designs: the earlier one at BLOCK and 4 warps, four vectors a
    # thread with evict-first hints.
    assert torch.equal(triple_pallas.triple_config(x, triple_pallas.BLOCK, 4), want)
    assert torch.equal(triple_pallas.triple_config(x, 4096, 8, evict_first=True), want)
    assert triple_pallas.launches["triple"] == before + 1


# K7's sizes at its tile edges: (elements a thread in a tile, tiles, extra
# elements).  multiply's tile is `threads` float4s; the A/B's build of 4
# loads a thread `threads` x 4; its bulk-copy builds take 32 KiB chunks.
K7_EDGES = {"tile-1": (4, 1, -1), "tile": (4, 1, 0), "tile+1": (4, 1, 1), "3tiles+5": (4, 3, 5),
            "tile4-1": (16, 1, -1), "tile4+1": (16, 1, 1)}


@pytest.mark.parametrize("shape", [(8, 128), (1,), (3, 333), ((1 << 20) + 5,), *K7_EDGES,
                                   (8191,), (8193,), (3 * 8192 + 5,)])  # 32 KiB chunks
@pytest.mark.parametrize("offset", [0, 1])  # 1: the data does not start on 16 bytes
@pytest.mark.parametrize("threads", [64, 256, 1024])
def test_multiply_kernel_matches_plain(cuda, shape, offset, threads):
    if shape in K7_EDGES:
        per_thread, tiles, extra = K7_EDGES[shape]
        shape = (tiles * threads * per_thread + extra,)
    n = int(np.prod(shape))
    base = torch.from_numpy(np.random.RandomState(n).standard_normal(n + offset).astype(
        np.float32)).to(cuda)
    data = base[offset:].view(shape)
    before = triple.launches["multiply"]
    got = triple.multiply(data, 0.1, threads=threads)
    torch.cuda.synchronize()
    assert triple.launches["multiply"] == before + 1
    want = triple.multiply_plain(data, 0.1)
    assert torch.equal(got, want)
    # The A/B's designs: K7's measurement builds, the grid-stride kernel.
    for build in examples_ab.BUILDS:
        assert torch.equal(examples_ab.k7_build(data, build, 0.1, threads), want)
    assert torch.equal(examples_ab.k7_grid_stride(data, 0.1, threads), want)
    assert triple.launches["multiply"] == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        triple.multiply(torch.zeros((4, 4), device=cuda).T, 3.0)


def test_examples_run_on_the_card(cuda, monkeypatch, tmp_path, capsys):
    from katsdpsigproc_tpu_torch.examples import (fill_reduce, hello_device, triple, triple_fn,
                                                  triple_op, triple_pallas)

    monkeypatch.setenv("KATSDPSIGPROC_TPU_TORCH_TUNE_DB", str(tmp_path / "tuning.json"))
    before = (triple.launches["multiply"], triple_pallas.launches["triple"])
    for example in (hello_device, triple_fn, triple, triple_pallas, triple_op, fill_reduce):
        example.main([])
    torch.cuda.synchronize()
    assert triple.launches["multiply"] >= before[0] + 3  # triple, and triple_op's two calls
    assert triple_pallas.launches["triple"] == before[1] + 1
    assert "context on cuda" in capsys.readouterr().out


@pytest.mark.parametrize("flagger", ["torch", "hybrid", "fused"])
def test_resource_pipeline_equals_k1_on_each_dump(cuda, flagger):
    from katsdpsigproc_tpu_torch.examples import resource_pipeline as rp
    from katsdpsigproc_tpu_torch.utils import backend

    shape = (300, 12)
    ctx = backend.create_some_context(devices=[cuda])
    results = rp.run(rp.RandomDumps(*shape, seed=3, pin=True), 4, flagger, ctx, shape, "card")
    again = rp.RandomDumps(*shape, seed=3, pin=False)
    for i in range(4):
        host = asyncio.run(again.get(i))  # (channels, baselines, 2)
        k1 = ff.flag_dump(host.transpose(0, 1).contiguous().to(cuda))
        assert np.array_equal(results[i], k1.T.cpu().numpy()), i


# The cost probes K8 and K10 against their plain versions.


def _cost():
    from katsdpsigproc_tpu_torch.scripts import prim_cost, roofline_skeleton

    return prim_cost, roofline_skeleton


@pytest.mark.parametrize("body", [None, "add", "minmax", "mul", "select", "cmp_f32", "roll_lane",
                                  "shift_ch", "reduce", "rank_round", "sqrt"])
@pytest.mark.parametrize("rows,width", [(256, 1024), (5, 96)])
def test_prim_cost_chain_matches_plain(cuda, body, rows, width):
    """Exact, but `reduce`: the kernel sums a row by warp shuffles, so rtol 1e-6."""
    prim_cost, _ = _cost()
    x = prim_cost.block(rows, width, cuda)
    before = prim_cost.launches[body]
    got = prim_cost.chain(x, body, 2, 4)
    want = prim_cost.chain_plain(x, body, 2, 4)
    torch.cuda.synchronize()
    assert prim_cost.launches[body] == before + 1
    if body == "reduce":
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("unroll", [1, 2, 4, 8, 16])
def test_prim_cost_unrolls_and_launches_as_k1(cuda, unroll):
    prim_cost, _ = _cost()
    x = prim_cost.block(8, 256, cuda)
    assert torch.equal(prim_cost.chain(x, "roll_lane", 3, unroll),
                       prim_cost.chain_plain(x, "roll_lane", 3, unroll))
    cfg = prim_cost.launch_config("rank_round", 1024, unroll)  # the strided layout's launch
    assert cfg == dict(ff.strided_launch_config(32768), threads=1024), cfg
    assert cfg["ctas_per_sm"] == 1


def _amplitudes(kind, rows, channels, seed):
    rs = np.random.RandomState(seed)
    if kind == "uniform":
        return rs.uniform(0.25, 0.75, (rows, channels)).astype(np.float32)
    amp = np.ones((rows, channels), np.float32)
    amp[rs.random_sample(amp.shape) < 1.0 / 40.0] = 0.2
    return amp


# K10 on K1's run layout: one tile and partial tiles (12 .. 1025), runs
# shorter than the dilation's reach (C <= 10240: the plainer path) and not
# (10241: a last run of 1 channel, 32768, the limit).
_SKELETON_CHANNELS = (12, 13, 99, 257, 1023, 1024, 1025, 10240, 10241, 32768, "limit")


@pytest.mark.parametrize("channels", _SKELETON_CHANNELS)
@pytest.mark.parametrize("kind", ["uniform", "dips"])
def test_skeleton_matches_plain(cuda, channels, kind):
    """The uint8 output and the rank carry, widths 5, 13 and 31, at the JAX
    scale 0.5 (output 0) and at scale 1 (the output is the dilated flags)."""
    _, rsk = _cost()
    if channels == "limit":
        channels = ff.max_channels()
    rows = 3 if channels > 4096 else 6
    amp = torch.from_numpy(_amplitudes(kind, rows, channels, channels)).to(cuda)
    for width in (w for w in (5, 13, 31) if w <= channels):
        for scale in (0.5, 1.0):
            before = rsk.launches["skeleton"]
            out, rank = rsk.skeleton(amp, width=width, flag_scale=scale, return_rank=True)
            torch.cuda.synchronize()
            assert rsk.launches["skeleton"] == before + 1
            want_out, want_rank = rsk.skeleton_plain(amp, width=width, flag_scale=scale,
                                                     return_rank=True)
            assert torch.equal(out, want_out), (width, scale, int((out != want_out).sum()))
            assert torch.equal(rank.view(torch.int32), want_rank.view(torch.int32)), (width, scale)
            assert torch.equal(rsk.skeleton(amp, width=width, flag_scale=scale), out)


def test_skeleton_launches_as_k1(cuda):
    """K10 launches as K1 does (1024 threads, K1's dynamic shared memory,
    one CTA per SM at 32768 channels) and takes K1's channel limit."""
    _, rsk = _cost()
    for channels in (128, 32768, ff.max_channels()):
        k1 = ff.launch_config(channels)
        cfg = rsk.launch_config(channels)
        assert cfg["threads"] == k1["threads"] and cfg["smem_bytes"] == k1["smem_bytes"], cfg
        if channels == 32768:
            assert cfg == k1 and cfg["ctas_per_sm"] == 1, (cfg, k1)
    with pytest.raises(ValueError, match="limit"):
        rsk.skeleton(torch.zeros((1, ff.max_channels() + 1), device=cuda))


def test_time_queued_times_the_card_not_the_launches(cuda):
    """A kernel shorter than its launch: the queued time is the card's."""
    from katsdpsigproc_tpu_torch.utils import profiling

    x = torch.ones(1024, device=cuda)
    queued, samples = profiling.time_queued({"add": lambda: x + x, "mul": lambda: x * x},
                                            reps=3, iters=20)
    assert len(samples["add"]) == 3
    assert 0 < queued["add"] < 0.02 and 0 < queued["mul"] < 0.02, queued


@pytest.mark.parametrize("complex_data", [False, True])
@pytest.mark.parametrize("average_freq", [1, 4])
def test_twodflag_on_the_card_matches_the_cpu(cuda, complex_data, average_freq):
    """The 2-D flagger on the card flags as it does on the CPU (its window
    sums are ordered adds and its medians exact on both)."""
    from katsdpsigproc_tpu_torch.models.rfi import twodflag
    from katsdpsigproc_tpu_torch.scripts.rfiflagtest import generate_data

    data = generate_data(200, 300, 5)
    if not complex_data:
        data = np.abs(data)
    rs = np.random.RandomState(average_freq)
    flags = rs.random_sample(data.shape) < 0.05
    data[rs.random_sample(data.shape) < 0.01] = np.nan
    flagger = twodflag.SumThresholdFlagger(average_freq=average_freq, freq_chunks=7)
    on_card = flagger.get_flags(data, flags)  # the card by default
    assert on_card.any() and not on_card.all()
    np.testing.assert_array_equal(on_card, flagger.get_flags(data, flags, device="cpu"))


@pytest.mark.parametrize("kind", ["r2c", "c2r", "c2c"])
def test_fft_on_the_card_matches_the_cpu(cuda, kind):
    from katsdpsigproc_tpu_torch.ops import fft
    from katsdpsigproc_tpu_torch.utils import backend

    shape = (6, 1000)
    rs = np.random.RandomState(3)
    real = rs.standard_normal(shape).astype(np.float32)
    spectrum = np.fft.rfft(real).astype(np.complex64)
    cplx = (real + 1j * rs.standard_normal(shape)).astype(np.complex64)
    dtypes, src, mode = {"r2c": ((np.float32, np.complex64), real, fft.FftMode.FORWARD),
                         "c2r": ((np.complex64, np.float32), spectrum, fft.FftMode.INVERSE),
                         "c2c": ((np.complex64, np.complex64), cplx, fft.FftMode.INVERSE)}[kind]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        ctx = backend.DeviceContext(dev)
        op = fft.FftTemplate(ctx, 1, shape, *dtypes).instantiate(None, mode)
        assert op.device == dev
        outs.append(op(src=torch.from_numpy(src).to(dev))["dest"])
    assert outs[0].is_cuda and outs[0].dtype == outs[1].dtype
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].numpy(), rtol=1e-4, atol=1e-2)


def test_fused_template_matches_flag_transposed(cuda):
    vis_t, flags = _dump(2048, 6, seed=31)
    vis_t, flags = vis_t.to(cuda), flags.to(cuda)
    tmpl = ff.FusedFlaggerTemplate(None, width=15, n_windows=5, tuning={"bb": 8, "nref": 2})
    assert tmpl.tuning == {}
    before = ff.launches["flagger"]
    got = tmpl(vis_t, flags, n_sigma=9.0)
    assert ff.launches["flagger"] == before + 1  # K1, not its plain version
    assert torch.equal(got, ff.flag_transposed(vis_t, flags, width=15, n_sigma=9.0, n_windows=5))
    assert torch.equal(got, ff.flag_transposed_plain(vis_t, flags, width=15, n_sigma=9.0,
                                                     n_windows=5))


@pytest.fixture
def nccl_world(cuda):
    """A process group of world size 1 on NCCL (the card's machine has one card)."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


def test_sharded_fused_flagger_runs_k1(nccl_world):
    from katsdpsigproc_tpu_torch.parallel import flagger as pflagger, mesh as pmesh

    vis_t, flags = _dump(4096, 16, seed=41)
    m = pmesh.make_mesh((1,), (pmesh.BASELINE_AXIS,))
    fn = pflagger.make_sharded_fused_flagger(m, bb=8)
    spec = (pmesh.BASELINE_AXIS,)
    local = pmesh.shard_with_spec(m, vis_t, spec)
    local_flags = pmesh.shard_with_spec(m, flags, spec)
    assert local.device == nccl_world
    before = ff.launches["flagger"]
    got, got_flags = fn(local), fn(local, local_flags)
    assert ff.launches["flagger"] == before + 2  # K1, not its plain version
    assert torch.equal(got, ff.flag_dump(vis_t.to(nccl_world))) and got.any()
    assert torch.equal(got_flags, ff.flag_dump(vis_t.to(nccl_world), flags.to(nccl_world)))
    assert torch.equal(pmesh.gather(m, got, spec).cpu(), ff.flag_transposed_plain(vis_t))


def test_sharded_stage_flagger_matches_k1(nccl_world):
    """The (1, 1) mesh's flagger (NCCL all_reduce rounds; halos that only pad)
    equals K1 on a small dump."""
    from katsdpsigproc_tpu_torch.parallel import flagger as pflagger, mesh as pmesh

    vis_t, _ = _dump(2048, 16, seed=42)
    m = pmesh.make_mesh((1, 1), (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS))
    for block in (None, 8):
        fn = pflagger.make_sharded_flagger(m, threshold="sum", baseline_block=block)
        got = fn(pmesh.shard(m, vis_t.transpose(0, 1)))
        assert got.device == nccl_world
        assert torch.equal(got.T, ff.flag_dump(vis_t.to(nccl_world)))


def test_get_flags_sharded_matches_get_flags(nccl_world):
    from katsdpsigproc_tpu_torch.models.rfi import twodflag
    from katsdpsigproc_tpu_torch.parallel import mesh as pmesh

    rs = np.random.RandomState(5)
    shape = (48, 128, 3)
    data = np.abs(rs.standard_normal(shape)).astype(np.float32)
    data[7, 40] = 60.0
    flags = np.zeros(shape, bool)
    flagger = twodflag.SumThresholdFlagger()
    got = flagger.get_flags_sharded(data, flags, pmesh.make_mesh((1,), (pmesh.BASELINE_AXIS,)))
    np.testing.assert_array_equal(got, flagger.get_flags(data, flags))
    assert got[7, 40].all()


def test_regions_on_cuda_tensors(cuda):
    """copy_region between CUDA tensors and from a CPU tensor to one,
    set_region and get_region, each bit for bit numpy's slice assignment."""
    rs = np.random.RandomState(8)
    h_src = (rs.standard_normal((40, 70)) + 1j * rs.standard_normal((40, 70))).astype(
        np.complex64)
    h_dest = (rs.standard_normal((20, 64)) + 0j).astype(np.complex64)
    sr, dr = np.s_[3:35:2, 5:65], np.s_[2:18, 2:62]
    expected = h_dest.copy()
    expected[dr] = h_src[sr]
    for src in (torch.from_numpy(h_src).to(cuda), torch.from_numpy(h_src)):
        dest = torch.from_numpy(h_dest).to(cuda)
        assert regions.copy_region(src, dest, sr, dr) is dest
        assert torch.equal(dest.cpu(), torch.from_numpy(expected))
    dest = torch.from_numpy(h_dest).to(cuda)
    regions.set_region(dest, h_src, dr, sr)
    assert torch.equal(dest.cpu(), torch.from_numpy(expected))
    ary = h_dest.copy()
    regions.get_region(torch.from_numpy(h_src).to(cuda), ary, sr, dr)
    np.testing.assert_array_equal(ary.view(np.uint64), expected.view(np.uint64))
    with pytest.raises(TypeError, match="dtype mismatch"):
        regions.set_region(dest, h_src.astype(np.complex128), dr, sr)


def test_plugin_lists_the_card(cuda, tmp_path):
    """The port's plugin in a subprocess (--noconftest), first-per-api: cuda:0
    and the CPU; cuda_only runs on cuda:0."""
    outcomes, proc = run_plugin(tmp_path)
    assert proc.returncode == 0, proc.stdout
    assert outcomes["test_device[cuda:0]"] == outcomes["test_device[cpu]"] == "PASSED"
    assert outcomes["test_cuda_only[cuda:0]"] == "PASSED"
    assert outcomes["test_cpu_only[cpu]"] == "PASSED"
    assert outcomes["test_context[cuda:0]"] == "PASSED"
    assert not any("cuda:1" in name for name in outcomes)


def test_cuda_test_runs_on_the_card(cuda):
    seen = []

    @test_accel.device_test
    @test_accel.cuda_test
    def my_test(context, device):
        seen.append(device)
        return torch.ones(4, device=device).sum().item()

    assert my_test() == 4.0
    assert seen == [torch.device("cuda", 0)]


def _harness(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    err = capsys.readouterr().err
    assert exit_info.value.code == 0, err
    return err


def test_transposetest_at_the_reference_size(cuda, capsys):
    """3072 x 8320 complex64 through K5: the whole output equals numpy's .T;
    one K5 launch for the checked call and each of time_fn's 2 warm-ups and
    3 timed calls."""
    before = tr.launches["transpose"]
    err = _harness(transposetest.main, ["--engine", "cuda", "--iters", "3"], capsys)
    assert "engine: cuda" in err and "Mismatches: 0 / 25559040" in err, err
    assert tr.launches["transpose"] - before == 6


def test_percentiletest_at_the_reference_size(cuda, capsys):
    """4000 x 5000 through K4, exactly numpy's lower percentiles; one K4 launch
    a call, as for K5."""
    before = pct.launches["percentile5"]
    err = _harness(percentiletest.main, ["--engine", "cuda", "--iters", "3"], capsys)
    assert "engine: cuda" in err and "exact match vs np.percentile(..., 'lower')" in err, err
    assert pct.launches["percentile5"] - before == 6
