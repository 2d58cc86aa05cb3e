"""The port's fused flagger (katsdpsigproc_tpu_torch.models.rfi.fused_flagger)
on the CPU, where each wrapper takes its plain PyTorch version, against the
JAX Pallas kernels in interpret mode, the JAX engines and the host oracles.

Tolerance: exact on every uint8 mask.  The JAX kernels run under jit,
where XLA on the CPU contracts re*re + im*im into an FMA (see
tests/test_torch_device.py); at these sizes no amplitude sits close
enough to a threshold or a median tie for that ulp to flip a flag, and
the masks are compared bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import device as jdev, host as jhost, pallas_flagger as jpf
from katsdpsigproc_tpu_torch.models.rfi import device as tdev, fused_flagger as ff, host as thost
from katsdpsigproc_tpu_torch.pytest_plugin import patch_autotune  # noqa: F401
from katsdpsigproc_tpu_torch.scripts import common
from katsdpsigproc_tpu_torch.utils import tune

from .helpers import rfi_test_data

ROOT = Path(__file__).resolve().parent.parent
PARAMS = dict(width=13, n_sigma=11.0, n_windows=4, falloff=1.2, flag_value=1)


def _host_flagger(host, n_windows=4):
    return host.FlaggerHost(host.BackgroundMedianFilterHost(13), host.NoiseEstMADHost(),
                            host.ThresholdSumHost(11.0, n_windows=n_windows))


def _vis_t(vis):
    return np.moveaxis(jdev.to_planar(vis), 0, 1).copy()  # (B, C, 2)


@pytest.mark.parametrize("channels,baselines", [(128, 16), (300, 8), (99, 8), (257, 8)])
def test_flag_transposed_matches_pallas_and_host(channels, baselines):
    # 99/257 channels flip the right-edge fill parity of the fast path.
    vis, _, _ = rfi_test_data(shape=(channels, baselines), seed=3)
    vt = _vis_t(vis)
    got = ff.flag_transposed(torch.from_numpy(vt), **PARAMS)
    want = jpf.flag_transposed(jnp.asarray(vt), bb=baselines, interpret=True, **PARAMS)
    assert got.dtype == torch.uint8 and got.shape == (baselines, channels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().T, _host_flagger(thost)(vis))


def test_flag_transposed_matches_pallas_dma():
    rs = np.random.RandomState(3)
    vt = rs.standard_normal((16, 300, 2)).astype(np.float32)
    vt[:, 120, :] *= 40.0
    got = ff.flag_transposed(torch.from_numpy(vt), **PARAMS)
    want = jpf.flag_transposed_dma(jnp.asarray(vt), bb=8, interpret=True, **PARAMS)
    assert got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_large_windows_and_flag_value_match_pallas():
    vis, _, _ = rfi_test_data(shape=(384, 8), seed=11)
    vt = _vis_t(vis)
    kw = {**PARAMS, "n_windows": 6, "flag_value": 3}
    got = ff.flag_transposed(torch.from_numpy(vt), **kw)
    want = jpf.flag_transposed(jnp.asarray(vt), bb=8, fold=128, interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().T, 3 * _host_flagger(thost, n_windows=6)(vis))


@pytest.mark.parametrize("mode", ["full", "channel"])
def test_input_flags_match_pallas_and_host(mode):
    vis, _, input_flags = rfi_test_data(shape=(256, 8), seed=6)
    vt = torch.from_numpy(_vis_t(vis))
    if mode == "channel":
        host_arg = input_flags[:, 0]
        kw = {"channel_flags": host_arg.astype(np.uint8)}
    else:
        host_arg = input_flags
        kw = {"input_flags": input_flags.T.astype(np.uint8).copy()}
    got = ff.flag_transposed(vt, **{k: torch.from_numpy(v) for k, v in kw.items()}, **PARAMS)
    want = jpf.flag_transposed(jnp.asarray(vt.numpy()), bb=8, fold=128, interpret=True,
                               **{k: jnp.asarray(v) for k, v in kw.items()}, **PARAMS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().T, _host_flagger(jhost)(vis, host_arg))


@pytest.mark.parametrize("nref", [1, 2])
def test_madnz_threshold_matches_pallas(nref):
    rs = np.random.RandomState(13)
    dev_t = rs.standard_normal((16, 256)).astype(np.float32)
    dev_t[:, 80] += 30.0
    kw = dict(n_sigma=11.0, n_windows=4, falloff=1.2, flag_value=1)
    got = ff.madnz_threshold(torch.from_numpy(dev_t), **kw)
    want = jpf.madnz_threshold(jnp.asarray(dev_t), bb=4, fold=128, interpret=True, nref=nref,
                               **kw)
    assert got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ff.madnz_threshold_plain(torch.from_numpy(dev_t), **kw).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("channels", [1, 13, 99, 1023, 1024, 1025, 4097])
def test_madnz_threshold_plain_matches_pallas_on_adversarial_deviations(channels):
    """Deviations K1 never makes (NaN, +-inf, -0, all-zero and all-NaN rows;
    no denormals, which XLA on the CPU flushes to zero), at one channel,
    fewer channels than a window and around K2's 1024-thread CTA."""
    dev_t = common.adversarial_deviations(8, channels, channels, denormals=False)
    for kw in (dict(n_sigma=11.0, n_windows=4, falloff=1.2, flag_value=1),
               dict(n_sigma=5.0, n_windows=6, falloff=1.2, flag_value=3)):
        got = ff.madnz_threshold_plain(torch.from_numpy(dev_t), **kw)
        want = jpf.madnz_threshold(jnp.asarray(dev_t), bb=8, interpret=True, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ff.madnz_threshold(torch.from_numpy(dev_t), **kw).numpy(),
                                      got.numpy())


def _seed1_dump(channels=512, rows=64):
    """The benchmark's seed-1 dump recipe (bench.py:361-366) at a small size."""
    rs = np.random.RandomState(seed=1)
    shape = (channels, rows)
    vis = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    spikes = rs.random_sample(shape) < 1.0 / 64.0
    vis += spikes * (rs.random_sample(shape) * 20.0 + 50.0)
    return vis


def test_slice_matches_jax_engines_and_host_oracles():
    """The whole slice: flag_dump on the corner-turned dump and make_flagger_fn
    ("torch", "hybrid") on the channel-major (512, 64, 2) seed-1 dump equal the
    JAX engine, the JAX host oracle and the port's host copy."""
    vis = _seed1_dump()
    planar = jdev.to_planar(vis)  # (C, B, 2)
    expected = _host_flagger(jhost)(vis)
    np.testing.assert_array_equal(_host_flagger(thost)(vis), expected)
    assert expected.any()
    jax_xla = np.asarray(jdev.make_flagger_fn(13, 11.0)(jnp.asarray(planar)))
    np.testing.assert_array_equal(jax_xla, expected)
    vis_c = torch.from_numpy(planar)
    dump = ff.flag_dump(vis_c.transpose(0, 1).contiguous(), **PARAMS)
    np.testing.assert_array_equal(dump.numpy().T, expected)
    for engine, block in [("torch", None), ("hybrid", None), ("hybrid", 24)]:
        fn = tdev.make_flagger_fn(13, 11.0, engine=engine, baseline_block=block)
        np.testing.assert_array_equal(fn(vis_c).numpy(), expected, err_msg=engine)


def test_hybrid_engine_matches_jax_hybrid():
    vis, _, _ = rfi_test_data(shape=(256, 16), seed=15)
    planar = jdev.to_planar(vis)
    ref = jdev.make_flagger_fn(13, 11.0, engine="hybrid",
                               pallas_kw=dict(bb=4, fold=128, interpret=True))
    got = tdev.make_flagger_fn(13, 11.0, engine="hybrid")(torch.from_numpy(planar))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(jnp.asarray(planar))))


def test_cpu_tensors_take_the_plain_versions():
    vis, _, _ = rfi_test_data(shape=(128, 8), seed=4)
    vt = torch.from_numpy(_vis_t(vis))
    before = dict(ff.launches)
    np.testing.assert_array_equal(ff.flag_transposed(vt).numpy(),
                                  ff.flag_transposed_plain(vt).numpy())
    assert ff.launches == before  # no kernel ran, so nothing was counted


def test_validation():
    vt = torch.zeros((4, 64, 2))
    with pytest.raises(ValueError, match="not both"):
        ff.flag_transposed(vt, torch.zeros((4, 64), dtype=torch.uint8),
                           channel_flags=torch.zeros(64, dtype=torch.uint8))
    with pytest.raises(ValueError, match="width"):
        ff.flag_transposed(vt, width=12)
    with pytest.raises(ValueError, match="flag_value"):
        ff.flag_transposed(vt, flag_value=256)
    with pytest.raises(TypeError, match="float32"):
        ff.flag_transposed(vt.double())
    with pytest.raises(ValueError, match="shape"):
        ff.flag_transposed(vt, torch.zeros((4, 63), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        ff.flag_transposed(vt, channel_flags=torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows, channels, 2"):
        ff.flag_transposed(torch.zeros((4, 64)))
    with pytest.raises(TypeError, match="float32"):
        ff.madnz_threshold(torch.zeros((4, 64), dtype=torch.float64))


@pytest.mark.parametrize("rank_radix", [0, 5, 8])
def test_rank_radix_validation(rank_radix):
    """As the JAX package's test_rank_radix_validation: a rank_radix outside
    1..4 raises ValueError in flag_transposed and madnz_threshold, before
    the wrapper looks at the tensor's device."""
    vis, _, _ = rfi_test_data(shape=(128, 8), seed=10)
    vt = _vis_t(vis)
    dev_t = np.random.RandomState(10).standard_normal((8, 128)).astype(np.float32)
    with pytest.raises(ValueError, match="rank_radix"):
        jpf.flag_transposed(jnp.asarray(vt), bb=8, interpret=True, rank_radix=rank_radix)
    with pytest.raises(ValueError, match="rank_radix"):
        jpf.madnz_threshold(jnp.asarray(dev_t), bb=8, interpret=True, rank_radix=rank_radix)
    with pytest.raises(ValueError, match="rank_radix"):
        ff.flag_transposed(torch.from_numpy(vt), rank_radix=rank_radix)
    with pytest.raises(ValueError, match="rank_radix"):
        ff.madnz_threshold(torch.from_numpy(dev_t), rank_radix=rank_radix)
    with pytest.raises(ValueError, match="rank_radix"):  # not a tensor the port takes
        ff.madnz_threshold(torch.zeros((8, 128), dtype=torch.float16), rank_radix=rank_radix)


@pytest.mark.parametrize("rank_radix", [1, 2, 3, 4])
def test_rank_radix_1_to_4_is_accepted_and_ignored(rank_radix):
    vis, _, _ = rfi_test_data(shape=(128, 8), seed=10)
    vt = torch.from_numpy(_vis_t(vis))
    np.testing.assert_array_equal(ff.flag_transposed(vt, rank_radix=rank_radix).numpy(),
                                  ff.flag_transposed(vt).numpy())
    dev_t = torch.from_numpy(common.adversarial_deviations(8, 128, 10, denormals=False))
    np.testing.assert_array_equal(ff.madnz_threshold(dev_t, rank_radix=rank_radix).numpy(),
                                  ff.madnz_threshold(dev_t).numpy())


def _spiked_vis_t(rows: int, channels: int, seed: int = 1) -> np.ndarray:
    """(rows, channels, 2) standard-normal float32, channel 100 scaled by 50."""
    vt = np.random.default_rng(seed).standard_normal((rows, channels, 2)).astype(np.float32)
    vt[:, 100] *= 50.0
    return vt


def _host_flags(vt: np.ndarray, width: int) -> np.ndarray:
    vis = (vt[..., 0] + 1j * vt[..., 1]).T  # (channels, rows) complex
    return thost.FlaggerHost(thost.BackgroundMedianFilterHost(width), thost.NoiseEstMADHost(),
                             thost.ThresholdSumHost(11.0))(vis).T


@pytest.mark.parametrize("width", [33, 35, 41])
def test_wide_windows_match_pallas_and_host(width):
    """Every odd width flags as the JAX kernel and the host oracle do: the
    port once refused widths above 31, which the JAX function takes."""
    vt = _spiked_vis_t(8, 256)
    got = ff.flag_transposed(torch.from_numpy(vt), **{**PARAMS, "width": width})
    want = jpf.flag_transposed(jnp.asarray(vt), bb=8, fold=256, interpret=True,
                               **{**PARAMS, "width": width})
    assert got.numpy()[:, 100].all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), _host_flags(vt, width))


def test_rows_above_the_card_limit_take_the_wide_path():
    """A row longer than the run layout holds on the H100 (52310 channels)
    goes to the wide-row path on the card, and on the CPU to the plain
    version, whose flags are the host oracle's; so does a window too wide
    for the run layout's in-place median."""
    limit = 52310
    assert not ff._wide_path(limit, limit) and ff._wide_path(limit + 1, limit)
    assert ff._wide_path(65537, limit) and ff._wide_path(1024, limit, width=67)
    assert not ff._wide_path(1024, limit, width=ff.IN_PLACE_MAX_WIDTH)
    vt = _spiked_vis_t(2, 65537, seed=2)
    before = dict(ff.launches), dict(ff.wide_launches), dict(ff.k1_ctas)
    got = ff.flag_transposed(torch.from_numpy(vt))
    assert got.shape == (2, 65537) and got.numpy()[:, 100].all()
    np.testing.assert_array_equal(got.numpy(), _host_flags(vt, 13))
    assert (ff.launches, ff.wide_launches, ff.k1_ctas) == before  # no kernel ran on the CPU


# K1's CTA size as a function of the row's length alone: the fewest threads
# whose rank search holds the row in registers, 32 channels a thread, and
# 1024 for rows past 32768 channels (the H100's run-layout limit is 52310).
@pytest.mark.parametrize("channels, threads", [
    (1, 128), (4096, 128), (4097, 256), (8192, 256), (8193, 512), (16384, 512),
    (16385, 1024), (32768, 1024), (32769, 1024), (52310, 1024)])
def test_k1_threads_at_the_rule_s_boundaries(channels, threads):
    assert ff.k1_threads(channels) == threads


@pytest.mark.parametrize("threads", ff.K1_THREADS)
def test_k1_threads_gives_no_run_over_32_channels(threads):
    """Each CTA size takes one unbroken range of rows up to 32768 channels,
    every one of them in runs of at most 32 channels (ceil(C / threads)),
    so SumThreshold's register path takes all four windows of 1-8 wherever
    a run is 7 channels or more; a row fills its rank search's registers
    only at the top of its range."""
    rows = [c for c in range(1, 32769) if ff.k1_threads(c) == threads]
    first = 1 if threads == ff.K1_THREADS[0] else ff.RANK_REGS * threads // 2 + 1
    assert rows == list(range(first, ff.RANK_REGS * threads + 1))
    assert max(-(-c // threads) for c in rows) == ff.RANK_REGS == 32


def test_network_header_renders_the_port_networks():
    text = ff._network_header(13)
    assert "#define FF_WIDTH 13" in text
    fast = next(line for line in text.splitlines() if line.startswith("#define FF_NET_FAST"))
    assert fast.count("FF_CE_") == len(tdev.rank_ops.selection_network(13, (6, 7)))
    assert "FF_CE_BOTH(w, 0, 8) FF_CE_BOTH(w, 0, 12)" in fast
    # Above the widest window whose members sit in registers, the kernel
    # counts the median's ranks instead of running a network.
    wide = ff._network_header(ff.REGISTER_MAX_WIDTH + 2)
    assert "#define FF_MEDIAN_COUNT" in wide and "FF_NET_FAST" not in wide
    assert "FF_NET_FAST" in ff._network_header(ff.REGISTER_MAX_WIDTH)


def test_port_runs_without_jax():
    """A subprocess where `import jax` fails imports the port and flags a dump."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "import katsdpsigproc_tpu_torch as port\n"
        "from katsdpsigproc_tpu_torch.models.rfi import fused_flagger, device, twodflag\n"
        "from katsdpsigproc_tpu_torch.ops import fft\n"
        "from katsdpsigproc_tpu_torch.scripts import fftflagtest, rfiflagtest\n"
        "import katsdpsigproc_tpu_torch.parallel\n"
        "from katsdpsigproc_tpu_torch.parallel import collectives, flagger, mesh, multihost\n"
        "rs = np.random.RandomState(0)\n"
        "v = rs.standard_normal((8, 96, 2)).astype(np.float32); v[:, 40] *= 50\n"
        "f = fused_flagger.flag_dump(torch.from_numpy(v))\n"
        "assert f.shape == (8, 96) and f[:, 40].all(), f\n"
        "t = fused_flagger.FusedFlaggerTemplate(None, tuning={'bb': 8})\n"
        "assert (t(torch.from_numpy(v)) == f).all()\n"
        "a = np.abs(rs.standard_normal((16, 32, 2))).astype(np.float32); a[5, 9] = 60\n"
        "g = twodflag.SumThresholdFlagger().get_flags(a, np.zeros(a.shape, bool), device='cpu')\n"
        "assert g[5, 9].all(), g\n"
        "op = fft.FftTemplate(None, 1, (4, 16), np.float32, np.complex64).instantiate()\n"
        "assert op(src=torch.ones((4, 16)))['dest'][0, 0] == 16\n"
        "assert 'katsdpsigproc_tpu' not in sys.modules\n"
        "print('ok', port.__version__, port.MAD_NORMAL)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok 0.5.0 1.4826")


def test_fused_template_tuning_override(monkeypatch):
    """The template honours an explicit JAX tuning dict without a search: its
    TPU knobs (bb, nref) are dropped, and it flags as flag_transposed does.
    (The port of tests/rfi/test_pallas_flagger.py::test_fused_template_tuning_override.)"""
    vis, _, _ = rfi_test_data(shape=(256, 16), seed=17)
    vt = _vis_t(vis)

    def no_search(*args, **kwargs):
        raise AssertionError("the template searched")

    monkeypatch.setattr(tune, "autotuner_impl", no_search)
    tmpl = ff.FusedFlaggerTemplate(None, tuning={"bb": 8, "nref": 2})
    assert tmpl.tuning == {}
    got = tmpl(torch.from_numpy(vt))
    np.testing.assert_array_equal(got.numpy(), ff.flag_transposed(torch.from_numpy(vt)).numpy())
    want = jpf.FusedFlaggerTemplate(None, tuning={"bb": 8, "nref": 2})(jnp.asarray(vt),
                                                                       interpret=True)
    assert got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["none", "full", "channel"])
def test_fused_template_parameters_match_jax(mode):
    """Width, windows, falloff and flag value from the template, n_sigma and
    the flags from the call, as in the JAX template (whose shipped TPU
    record the port maps to no knobs)."""
    from katsdpsigproc_tpu.utils import tune as jtune

    record = next(r["result"] for r in json.load(open(os.path.join(
        os.path.dirname(jtune.__file__), "tuning_table.json")))
        if r["fn"] == "FusedFlaggerTemplate.autotune")
    assert tune.from_jax_tuning(record) == {}
    vis, _, input_flags = rfi_test_data(shape=(200, 8), seed=24)
    vt = _vis_t(vis)
    flags = input_flags.T.astype(np.uint8).copy()
    kw = {"none": {}, "full": {"input_flags": flags},
          "channel": {"channel_flags": flags[0].copy()}}[mode]
    params = dict(width=9, n_windows=5, threshold_falloff=1.3, flag_value=3)
    got = ff.FusedFlaggerTemplate(None, tuning=record, **params)(
        torch.from_numpy(vt), n_sigma=9.0, **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = jpf.FusedFlaggerTemplate(None, tuning={"bb": 8, "fold": 128}, **params)(
        jnp.asarray(vt), n_sigma=9.0, interpret=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    assert (got.numpy() == 3).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_template_resolves_its_tuning(patch_autotune):
    """Without `tuning`, the template asks its autotuner (stubbed here) and keeps no knob."""
    assert ff.FusedFlaggerTemplate(None).tuning == {}


def test_positional_parameters_in_the_jax_order():
    """The JAX functions' parameters by position, TPU knobs included: the
    port takes and ignores `slab`, `bb`, `fold` and `interpret`."""
    vis, _, input_flags = rfi_test_data(shape=(256, 16), seed=21)
    vt = _vis_t(vis)
    flags = input_flags.T.astype(np.uint8).copy()
    v, f = torch.from_numpy(vt), torch.from_numpy(flags)
    jv, jf = jnp.asarray(vt), jnp.asarray(flags)
    # flag_dump(vis_t, input_flags, slab, width, n_sigma, n_windows, falloff, flag_value,
    #           bb, fold, interpret)
    got = ff.flag_dump(v, None, 256, 13, 11.0, 4, 1.2, 1, 8, 128, True)
    want = jpf.flag_dump(jv, None, 256, 13, 11.0, 4, 1.2, 1, 8, 128, True)
    assert got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ff.flag_dump(v, None, 256, 13, 11.0, 4, 1.2, 1).numpy(),
                                  got.numpy())
    # flag_transposed(vis_t, input_flags, width, n_sigma, n_windows, falloff, flag_value,
    #                 bb, fold, interpret)
    got = ff.flag_transposed(v, f, 13, 11.0, 5, 1.2, 2, 8, 128, True)
    want = jpf.flag_transposed(jv, jf, 13, 11.0, 5, 1.2, 2, 8, 128, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # madnz_threshold(dev_t, n_sigma, n_windows, falloff, flag_value, bb, fold, interpret)
    rs = np.random.RandomState(22)
    dev_t = rs.standard_normal((16, 256)).astype(np.float32)
    dev_t[:, 90:93] += 9.0
    got = ff.madnz_threshold(torch.from_numpy(dev_t), 11.0, 4, 1.2, 1, 4, 128, True)
    want = jpf.madnz_threshold(jnp.asarray(dev_t), 11.0, 4, 1.2, 1, 4, 128, True)
    assert got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_strided_views_flag_as_their_copies():
    """The bench's flag_dump(swapaxes(v, 0, 1)) of a channel-major dump."""
    vis, _, _ = rfi_test_data(shape=(128, 8), seed=23)
    planar = torch.from_numpy(jdev.to_planar(vis))  # (C, B, 2)
    want = ff.flag_dump(planar.transpose(0, 1).contiguous())
    np.testing.assert_array_equal(ff.flag_dump(planar.transpose(0, 1)).numpy(), want.numpy())
    dev = torch.from_numpy(np.random.RandomState(24).standard_normal((128, 8)).astype(np.float32))
    np.testing.assert_array_equal(ff.madnz_threshold(dev.T).numpy(),
                                  ff.madnz_threshold(dev.T.contiguous()).numpy())


@pytest.mark.parametrize("kw", [{"layout": "leading"}, {"ingest": "amp"}])
def test_leading_layout_and_amp_ingest_match_pallas(kw):
    """The JAX package's other input forms give its flags, FULL flags too."""
    vis, _, input_flags = rfi_test_data(shape=(128, 8), seed=25)
    vt = np.ascontiguousarray(np.moveaxis(jdev.to_planar(vis), 0, 1))  # (B, C, 2)
    if kw.get("layout") == "leading":
        vt = np.ascontiguousarray(np.moveaxis(vt, -1, 0))  # (2, B, C)
    f_t = np.ascontiguousarray(input_flags.T)
    for flags in (None, f_t):
        jargs = [jnp.asarray(vt)] + ([] if flags is None else [jnp.asarray(flags)])
        targs = [torch.from_numpy(vt)] + ([] if flags is None else [torch.from_numpy(flags)])
        want = np.asarray(jpf.flag_transposed(*jargs, bb=8, interpret=True, **kw))
        np.testing.assert_array_equal(ff.flag_transposed(*targs, **kw).numpy(), want)
        np.testing.assert_array_equal(ff.flag_dump(*targs, **kw).numpy(), want)


def _tree_sum(x, c: int, level: int):
    """The reference's window sum from c, by its definition: Kogge-Stone tree order."""
    if level == 0:
        return x[c]
    half = 1 << (level - 1)
    return np.float32(_tree_sum(x, c, level - 1) + _tree_sum(x, c + half, level - 1))


def _doubling_sums(x, window: int, chunk: int = 8):
    """Window sums as K1's run layout builds them: chunks of `chunk` starts,
    each from chunk + window - 1 values by s_2m[i] = s_m[i] + s_m[i + m]."""
    n = len(x) - window + 1
    padded = np.concatenate([x, np.full(chunk, np.nan, np.float32)])  # never summed into a start
    out = np.empty(n, np.float32)
    for k0 in range(0, n, chunk):
        s = padded[k0:k0 + chunk + window - 1].copy()
        m = 1
        while m < window:
            top = len(s) - 2 * m + 1
            s[:top] = s[:top] + s[m:m + top]  # reads s_m[i + m] before it is overwritten
            m *= 2
        out[k0:k0 + chunk] = s[:chunk][:n - k0]
    return out


def _run_layout_threshold_sum(dev, noise, n_sigma, n_windows, falloff):
    """SumThreshold on one row as K1's run layout does it: doubling window
    sums over the clamped values, and the dilation by shift-OR doubling."""
    channels = len(dev)
    flags = np.zeros(channels, bool)
    base = np.float32(np.float32(n_sigma) * noise)
    for w in range(n_windows):
        window = 1 << w
        if window > channels:
            break
        thr = np.float32(base * np.float32(falloff ** -w))
        clamped = np.where(flags, thr, dev).astype(np.float32)
        hits = _doubling_sums(clamped, window) > np.float32(thr * np.float32(window))
        dilated = np.concatenate([hits, np.zeros(window - 1, bool)])
        m = 1
        while m < window:  # d_2m = d_m | d_m << m
            dilated[m:] |= dilated[:-m].copy()
            m *= 2
        flags |= dilated
    return flags


def test_doubling_window_sums_are_the_tree_sums_bit_for_bit():
    """The identity K1's SumThreshold rests on, in float32: the doubling
    recurrence gives the Kogge-Stone tree sums of the reference for windows
    1-32, and so the flags of device.threshold_sum."""
    rs = np.random.RandomState(31)
    channels = 301
    dev = (rs.standard_normal(channels) * 10.0 ** rs.uniform(-3, 3, channels)).astype(np.float32)
    flagged = rs.random_sample(channels) < 0.2
    clamped = np.where(flagged, np.float32(2.5), dev).astype(np.float32)
    left_to_right = 0
    for level in range(6):
        window = 1 << level
        got = _doubling_sums(clamped, window)
        want = np.array([_tree_sum(clamped, c, level) for c in range(channels - window + 1)],
                        np.float32)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=window)
        sequential = np.array([np.cumsum(clamped[c:c + window], dtype=np.float32)[-1]
                               for c in range(channels - window + 1)], np.float32)
        left_to_right += int((sequential != want).sum())
    assert left_to_right > 0  # the order matters on these values, so the test can see it
    for n_windows in (4, 6):
        row = rs.standard_normal((4, channels)).astype(np.float32)
        row[:, 100:104] += 1.5
        row[:, 200] += 9.0
        noise = torch.from_numpy(np.full(4, 0.3, np.float32))
        want = tdev.threshold_sum(torch.from_numpy(row), noise, 4.0, n_windows, 1.2, 1,
                                  transposed=True).numpy()
        got = np.stack([_run_layout_threshold_sum(r, np.float32(0.3), 4.0, n_windows, 1.2)
                        for r in row])
        assert want.any()
        np.testing.assert_array_equal(got.astype(np.uint8), want)
