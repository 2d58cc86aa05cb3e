"""The port's stage templates, FlaggerDevice and *HostFromDevice wrappers
(katsdpsigproc_tpu_torch.models.rfi.device) against the numpy host oracle
and the JAX package's FlaggerDevice, on the CPU.

The cases of ``tests/rfi/test_device.py`` for stages, flaggers and
wrappers, with the same inputs (numpy, seeded) given to the port, the
oracle and the JAX package.

Tolerances.  Masks: bit for bit against the oracle and the JAX
FlaggerDevice.  Noise: exact against JAX, rtol 1e-5 against the oracle
(as the JAX test allows).  Deviations: atol 1e-6 against the oracle (as
the JAX test allows), and bit for bit against the JAX stage run eagerly.
The JAX templates run their stages under ``jax.jit``, where XLA on the CPU
may contract and reassociate float32 arithmetic (ROADMAP Queue 3,
``test_amplitude_contraction_under_jit``); against them deviations are
held to 2 ulp of their scale, and the masks stay bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import device as jdev, host as jhost
from katsdpsigproc_tpu_torch.models.rfi import device, host
from katsdpsigproc_tpu_torch.pytest_plugin import patch_autotune  # noqa: F401

from .helpers import complex_normal, rfi_test_data
from .torch_helpers import inexact_float64_sqrt

MODES = [device.BackgroundFlags.NONE, device.BackgroundFlags.CHANNEL,
         device.BackgroundFlags.FULL]


@pytest.fixture
def ctx(patch_autotune):  # noqa: F811
    from katsdpsigproc_tpu_torch.utils import backend

    return backend.create_some_context()


@pytest.fixture(scope="module")
def big_data():
    shape = (417, 313)
    rs = np.random.RandomState(seed=1)
    vis = complex_normal(rs, size=shape).astype(np.complex64)
    flags = (rs.random_sample(shape) < 0.1).astype(np.uint8)
    flags[100:110, 0:100] = 4  # entire windows flagged; non-0/1 flag values
    return vis, flags


def _flag_arg(use_flags, flags):
    if not use_flags:
        return None
    return flags if use_flags == device.BackgroundFlags.FULL else flags[:, 0].copy()


class TestBackgroundDevice:
    @pytest.mark.parametrize("amplitudes", [False, True])
    @pytest.mark.parametrize("use_flags", MODES)
    def test_vs_host_and_jax(self, ctx, big_data, amplitudes, use_flags):
        width = 5
        vis, flags = big_data
        if amplitudes:
            vis = np.abs(vis)
        f = _flag_arg(use_flags, flags)
        template = device.BackgroundMedianFilterDeviceTemplate(ctx, width, amplitudes, use_flags)
        assert template.host_class is host.BackgroundMedianFilterHost
        out = device.BackgroundHostFromDevice(template)(vis, f)
        np.testing.assert_allclose(template.host_class(width, amplitudes)(vis, f), out, atol=1e-6)
        # The JAX stage run eagerly (no jit contraction): bit for bit.  It
        # takes numpy's amplitudes, which the port's complex amplitude equals
        # (test_complex_amplitude_is_numpys).
        jflags = None if f is None else jnp.asarray(f)
        want = jdev.background_median_filter(jnp.asarray(np.abs(vis)), jflags, width, True,
                                             jdev.BackgroundFlags[use_flags.name])
        np.testing.assert_array_equal(out, np.asarray(want))

    @pytest.mark.parametrize("use_flags", MODES)
    def test_vs_jax_with_inexact_float64_roots(self, ctx, big_data, use_flags, monkeypatch):
        """The complex amplitude stays numpy's, so the deviations stay the JAX
        stage's bit for bit, when PyTorch's float64 square root is off in its
        last bits, as MKL's first call in a process returned it on the CPU
        (ROADMAP Queue 3: 59 deviations moved by one ulp)."""
        inexact_float64_sqrt(monkeypatch)
        vis, flags = big_data
        f = _flag_arg(use_flags, flags)
        template = device.BackgroundMedianFilterDeviceTemplate(ctx, 5, False, use_flags)
        out = device.BackgroundHostFromDevice(template)(vis, f)
        jflags = None if f is None else jnp.asarray(f)
        want = jdev.background_median_filter(jnp.asarray(np.abs(vis)), jflags, 5, True,
                                             jdev.BackgroundFlags[use_flags.name])
        np.testing.assert_array_equal(out, np.asarray(want))

    def test_use_flags_validation(self, ctx):
        with pytest.raises(TypeError):
            device.BackgroundMedianFilterDeviceTemplate(ctx, 5, use_flags="yes")
        t = device.BackgroundMedianFilterDeviceTemplate(ctx, 5, use_flags=True)
        assert t.use_flags == device.BackgroundFlags.CHANNEL
        t = device.BackgroundMedianFilterDeviceTemplate(ctx, 5, use_flags=False)
        assert t.use_flags == device.BackgroundFlags.NONE

    def test_flag_mismatch_raises(self, ctx):
        wrapper = device.BackgroundHostFromDevice(
            device.BackgroundMedianFilterDeviceTemplate(ctx, 5))
        with pytest.raises(TypeError):
            wrapper(np.zeros((8, 4), np.complex64), np.zeros(8, np.uint8))
        flagged = device.BackgroundHostFromDevice(
            device.BackgroundMedianFilterDeviceTemplate(ctx, 5, use_flags=True))
        with pytest.raises(TypeError):
            flagged(np.zeros((8, 4), np.complex64))

    def test_engine_knob_is_consumed(self, ctx, big_data):
        vis, _ = big_data
        bogus = device.BackgroundMedianFilterDeviceTemplate(ctx, 5, tuning={"engine": "bogus"})
        with pytest.raises(ValueError, match="unknown engine"):
            device.BackgroundHostFromDevice(bogus)(vis)
        outs = [device.BackgroundHostFromDevice(device.BackgroundMedianFilterDeviceTemplate(
            ctx, 5, tuning={"engine": engine}))(vis) for engine in ("network", "count")]
        np.testing.assert_array_equal(outs[0], outs[1])


class TestNoiseEstDevice:
    @pytest.mark.parametrize("transposed", [False, True])
    def test_vs_host_and_jax(self, ctx, transposed):
        shape = (367, 93)
        rs = np.random.RandomState(seed=2)
        deviations = np.abs(rs.standard_normal(shape)).astype(np.float32)
        deviations[rs.random_sample(shape) < 0.05] = 0.0  # zeros leave the median
        if transposed:
            template = device.NoiseEstMADTDeviceTemplate(ctx, 1024)
            jtemplate = jdev.NoiseEstMADTDeviceTemplate(None, 1024, tuning={"radix_bits": 4})
        else:
            template = device.NoiseEstMADDeviceTemplate(ctx)
            jtemplate = jdev.NoiseEstMADDeviceTemplate(None, tuning={"radix_bits": 4})
        out = device.NoiseEstHostFromDevice(template)(deviations)
        np.testing.assert_allclose(template.host_class()(deviations), out, rtol=1e-5)
        np.testing.assert_array_equal(out, jdev.NoiseEstHostFromDevice(jtemplate)(deviations))

    def test_max_channels(self, ctx):
        with pytest.raises(ValueError):
            device.NoiseEstMADTDeviceTemplate(ctx, 64).instantiate(None, 128, 4)

    @pytest.mark.parametrize("template_cls", [device.NoiseEstMADTDeviceTemplate,
                                              device.NoiseEstMADDeviceTemplate])
    def test_radix_knob_is_consumed(self, ctx, template_cls, monkeypatch):
        seen = []
        orig = device.rank_ops.median_non_zero

        def spy(values, n=None, *args, **kwargs):
            seen.append(kwargs.get("radix_bits"))
            return orig(values, n, *args, **kwargs)

        monkeypatch.setattr(device.rank_ops, "median_non_zero", spy)
        template = template_cls(ctx, tuning={"radix_bits": 2})
        dev = np.abs(np.random.RandomState(seed=3).standard_normal((64, 32))).astype(np.float32)
        noise = device.NoiseEstHostFromDevice(template)(dev)
        assert seen == [2]
        np.testing.assert_array_equal(noise, device.NoiseEstHostFromDevice(
            template_cls(ctx, tuning={"radix_bits": 8}))(dev))


class TestThresholdDevice:
    @pytest.mark.parametrize("transposed", [False, True])
    def test_simple_vs_host_and_jax(self, ctx, transposed):
        shape = (223, 131)
        rs = np.random.RandomState(seed=3)
        deviations = np.abs(rs.standard_normal(shape)).astype(np.float32)
        noise = rs.uniform(0.5, 1.5, shape[1]).astype(np.float32)
        template = device.ThresholdSimpleDeviceTemplate(ctx, transposed, flag_value=4)
        out = device.ThresholdHostFromDevice(template, n_sigma=3.0)(deviations, noise)
        np.testing.assert_array_equal(template.host_class(3.0, flag_value=4)(deviations, noise),
                                      out)
        jtemplate = jdev.ThresholdSimpleDeviceTemplate(None, transposed, flag_value=4)
        np.testing.assert_array_equal(
            out, jdev.ThresholdHostFromDevice(jtemplate, n_sigma=3.0)(deviations, noise))

    @pytest.mark.parametrize("n_windows", [1, 2, 4])
    def test_sum_vs_host_and_jax(self, ctx, n_windows):
        shape = (500, 37)
        rs = np.random.RandomState(seed=4)
        deviations = rs.standard_normal(shape).astype(np.float32)
        deviations[100, :] += 50.0
        deviations[200:204, 5:9] += 20.0
        deviations[300:316, 11] += 8.0
        noise = np.full(shape[1], 1.0, np.float32)
        template = device.ThresholdSumDeviceTemplate(ctx, n_windows, flag_value=2)
        out = device.ThresholdHostFromDevice(template, n_sigma=4.5)(deviations, noise)
        assert out.any()
        np.testing.assert_array_equal(
            template.host_class(4.5, n_windows, flag_value=2)(deviations, noise), out)
        jtemplate = jdev.ThresholdSumDeviceTemplate(None, n_windows, flag_value=2)
        np.testing.assert_array_equal(
            out, jdev.ThresholdHostFromDevice(jtemplate, n_sigma=4.5)(deviations, noise))


def _templates(lib, ctx, use_flags, transpose_noise_est, threshold_kind):
    background = lib.BackgroundMedianFilterDeviceTemplate(
        ctx, 13, use_flags=lib.BackgroundFlags[use_flags.name], tuning={"engine": "network"})
    if transpose_noise_est:
        noise_est = lib.NoiseEstMADTDeviceTemplate(ctx, 1024, tuning={"radix_bits": 4})
    else:
        noise_est = lib.NoiseEstMADDeviceTemplate(ctx, tuning={"radix_bits": 4})
    if threshold_kind == "sum":
        threshold = lib.ThresholdSumDeviceTemplate(ctx)
    else:
        threshold = lib.ThresholdSimpleDeviceTemplate(ctx, transposed=threshold_kind == "simple_t")
    return lib.FlaggerDeviceTemplate(background, noise_est, threshold)


class TestFlaggerDevice:
    @pytest.mark.parametrize("use_flags", MODES)
    @pytest.mark.parametrize("transpose_noise_est", [False, True])
    @pytest.mark.parametrize("threshold_kind", ["simple", "simple_t", "sum"])
    def test_spike_recovery_matches_jax(self, ctx, use_flags, transpose_noise_est,
                                        threshold_kind):
        vis, spikes, input_flags = rfi_test_data()
        args = (use_flags, transpose_noise_est, threshold_kind)
        flagger = device.FlaggerHostFromDevice(_templates(device, ctx, *args),
                                               threshold_args=dict(n_sigma=11.0))
        jflagger = jdev.FlaggerHostFromDevice(_templates(jdev, None, *args),
                                              threshold_args=dict(n_sigma=11.0))
        if use_flags == device.BackgroundFlags.CHANNEL:
            f = input_flags[:, 0].copy()
            expected = np.where(np.broadcast_to(input_flags[:, 0:1], vis.shape), 0, spikes)
        elif use_flags == device.BackgroundFlags.FULL:
            f = input_flags
            expected = np.where(input_flags, 0, spikes)
        else:
            f = None
            expected = spikes
        flags = flagger(vis, f)
        np.testing.assert_array_equal(flags, jflagger(vis, f))
        if threshold_kind == "sum":
            assert (flags[expected.astype(bool)] != 0).all()  # SumThreshold smears flags
        else:
            np.testing.assert_array_equal(expected, flags)

    @pytest.mark.parametrize("use_flags", MODES)
    def test_vs_full_host_flagger(self, ctx, use_flags):
        """Stage-identical device and host pipelines give the same mask."""
        vis, _, input_flags = rfi_test_data(shape=(229, 57), seed=7)
        f = _flag_arg(use_flags, input_flags)
        host_flagger = host.FlaggerHost(host.BackgroundMedianFilterHost(13),
                                        host.NoiseEstMADHost(), host.ThresholdSumHost(11.0))
        jhost_flagger = jhost.FlaggerHost(jhost.BackgroundMedianFilterHost(13),
                                          jhost.NoiseEstMADHost(), jhost.ThresholdSumHost(11.0))
        args = (use_flags, True, "sum")
        got = device.FlaggerHostFromDevice(_templates(device, ctx, *args),
                                           threshold_args=dict(n_sigma=11.0))(vis, f)
        want = jdev.FlaggerHostFromDevice(_templates(jdev, None, *args),
                                          threshold_args=dict(n_sigma=11.0))(vis, f)
        np.testing.assert_array_equal(got, host_flagger(vis, f))
        np.testing.assert_array_equal(got, jhost_flagger(vis, f))
        np.testing.assert_array_equal(got, want)

    def test_sequence_structure_and_intermediates(self, ctx):
        """The composed flagger is an OperationSequence with corner turns
        where layouts differ; its intermediates match the JAX ones."""
        vis, _, _ = rfi_test_data(shape=(150, 24), seed=5)
        args = (device.BackgroundFlags.NONE, True, "sum")
        fd = _templates(device, ctx, *args).instantiate(None, 150, 24,
                                                        threshold_args={"n_sigma": 11.0})
        jfd = _templates(jdev, None, *args).instantiate(None, 150, 24,
                                                        threshold_args={"n_sigma": 11.0})
        assert [n for n, _ in fd.operations] == [n for n, _ in jfd.operations] == [
            "background", "transpose_deviations", "noise_est", "threshold", "transpose_flags"]
        assert set(fd.slots) == set(jfd.slots)
        assert fd.parameters() == {k: (v.name if hasattr(v, "name") else v)
                                   for k, v in jfd.parameters().items()}
        fd.bind(vis=torch.from_numpy(vis))
        fd()
        jfd.bind(vis=jnp.asarray(vis))
        jfd()
        for name in ("flags", "flags_t"):
            np.testing.assert_array_equal(fd.buffer(name).numpy(), np.asarray(jfd.buffer(name)))
        # XLA's jit may round the deviations differently in the last place.
        dev, jd = fd.buffer("deviations").numpy(), np.asarray(jfd.buffer("deviations"))
        np.testing.assert_array_less(np.abs(dev - jd), 2 * np.spacing(np.abs(jd).max()) + 1e-30)
        np.testing.assert_array_equal(fd.buffer("noise").numpy(), np.asarray(jfd.buffer("noise")))
        functional = fd(vis=torch.from_numpy(vis))
        np.testing.assert_array_equal(functional["flags"].numpy(), fd.buffer("flags").numpy())

    def test_straight_threshold_needs_no_flag_turn(self, ctx):
        args = (device.BackgroundFlags.FULL, False, "simple")
        fd = _templates(device, ctx, *args).instantiate(None, 64, 8)
        assert [n for n, _ in fd.operations] == ["background", "noise_est", "threshold"]
        assert set(fd.input_slots()) == {"vis", "input_flags"}


def test_instance_abcs():
    assert issubclass(device.BackgroundMedianFilterDevice, device.AbstractBackgroundDevice)
    assert issubclass(device.NoiseEstMADDevice, device.AbstractNoiseEstDevice)
    assert issubclass(device.NoiseEstMADTDevice, device.AbstractNoiseEstDevice)
    assert issubclass(device.ThresholdSimpleDevice, device.AbstractThresholdDevice)
    assert issubclass(device.ThresholdSumDevice, device.AbstractThresholdDevice)


def test_complex_amplitude_is_numpys():
    """Complex visibilities take the amplitude XLA and numpy compute
    (``max * sqrt(fma(r, r, 1))``), not PyTorch's correctly rounded hypot."""
    vis, _, _ = rfi_test_data(shape=(300, 40), seed=6)
    got = device.amplitude(torch.from_numpy(vis)).numpy()
    np.testing.assert_array_equal(got, np.abs(vis))
    # Held to one ulp of XLA's: one CPU run once saw jnp.abs differ from
    # itself in the last place (ROADMAP Queue 3).
    want = np.asarray(jdev.amplitude(jnp.asarray(vis)))
    np.testing.assert_array_less(np.abs(got - want), np.spacing(want) * 1.0001)
