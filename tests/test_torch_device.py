"""The port's RFI stages (katsdpsigproc_tpu_torch.models.rfi.device) and
host-oracle copy against the JAX reference, on the CPU.

Tolerances.  Flags and counts: exact.  Float32 deviations, medians and
noise: exact against the JAX functions called eagerly, where XLA runs
each operation on its own.  Under ``jax.jit`` XLA on the CPU contracts
``re*re + im*im`` into a fused multiply-add, while the port (like the
TPU kernel and the CUDA kernel) rounds each operation:
:func:`test_amplitude_contraction_under_jit` pins that difference at
<= 1 ulp of the amplitude, and exactness again on inputs whose squares
are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import device as jdev, host as jhost
from katsdpsigproc_tpu_torch.models.rfi import device as tdev, host as thost
from katsdpsigproc_tpu_torch.utils import numerics

from .helpers import rfi_test_data
from .torch_helpers import inexact_float64_sqrt

MODES = ["NONE", "CHANNEL", "FULL"]


def _flags_arg(mode, flags):
    if mode == "NONE":
        return None
    return flags[:, 0].copy() if mode == "CHANNEL" else flags


@pytest.mark.parametrize("engine", ["network", "count"])
def test_masked_median_filter_matches_jax(engine):
    rs = np.random.RandomState(1)
    amp = np.abs(rs.standard_normal((61, 9))).astype(np.float32)
    amp[rs.random_sample(amp.shape) < 0.2] = np.nan
    amp[20:35, 4] = np.nan  # empty windows give NaN
    med, n = tdev.masked_median_filter(torch.from_numpy(amp), 13, engine)
    jmed, jn = jdev.masked_median_filter(jnp.asarray(amp), 13, engine)
    np.testing.assert_array_equal(med.numpy(), np.asarray(jmed))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


@pytest.mark.parametrize("channels", [13, 99, 100, 257])
def test_masked_median_filter_edge_fill_matches_jax(channels):
    """The ±inf parity-fill fast path at odd and even channel counts."""
    amp = np.abs(np.random.RandomState(channels).standard_normal((channels, 5))).astype(np.float32)
    med, n = tdev.masked_median_filter(torch.from_numpy(amp), 13, edges_only=True)
    jmed, jn = jdev.masked_median_filter(jnp.asarray(amp), 13, edges_only=True)
    np.testing.assert_array_equal(med.numpy(), np.asarray(jmed))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    general, _ = tdev.masked_median_filter(torch.from_numpy(amp), 13)
    np.testing.assert_array_equal(med.numpy(), general.numpy())


@pytest.mark.parametrize("is_amplitude", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fast_path", [None, False])
def test_background_median_filter_matches_jax(mode, is_amplitude, fast_path):
    vis, _, flags = rfi_test_data(shape=(150, 12), seed=2)
    data = np.abs(vis).astype(np.float32) if is_amplitude else jdev.to_planar(vis)
    if is_amplitude:
        data[3, 4] = -1.0  # negative amplitudes are excluded
    f = _flags_arg(mode, flags)
    got = tdev.background_median_filter(
        torch.from_numpy(data), None if f is None else torch.from_numpy(f), 13,
        is_amplitude, tdev.BackgroundFlags[mode], fast_path=fast_path)
    want = jdev.background_median_filter(
        jnp.asarray(data), None if f is None else jnp.asarray(f), 13,
        is_amplitude, jdev.BackgroundFlags[mode], fast_path=fast_path)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_amplitude_and_planar_match_jax():
    vis, _, _ = rfi_test_data(shape=(64, 8), seed=3)
    planar = tdev.to_planar(vis)
    np.testing.assert_array_equal(planar, jdev.to_planar(vis))
    np.testing.assert_array_equal(tdev.to_planar(vis, leading=True),
                                  jdev.to_planar(vis, leading=True))
    np.testing.assert_array_equal(tdev.to_planar(torch.from_numpy(vis)).numpy(), planar)
    np.testing.assert_array_equal(tdev.amplitude(torch.from_numpy(planar)).numpy(),
                                  np.asarray(jdev.amplitude(jnp.asarray(planar))))
    with pytest.raises(TypeError):
        tdev.amplitude(torch.zeros((4, 3)))


def test_amplitude_contraction_under_jit():
    """Hazard: XLA's CPU backend fuses re*re + im*im into an FMA under jit.

    The port rounds each operation; the two differ by at most one ulp of
    the amplitude, and not at all where the squares are exact."""
    rs = np.random.RandomState(4)
    planar = rs.standard_normal((4096, 2)).astype(np.float32)
    jitted = np.asarray(jax.jit(jdev.amplitude)(jnp.asarray(planar)))
    port = tdev.amplitude(torch.from_numpy(planar)).numpy()
    assert (port != jitted).any()  # the contraction is real on this backend
    np.testing.assert_array_less(np.abs(port - jitted), np.spacing(port) * 1.0001)
    fma = np.sqrt((planar[:, 0].astype(np.float64) ** 2
                   + (planar[:, 1] * planar[:, 1]).astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(jitted, fma)  # XLA: fma(re, re, im*im), then sqrt
    quant = (np.round(planar * 32) / 32).astype(np.float32)  # exact squares and sums
    np.testing.assert_array_equal(tdev.amplitude(torch.from_numpy(quant)).numpy(),
                                  np.asarray(jax.jit(jdev.amplitude)(jnp.asarray(quant))))


def test_sqrt_rn_is_correctly_rounded_whatever_the_float64_root(monkeypatch):
    """sqrt_rn equals numpy's correctly rounded float32 root bit for bit, also
    where the float64 root it starts from is off in its last 20 bits: on roots
    a hair from a rounding midpoint, random values and the edge values."""
    rs = np.random.RandomState(5)
    y = rs.uniform(0.5, 4.0, 20000).astype(np.float32)
    mid = (y.astype(np.float64) + np.nextafter(y, np.float32(np.inf)).astype(np.float64)) / 2
    near = (mid * mid).astype(np.float32)  # roots within 2**-40 of a midpoint
    edges = np.array([0.0, -0.0, 1e-45, 1e-40, 1.17e-38, 1.0, 2.0, 3.4e38, np.inf, -1.0,
                      -np.inf, np.nan], np.float32)
    x = np.concatenate([near, rs.uniform(0.0, 10.0, 20000).astype(np.float32), edges])
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    finite = ~np.isnan(want)
    for inexact in (False, True):
        if inexact:
            inexact_float64_sqrt(monkeypatch)
            # The fault is injected: the float64 root rounded once is wrong here.
            rounded = torch.sqrt(torch.from_numpy(near.astype(np.float64))).to(torch.float32)
            assert (rounded.numpy() != want[:near.size]).any()
        got = numerics.sqrt_rn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.signbit(got[finite]), np.signbit(want[finite]))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("radix", [1, 4])
def test_madnz_matches_jax(axis, radix):
    rs = np.random.RandomState(5)
    dev = rs.standard_normal((96, 10)).astype(np.float32)
    dev[rs.random_sample(dev.shape) < 0.1] = 0.0
    if axis == -1:
        dev = dev.T.copy()
    got = tdev.madnz(torch.from_numpy(dev), axis=axis, radix_bits=radix)
    want = jdev.madnz(jnp.asarray(dev), axis=axis, radix_bits=radix)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("n_windows,flag_value", [(1, 1), (4, 1), (6, 3)])
def test_thresholds_match_jax(transposed, n_windows, flag_value):
    rs = np.random.RandomState(6)
    dev = rs.standard_normal((40, 200)).astype(np.float32)
    dev[:, 50:54] += 3.0  # a broad weak feature only the wide windows catch
    dev[:, 120] += 20.0
    if not transposed:
        dev = dev.T.copy()
    noise = jdev.madnz(jnp.asarray(dev), axis=-1 if transposed else 0)
    kw = dict(n_sigma=4.0, n_windows=n_windows, threshold_falloff=1.2, flag_value=flag_value,
              transposed=transposed)
    got = tdev.threshold_sum(torch.from_numpy(dev), torch.from_numpy(np.array(noise)), **kw)
    want = jdev.threshold_sum(jnp.asarray(dev), noise, **kw)
    assert got.dtype == torch.uint8 and got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    simple = tdev.threshold_simple(torch.from_numpy(dev), torch.from_numpy(np.array(noise)),
                                   4.0, flag_value, transposed)
    np.testing.assert_array_equal(
        simple.numpy(), np.asarray(jdev.threshold_simple(jnp.asarray(dev), noise, 4.0,
                                                         flag_value, transposed)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("threshold,block", [("sum", None), ("sum", 5), ("simple", None)])
def test_make_flagger_fn_torch_matches_jax_xla(mode, threshold, block):
    vis, _, flags = rfi_test_data(shape=(130, 12), seed=7)
    planar = jdev.to_planar(vis)
    f = _flags_arg(mode, flags)
    kw = dict(width=13, n_sigma=11.0, use_flags=None, threshold=threshold, n_windows=4,
              threshold_falloff=1.2, flag_value=1, baseline_block=block)
    port = tdev.make_flagger_fn(**{**kw, "use_flags": tdev.BackgroundFlags[mode]}, engine="torch")
    ref = jdev.make_flagger_fn(**{**kw, "use_flags": jdev.BackgroundFlags[mode]}, engine="xla")
    args_t = (torch.from_numpy(planar),) + (() if f is None else (torch.from_numpy(f),))
    args_j = (jnp.asarray(planar),) + (() if f is None else (jnp.asarray(f),))
    got = port(*args_t)
    assert got.shape == (130, 12) and got.dtype == torch.uint8 and got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(*args_j)))


def test_make_flagger_fn_validation():
    with pytest.raises(ValueError, match="engine"):
        tdev.make_flagger_fn(engine="xla")
    with pytest.raises(ValueError, match="hybrid"):
        tdev.make_flagger_fn(engine="hybrid", threshold="simple")


@pytest.mark.parametrize("mode", MODES)
def test_host_copy_matches_jax_host(mode):
    vis, _, flags = rfi_test_data(shape=(120, 10), seed=8)
    f = _flags_arg(mode, flags)
    background_t = thost.BackgroundMedianFilterHost(13)(vis, f)
    background_j = jhost.BackgroundMedianFilterHost(13)(vis, f)
    np.testing.assert_array_equal(background_t, background_j)
    noise = thost.NoiseEstMADHost()(background_t)
    np.testing.assert_array_equal(noise, jhost.NoiseEstMADHost()(background_j))
    for cls in ("ThresholdSumHost", "ThresholdSimpleHost"):
        np.testing.assert_array_equal(getattr(thost, cls)(11.0)(background_t, noise),
                                      getattr(jhost, cls)(11.0)(background_j, noise))
    flagger_t = thost.FlaggerHost(thost.BackgroundMedianFilterHost(13), thost.NoiseEstMADHost(),
                                  thost.ThresholdSumHost(11.0))
    flagger_j = jhost.FlaggerHost(jhost.BackgroundMedianFilterHost(13), jhost.NoiseEstMADHost(),
                                  jhost.ThresholdSumHost(11.0))
    np.testing.assert_array_equal(flagger_t(vis, f), flagger_j(vis, f))
