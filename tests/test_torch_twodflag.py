"""The port's 2-D flagger stages (katsdpsigproc_tpu_torch.models.rfi.twodflag)
against the JAX module's, on the CPU.

Each JAX stage runs as the product runs it, under ``jax.jit`` and mapped
over baselines by ``jax.vmap``; the port's takes the same baselines as a
leading axis.  Inputs are made with numpy from seeds.  Tolerance: exact,
bit for bit on every float32 output and every mask.

One difference is pinned, not matched: under ``jax.jit`` XLA on the CPU
turns the box filter's division by the constant ``(2r + 1) ** passes``
into a product with its float32 reciprocal, which moves some background
values by an ulp or two.  The port divides, as the JAX code is written
and as the numpy oracle does; the filter stages are held bit for bit to
JAX run eagerly and to the oracle, and
:func:`test_box_filter_division_becomes_a_reciprocal_under_jit` pins the
jitted difference.  The end-to-end flags equal the jitted product's
(``tests/test_torch_twodflag_flagger.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import twodflag as jtd
from katsdpsigproc_tpu_torch.models.rfi import twodflag as ttd
from katsdpsigproc_tpu_torch.ops import rank as trank

from .rfi import twodflag_oracle as oracle
from .rfi.test_twodflag_oracle import _synthetic


def _jax_batched(fn, *arrays, jit=True, **static):
    """`fn` mapped over the leading axis of every array, under jit unless told otherwise."""
    mapped = jax.vmap(functools.partial(fn, **static))
    return (jax.jit(mapped) if jit else mapped)(*map(jnp.asarray, arrays))


def _bits_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def _amp_cube(seed, shape=(3, 24, 40), flag_frac=0.1):
    """(bl, time, freq) amplitudes with planted spikes and random flags."""
    rs = np.random.RandomState(seed)
    data, _ = _synthetic(rs, shape)
    return np.abs(data).astype(np.float32), rs.random_sample(shape) < flag_frac


def _adversarial(seed, shape):
    """Amplitudes full of ties, zeros, infinities and powers of two."""
    rs = np.random.RandomState(seed)
    choices = np.array([0.0, 0.5, 1.0, 1.0, 2.0, 3.0, np.inf], np.float32)
    data = rs.choice(choices, shape).astype(np.float32)
    noisy = rs.random_sample(shape) < 0.3
    data[noisy] = rs.uniform(0, 4, noisy.sum()).astype(np.float32)
    return data


@pytest.mark.parametrize("factor", [1, 3, 4])
@pytest.mark.parametrize("complex_data", [True, False])
def test_average_freq(factor, complex_data):
    rs = np.random.RandomState(factor)
    data, _ = _synthetic(rs, (12, 98, 3), complex_data=complex_data)
    nan = rs.random_sample(data.shape) < 0.05
    data = np.where(nan, data.dtype.type(np.nan), data)
    flags = rs.random_sample(data.shape) < 0.2
    flags[:, 8:16] = True  # whole bins flagged
    want = jax.jit(jtd._average_freq, static_argnums=2)(jnp.asarray(data), jnp.asarray(flags),
                                                        factor)
    got = ttd._average_freq(torch.from_numpy(data), torch.from_numpy(flags), factor)
    _bits_equal(got[0], want[0])
    _bits_equal(got[1], want[1])


@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 33])
def test_masked_median_axis0(n):
    """The sort-based median equals JAX's rank search (and the port's)."""
    data = _adversarial(n, (4, n, 9))
    valid = np.random.RandomState(n + 100).random_sample(data.shape) < 0.7
    valid[0, :, 0] = False  # a column with nothing valid
    for empty in (0.0, np.nan):
        want = _jax_batched(lambda d, v: jtd._masked_median_axis0(d, v, empty_value=empty),
                            data, valid)
        got = ttd._masked_median_axis0(torch.from_numpy(data), torch.from_numpy(valid),
                                       empty_value=empty)
        _bits_equal(got, want)
    if n:
        vals = torch.where(torch.from_numpy(valid), torch.from_numpy(data), torch.nan)
        count = torch.from_numpy(valid).sum(1, dtype=torch.int32)
        search = trank.find_rank_float(vals.movedim(1, -1), count // 2, (count & 1) == 0,
                                       radix_bits=4)
        _bits_equal(got, torch.where(count > 0, search, torch.nan))


def test_medians():
    data, flags = _amp_cube(1)
    data = data - 1.0  # residual-like, both signs
    jdata, jflags = jnp.asarray(data), jnp.asarray(flags)
    tdata, tflags = torch.from_numpy(data), torch.from_numpy(flags)
    want = jax.jit(jax.vmap(jtd._time_median))(jnp.abs(jdata), jflags)
    got = ttd._time_median(tdata.abs(), tflags)
    _bits_equal(got[0], want[0])
    _bits_equal(got[1], want[1])
    _bits_equal(ttd._median_abs(tdata, tflags), jax.jit(jax.vmap(jtd._median_abs))(jdata, jflags))
    _bits_equal(ttd._median_abs_axis0(tdata, tflags),
                jax.jit(jax.vmap(jtd._median_abs_axis0))(jdata, jflags))


def test_linearly_interpolate_nans():
    rs = np.random.RandomState(5)
    data = rs.uniform(-3, 3, (6, 5, 37)).astype(np.float32)
    data[rs.random_sample(data.shape) < 0.4] = np.nan
    data[0, 0] = np.nan  # all NaN
    data[0, 1, :5] = np.nan  # leading run
    data[0, 2, -7:] = np.nan  # trailing run
    data[0, 3] = 1.0  # none
    want = jax.jit(jtd._linearly_interpolate_nans)(jnp.asarray(data))
    _bits_equal(ttd._linearly_interpolate_nans(torch.from_numpy(data)), want)
    _bits_equal(ttd._linearly_interpolate_nans1d(torch.from_numpy(data[1, 1])),
                jax.jit(jtd._linearly_interpolate_nans1d)(jnp.asarray(data[1, 1])))


@pytest.mark.parametrize("sigma", [(0.0, 4.0), (3.5, 0.0), (12.5, 10.0), (2.0, 1.0)])
def test_masked_gaussian_filter(sigma):
    data, flags = _amp_cube(2, shape=(30, 45))
    flags[:, 20:30] = True  # a region no support reaches at small sigma
    want = jtd.masked_gaussian_filter(jnp.asarray(data), jnp.asarray(flags), np.array(sigma))
    got = ttd.masked_gaussian_filter(torch.from_numpy(data), torch.from_numpy(flags),
                                     np.array(sigma))
    _bits_equal(got, want)
    _bits_equal(got, oracle.masked_gaussian_filter(data, flags, np.array(sigma)))


def test_box_filter_division_becomes_a_reciprocal_under_jit():
    """Hazard: under jit, XLA on the CPU computes the box filter's ``x / C``
    (C = (2r + 1) ** passes, a constant) as ``x * float32(1 / C)``.

    The port divides, as the JAX code reads and the oracle computes; the
    jitted filter differs from it by at most two ulps (one from the
    product, one more through ``fd / fw``)."""
    x = np.random.RandomState(0).uniform(0, 1000, 4096).astype(np.float32)
    c = np.float32(7.0 ** 4)
    jitted = np.asarray(jax.jit(lambda v: v / jnp.asarray(c))(x))
    np.testing.assert_array_equal(jitted, x * np.float32(1.0 / c))  # the rewrite
    assert (jitted != x / c).any()

    data, flags = _amp_cube(2, shape=(30, 45))
    sigma = np.array((0.0, 4.0))  # r = 3 along frequency: C = 7 ** 4
    port = ttd.masked_gaussian_filter(torch.from_numpy(data), torch.from_numpy(flags),
                                      sigma).numpy()
    jit_filter = jax.jit(functools.partial(jtd.masked_gaussian_filter, sigma=sigma))
    jitted = np.asarray(jit_filter(jnp.asarray(data), jnp.asarray(flags)))
    assert (port != jitted).any()  # the rewrite is real on this backend
    both = ~np.isnan(port)
    np.testing.assert_array_equal(np.isnan(jitted), ~both)
    ulps = np.abs(port[both].view(np.int32).astype(np.int64) - jitted[both].view(np.int32))
    assert ulps.max() <= 2
    _bits_equal(port, jtd.masked_gaussian_filter(jnp.asarray(data), jnp.asarray(flags), sigma))


def test_box_gaussian_filter_checks_sigma():
    with pytest.raises(ValueError, match="sigma"):
        ttd._box_gaussian_filter(torch.zeros((4, 5)), np.array([1.0]))


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("spectrum", [False, True])
def test_get_background2d(iterations, spectrum):
    data, flags = _amp_cube(3 + iterations)
    if spectrum:  # the time-median spectrum's (bl, 1, freq) shape
        data, flags = data[:, :1], flags[:, :1]
    sigma = np.array((0.0, 4.0) if spectrum else (3.5, 4.0))
    chunks = np.array([0, 13, 26, 40])
    want = _jax_batched(jtd._get_background2d, data, flags, jit=False, iterations=iterations,
                        spike_width=sigma, reject_threshold=2.0, freq_chunk_ends=chunks)
    got = ttd._get_background2d(torch.from_numpy(data), torch.from_numpy(flags), iterations,
                                sigma, 2.0, chunks)
    _bits_equal(got, want)


@pytest.mark.parametrize("axis,chunks", [
    (0, None),
    (1, np.array([0, 13, 26, 40])),
    (1, np.array([0, 0, 5, 5, 40])),  # zero-length chunks
    (1, np.array([0, 40])),
])
@pytest.mark.parametrize("windows", [[1, 2, 4, 8], [1], [3, 16]])
def test_sum_threshold(axis, chunks, windows):
    data, flags = _amp_cube(6)
    data = data - 1.2
    data[:, 5:7, 10:12] += 4.0  # a weak block only the wide windows see
    kw = dict(axis=axis, windows=windows, outlier_nsigma=4.5, rho=1.3, chunks=chunks)
    want = _jax_batched(jtd._sum_threshold, data, flags, **kw)
    got = ttd._sum_threshold(torch.from_numpy(data), torch.from_numpy(flags), **kw)
    _bits_equal(got, want)
    assert got.any()


def test_sum_threshold_checks_axis():
    with pytest.raises(ValueError, match="axis"):
        ttd._sum_threshold(torch.zeros((1, 4, 4)), torch.zeros((1, 4, 4), dtype=torch.bool),
                           2, [1], 4.5, 1.3)


@pytest.mark.parametrize("extend", [1, 2, 3, 4, 41])
def test_combine_and_unaverage(extend):
    rs = np.random.RandomState(extend)
    spec = rs.random_sample((3, 1, 25)) < 0.05
    time_flags = rs.random_sample((3, 20, 25)) < 0.05
    freq_flags = rs.random_sample((3, 20, 25)) < 0.05
    time_flags[1, :, 4] = True  # a column past flag_all_time_frac
    freq_flags[2, 7, :21] = True  # a row past flag_all_freq_frac
    want = _jax_batched(jtd._combine_flags, spec, time_flags, freq_flags, time_extend=extend)
    got = ttd._combine_flags(*map(torch.from_numpy, (spec, time_flags, freq_flags)), extend)
    _bits_equal(got, want)
    for average_freq, orig_freq in ((1, 25), (4, 98), (4, 100)):
        kw = dict(freq_extend=extend, average_freq=average_freq, flag_all_time_frac=0.6,
                  flag_all_freq_frac=0.8, orig_freq=orig_freq)
        want_u = _jax_batched(jtd._unaverage_freq, np.asarray(want), **kw)
        _bits_equal(ttd._unaverage_freq(got, **kw), want_u)


def test_unaverage_counts_against_float32_thresholds():
    """flag_all_*_frac compare an integer count with a float32 product:
    0.7 * 10 rounds to float32 7.0000005, so 7 flagged of 10 is not over it."""
    flags = np.zeros((1, 10, 10), bool)
    flags[0, 3, :7] = True
    flags[0, :7, 5] = True
    kw = dict(freq_extend=1, average_freq=1, flag_all_time_frac=0.7, flag_all_freq_frac=0.7,
              orig_freq=10)
    got = ttd._unaverage_freq(torch.from_numpy(flags), **kw)
    _bits_equal(got, _jax_batched(jtd._unaverage_freq, flags, **kw))
    assert not got[0, 3].all() and not got[0, :, 5].all()


def test_get_baseline_flags():
    data, flags = _amp_cube(7, shape=(3, 30, 48))
    kw = dict(outlier_nsigma=4.5, windows_time=np.array([1, 2, 4]),
              windows_freq=np.array([1, 2, 4]), background_reject=2.0,
              background_iterations=2, spike_width_time=3.5, spike_width_freq=4.0,
              time_extend=3, freq_extend=3, freq_chunk_ends=np.array([0, 16, 32, 48]),
              average_freq=1, flag_all_time_frac=0.6, flag_all_freq_frac=0.8, rho=1.3,
              orig_freq=48)
    want = _jax_batched(jtd._get_baseline_flags, data, flags, **kw)
    got = ttd._get_baseline_flags(torch.from_numpy(data), torch.from_numpy(flags), **kw)
    _bits_equal(got, want)
    assert got.any() and not got.all()


def test_get_flags_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.ones((8, 16, 1), np.float32)
    flagger = ttd.SumThresholdFlagger()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagger.get_flags(data, np.zeros(data.shape, bool))
    assert flagger.get_flags(data, np.zeros(data.shape, bool), device="cpu").shape == data.shape


def test_get_flags_checks_shapes():
    flagger = ttd.SumThresholdFlagger()
    with pytest.raises(ValueError, match="Shape mismatch"):
        flagger.get_flags(np.ones((4, 5, 2)), np.zeros((4, 5, 3), bool), device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        flagger.get_flags(np.ones((4, 5)), np.zeros((4, 5), bool), device="cpu")
