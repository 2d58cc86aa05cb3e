"""The port's 2-D flagger end to end (``SumThresholdFlagger.get_flags``) on
the CPU, against the JAX flagger (its jitted ``_impl``, the product) and
the independent numpy oracle ``tests/rfi/twodflag_oracle.py``.

The cases are those of ``tests/rfi/test_twodflag_oracle.py`` at its small
shapes, plus complex input with NaN in one part only.  Each JAX and
oracle result is computed once per module.  Tolerance: exact, mask for
mask.
"""

import functools

import numpy as np
import pytest

from katsdpsigproc_tpu.models.rfi.twodflag import SumThresholdFlagger as JaxFlagger
from katsdpsigproc_tpu_torch.models.rfi.twodflag import SumThresholdFlagger

from .rfi import twodflag_oracle as oracle
from .rfi.test_twodflag_oracle import SMALL, _synthetic


def _planted_rfi():
    data, _ = _synthetic(np.random.RandomState(7), (40, 128, 3))
    return data, np.zeros(data.shape, bool), SMALL


def _input_flags():
    rs = np.random.RandomState(8)
    data, _ = _synthetic(rs, (32, 96, 2))
    return data, rs.random_sample(data.shape) < 0.1, SMALL


def _average_freq():
    rs = np.random.RandomState(9)
    data, _ = _synthetic(rs, (32, 100, 2))
    return data, rs.random_sample(data.shape) < 0.05, dict(SMALL, average_freq=4)


def _average_freq_uneven():
    # 98 channels / average_freq 4: a ragged final bin
    data, _ = _synthetic(np.random.RandomState(10), (24, 98, 2))
    return data, np.zeros(data.shape, bool), dict(SMALL, average_freq=4)


def _nan_inputs():
    rs = np.random.RandomState(11)
    data, _ = _synthetic(rs, (32, 96, 2))
    data = np.where(rs.random_sample(data.shape) < 0.05, np.complex64(np.nan), data)
    return data, np.zeros(data.shape, bool), SMALL


def _nan_in_one_part():
    """Complex input with NaN in the real or the imaginary part only, and inf + NaN j."""
    rs = np.random.RandomState(19)
    data, _ = _synthetic(rs, (32, 96, 2))
    re, im = data.real.copy(), data.imag.copy()
    re[rs.random_sample(re.shape) < 0.03] = np.nan
    im[rs.random_sample(im.shape) < 0.03] = np.nan
    both = rs.random_sample(re.shape) < 0.01
    re[both], im[both] = np.inf, np.nan
    return (re + 1j * im).astype(np.complex64), np.zeros(data.shape, bool), SMALL


def _all_flagged_chunk():
    data, _ = _synthetic(np.random.RandomState(12), (32, 96, 2))
    flags = np.zeros(data.shape, bool)
    flags[:, 0:32, :] = True  # chunk 0 of 3: empty noise estimates
    return data, flags, SMALL


def _all_flagged():
    data, _ = _synthetic(np.random.RandomState(13), (16, 48, 2))
    return data, np.ones(data.shape, bool), SMALL


def _freq_chunks_exceed_channels():
    data, _ = _synthetic(np.random.RandomState(14), (16, 6, 2))
    return data, np.zeros(data.shape, bool), dict(
        windows_time=[1, 2], windows_freq=[1, 2], spike_width_time=2.0,
        spike_width_freq=2.0, freq_chunks=10)


def _single_chunk():
    data, _ = _synthetic(np.random.RandomState(15), (24, 64, 2))
    return data, np.zeros(data.shape, bool), dict(SMALL, freq_chunks=1)


def _magnitude_input():
    data, _ = _synthetic(np.random.RandomState(17), (32, 96, 2), complex_data=False)
    return data, np.zeros(data.shape, bool), SMALL


CASES = {f.__name__[1:]: f for f in (
    _planted_rfi, _input_flags, _average_freq, _average_freq_uneven, _nan_inputs,
    _nan_in_one_part, _all_flagged_chunk, _all_flagged, _freq_chunks_exceed_channels,
    _single_chunk, _magnitude_input)}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(data, flags, params, JAX flags, oracle flags), once per module."""
    data, flags, params = CASES[name]()
    return (data, flags, params, JaxFlagger(**params).get_flags(data, flags),
            oracle.get_flags(data, flags, **params))


@pytest.mark.parametrize("name", list(CASES))
def test_get_flags_matches_jax(name):
    data, flags, params, want, _ = _case(name)
    got = SumThresholdFlagger(**params).get_flags(data, flags, device="cpu")
    assert got.dtype == np.bool_ and got.shape == data.shape
    mismatch = int((got != want).sum())
    assert mismatch == 0, f"{mismatch} / {got.size} flags differ from the JAX flagger"


@pytest.mark.parametrize("name", list(CASES))
def test_get_flags_matches_oracle(name):
    data, flags, params, _, want = _case(name)
    got = SumThresholdFlagger(**params).get_flags(data, flags, device="cpu")
    mismatch = int((got != want).sum())
    assert mismatch == 0, f"{mismatch} / {got.size} flags differ from the numpy oracle"
    if name == "planted_rfi":
        _, spikes = _synthetic(np.random.RandomState(7), data.shape)
        assert (got & spikes).sum() > 0.8 * spikes.sum()
    if name in ("nan_inputs", "nan_in_one_part"):
        assert got[np.isnan(data.real) | np.isnan(data.imag)].all()


def test_chunks_of_baselines_flag_as_one_batch():
    """get_flags' 16-baseline chunks (and any chunk_size) give the flags of
    the whole batch: the baselines are independent."""
    data, _ = _synthetic(np.random.RandomState(20), (16, 40, 18))
    flags = np.zeros(data.shape, bool)
    flagger = SumThresholdFlagger(**SMALL)
    whole = flagger.get_flags(data, flags, chunk_size=18, device="cpu")
    np.testing.assert_array_equal(flagger.get_flags(data, flags, device="cpu"), whole)
    np.testing.assert_array_equal(flagger.get_flags(data, flags, chunk_size=5, device="cpu"),
                                  whole)
    assert whole.any()


def test_windows_time_clipped_by_the_frequency_extent():
    """The reference's quirk: windows_time is clipped by the channel count."""
    flagger = SumThresholdFlagger(**SMALL)
    data, _ = _synthetic(np.random.RandomState(21), (40, 3, 1))
    flags = np.zeros(data.shape, bool)
    want = JaxFlagger(**SMALL).get_flags(data, flags)
    np.testing.assert_array_equal(flagger.get_flags(data, flags, device="cpu"), want)
    np.testing.assert_array_equal(want, oracle.get_flags(data, flags, **SMALL))
