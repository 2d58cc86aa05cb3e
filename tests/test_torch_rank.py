"""The port's rank library (katsdpsigproc_tpu_torch.ops.rank) against the
JAX reference (katsdpsigproc_tpu.ops.rank), on the CPU.

Tolerance: exact everywhere.  The networks are compared as comparator
lists; every order statistic is a selected input value or a float32
average taken in the same order, so results must agree bit for bit
(NaN positions included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.ops import rank as jrank
from katsdpsigproc_tpu_torch.ops import rank as trank


def _positive(shape, seed, zeros=0.1, nans=0.05, ties=True):
    """Positive float32 data with zeros, NaNs (absent) and repeated values."""
    rs = np.random.RandomState(seed)
    x = np.abs(rs.standard_normal(shape)).astype(np.float32)
    if ties:
        x = np.round(x * 8) / 8  # many exact ties
    x[rs.random_sample(shape) < zeros] = 0.0
    x[rs.random_sample(shape) < nans] = np.nan
    return x.astype(np.float32)


@pytest.mark.parametrize("n,outputs", [(13, (6, 7)), (13, tuple(range(7)))])
def test_selection_network_matches_jax(n, outputs):
    assert trank.selection_network(n, outputs) == jrank.selection_network(n, outputs)


@pytest.mark.parametrize("n", range(3, 16, 2))
def test_selection_network_sweep_matches_jax(n):
    assert trank.batcher_pairs(n) == jrank.batcher_pairs(n)
    for outputs in [(n // 2, n // 2 + 1), tuple(range(n // 2 + 1)), (n // 2,)]:
        net = trank.selection_network(n, outputs)
        assert net == jrank.selection_network(n, outputs)
        assert trank._verify_01(n, net, outputs)


def test_apply_selection_network_propagates_nan_like_jax():
    x = _positive((13, 200), seed=1, nans=0.1)
    x[:, :3] = np.inf
    net = trank.selection_network(13, (6, 7))
    got = trank.apply_selection_network([torch.from_numpy(r) for r in x], net)
    want = jrank.apply_selection_network([jnp.asarray(r) for r in x], net)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("radix", [1, 4])
def test_median_non_zero_matches_jax(radix, axis):
    x = _positive((41, 57), seed=2)
    got = trank.median_non_zero(torch.from_numpy(x), radix_bits=radix, axis=axis)
    want = jrank.median_non_zero(jnp.asarray(x), radix_bits=radix, axis=axis)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("radix", [1, 3, 4])
def test_find_rank_float_matches_jax(radix, axis):
    x = _positive((33, 64), seed=3)
    batch = x.shape[1] if axis == 0 else x.shape[0]
    rs = np.random.RandomState(4)
    target = rs.randint(0, x.shape[axis], size=batch).astype(np.int32)
    halfway = rs.random_sample(batch) < 0.5
    got = trank.find_rank_float(torch.from_numpy(x), torch.from_numpy(target),
                                torch.from_numpy(halfway), radix_bits=radix, axis=axis)
    want = jrank.find_rank_float(jnp.asarray(x), jnp.asarray(target), jnp.asarray(halfway),
                                 radix_bits=radix, axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_median_non_zero_is_numpy_median_of_nonzeros():
    x = _positive((16, 101), seed=5, nans=0.0, ties=False)
    want = np.array([np.median(r[r > 0]) for r in x], np.float32)
    np.testing.assert_array_equal(trank.median_non_zero(torch.from_numpy(x)).numpy(), want)


def test_count_hooks_replace_local_reductions():
    """The count_fn/max_below_fn hooks (the collective-count contract) see
    every reduction: wrapping the defaults changes nothing but the call count."""
    x = torch.from_numpy(_positive((8, 77), seed=6))
    calls = {"count": 0, "max": 0}

    def count_fn(mask):
        calls["count"] += 1
        return torch.sum(mask, dim=-1, dtype=torch.int32)

    def max_below_fn(values, limit):
        calls["max"] += 1
        below = values < limit[..., None]
        return torch.amax(torch.where(below, values, 0.0), dim=-1)

    target = torch.full((8,), 30, dtype=torch.int32)
    base = trank.find_rank_float(x, target, True)
    hooked = trank.find_rank_float(x, target, True, count_fn=count_fn, max_below_fn=max_below_fn,
                                   radix_bits=2)
    np.testing.assert_array_equal(hooked.numpy(), base.numpy())
    assert calls == {"count": 16 + 1, "max": 1}  # 16 two-bit digits + the final rank


def test_rank_zeros_fmin_fmax_match_jax():
    x = _positive((5, 40), seed=7)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    limit = np.float32(0.75)
    np.testing.assert_array_equal(trank.rank(xt, limit).numpy(), np.asarray(jrank.rank(xj, limit)))
    lim = np.linspace(0.1, 1.5, 5).astype(np.float32)
    np.testing.assert_array_equal(trank.rank(xt, torch.from_numpy(lim)).numpy(),
                                  np.asarray(jrank.rank(xj, jnp.asarray(lim))))
    np.testing.assert_array_equal(trank.zeros(xt).numpy(), np.asarray(jrank.zeros(xj)))
    x[2] = np.nan  # an all-NaN row gives NaN
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(trank.fmin(xt).numpy(), np.asarray(jrank.fmin(xj)))
    np.testing.assert_array_equal(trank.fmax(xt).numpy(), np.asarray(jrank.fmax(xj)))
