"""The masked-median kernel's route and algorithm (``twodflag.masked_median``), on the CPU.

The kernel (``csrc/masked_median.cu``) runs only on a card
(``tests/test_torch_masked_median_cuda.py`` holds it to the plain version
there, bit for bit).  Here:

* the kernel's algorithm written out in numpy (keys whose unsigned order is
  the sort's, the radix-4 search of counts from the highest bit in which the
  least and greatest keys differ, stopping where one key is left, the last
  pass for rank k and the greatest key below it) gives the plain version's
  bits on ties, NaN, +-inf, +-0, masked lines, n of 0, 1, 2, odd and even,
  and zero-length chunks;
* the wrapper's mapping of the flagger's four layouts to the kernel's axes;
* a tensor on the CPU takes the plain version and counts under "plain";
* ``_chunk_thresholds`` and ``_get_background2d``, with every chunk in one
  call, give the bits of a median a chunk.

This file imports no jax.
"""

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import twodflag

MASKED = np.uint64(0xFFFFFFFF)
NAN_KEY = np.uint64(0xFFFFFFFE)
ZERO_KEY = np.uint64(0x80000000)
CANONICAL_NAN = np.uint32(0x7FC00000)


def _adversarial(seed, shape, flag_frac=0.3):
    """Float32 data of ties, signed zeros, infinities, NaN and noise, and bool flags."""
    rs = np.random.RandomState(seed)
    choices = np.array([0.0, -0.0, 0.5, -0.5, 1.0, 1.0, 2.0, -3.0, np.inf, -np.inf, np.nan,
                        1e-45, -1e-45], np.float32)
    data = rs.choice(choices, shape).astype(np.float32)
    noisy = rs.random_sample(shape) < 0.4
    data[noisy] = rs.standard_normal(noisy.sum()).astype(np.float32)
    if data.size:  # NaN with a payload and its sign set
        data.reshape(-1).view(np.uint32)[rs.choice(data.size, 1 + data.size // 50)] = 0xFFC00001
    flags = rs.random_sample(shape) < flag_frac
    if shape[1]:
        flags[0] = True  # a baseline all masked
    return torch.from_numpy(data), torch.from_numpy(flags)


def _keys(x, flagged, take_abs):
    """The kernel's key_of: the sort's order as unsigned order, masked entries last."""
    x = np.abs(x) if take_abs else x
    bits = x.view(np.uint32).astype(np.uint64)
    key = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    key = np.where(x == 0, ZERO_KEY, key)
    key = np.where(np.isnan(x), NAN_KEY, key)
    return np.where(flagged, MASKED, key).astype(np.uint64)


def _values(key):
    """The kernel's value_of: a key back to its float32, NaN canonical."""
    bits = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    bits = np.where(key >= NAN_KEY, CANONICAL_NAN, bits).astype(np.uint32)
    return bits.view(np.float32)


def _select(keys, empty):
    """The kernel's selection over the rows of (P, L) keys; returns (medians, rounds).

    Per population: n valid, m of them not NaN, the least and greatest
    non-NaN keys; then the search of counts from their highest differing
    bit, two bits a round (counts below three candidates), while the
    quarter holding rank k holds more than one key; then the least key at
    or above the prefix (rank k) and the greatest below it (rank k - 1
    where exactly k keys lie below).
    """
    n = (keys != MASKED).sum(1)
    m = (keys < NAN_KEY).sum(1)
    k = n // 2
    kmin = np.where(keys < NAN_KEY, keys, np.uint64(0xFFFFFFFF)).min(1, initial=0xFFFFFFFF)
    kmax = np.where(keys < NAN_KEY, keys, np.uint64(0)).max(1, initial=0)
    diff = kmin ^ kmax
    bit = np.array([int(d).bit_length() - 1 for d in diff])
    lo = np.where(bit < 0, kmin, kmin & ~((np.uint64(2) << np.maximum(bit, 0).astype(np.uint64))
                                          - np.uint64(1)))
    below, inside = np.zeros_like(n), m.copy()
    rounds = np.zeros_like(n)
    while True:
        active = (k < m) & (bit >= 0) & (inside > 1)
        if not active.any():
            break
        step = np.uint64(1) << np.maximum(bit - 1, 0).astype(np.uint64)
        cands = [lo + np.uint64(j) * step for j in (1, 2, 3)]
        c1, c2, c3 = ((keys < cand[:, None]).sum(1) for cand in cands)
        quarter = np.where(k < c1, 0, np.where(k < c2, 1, np.where(k < c3, 2, 3)))
        new_in = np.choose(quarter, [c1 - below, c2 - c1, c3 - c2, below + inside - c3])
        new_below = np.choose(quarter, [below, c1, c2, c3])
        new_lo = np.choose(quarter, [lo] + cands)
        inside = np.where(active, new_in, inside)
        below = np.where(active, new_below, below)
        lo = np.where(active, new_lo, lo)
        bit = np.where(active, bit - 2, bit)
        rounds += active
    u = np.where(keys >= lo[:, None], keys, np.uint64(0xFFFFFFFF)).min(1, initial=0xFFFFFFFF)
    mx = np.where(keys < lo[:, None], keys, np.uint64(0)).max(1, initial=0)
    upper = _values(u)
    lower = np.where(below == k, _values(mx), upper)
    with np.errstate(invalid="ignore", over="ignore"):
        mean = (upper + lower) * np.float32(0.5)
        out = np.where(((n & 1) == 0) & (lower < upper), mean, upper).astype(np.float32)
    out = np.where(k >= m, np.array(CANONICAL_NAN).view(np.float32), out)
    out = np.where(n == 0, np.float32(empty), out).astype(np.float32)
    return out, rounds


def _kernel_algorithm(data, flags, chunks, *, empty_value, take_abs=False, blocks=False):
    """The kernel's result of (B, N, M) `data`: (chunks, B, M or 1), and the rounds each took."""
    x, f = data.numpy(), flags.numpy() != 0
    n_b, _, n_m = x.shape
    outs, rounds = [], []
    for lo, hi in zip(chunks[:-1], chunks[1:]):
        xs, fs = x[:, lo:hi], f[:, lo:hi]
        if blocks:
            pop, pop_f = xs.reshape(n_b, -1), fs.reshape(n_b, -1)
        else:
            pop, pop_f = xs.transpose(0, 2, 1).reshape(n_b * n_m, -1), \
                fs.transpose(0, 2, 1).reshape(n_b * n_m, -1)
        med, r = _select(_keys(pop, pop_f, take_abs), empty_value)
        outs.append(med.reshape(n_b, -1))
        rounds.append(r)
    return torch.from_numpy(np.stack(outs)), np.concatenate(rounds)


def _bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("take_abs", [False, True])
@pytest.mark.parametrize("blocks", [False, True])
@pytest.mark.parametrize("shape, chunks", [
    ((5, 0, 3), [0, 0]),  # no entries at all
    ((6, 1, 4), [0, 1]),  # n of 0 or 1
    ((6, 2, 4), [0, 2]),  # n of 0, 1 or 2
    ((7, 9, 5), [0, 9]),
    ((7, 10, 5), [0, 0, 3, 3, 10]),  # zero-length chunks among odd and even ones
    ((4, 75, 33), [0, 75]),
    ((3, 130, 6), list(np.linspace(0, 130, 9).astype(int))),
])
def test_the_kernel_algorithm_gives_the_plain_bits(shape, chunks, blocks, take_abs):
    data, flags = _adversarial(sum(shape) + 7 * len(chunks), shape)
    for empty in (0.0, np.nan):
        want = twodflag.masked_median_plain(data, flags, np.array(chunks), empty_value=empty,
                                            take_abs=take_abs, blocks=blocks)
        got, _ = _kernel_algorithm(data, flags, chunks, empty_value=empty, take_abs=take_abs,
                                   blocks=blocks)
        _bits_equal(got, want)


@pytest.mark.parametrize("fill", [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0])
def test_lines_of_one_value(fill):
    """A line of one repeated value, and one where that value ties a noisy half."""
    rs = np.random.RandomState(3)
    data = np.full((4, 12, 6), fill, np.float32)
    data[2:, :6] = rs.standard_normal((2, 6, 6)).astype(np.float32)
    flags = rs.random_sample(data.shape) < 0.2
    data, flags = torch.from_numpy(data), torch.from_numpy(flags)
    want = twodflag.masked_median_plain(data, flags, [0, 12], empty_value=np.nan)
    got, _ = _kernel_algorithm(data, flags, [0, 12], empty_value=np.nan)
    _bits_equal(got, want)


def test_the_search_stops_where_one_key_is_left():
    """|noise| settles in about (log2(n) + 8) / 2 rounds of two bits (some spent on the
    exponent's bits), not 16."""
    rs = np.random.RandomState(4)
    for length in (75, 128, 9600):
        data = torch.from_numpy(np.abs(rs.standard_normal((64, length, 1))).astype(np.float32))
        flags = torch.from_numpy(rs.random_sample(data.shape) < 0.05)
        got, rounds = _kernel_algorithm(data, flags, [0, length], empty_value=np.nan)
        _bits_equal(got, twodflag.masked_median_plain(data, flags, [0, length],
                                                      empty_value=np.nan))
        assert np.median(rounds) <= (np.log2(length) + 9) / 2, (length, np.median(rounds))
        assert rounds.max() < 16


def test_the_axes_put_the_least_stride_across_the_lines():
    """The flagger's four layouts: time lines, frequency lines, the 2-D block, the spectrum."""
    b, t, f = 40, 75, 1024
    inner = torch.zeros((t, f, b)).permute(2, 0, 1)  # (B, T, F), baselines innermost
    dense = torch.zeros((b, t, f))
    spectrum = torch.zeros((b, 1, f))
    cases = [
        (inner, False, (2, 0, 1, None)),  # time lines: 32 baselines a warp
        (inner.transpose(1, 2), False, (2, 0, 1, None)),  # frequency lines, baselines innermost
        (dense.transpose(1, 2), False, (0, 2, 1, None)),  # frequency lines along the contiguous axis
        (dense.transpose(1, 2), True, (None, 0, 1, 2)),  # the 2-D background's blocks
        (spectrum.transpose(1, 2), False, (2, 0, 1, None)),  # the spectrum: never the axis of 1
        (spectrum.transpose(1, 2), True, (None, 0, 1, 2)),
    ]
    for view, blocks, want in cases:
        assert twodflag.masked_median_axes(tuple(view.shape), view.stride(), blocks) == want


@pytest.mark.parametrize("blocks", [False, True])
def test_the_launch_arguments(blocks):
    data = torch.zeros((75, 1024, 40)).permute(2, 0, 1).transpose(1, 2)  # (B, F, T)
    flags = torch.zeros((40, 75, 1024), dtype=torch.bool).transpose(1, 2)
    chunks = [int(c) for c in np.linspace(0, 1024, 9)]
    out = torch.empty((8, 40, 1 if blocks else 75))
    args = twodflag._mm_args(data, flags, chunks, out, empty_value=float("nan"), take_abs=True,
                             blocks=blocks)
    axes = twodflag.masked_median_axes(tuple(data.shape), data.stride(), blocks)
    assert list(args.n) == [1 if a is None else data.shape[a] for a in axes]
    assert list(args.sd) == [0 if a is None else data.stride(a) for a in axes]
    assert list(args.sf) == [0 if a is None else flags.stride(a) for a in axes]
    if blocks:  # (chunk, outer, column): the baselines are the columns
        assert list(args.so) == [40, 0, 1] and list(args.n) == [1, 40, 1024, 75]
    else:  # outer the dumps, columns the baselines
        assert list(args.so) == [40 * 75, 1, 75] and list(args.n) == [75, 40, 1024, 1]
    assert args.n_chunks == 8 and list(args.chunk_ends)[:9] == chunks and args.take_abs == 1


def test_a_cpu_tensor_takes_the_plain_route(monkeypatch):
    monkeypatch.setattr(twodflag, "medians", {"kernel": 0, "plain": 0})
    monkeypatch.setattr(twodflag, "launches", {"box_strided": 0, "box_rows": 0,
                                               "sum_threshold": 0, "median": 0})
    data, flags = _adversarial(5, (3, 20, 16))
    twodflag._time_median(data, flags)
    twodflag._median_abs(data, flags)
    twodflag._median_abs_axis0(data, flags)
    twodflag._chunk_thresholds(data, flags, 4.5, np.array([0, 5, 5, 20]))
    assert twodflag.medians == {"kernel": 0, "plain": 4}
    rs = np.random.RandomState(6)
    scan = np.abs(rs.standard_normal((24, 40, 5))).astype(np.float32)
    twodflag.SumThresholdFlagger(freq_chunks=4).get_flags(scan, np.zeros(scan.shape, bool),
                                                          device="cpu")
    # a batch: the time median, the spectrum's background and thresholds, the
    # 2-D background, the time and the frequency thresholds
    assert twodflag.medians == {"kernel": 0, "plain": 4 + 6}
    assert twodflag.launches["median"] == 0


@pytest.mark.parametrize("chunks", [[0, 30], [0, 10, 10, 30], [0, 0, 7, 30, 30]])
def test_the_chunk_thresholds_are_the_chunk_medians(chunks):
    data, flags = _adversarial(7, (4, 30, 6), flag_frac=0.2)
    threshold = twodflag._chunk_thresholds(data, flags, 4.5, np.array(chunks))
    scale = float(np.float32(4.5 * twodflag.MAD_NORMAL))
    for c, (lo, hi) in enumerate(zip(chunks[:-1], chunks[1:])):
        if hi == lo:
            want = torch.full((4, 6), torch.inf)
        else:
            med = twodflag._median_abs_axis0(data[:, lo:hi], flags[:, lo:hi])[:, 0]
            want = torch.where(torch.isnan(med), torch.inf, med * scale)
        _bits_equal(threshold[c], want)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("shape, n_chunks", [((3, 24, 40), 4), ((5, 1, 64), 8), ((2, 9, 12), 5)])
def test_the_background_takes_every_chunk_in_one_call(shape, n_chunks, iterations, monkeypatch):
    """The 2-D background's thresholds and flags are those of a median a chunk."""
    rs = np.random.RandomState(sum(shape))
    data = np.abs(rs.standard_normal(shape)).astype(np.float32) + 1
    data[rs.random_sample(shape) < 0.02] = 40.0
    data, flags = torch.from_numpy(data), torch.from_numpy(rs.random_sample(shape) < 0.1)
    ends = np.linspace(0, shape[2], n_chunks + 1).astype(np.int_)
    spike_width, reject = np.array((1.5, 2.0)), 2.0
    scale = twodflag._f32(twodflag.MAD_NORMAL * reject)

    def chunk_by_chunk(d, f):
        for factor in range(iterations, 0, -1):
            sigma = np.concatenate([[0.0], factor * spike_width])
            background = twodflag.masked_gaussian_filter(d, f, sigma)
            new = []
            for lo, hi in zip(ends[:-1], ends[1:]):
                sub = torch.abs(d[:, :, lo:hi] - background[:, :, lo:hi])
                new.append(sub > (twodflag._median_abs(sub, f[:, :, lo:hi]) * scale)[:, None, None])
            f = f | torch.cat(new, dim=2)
        return f

    seen = []
    real = twodflag.masked_gaussian_filter
    monkeypatch.setattr(twodflag, "masked_gaussian_filter",
                        lambda d, f, sigma: seen.append(f) or real(d, f, sigma))
    monkeypatch.setattr(twodflag, "medians", {"kernel": 0, "plain": 0})
    twodflag._get_background2d(data, flags, iterations, spike_width, reject, ends)
    assert twodflag.medians["plain"] == iterations  # every chunk in one call
    assert torch.equal(seen[-1], chunk_by_chunk(data, flags))


def test_the_masked_median_axis0_is_one_chunk():
    data, flags = _adversarial(8, (3, 11, 2, 4))
    got = twodflag._masked_median_axis0(data, ~flags, empty_value=0.0)
    want = twodflag.masked_median_plain(data.reshape(3, 11, 8), flags.reshape(3, 11, 8), [0, 11],
                                        empty_value=0.0)[0].reshape(3, 2, 4)
    _bits_equal(got, want)


@pytest.mark.parametrize("change, error, match", [
    (lambda d, f, c: (d.double(), f, c), TypeError, "float32"),
    (lambda d, f, c: (d, f.float(), c), TypeError, "uint8"),
    (lambda d, f, c: (d[0], f[0], c), ValueError, r"\(B, N, M\)"),
    (lambda d, f, c: (d, f[:, :3], c), ValueError, r"\(B, N, M\)"),
    (lambda d, f, c: (d, f, [0, 3, 11]), ValueError, "chunks"),
    (lambda d, f, c: (d, f, [0, 6, 3, 12]), ValueError, "chunks"),
    (lambda d, f, c: (d, f, c), ValueError, "one card"),
])
def test_the_cuda_wrapper_refuses_what_the_kernel_does_not_take(change, error, match):
    data, flags = _adversarial(9, (2, 12, 3))
    with pytest.raises(error, match=match):
        twodflag.masked_median_cuda(*change(data, flags, [0, 6, 12]), empty_value=0.0)
