"""The SumThreshold kernel's route and algorithm (``twodflag._sum_threshold1d``), on the CPU.

The kernel (``csrc/sum_threshold.cu``) runs only on a card
(``tests/test_torch_sum_threshold_cuda.py`` holds it to the plain version
there, bit for bit).  Here:

* a tensor on the CPU takes the plain version and counts under "plain";
* the wrapper refuses what the kernel does not take, before it looks for
  a card;
* the kernel's algorithm written out in PyTorch (line by line, each chunk
  or a tile of it with its halo, the windows in order, 8 window starts a
  thread reading each member once, ``fpos``/``fneg`` and the hits as bit
  masks of 8 positions, the dilation by the latest hit, the chunk's crop)
  gives the plain version's bits.

This file imports no jax.
"""

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch.models.rfi import twodflag

GROUP = 8  # window starts (and positions) a kernel thread takes
NONE = -(1 << 30)


def _lines(seed, shape, special=False, flag_frac=0.05):
    """(B, N, M) residual-like float32 data with outliers both ways, and bool flags."""
    rs = np.random.RandomState(seed)
    data = rs.standard_normal(shape).astype(np.float32)
    spikes = rs.random_sample(shape) < 0.03
    data[spikes] *= rs.choice([-12.0, 9.0, 25.0], spikes.sum()).astype(np.float32)
    data[:, shape[1] // 3:shape[1] // 3 + 5] += 3.0  # a broad rise: the wider windows' work
    data[-1, 1, -1] = 60.0  # a spike even the shortest line flags
    flags = rs.random_sample(shape) < flag_frac
    if special:
        flat = data.reshape(-1)
        flat[rs.choice(flat.size, 5)] = np.nan
        flat[rs.choice(flat.size, 3)] = np.inf
        flat[rs.choice(flat.size, 3)] = -np.inf
        flags[0, :, 0] = True  # a line all flagged: threshold inf
    return torch.from_numpy(data), torch.from_numpy(flags)


def _chunks(n, n_chunks):
    """`n_chunks` chunks of `n` as the flagger makes them, or the chunk ends given."""
    if isinstance(n_chunks, list):
        return np.array(n_chunks)
    return np.linspace(0, n, n_chunks + 1).astype(np.int_)


def _plain(data, flags, windows, chunks, nsigma=4.5, rho=1.3):
    threshold = twodflag._chunk_thresholds(data, flags, nsigma, chunks)
    return threshold, twodflag.sum_threshold_plain(data, threshold, windows, rho, chunks)


def _kernel_algorithm(data, threshold, windows, rho, chunks, tile=None):
    """The kernel's steps in plain PyTorch, over every line at once.

    Each chunk in tiles of `tile` outputs (the whole chunk by default), a
    tile's window its outputs with a halo of sum(w - 1) positions each side
    inside the chunk's padded range; per window, each group of 8 window
    starts sums its 8 + w - 1 members, each clamped as it is read and added
    in ascending offset, into hit bits (fpos in bits 0-7, fneg in 8-15);
    then each group of 8 positions ORs in the hits that cover it, found by
    the latest hit at or before each position; the tile's outputs are the
    flags over its own positions.
    """
    n_b, n, n_m = data.shape
    lines = data.permute(0, 2, 1).reshape(n_b * n_m, n)
    t0s_all = threshold.permute(0, 1, 2).reshape(threshold.shape[0], n_b * n_m)
    wmax, halo = max(windows), sum(w - 1 for w in windows)
    divisors, inv_ws = twodflag._window_constants(windows, rho)
    out = torch.zeros(lines.shape, dtype=torch.bool)
    for c in range(len(chunks) - 1):
        lo, hi = int(chunks[c]), int(chunks[c + 1])
        if hi == lo:
            continue
        plo, phi = max(lo - wmax + 1, 0), min(hi + wmax - 1, n)
        p = phi - plo
        for t0 in range(lo, hi, tile or hi - lo):
            t1 = min(hi, t0 + (tile or hi - lo))
            wlo, whi = max(plo, t0 - halo), min(phi, t1 + halo)
            length = whi - wlo
            n_groups = -(-length // GROUP)
            x = torch.zeros(lines.shape[0], length + GROUP - 1)
            x[:, :length] = lines[:, wlo:whi]
            fl = torch.zeros(lines.shape[0], n_groups + 1, dtype=torch.int32)
            for w, divisor, inv_w in zip(windows, divisors, inv_ws):
                if w > p:
                    continue
                assert w <= length  # the halo holds every window that runs
                n_out = length - w + 1
                th = twodflag._div(t0s_all[c], divisor)
                nth = -th

                def member(q):
                    f = fl[:, q // GROUP] >> (q % GROUP)
                    v = torch.where(((f & 1) != 0) & (x[:, q] > th), th, x[:, q])
                    return torch.where(((f & 0x100) != 0) & (v < nth), nth, v)

                hits = torch.zeros(lines.shape[0], n_groups, dtype=torch.int32)
                for g in range(n_groups):
                    i0 = GROUP * g
                    if i0 >= n_out:
                        continue
                    acc = [None] * GROUP
                    for j in range(GROUP + w - 1):
                        v = member(i0 + j)
                        for m in range(GROUP):
                            if j == m:
                                acc[m] = v
                            elif 0 <= j - m < w:
                                acc[m] = acc[m] + v
                    for m in range(GROUP):
                        if i0 + m < n_out:
                            hits[:, g] |= (acc[m] * inv_w > th).to(torch.int32) << m
                            hits[:, g] |= (acc[m] * -inv_w > th).to(torch.int32) << (8 + m)
                dil = torch.zeros_like(hits)
                for g in range(n_groups):
                    last = [torch.full((lines.shape[0],), NONE) for _ in (0, 1)]
                    for gg in range(g - 1, -1, -1):
                        if GROUP * gg + GROUP - 1 < GROUP * g - w + 1:
                            break
                        for half in (0, 1):
                            byte = (hits[:, gg] >> (8 * half)) & 0xFF
                            top = torch.where(byte > 0, GROUP * gg + 31 - _clz(byte), NONE)
                            last[half] = torch.where(last[half] == NONE, top, last[half])
                    for b in range(GROUP):
                        j = GROUP * g + b
                        for half in (0, 1):
                            hit = ((hits[:, g] >> (8 * half + b)) & 1) != 0
                            last[half] = torch.where(hit, j, last[half])
                            dil[:, g] |= ((j - last[half]) < w).to(torch.int32) << (8 * half + b)
                fl[:, :n_groups] |= dil
            for q in range(t0 - wlo, t1 - wlo):
                out[:, wlo + q] = ((fl[:, q // GROUP] >> (q % GROUP)) & 0x101) != 0
    return out.reshape(n_b, n_m, n).permute(0, 2, 1)


def _clz(byte):
    """CUDA's ``__clz`` of a non-zero value below 256, per element (0 for zero)."""
    bits = torch.zeros_like(byte)
    for k in range(8):
        bits = torch.where((byte >> k) & 1 != 0, k, bits)
    return torch.where(byte > 0, 31 - bits, 0)


def test_a_cpu_tensor_takes_the_plain_route(monkeypatch):
    monkeypatch.setattr(twodflag, "sum_thresholds", {"kernel": 0, "plain": 0})
    monkeypatch.setattr(twodflag, "launches", {"box_strided": 0, "box_rows": 0,
                                               "sum_threshold": 0})
    data, flags = _lines(1, (3, 40, 20))
    chunks = _chunks(20, 4)
    got = twodflag._sum_threshold(data, flags, 1, [1, 2, 4, 8], 4.5, 1.3, chunks)
    assert twodflag.sum_thresholds == {"kernel": 0, "plain": 1}
    threshold, want = _plain(data.transpose(1, 2), flags.transpose(1, 2), [1, 2, 4, 8], chunks)
    assert torch.equal(got, want.transpose(1, 2))
    twodflag._sum_threshold(data, flags, 0, [1, 2, 4, 8], 4.5, 1.3)
    assert twodflag.sum_thresholds == {"kernel": 0, "plain": 2}
    assert twodflag.launches["sum_threshold"] == 0


def test_the_chunk_thresholds_are_the_chunk_medians():
    data, flags = _lines(2, (2, 30, 3), special=True)
    chunks = np.array([0, 10, 10, 30])
    threshold = twodflag._chunk_thresholds(data, flags, 4.5, chunks)
    assert threshold.shape == (3, 2, 3) and threshold.dtype == torch.float32
    scale = np.float32(4.5 * twodflag.MAD_NORMAL)
    for c, (lo, hi) in enumerate([(0, 10), (10, 30)]):
        med = twodflag._median_abs_axis0(data[:, lo:hi], flags[:, lo:hi])[:, 0]
        want = torch.where(torch.isnan(med), torch.inf, med * float(scale))
        assert torch.equal(threshold[2 * c], want)
    assert torch.isinf(threshold[1]).all()  # the zero-length chunk
    assert torch.isinf(threshold[:, 0, 0]).all()  # the line all flagged


@pytest.mark.parametrize("shape, windows, n_chunks, tile, special", [
    ((2, 75, 3), [1, 2, 4, 8], 1, None, False),  # a calibrator scan's time lines
    ((2, 75, 3), [1, 2, 4, 8], 1, None, True),  # NaN and inf, a line all flagged
    ((3, 200, 1), [1, 2, 4, 8], 8, None, False),  # a spectrum's (B, F, 1), 8 chunks
    ((2, 150, 2), [1, 2, 4, 8], 10, None, True),  # 10 chunks
    ((2, 5, 3), [1, 2, 4, 8], 1, None, False),  # windows longer than the line
    ((2, 6, 2), [1, 2, 4, 8], 10, None, True),  # chunks of 0 and 1 samples
    ((2, 40, 2), [1, 2, 4, 8], [0, 0, 17, 17, 40, 40], None, True),  # zero-length chunks
    ((1, 150, 2), [1, 2, 4, 8, 16, 32, 64], 1, None, True),
    ((1, 150, 2), [1, 2, 4, 8, 16, 32, 64], 8, None, False),  # windows past the chunks
    ((2, 100, 2), [1, 2, 4, 8], 1, 7, True),  # tiles with halos
    ((2, 160, 2), [1, 2, 4, 8], 8, 9, False),
    ((1, 140, 2), [1, 2, 4, 8, 16, 32], 1, 30, True),
    ((2, 40, 2), [8, 3, 1, 5], 2, None, True),  # windows in no order, not powers of two
])
def test_the_kernel_algorithm_gives_the_plain_bits(shape, windows, n_chunks, tile, special):
    data, flags = _lines(3, shape, special=special)
    chunks = _chunks(shape[1], n_chunks)
    threshold, want = _plain(data, flags, windows, chunks)
    # chunks of one sample flag nothing: each is its own noise estimate
    assert not want.all() and (want.any() or shape[1] < len(chunks) - 1)
    got = _kernel_algorithm(data, threshold, windows, 1.3, chunks, tile)
    assert torch.equal(got, want)


def test_the_kernel_algorithm_at_another_falloff():
    data, flags = _lines(4, (2, 60, 2), special=True)
    chunks = _chunks(60, 3)
    threshold = twodflag._chunk_thresholds(data, flags, 3.0, chunks)
    want = twodflag.sum_threshold_plain(data, threshold, [1, 2, 4, 8], 0.8, chunks)
    assert torch.equal(_kernel_algorithm(data, threshold, [1, 2, 4, 8], 0.8, chunks), want)


def test_the_axes_put_the_least_stride_across_the_lines():
    shape = (2016, 75, 1024)
    baselines_inner = (1, 1024 * 2016, 2016)  # the flagger's time lines
    assert twodflag.sum_threshold_axes(shape, baselines_inner) == (2, 1, 0)
    freq = (2016, 1024, 75)  # its frequency lines, the transposed view
    assert twodflag.sum_threshold_axes(freq, (1, 2016, 1024 * 2016)) == (2, 1, 0)
    assert twodflag.sum_threshold_axes(shape, (75 * 1024, 1024, 1)) == (0, 1, 2)
    assert twodflag.sum_threshold_axes(freq, (75 * 1024, 1, 1024)) == (0, 1, 2)
    # a spectrum, (B, F, 1): the size-1 axis is never the columns
    assert twodflag.sum_threshold_axes((2016, 1024, 1), (1024, 1, 1)) == (2, 1, 0)


def _args(n=12, n_chunks=2):
    data, _ = _lines(5, (2, n, 3))
    return data, torch.ones((n_chunks, 2, 3)), [1, 2, 4], _chunks(n, n_chunks)


@pytest.mark.parametrize("change, error, match", [
    (lambda d, t, w, c: (d, t, w, c), ValueError, "one card"),  # CPU tensors
    (lambda d, t, w, c: (d.double(), t, w, c), TypeError, "float32"),
    (lambda d, t, w, c: (d, t.double(), w, c), TypeError, "float32"),
    (lambda d, t, w, c: (d.numpy(), t, w, c), TypeError, "tensors"),
    (lambda d, t, w, c: (d[0], t, w, c), ValueError, r"\(B, N, M\)"),
    (lambda d, t, w, c: (d, t, w, c[:-1]), ValueError, "chunks"),  # short of N
    (lambda d, t, w, c: (d, t, w, c + 1), ValueError, "chunks"),  # not from 0
    (lambda d, t, w, c: (d, t, w, c[::-1]), ValueError, "chunks"),
    (lambda d, t, w, c: (d, t, w, np.array([0])), ValueError, "chunks"),
    (lambda d, t, w, c: (d, t[:1], w, c), ValueError, "threshold"),
    (lambda d, t, w, c: (d, t, [], c), ValueError, "windows"),
    (lambda d, t, w, c: (d, t, [0, 1], c), ValueError, "windows"),
    (lambda d, t, w, c: (d, t, list(range(1, 34)), c), ValueError, "windows"),
])
def test_the_cuda_wrapper_refuses_what_the_kernel_does_not_take(change, error, match):
    data, threshold, windows, chunks = change(*_args())
    with pytest.raises(error, match=match):
        twodflag.sum_threshold_cuda(data, threshold, windows, 1.3, chunks)


def test_the_cuda_wrapper_takes_any_number_of_chunks():
    data, _, windows, _ = _args(n=300)
    for n_chunks in (128, 129, 300):  # past 128, one launch for each 128
        with pytest.raises(ValueError, match="one card"):  # they pass the checks
            twodflag.sum_threshold_cuda(data, torch.ones((n_chunks, 2, 3)), windows, 1.3,
                                        _chunks(300, n_chunks))


@pytest.mark.parametrize("n, n_chunks, windows, fits", [
    (400, 1, [2 ** k for k in range(8)], False),  # halo 247 on a padded chunk of 400
    (400, 1, [1, 2, 4, 8, 16, 32, 64], True),  # halo 120: tiles of 84 outputs
    (324, 1, [2 ** k for k in range(8)], True),  # the whole line in one tile
    (2000, 10, [1, 2, 4, 8, 16, 32, 64, 82], False),  # halo 201 > 161
    (2000, 10, [1, 2, 4, 8, 16, 32, 64, 42], True),  # halo 161
    (3000, 1, [1, 2, 4, 8], True),  # 3000 dumps, halo 11
])
def test_the_cuda_wrapper_refuses_a_halo_that_leaves_no_room(n, n_chunks, windows, fits):
    data = torch.zeros((1, n, 2))
    match = "one card" if fits else "leave no room"
    with pytest.raises(ValueError, match=match):
        twodflag.sum_threshold_cuda(data, torch.ones((n_chunks, 1, 2)), windows, 1.3,
                                    _chunks(n, n_chunks))
