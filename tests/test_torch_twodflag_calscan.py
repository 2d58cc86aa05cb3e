"""The 2-D flagger as the benchmark's calibrator-scan cell runs it, on the CPU at small sizes.

* ``flagbench/reference_twod.py`` (the cell's plain reference) equals the
  numpy oracle ``tests/rfi/twodflag_oracle.py`` and the port's
  ``get_flags(..., device="cpu")`` mask for mask, with katsdpcal's
  calibrator settings and with the flagger's defaults, on seeded cubes and
  the oracle's edge cases;
* ``get_flags`` takes a tensor and gives a tensor of the same shape, equal
  to the numpy path's flags;
* the batches: 16 baselines on the CPU, an explicit ``chunk_size``
  honoured, and on a CUDA device :func:`batch_baselines`, which prefers a
  divisor of the baselines;
* the spans and the ``batches`` counter.

The ``cuda`` tests (a scan on the card stays there; no synchronise on the
path) skip without a card.  This file imports no jax::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_twodflag_calscan.py -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flagbench import reference_twod
from katsdpsigproc_tpu_torch.models.rfi import twodflag
from katsdpsigproc_tpu_torch.models.rfi.twodflag import SumThresholdFlagger
from katsdpsigproc_tpu_torch.utils import profiling

from .rfi import twodflag_oracle as oracle

ROOT = Path(__file__).resolve().parents[1]
CALSCAN = json.loads((ROOT / "flagbench" / "configs" / "meerkat-l-4k-calscan.json").read_text())
PARAMS = {"calscan": CALSCAN["flagger"], "defaults": {}}
STAGES = ("ksp.twod.average", "ksp.twod.spectrum", "ksp.twod.background",
          "ksp.twod.sum_threshold.time", "ksp.twod.sum_threshold.freq", "ksp.twod.finish")


def _cube(seed, shape, complex_data=True):
    """Noise with planted spikes and narrowband runs, (time, freq, bl)."""
    rs = np.random.RandomState(seed)
    if complex_data:
        data = rs.standard_normal(shape) + 1j * rs.standard_normal(shape) + 4.0
    else:
        data = np.abs(rs.standard_normal(shape) + 4.0)
    data = data + (rs.random_sample(shape) < 0.01) * (30.0 + 10.0 * rs.random_sample(shape))
    data[:, shape[1] // 3:shape[1] // 3 + 3] += 3.0 * (rs.random_sample(shape[::2]) < 0.2)[:, None]
    return data.astype(np.complex64 if complex_data else np.float32), rs


def _seeded():
    data, rs = _cube(31, (24, 96, 3))
    return data, rs.random_sample(data.shape) < 0.02


def _channel_mask():
    data, rs = _cube(32, (20, 80, 2))
    flags = rs.random_sample(data.shape) < 1 / 256
    flags[:, 25:35] = True  # a static mask, as of a downlink band
    return data, flags


def _all_flagged_chunk():
    data, _ = _cube(33, (16, 96, 2))
    flags = np.zeros(data.shape, bool)
    flags[:, 0:12] = True  # the first chunk of 8, the first of 10 and more
    return data, flags


def _nan_in_one_part():
    data, rs = _cube(34, (16, 64, 2))
    re, im = data.real.copy(), data.imag.copy()
    re[rs.random_sample(re.shape) < 0.03] = np.nan
    im[rs.random_sample(im.shape) < 0.03] = np.nan
    return (re + 1j * im).astype(np.complex64), np.zeros(data.shape, bool)


def _chunks_exceed_channels():
    data, _ = _cube(35, (16, 6, 2))
    return data, np.zeros(data.shape, bool)


def _windows_time_quirk():
    """3 channels: windows_time is clipped by the channel count, not the dumps."""
    data, _ = _cube(36, (40, 3, 1))
    return data, np.zeros(data.shape, bool)


def _magnitudes():
    data, rs = _cube(37, (20, 64, 2), complex_data=False)
    return data, rs.random_sample(data.shape) < 0.05


CASES = {f.__name__[1:]: f for f in (_seeded, _channel_mask, _all_flagged_chunk, _nan_in_one_part,
                                     _chunks_exceed_channels, _windows_time_quirk, _magnitudes)}


def _reference(data, flags, params, **kw):
    return reference_twod.flag_scan(torch.from_numpy(data), torch.from_numpy(flags), params,
                                    **kw).numpy()


@pytest.mark.parametrize("params", list(PARAMS))
@pytest.mark.parametrize("case", list(CASES))
def test_reference_equals_the_oracle_and_the_port(case, params):
    data, flags = CASES[case]()
    kw = PARAMS[params]
    want = oracle.get_flags(data, flags, **kw)
    got = _reference(data, flags, kw)
    assert got.dtype == np.bool_ and got.shape == data.shape
    assert int((got != want).sum()) == 0, "the reference differs from the numpy oracle"
    port = SumThresholdFlagger(**kw).get_flags(data, flags, device="cpu")
    assert int((got != port).sum()) == 0, "the reference differs from the port"
    if case == "seeded":
        assert 0.01 < want.mean() < 0.6


def test_reference_blocks_flag_as_one():
    data, flags = _seeded()
    whole = _reference(data, flags, PARAMS["calscan"])
    np.testing.assert_array_equal(_reference(data, flags, PARAMS["calscan"], block=2), whole)


def test_reference_in_bfloat16_differs():
    """The control: the reference in bfloat16 does not give the float32 flags."""
    data, flags = _seeded()
    exact = _reference(data, flags, PARAMS["calscan"])
    low = _reference(data, flags, PARAMS["calscan"], dtype=torch.bfloat16)
    assert int((low != exact).sum()) > 0


@pytest.mark.parametrize("complex_data", [True, False], ids=["complex", "magnitude"])
def test_a_tensor_gives_a_tensor(complex_data):
    data, rs = _cube(40, (20, 48, 5), complex_data)
    flags = (rs.random_sample(data.shape) < 0.05).astype(np.uint8)
    flagger = SumThresholdFlagger(**PARAMS["calscan"])
    want = flagger.get_flags(data, flags, device="cpu")
    got = flagger.get_flags(torch.from_numpy(data), torch.from_numpy(flags), device="cpu")
    assert isinstance(want, np.ndarray) and want.dtype == np.bool_
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
    assert got.shape == data.shape and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def _batches_of(fn):
    before = dict(twodflag.batches)
    fn()
    return {k: twodflag.batches[k] - before[k] for k in before}


def test_the_cpu_batch_is_16_and_chunk_size_is_honoured():
    data, _ = _cube(41, (12, 24, 40))
    flags = np.zeros(data.shape, bool)
    flagger = SumThresholdFlagger(**PARAMS["calscan"])
    out = {}
    assert _batches_of(lambda: out.setdefault(None, flagger.get_flags(data, flags, device="cpu"))) \
        == {"calls": 1, "batches": 3, "baselines": 40}
    assert _batches_of(lambda: out.setdefault(7, flagger.get_flags(data, flags, chunk_size=7,
                                                                  device="cpu"))) \
        == {"calls": 1, "batches": 6, "baselines": 40}
    np.testing.assert_array_equal(out[7], out[None])


# The caching allocator's peak over one batch less what it held before, per
# baseline and channel, on an H100 (calscan's flagger, time radius 10 unless
# named): (dumps, time radius, bytes).
MEASURED = [(8, 10, 2509.0), (16, 10, 2929.0), (32, 10, 3769.0), (75, 10, 6214.0),
            (150, 10, 12468.0), (300, 10, 24936.0), (1000, 10, 82512.0), (3000, 10, 246672.0),
            (16, 1, 1312.0), (75, 21, 7859.0)]


@pytest.mark.parametrize("n_time, radius, measured", MEASURED)
def test_the_batch_model_covers_the_measured_peaks(n_time, radius, measured):
    modelled = twodflag.batch_bytes(n_time, 1024, radius) / 1024
    assert measured <= modelled <= 1.08 * measured


@pytest.mark.parametrize("free, size", [
    (80 * 10 ** 9, 2016),  # 2496 fit BATCH_BYTES: the divisor 2016 of 8064 (4 batches)
    (2 ** 36, 2016),  # half the free memory is more than BATCH_BYTES: the same batch
    (2 ** 36 + 5 * 10 ** 9, 2016),
    (26 * 10 ** 9, 2015),  # half of it holds 2015: no divisor of 8064 in 1512-2015
    (2 ** 29, 36),  # 41 fit: 36 and 32 divide 8064, 36 is the larger
])
def test_the_card_batch_prefers_a_divisor_near_what_fits(free, size):
    assert twodflag.batch_baselines(75, 1024, 8064, 10, free) == size


def test_the_card_batch_is_bounded():
    assert twodflag.batch_baselines(75, 1024, 8064, 10, 0) == 1
    assert twodflag.batch_baselines(75, 1024, 60, 10, 2 ** 36) == 60
    # 8063 = 11 * 733: no divisor within the slack below the 1331 that fit
    assert twodflag.batch_baselines(75, 1024, 8063, 10, 2 ** 34) == 1331
    # few dumps: the box filter's padding sets the size, 2.5 times 82 B a sample
    assert twodflag.batch_baselines(8, 1024, 8064, 10, 2 ** 37) == 6231


@pytest.fixture
def no_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _raise(*args, **kwargs):
    raise AssertionError("a span was opened with the profiler off")


def test_spans_cost_nothing_when_off(monkeypatch, no_spans):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(profiling, "_Annotation", _raise)
    data, flags = _seeded()
    SumThresholdFlagger(**PARAMS["calscan"]).get_flags(data, flags, chunk_size=2, device="cpu")
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_spans_and_counter_under_a_trace(tmp_path, no_spans):
    data, flags = _seeded()
    flagger = SumThresholdFlagger(**PARAMS["calscan"])
    with profiling.trace(str(tmp_path / "trace.json")) as prof:
        counted = _batches_of(lambda: flagger.get_flags(data, flags, chunk_size=2, device="cpu"))
    assert counted == {"calls": 1, "batches": 2, "baselines": 3}
    spans = profiling.spans()
    call, = [s for s in spans if s.name == "ksp.twod.get_flags"]
    assert call.parent is None and call.key is None
    batch = [s for s in spans if s.name == "ksp.twod.batch"]
    assert [s.key for s in batch] == [0, 2]
    assert all(s.parent == call.id for s in batch)
    for b in batch:
        inside = [s for s in spans if s.parent == b.id]
        # the NaN flags are a second finish span, after the one of the combining
        assert [s.name for s in sorted(inside, key=lambda s: s.start_ns)] == [*STAGES,
                                                                             STAGES[-1]]
        assert all(s.key == b.key and b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns
                   for s in inside)
    host = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    assert {"ksp.twod.get_flags", "ksp.twod.batch", *STAGES} <= host


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_scan_on_the_card_stays_there(cuda):
    data, rs = _cube(50, (75, 128, 40))
    flags = (rs.random_sample(data.shape) < 1 / 256).astype(np.uint8)
    flagger = SumThresholdFlagger(**PARAMS["calscan"])
    scan, scan_flags = torch.from_numpy(data).to(cuda), torch.from_numpy(flags).to(cuda)
    counted = _batches_of(lambda: flagger.get_flags(scan, scan_flags))
    assert counted == {"calls": 1, "batches": 1, "baselines": 40}
    got = flagger.get_flags(scan, scan_flags)
    assert got.device == cuda and got.dtype == torch.bool and got.shape == data.shape
    want = flagger.get_flags(data, flags, device="cpu")
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    ref = reference_twod.flag_scan(scan, scan_flags, PARAMS["calscan"])
    assert torch.equal(ref, got)


@pytest.mark.cuda
def test_a_short_scan_of_many_baselines_fits_its_batch(cuda):
    """8 dumps, where the box filter's padding is most of a batch's memory."""
    shape = (8, 1024, 4032)
    g = torch.Generator(device=cuda).manual_seed(52)
    scan = torch.randn(shape, dtype=torch.complex64, device=cuda, generator=g) + 4
    scan_flags = (torch.rand(shape, device=cuda, generator=g) < 1 / 256).to(torch.uint8)
    flagger = SumThresholdFlagger(**PARAMS["calscan"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    counted = _batches_of(lambda: flagger.get_flags(scan, scan_flags))
    got = flagger.get_flags(scan, scan_flags)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - held
    assert counted == {"calls": 1, "batches": 1, "baselines": 4032}
    # both calls' flags, one of them alive through the other's batch
    assert peak <= 4032 * twodflag.batch_bytes(8, 1024, 10) + 2 * got.numel()
    assert torch.equal(got, reference_twod.flag_scan(scan, scan_flags, PARAMS["calscan"]))


@pytest.mark.cuda
def test_no_synchronise_on_the_card_path(cuda):
    data, _ = _cube(51, (30, 64, 12))
    scan = torch.from_numpy(data).to(cuda)
    flags = torch.zeros(scan.shape, dtype=torch.uint8, device=cuda)
    flagger = SumThresholdFlagger(**PARAMS["calscan"])
    flagger.get_flags(scan, flags, chunk_size=5)  # loads every kernel first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flagger.get_flags(scan, flags, chunk_size=5)
        flagger.get_flags(scan, flags)
    finally:
        torch.cuda.set_sync_debug_mode(0)
