"""The calibrator-scan cell (``l4k-calscan``): its loop, data, readers and entries, on the CPU.

The loop runs through ``run_cell`` at a small scan; a flagger that drops a
flag is caught; the scans are the seed's, bit for bit; each of the cell's
readers gives None where it has nothing to read.
"""

from types import SimpleNamespace

import pytest
import torch

from flagbench import data_twod, harness, loops, spans
from flagbench.loops import twod
from katsdpsigproc_tpu_torch.models.rfi import twodflag
from katsdpsigproc_tpu_torch.utils import profiling

SPEC = harness.load_spec()
CELL = "l4k-calscan"
# 24 dumps of 400 channels from 925 MHz: the static mask and the first bursts.
SMALL = {"dumps": 24, "channels": 400, "first_channel": 330, "products": 6}
READERS = ("twod_roofline", "twod_kernels_per_scan", "twod_host_ms", "twod_batch_baselines")


def _run(seed=2**31 + 23):
    return harness.run_cell(SPEC, CELL, seed, 0.2, False, torch.device("cpu"), 0.0,
                            overrides=SMALL)


def test_the_loop_runs_to_correct():
    result = _run()
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert result["checks"] == {"flag_mismatches": {"value": 0, "limit": 0},
                                "dumps_missing": {"value": 0, "limit": 0}}
    assert set(result["metrics"]) == {"gvis_per_s", "dump_ms_p95", "setup_s"}


class DropsOneFlag(twodflag.SumThresholdFlagger):
    def get_flags(self, *args, **kwargs):
        flags = super().get_flags(*args, **kwargs)
        first = tuple(flags.nonzero()[0].tolist())
        flags[first] = False
        return flags


def test_a_dropped_flag_is_caught(monkeypatch):
    monkeypatch.setattr(twodflag, "SumThresholdFlagger", DropsOneFlag)
    result = _run()
    assert result["correct"] is False
    assert result["checks"]["flag_mismatches"]["value"] == result["failed"] > 0


def test_the_scans_are_the_seed_s():
    config = dict(harness.load_config(SPEC, "meerkat-l-4k-calscan"), **SMALL)
    traffic = harness.load_traffic("calscan")
    first = data_twod.make_ring(2**31 + 5, config, traffic, "cpu")
    again = data_twod.make_ring(2**31 + 5, config, traffic, "cpu")
    other = data_twod.make_ring(2**31 + 6, config, traffic, "cpu")
    assert len(first) == traffic["ring"] == 2
    for (scan, flags), (scan2, flags2), (scan3, flags3) in zip(first, again, other):
        assert scan.dtype == torch.complex64 and flags.dtype == torch.uint8
        assert scan.shape == flags.shape == (24, 400, 6)
        assert torch.equal(torch.view_as_real(scan), torch.view_as_real(scan2))
        assert torch.equal(flags, flags2)
        assert not torch.equal(scan, scan3) and not torch.equal(flags, flags3)
    assert not torch.equal(first[0][0], first[1][0])
    masked = data_twod.channel_mhz(config)
    masked = torch.from_numpy((masked >= 925.0) & (masked <= 960.0))
    assert bool(first[0][1][:, masked].all()) and 0 < int(masked.sum()) < 400


def test_readers_give_none_with_nothing_to_read():
    profiling.reset_spans()
    cell = SimpleNamespace(trace=None, counters={}, n_vis=10)
    for name in READERS:
        assert harness.load_reader(name)(cell) is None, name
    cell.counters = {"twod_batches": {"calls": 0, "batches": 0, "baselines": 0}}
    assert harness.load_reader("twod_batch_baselines")(cell) is None


def test_the_window_counts_its_own_batches():
    """``twod_batches`` is the counter over the window, and absent for a program without one."""
    cell, loop = harness.build_cell(SPEC, CELL, 2**31 + 29, torch.device("cpu"), SMALL)
    loop.warm()
    from flagbench.traces import Tracer

    counters = loop.window(0.0, Tracer(False, cell.device), loops.Sample(2, 1))
    assert counters["dumps"] == 1
    assert counters["twod_batches"] == {"calls": 1, "batches": 1, "baselines": 6}
    loop.twodflag = SimpleNamespace(SumThresholdFlagger=twodflag.SumThresholdFlagger)
    assert "twod_batches" not in loop.window(0.0, Tracer(False, cell.device), loops.Sample(2, 1))


def test_readers_read_what_there_is(monkeypatch):
    from flagbench import traces

    summary = traces.Summary(window_s=4.0, busy_s=2.0, kernels={
        "elementwise_kernel": (900, 1.5), "Memcpy DtoD (Device -> Device)": (40, 0.1),
        "sort_kernel": (100, 0.4), "Memset (Device)": (7, 0.0)})
    cell = SimpleNamespace(trace=summary, n_vis=10 ** 9, counters={
        "dumps": 2, "twod_batches": {"calls": 2, "batches": 6, "baselines": 30}})
    assert harness.load_reader("twod_batch_baselines")(cell) == 5.0
    assert harness.load_reader("twod_kernels_per_scan")(cell) == 500.0
    assert harness.load_reader("twod_roofline")(cell) == pytest.approx(100 * 10 / 3.35e3)
    monkeypatch.setattr(spans, "recorded", lambda: [
        profiling.Span(1, "ksp.twod.get_flags", 0, 3_000_000, None, None, 0),
        profiling.Span(2, "ksp.twod.get_flags", 0, 5_000_000, None, None, 0)])
    assert harness.load_reader("twod_host_ms")(cell) == pytest.approx(4.0)


def test_the_cell_resolves():
    entry = [w for w in SPEC["workloads"] if w["name"] == CELL][0]
    assert entry["chips"] == 1 and entry["config"] == "meerkat-l-4k-calscan"
    config = harness.load_config(SPEC, entry["config"])
    listed = [c for c in SPEC["configs"] if c["name"] == entry["config"]][0]
    assert config["source"] == listed["source"] and config["reduced"] == listed["reduced"]
    assert config["products"] == config["baselines"] * config["pols"]
    assert twod.TwoD.n_vis(config) == 75 * 1024 * 8064
    traffic = harness.load_traffic(entry["traffic"])
    assert loops.load(traffic["loop"]) is twod.TwoD
    e2e = {m["name"] for m in harness.end_to_end_metrics(SPEC, CELL)}
    assert e2e == {"gvis_per_s", "dump_ms_p95", "setup_s"}
    per_layer = {m["name"] for m in harness.per_layer_metrics(SPEC, CELL)}
    assert per_layer == {"idle_share", *READERS}
    twodflag.SumThresholdFlagger(**config["flagger"])  # the flagger takes every parameter


class HandsBackToTheHost(twodflag.SumThresholdFlagger):
    def get_flags(self, *args, **kwargs):
        return super().get_flags(*args, **kwargs).cpu().numpy()


@pytest.mark.cuda
def test_prepare_refuses_a_program_that_hands_the_flags_back(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = harness.load_config(SPEC, "meerkat-l-4k-calscan")
    assert twod.TwoD.prepare(config)[0] == "get_flags probed"
    monkeypatch.setattr(twodflag, "SumThresholdFlagger", HandsBackToTheHost)
    with pytest.raises(RuntimeError, match="left there"):
        twod.TwoD.prepare(config)
