"""The separate-pass flagger of a whole dump, as the benchmark's l32k-hybrid cell runs it.

* The flagger the ``hybrid`` loop builds (``make_flagger_fn(engine="hybrid")``:
  the background median pass, the deviations turned baseline-major, then
  K2's MAD noise and SumThreshold, a slab of ``baseline_block`` rows at a
  time) equals ``flagbench/reference.py`` flag for flag at small sizes on
  the CPU, slabs that divide the rows and slabs that do not; the bfloat16
  reference differs from the float32 one.
* The loop runs end to end on the CPU, its checks hold, and a broken K2
  comes out as ``correct`` false.
* ``ksp.hybrid`` holds one ``ksp.hybrid.background``, ``.turn`` and
  ``.store`` a slab, in that order, under a profiler session, and nothing
  is recorded without one; ``counts_hybrid``'s bounds; the readers of the
  cell's four metrics; the cell's entries in ``BENCHMARK.json``.

The ``cuda`` tests (the flagger on the card against the reference, one K2
launch a slab, and the loop's ``k2_launch_gap``) skip without a card.
This file imports no jax::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hybrid_cell.py -q
"""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from flagbench import counts, counts_hybrid, data, harness, loops, reference, spans
from flagbench.loops import hybrid
from flagbench.traces import Summary, Tracer
from katsdpsigproc_tpu_torch.models.rfi import device as rfi_device
from katsdpsigproc_tpu_torch.models.rfi import fused_flagger as ff
from katsdpsigproc_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SPEC = harness.load_spec(ROOT)
CELL = "l32k-hybrid"
CONFIG = harness.load_config(SPEC, "meerkat-l-32k-hybrid", ROOT)
TRAFFIC = harness.load_traffic("hybrid")
FLAGGER = CONFIG["flagger"]
CPU = torch.device("cpu")
SEEDS = (5, 2 ** 33 + 17, 3141592653)
# (channels, rows, baseline_block): slabs that divide the rows, a last slab
# shorter than the rest, and one slab for the whole dump.
SIZES = [(512, 64, 16), (512, 60, 16), (256, 40, None)]
READERS = ("k2_roofline", "background_roofline", "hybrid_kernels_per_dump", "hybrid_host_ms")


def _small(channels, rows, block):
    return {"channels": channels, "rows": rows,
            "flagger_fn": dict(CONFIG["flagger_fn"], baseline_block=block)}


def _cell(seed, device=CPU, size=(512, 60, 16)):
    return harness.build_cell(SPEC, CELL, seed, device, _small(*size))


def _assert_equal(got, want):
    assert got.dtype == torch.uint8 and got.shape == want.shape
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} mismatching flags of {got.numel()}"


@pytest.fixture
def no_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_the_loops_flagger_equals_the_reference(seed, size):
    cell, loop = _cell(seed, size=size)
    assert isinstance(loop, hybrid.Hybrid)
    for slot, vis in enumerate(cell.ring):
        got = loop.flags_on_device(loop.fn(vis))
        want = loop.reference_flags(slot)
        _assert_equal(got, want)
        _assert_equal(want, reference.flag_dump(vis, FLAGGER))
        assert set(want.unique().tolist()) == {0, 1}
        # every engine gives K1's flags (here its plain version)
        _assert_equal(got, ff.flag_dump(vis.transpose(0, 1), **FLAGGER))


def test_the_bfloat16_reference_differs_from_the_float32_reference():
    cell, loop = _cell(21)
    exact = loop.reference_flags(0)
    low = loop.reference_flags(0, torch.bfloat16)
    assert int((exact != low).sum()) > 0


def test_the_loop_builds_its_flagger_from_the_configuration(monkeypatch):
    seen = []
    real = rfi_device.make_flagger_fn

    def make_flagger_fn(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(rfi_device, "make_flagger_fn", make_flagger_fn)
    _, loop = _cell(3)
    assert seen == [((13, 11.0), {"n_windows": 4, "threshold_falloff": 1.2, "flag_value": 1,
                                  "engine": "hybrid", "baseline_block": 16,
                                  "background_fast": False})]
    assert loop.slabs == 4  # 60 rows in slabs of 16


def test_the_loop_takes_no_input_flags():
    cell = SimpleNamespace(config=dict(CONFIG, **_small(64, 8, 4)),
                           traffic=dict(TRAFFIC, input_flags="channel"), device=CPU)
    with pytest.raises(ValueError, match="input_flags"):
        hybrid.Hybrid.inputs(cell, 1)


@pytest.mark.parametrize("trace", [False, True])
def test_the_loop_runs_on_the_cpu(monkeypatch, trace, no_spans):
    assert loops.load("hybrid") is hybrid.Hybrid
    # a short traced stretch: the profiler's post-processing of the mix's 6 s takes minutes here
    monkeypatch.setattr(harness, "load_traffic", lambda name: dict(TRAFFIC, trace_seconds=0.2))
    result = harness.run_cell(SPEC, CELL, 2 ** 31 + 3, 0.2, trace, CPU, 0.0,
                              _small(512, 60, 16))
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert list(result["checks"]) == ["flag_mismatches", "dumps_missing"]  # k2_launch_gap: card
    if trace:
        assert result["metrics"]["hybrid_host_ms"]["value"] > 0
        assert "k2_roofline" not in result["metrics"]  # no K2 kernel on the CPU
    else:
        assert set(result["metrics"]) == {"gvis_per_s", "dump_ms_p95", "setup_s"}


def test_the_window_counts_k2s_launches():
    cell, loop = _cell(4)
    loop.warm()
    counters = loop.window(0.0, Tracer(False, CPU), loops.Sample(2, 4))
    assert counters["dumps"] >= 1 and counters["k2_launches"] == 0  # the plain K2 on the CPU
    assert loop.checks(counters) == {}
    on_card = SimpleNamespace(cell=SimpleNamespace(device=torch.device("cuda", 0)), slabs=8)
    assert hybrid.Hybrid.checks(on_card, {"dumps": 3, "k2_launches": 24}) == {
        "k2_launch_gap": {"value": 0, "limit": 0}}
    assert hybrid.Hybrid.checks(on_card, {"dumps": 3, "k2_launches": 0}) == {
        "k2_launch_gap": {"value": 24, "limit": 0}}


def _zeros(dev_t, **kw):
    """A K2 that never writes its flags."""
    return torch.zeros(dev_t.shape, dtype=torch.uint8)


def _half_rows(dev_t, **kw):
    """A K2 that leaves the second half of its rows unflagged."""
    flags = ff.madnz_threshold_plain(dev_t, **kw)
    flags[flags.shape[0] // 2:] = 0
    return flags


def _one_flag(dev_t, **kw):
    """A K2 that flips one flag of each slab."""
    flags = ff.madnz_threshold_plain(dev_t, **kw)
    flags[0, 0] ^= 1
    return flags


def _stale():
    """A K2 that returns its first slab's flags for every later slab."""
    first = []

    def madnz_threshold(dev_t, **kw):
        if not first:
            first.append(ff.madnz_threshold_plain(dev_t, **kw))
        return first[0].clone()
    return madnz_threshold


FAULTS = {"unchanged": lambda: _zeros, "half_rows": lambda: _half_rows,
          "one_flag": lambda: _one_flag, "stale": _stale}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_k2_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(ff, "madnz_threshold", FAULTS[fault]())
    result = harness.run_cell(SPEC, CELL, 2 ** 31 + 3, 0.2, False, CPU, 0.0,
                              _small(512, 64, 16))
    assert result["correct"] is False
    assert result["checks"]["flag_mismatches"]["value"] > 0 and result["failed"] > 0


def _flagger(block, engine="hybrid"):
    return rfi_device.make_flagger_fn(FLAGGER["width"], FLAGGER["n_sigma"],
                                      n_windows=FLAGGER["n_windows"],
                                      threshold_falloff=FLAGGER["falloff"], engine=engine,
                                      baseline_block=block)


def _raise(*args, **kwargs):
    raise AssertionError("a span was opened with the profiler off")


def test_no_span_without_a_session(monkeypatch, no_spans):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(profiling, "_Annotation", _raise)
    vis = data.make_dump(data.generator(6, CPU), 128, 20, TRAFFIC["data"], CPU)
    _flagger(8)(vis)
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


@pytest.mark.parametrize("block,starts", [(8, [0, 8, 16]), (None, [0])])
def test_the_spans_under_a_session(tmp_path, no_spans, block, starts):
    vis = data.make_dump(data.generator(6, CPU), 128, 20, TRAFFIC["data"], CPU)
    fn = _flagger(block)
    with profiling.trace(str(tmp_path / "trace.json")) as prof:
        flags = fn(vis)
    _assert_equal(flags, fn(vis))  # the flags do not change under a session
    recorded = profiling.spans()
    call, = [s for s in recorded if s.name == "ksp.hybrid"]
    assert call.parent is None and call.key is None
    inside = sorted((s for s in recorded if s.parent == call.id), key=lambda s: s.start_ns)
    stages = ["ksp.hybrid.background", "ksp.hybrid.turn", "ksp.hybrid.store"]
    assert [(s.name, s.key) for s in inside] == [(n, k) for k in starts for n in stages]
    assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns for s in inside)
    assert all(a.end_ns <= b.start_ns for a, b in zip(inside, inside[1:]))
    assert not [s for s in recorded if s.name.startswith("ksp.launch")]  # K2 only on the card
    host = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    assert {"ksp.hybrid", *stages} <= host


def test_the_torch_engine_records_no_hybrid_span(tmp_path, no_spans):
    vis = data.make_dump(data.generator(7, CPU), 64, 12, TRAFFIC["data"], CPU)
    with profiling.trace(str(tmp_path / "trace.json")):
        _flagger(4, engine="torch")(vis)
    assert not [s for s in profiling.spans() if s.name.startswith("ksp.hybrid")]


def test_the_bounds_at_the_cells_shape():
    n_vis = CONFIG["channels"] * CONFIG["rows"]
    assert n_vis == 32768 * 8064
    assert counts_hybrid.stage_ops_per_vis(counts_hybrid.K2_STAGES, 13, 4) == 65
    assert counts_hybrid.stage_ops_per_vis(counts_hybrid.BACKGROUND_STAGES, 13, 4) == 79
    k2 = counts_hybrid.k2_bound_s(n_vis, 13, 4)
    assert k2 == 65 * n_vis / counts.F32_OPS_PER_S  # operations-bound
    assert 0.512e-3 < k2 < 0.514e-3
    background = counts_hybrid.background_bound_s(n_vis, 13, 4)
    assert background == 12 * n_vis / counts.HBM_BYTES_PER_S  # bytes-bound
    assert 0.946e-3 < background < 0.948e-3


K2_NAME = ("void (anonymous namespace)::madnz_threshold_kernel<1024>(float const*, unsigned "
           "char*, int, int, float, (anonymous namespace)::Scales)")
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add"


def _reader_cell(kernels, dumps=3):
    return SimpleNamespace(config=CONFIG, flagger=FLAGGER, n_vis=CONFIG["channels"] * CONFIG["rows"],
                           counters={"dumps": dumps},
                           trace=Summary(window_s=0.6, busy_s=0.59, kernels=kernels))


def test_the_readers(monkeypatch):
    read = {name: harness.load_reader(name) for name in READERS}
    cell = _reader_cell({K2_NAME: (24, 0.024),
                         "void (anonymous namespace)::madnz_threshold_wide_kernel(float)": (1, 9.0),
                         ELEMENTWISE: (3000, 0.3), "other_kernel": (3000, 0.27),
                         "Memcpy DtoD (Device -> Device)": (48, 5.0),
                         "Memset (Device)": (8, 1.0)})
    launch = counts_hybrid.k2_bound_s(32768 * 1008, 13, 4)
    assert read["k2_roofline"](cell) == pytest.approx(100 * launch / 1e-3)
    background = counts_hybrid.background_bound_s(32768 * 8064, 13, 4)
    # every kernel but K2's (its wide-row one too), copies and fills left out, over 3 dumps
    assert read["background_roofline"](cell) == pytest.approx(100 * background / (0.57 / 3))
    assert read["hybrid_kernels_per_dump"](cell) == pytest.approx((24 + 1 + 6000) / 3)
    monkeypatch.setattr(spans, "recorded", lambda: [
        profiling.Span(1, "ksp.hybrid", 0, 90_000_000, None, None, 0),
        profiling.Span(2, "ksp.hybrid.background", 0, 80_000_000, 1, 0, 0),
        profiling.Span(3, "ksp.hybrid", 0, 110_000_000, None, None, 0)])
    assert read["hybrid_host_ms"](cell) == pytest.approx(100.0)


def test_the_readers_give_none_where_nothing_was_traced(monkeypatch, no_spans):
    read = {name: harness.load_reader(name) for name in READERS}
    untraced = SimpleNamespace(config=CONFIG, flagger=FLAGGER, n_vis=1, counters={"dumps": 3},
                               trace=None)
    assert all(read[name](untraced) is None for name in READERS)
    copies_only = _reader_cell({"Memcpy DtoD (Device -> Device)": (48, 5.0)})
    assert read["k2_roofline"](copies_only) is None
    assert read["background_roofline"](copies_only) is None
    assert read["hybrid_kernels_per_dump"](copies_only) is None
    assert read["background_roofline"](_reader_cell({K2_NAME: (8, 0.003)})) is None
    assert read["hybrid_kernels_per_dump"](_reader_cell({ELEMENTWISE: (9, 0.1)}, dumps=0)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [
        profiling.Span(1, "ksp.flag_dump", 0, 5, None, None, 0)])
    assert read["hybrid_host_ms"](untraced) is None  # a program without the span


def test_the_cells_entries():
    cell, = [w for w in SPEC["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("meerkat-l-32k-hybrid",
                                                                "hybrid", 1)
    assert len(cell["why"]) <= 200
    config, = [c for c in SPEC["configs"] if c["name"] == cell["config"]]
    assert config["reduced"] == [] == CONFIG["reduced"]
    assert config["source"] == CONFIG["source"] and len(config["source"]) <= 200
    assert config["file"] == "flagbench/configs/meerkat-l-32k-hybrid.json"
    assert FLAGGER == {"width": 13, "n_sigma": 11.0, "n_windows": 4, "falloff": 1.2,
                       "flag_value": 1}
    assert CONFIG["flagger_fn"] == {"engine": "hybrid", "baseline_block": 1008,
                                    "background_fast": False}
    resident = harness.load_config(SPEC, "meerkat-l-32k", ROOT)
    for key in ("band_mhz", "channels", "antennas", "baselines", "pols", "rows", "dtype"):
        assert CONFIG[key] == resident[key]
    assert CONFIG["bytes"]["ring_of_2"] == 2 * CONFIG["channels"] * CONFIG["rows"] * 8
    assert TRAFFIC["data"] == harness.load_traffic("resident")["data"]
    assert (TRAFFIC["loop"], TRAFFIC["in_flight"], TRAFFIC["ring"], TRAFFIC["input_flags"],
            TRAFFIC["sample"], TRAFFIC["trace_seconds"]) == ("hybrid", 1, 2, "none", 8, 6)
    assert hybrid.Hybrid.n_vis(CONFIG) == 32768 * 8064
    by_name = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name in ("gvis_per_s", "dump_ms_p95", "idle_share"):
        assert by_name[name]["workloads"][-1] == CELL
    for name in READERS:
        assert by_name[name]["workloads"] == [CELL]
        assert (ROOT / "flagbench" / "metrics" / f"{name}.py").is_file()
    reported = [m["name"] for m in harness.per_layer_metrics(SPEC, CELL)]
    assert reported == ["idle_share", *READERS]
    assert [m["name"] for m in harness.end_to_end_metrics(SPEC, CELL)] == [
        "gvis_per_s", "dump_ms_p95", "setup_s"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("channels,rows,block", [(32768, 64, 16), (4096, 512, 96),
                                                 (4096, 512, 1008)])
def test_the_flagger_on_the_card_equals_the_reference(cuda, channels, rows, block):
    vis = data.make_dump(data.generator(31, cuda), channels, rows, TRAFFIC["data"], cuda)
    fn = _flagger(block)
    before = ff.launches["madnz_threshold"]
    got = fn(vis)
    torch.cuda.synchronize(cuda)
    slabs = -(-rows // min(block, rows))
    assert ff.launches["madnz_threshold"] == before + slabs
    _assert_equal(got.transpose(0, 1), reference.flag_dump(vis, FLAGGER))


@pytest.mark.cuda
def test_the_loop_on_the_card_launches_k2_once_a_slab(cuda):
    result = harness.run_cell(SPEC, CELL, 2 ** 31 + 5, 0.5, False, cuda, 0.0,
                              _small(4096, 256, 96))
    assert result["correct"] is True
    assert result["checks"]["k2_launch_gap"] == {"value": 0, "limit": 0}
