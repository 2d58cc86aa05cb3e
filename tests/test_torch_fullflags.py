"""Ingest's flagging with per-sample input flags (FULL mode), as the benchmark's l32k-fullflags cell runs it.

* The port's ``flag_dump(vis.transpose(0, 1), flags.transpose(0, 1))`` of
  a channel-major dump equals ``flagbench/reference_ingest.py`` flag for
  flag, at small sizes on the CPU: the cell's flag maker scaled down
  (static ranges, one antenna's rows, a lost block zeroed, ``flag_value``
  16), and flags made for the cases a dump's flags bring: a wholly flagged
  row, a row with fewer unflagged channels than a window, flags at both
  band edges, and a mask equal to a CHANNEL mask (which gives the CHANNEL
  call's flags).
* The loop's flag maker is deterministic in the seed, and each population
  has its share; the bfloat16 reference differs from the float32 one.
* ``ksp.flag_dump.input_flags`` is recorded inside ``ksp.flag_dump`` only
  when ``input_flags`` is given; the counter ``k1_modes``; the readers of
  the cell's three metrics; the cell's entries in ``BENCHMARK.json``.

The ``cuda`` tests (K1's FULL mode through ``flag_dump`` on the card
against the reference, one ``k1_modes["full"]`` launch a call) skip
without a card.  This file imports no jax::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fullflags.py -q
"""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from flagbench import counts, counts_ingest, data, harness, loops, reference, reference_ingest
from flagbench.loops import fullflags, resident
from flagbench.traces import Summary, Tracer
from katsdpsigproc_tpu_torch.models.rfi import fused_flagger as ff
from katsdpsigproc_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SPEC = harness.load_spec(ROOT)
CELL = "l32k-fullflags"
CONFIG = harness.load_config(SPEC, "meerkat-l-32k-ingest", ROOT)
TRAFFIC = harness.load_traffic("fullflags")
FLAGGER = CONFIG["flagger"]
# The cell scaled down: 6 antennas (15 baselines, 60 rows), 1024 channels,
# lost blocks of 32 channels (1024 / 32 streams).
SMALL = dict(CONFIG, channels=1024, antennas=6, baselines=15, rows=60)
SMALL_TRAFFIC = dict(TRAFFIC, data_lost=dict(TRAFFIC["data_lost"], block_channels=32))
SEEDS = (5, 2 ** 33 + 17, 3141592653)


def _dump(channels, rows, seed):
    """A channel-major (channels, rows, 2) dump of the cell's interference, on the CPU."""
    return data.make_dump(data.generator(seed, "cpu"), channels, rows, TRAFFIC["data"], "cpu")


def _port(vis, flags, **kw):
    return ff.flag_dump(vis.transpose(0, 1), flags.transpose(0, 1), **dict(FLAGGER, **kw))


def _assert_equal(got, want):
    assert got.dtype == torch.uint8 and got.shape == want.shape
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} mismatching flags of {got.numel()}"


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_equals_the_reference_on_the_cells_flags(seed):
    ring, flags_ring = fullflags.make_ring(seed, SMALL, SMALL_TRAFFIC, "cpu")
    for vis, flags in zip(ring, flags_ring):
        want = reference_ingest.flag_dump(vis, flags, FLAGGER)
        _assert_equal(_port(vis, flags), want)
        assert set(want.unique().tolist()) == {0, 16}  # flags set, in bit ingest_rfi


def _whole_row(flags):
    flags[:, 7] = 4  # a CAM-flagged row: every sample
    flags[:, 8] = 4


def _short_row(flags):
    flags[:, 3] = 2
    flags[100:105, 3] = 0  # 5 unflagged channels, fewer than the window of 13
    flags[:, 4] = 2
    flags[::97, 4] = 0  # 6 scattered ones


def _band_edges(flags):
    flags[:6, ::2] = 8
    flags[-6:, 1::3] = 8
    flags[:1, :] |= 2
    flags[-1:, :] |= 2


def _ingest(flags):
    _whole_row(flags)
    _short_row(flags)
    _band_edges(flags)
    flags[256:288] |= 8  # a lost block


CASES = {"whole_row": _whole_row, "short_row": _short_row, "band_edges": _band_edges,
         "all_of_them": _ingest}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_equals_the_reference_on_a_dumps_edge_cases(case):
    vis = _dump(512, 16, 11)
    flags = torch.zeros((512, 16), dtype=torch.uint8)
    CASES[case](flags)
    vis[(flags & 8) != 0] = 0.0  # lost data zeroed
    want = reference_ingest.flag_dump(vis, flags, FLAGGER)
    _assert_equal(_port(vis, flags), want)
    if case == "whole_row":
        assert not want[7].any() and not want[8].any()  # noise 0: nothing exceeds it


def test_a_mask_equal_to_a_channel_mask_gives_the_channel_calls_flags():
    vis = _dump(1024, 24, 12)
    channel = resident.channel_mask(SMALL, TRAFFIC["static"]["channel_ranges_mhz"], "cpu")
    flags = (channel * 2)[:, None].expand(1024, 24).contiguous()
    got = _port(vis, flags)
    _assert_equal(got, ff.flag_dump(vis.transpose(0, 1), channel_flags=channel, **FLAGGER))
    _assert_equal(got, reference.flag_dump(vis, FLAGGER, channel))
    _assert_equal(got, reference_ingest.flag_dump(vis, flags, FLAGGER))


def test_the_flag_maker_is_deterministic_in_the_seed():
    a = fullflags.make_ring(7, SMALL, SMALL_TRAFFIC, "cpu")
    b = fullflags.make_ring(7, SMALL, SMALL_TRAFFIC, "cpu")
    c = fullflags.make_ring(8, SMALL, SMALL_TRAFFIC, "cpu")
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)
    assert not torch.equal(a[1][0], c[1][0]) or not torch.equal(a[1][1], c[1][1])
    assert not torch.equal(a[0][0], c[0][0])


@pytest.mark.parametrize("seed", SEEDS)
def test_each_population_has_its_share(seed):
    bits = CONFIG["input_flag_bits"]
    channels, rows = SMALL["channels"], SMALL["rows"]
    mask = resident.channel_mask(SMALL, TRAFFIC["static"]["channel_ranges_mhz"], "cpu").bool()
    ring, flags_ring = fullflags.make_ring(seed, SMALL, SMALL_TRAFFIC, "cpu")
    cam_rows = []
    for vis, flags in zip(ring, flags_ring):
        static = (flags & bits["static"]) != 0
        assert torch.equal(static, mask[:, None].expand(channels, rows))
        cam = ((flags & bits["cam"]) != 0).all(dim=0)
        assert not ((flags & bits["cam"]) != 0)[:, ~cam].any()
        assert int(cam.sum()) == (SMALL["antennas"] - 1) * SMALL["pols"]  # one antenna's rows
        cam_rows.append(cam)
        lost = ((flags & bits["data_lost"]) != 0)
        lost_channels = lost.all(dim=1)
        assert not lost[~lost_channels].any()
        assert int(lost_channels.sum()) == 2 * 32
        starts = torch.nonzero(lost_channels[1:] & ~lost_channels[:-1]).ravel() + 1
        assert all(int(s) % 32 == 0 for s in starts)  # on a stream's boundary
        assert not vis[lost_channels].any()  # zeroed
        assert int(flags.max()) <= bits["static"] | bits["cam"] | bits["data_lost"]
    assert not torch.equal(cam_rows[0], cam_rows[1])  # another antenna in each slot


def test_the_cells_populations_at_full_size():
    """The shares the configuration states, at 32768 channels and 8064 rows (no dump made)."""
    mask = resident.channel_mask(CONFIG, TRAFFIC["static"]["channel_ranges_mhz"], "cpu")
    assert round(float(mask.float().mean()), 3) == 0.294
    for antenna in (0, 31, 63):
        rows = fullflags.antenna_rows(CONFIG, antenna)
        assert len(rows) == len(set(rows.tolist())) == 252
    lost = TRAFFIC["data_lost"]
    assert lost["blocks"] * lost["block_channels"] / CONFIG["channels"] == 1 / 32
    assert CONFIG["channels"] // lost["block_channels"] == 64


def test_antenna_rows_are_the_upper_triangles_baselines():
    config = dict(SMALL, antennas=4, baselines=6, rows=24)
    # (0,1) (0,2) (0,3) (1,2) (1,3) (2,3): antenna 2 is in baselines 1, 3 and 5
    assert fullflags.antenna_rows(config, 2).tolist() == [4, 5, 6, 7, 12, 13, 14, 15,
                                                          20, 21, 22, 23]
    with pytest.raises(ValueError):
        fullflags.antenna_rows(dict(config, rows=25), 0)


def test_the_bfloat16_reference_differs_from_the_float32_reference():
    ring, flags_ring = fullflags.make_ring(21, SMALL, SMALL_TRAFFIC, "cpu")
    exact = reference_ingest.flag_dump(ring[0], flags_ring[0], FLAGGER)
    low = reference_ingest.flag_dump(ring[0], flags_ring[0], FLAGGER, dtype=torch.bfloat16)
    assert int((exact != low).sum()) > 0


def test_the_reference_leaves_flagged_samples_out_of_the_background():
    amp = torch.tensor([[1.0, 2.0, 100.0, 3.0, 4.0]])
    flagged = torch.tensor([[False, False, True, False, False]])
    dev = reference_ingest.deviations(amp, 3, flagged)
    # medians of the present members: [1,2] 1.5, [1,2] 1.5, flagged, [3,4] 3.5, [3,4] 3.5
    assert dev.tolist() == [[-0.5, 0.5, 0.0, -0.5, 0.5]]


@pytest.fixture
def no_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.mark.parametrize("mode", ["full", "channel", "none"])
def test_the_input_flags_span_only_with_input_flags(tmp_path, no_spans, mode):
    vis = _dump(128, 8, 3)
    flags = torch.zeros((128, 8), dtype=torch.uint8)
    flags[10:20] = 2
    kw = {"full": {"input_flags": flags.transpose(0, 1)},
          "channel": {"channel_flags": flags[:, 0].contiguous()}, "none": {}}[mode]
    with profiling.trace(str(tmp_path / "trace.json")):
        ff.flag_dump(vis.transpose(0, 1), **kw)
    spans = profiling.spans()
    call, = [s for s in spans if s.name == "ksp.flag_dump"]
    mine = [s for s in spans if s.name == "ksp.flag_dump.input_flags"]
    if mode != "full":
        assert mine == []
        return
    span, = mine
    check, = [s for s in spans if s.name == "ksp.flag_dump.check"]
    assert span.parent == call.id
    assert check.end_ns <= span.start_ns <= span.end_ns <= call.end_ns


def test_the_input_flags_are_checked():
    vis = _dump(64, 4, 3)
    with pytest.raises(TypeError):
        _port(vis, torch.zeros((64, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        _port(vis, torch.zeros((64, 5), dtype=torch.uint8))


def test_the_k1_modes_counter():
    assert ff.K1_MODES == ("none", "full", "channel")
    assert set(ff.k1_modes) == set(ff.K1_MODES)
    before = dict(ff.k1_modes)
    vis = _dump(64, 4, 3)
    _port(vis, torch.zeros((64, 4), dtype=torch.uint8))
    assert ff.k1_modes == before  # no kernel ran on the CPU


def test_the_loop_runs_on_the_cpu():
    assert loops.load("fullflags") is fullflags.FullFlags
    cell = SimpleNamespace(config=SMALL, traffic=dict(SMALL_TRAFFIC, sample=2),
                           device=torch.device("cpu"), counters={}, trace=None)
    fullflags.FullFlags.inputs(cell, 99)
    loop = fullflags.FullFlags(cell)
    loop.warm()
    sample = loops.Sample(2, 99)
    counters = loop.window(0.0, Tracer(False, cell.device), sample)
    assert counters["dumps"] >= 1 and counters["k1_full_launches"] == 0
    for _, slot, flags in sample.items:
        _assert_equal(loop.flags_on_device(flags), loop.reference_flags(slot))
    assert loop.checks(counters) == {}  # the launch checks are the card's


def test_the_loop_refuses_a_program_without_the_counter(monkeypatch):
    monkeypatch.delattr(ff, "k1_modes")
    with pytest.raises(RuntimeError, match="k1_modes"):
        fullflags.FullFlags.prepare(CONFIG)


def _trace(kernels):
    return Summary(window_s=3.0, busy_s=2.9, kernels=kernels)


def test_the_readers():
    from flagbench.metrics import input_flags_us, k1_full_roofline, k5_flags_roofline

    n_vis = CONFIG["channels"] * CONFIG["rows"]
    cell = SimpleNamespace(trace=None, n_vis=n_vis, flagger=FLAGGER)
    assert k1_full_roofline.read(cell) is None and k5_flags_roofline.read(cell) is None
    cell.trace = _trace({
        "void (anonymous namespace)::flagger_kernel<1, 1024>(float2 const*, unsigned char "
        "const*, unsigned char*, (anonymous namespace)::Params)": (2, 0.013),
        "void (anonymous namespace)::flagger_kernel<2, 1024>(float2 const*)": (5, 1.0),
        "void (anonymous namespace)::transpose_kernel<unsigned char>(unsigned char const*, "
        "unsigned char*, int, int, long long)": (2, 0.0008),
        "void (anonymous namespace)::transpose_kernel<float2>(float2 const*)": (2, 0.003)})
    k1_bound = counts_ingest.k1_full_bound_s(n_vis, 13, 4)
    assert k1_bound == counts.k1_ops_per_vis(13, 4) * n_vis / counts.F32_OPS_PER_S
    assert 1.13e-3 < k1_bound < 1.14e-3
    assert k1_full_roofline.read(cell) == pytest.approx(100 * k1_bound / 0.0065)
    k5_bound = counts_ingest.k5_flags_bound_s(n_vis)
    assert 0.157e-3 < k5_bound < 0.159e-3
    assert k5_flags_roofline.read(cell) == pytest.approx(100 * k5_bound / 0.0004)
    cell.trace = _trace({"void (anonymous namespace)::flagger_kernel<0, 1024>()": (1, 0.005)})
    assert k1_full_roofline.read(cell) is None and k5_flags_roofline.read(cell) is None
    profiling.reset_spans()
    assert input_flags_us.read(cell) is None


def test_the_cells_entries():
    cell, = [w for w in SPEC["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("meerkat-l-32k-ingest",
                                                                "fullflags", 1)
    config, = [c for c in SPEC["configs"] if c["name"] == cell["config"]]
    assert config["reduced"] == [] == CONFIG["reduced"]
    assert config["source"] == CONFIG["source"] and len(config["source"]) <= 200
    assert FLAGGER == {"width": 13, "n_sigma": 11.0, "n_windows": 4, "falloff": 1.2,
                       "flag_value": 16}
    assert FLAGGER["flag_value"] == CONFIG["input_flag_bits"]["ingest_rfi"]
    assert CONFIG["bytes"]["ring_of_2"] == 2 * CONFIG["channels"] * CONFIG["rows"] * 9
    by_name = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name in ("gvis_per_s", "dump_ms_p95", "idle_share"):
        assert CELL in by_name[name]["workloads"]
    for name in ("k1_full_roofline", "k5_flags_roofline", "input_flags_us"):
        assert by_name[name]["workloads"] == [CELL]
        assert (ROOT / "flagbench" / "metrics" / f"{name}.py").is_file()
    reported = [m["name"] for m in harness.per_layer_metrics(SPEC, CELL)]
    assert reported == ["idle_share", "k1_full_roofline", "k5_flags_roofline", "input_flags_us"]
    assert [m["name"] for m in harness.end_to_end_metrics(SPEC, CELL)] == [
        "gvis_per_s", "dump_ms_p95", "setup_s"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _flags_on(device, channels, rows, seed):
    """The ingest pattern at any size: static ranges, 1/16 of the rows, 2 lost blocks, edges."""
    config = dict(CONFIG, channels=channels)
    mask = resident.channel_mask(config, TRAFFIC["static"]["channel_ranges_mhz"], device).bool()
    flags = torch.zeros((channels, rows), dtype=torch.uint8, device=device)
    flags[mask] |= 2
    flags[:, 3::16] |= 4
    block = channels // 64
    flags[5 * block:6 * block] |= 8
    flags[40 * block:41 * block] |= 8
    flags[:3, ::2] |= 8
    flags[-3:, 1::2] |= 8
    vis = data.make_dump(data.generator(seed, device), channels, rows, TRAFFIC["data"], device)
    vis[(flags & 8) != 0] = 0.0
    return vis, flags


@pytest.mark.cuda
@pytest.mark.parametrize("channels,rows", [(4096, 512), (32768, 64)])
def test_k1_full_mode_on_the_card_equals_the_reference(cuda, channels, rows):
    vis, flags = _flags_on(cuda, channels, rows, 31)
    before = dict(ff.k1_modes)
    got = _port(vis, flags)
    assert ff.k1_modes["full"] == before["full"] + 1
    assert ff.k1_modes["none"] == before["none"] and ff.k1_modes["channel"] == before["channel"]
    _assert_equal(got, reference_ingest.flag_dump(vis, flags, FLAGGER))
    _port(vis, flags)
    assert ff.k1_modes["full"] == before["full"] + 2


@pytest.mark.cuda
def test_the_cells_flags_on_the_card_equal_the_reference(cuda):
    ring, flags_ring = fullflags.make_ring(2 ** 31 + 5, SMALL, SMALL_TRAFFIC, cuda)
    for vis, flags in zip(ring, flags_ring):
        _assert_equal(_port(vis, flags), reference_ingest.flag_dump(vis, flags, FLAGGER))
