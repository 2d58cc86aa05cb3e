"""The port's spans (``utils/profiling.annotate``) and the counter of ``_row_major``.

Off (no ``torch.profiler`` session recording) a span opens no profiler
range and records nothing; on, ``flag_dump`` and the streaming ingest
record their spans with their parents and request keys, as ranges on the
profiler's host timeline and in ``profiling.spans()``.  The ``cuda`` test
checks on the card that no span is mirrored on the device's timeline;
it skips without a card.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""

import asyncio
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

import katsdpsigproc_tpu_torch
from katsdpsigproc_tpu_torch.examples import context, resource_pipeline
from katsdpsigproc_tpu_torch.models.rfi import fused_flagger as ff
from katsdpsigproc_tpu_torch.utils import profiling

# The readers' kernel patterns (flagbench/metrics/k1_roofline.py, k5_roofline.py).
KERNEL_PATTERN = re.compile(r"\bflagger_kernel\b|\btranspose_kernel\b")
STREAM_SPANS = ("ksp.stream.get", "ksp.stream.slot_wait", "ksp.stream.enqueue",
                "ksp.stream.flags_wait", "ksp.stream.flags_copy", "ksp.stream.backpressure")
DUMPS = 3


@pytest.fixture(autouse=True)
def no_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _vis(channels=64, rows=16, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((channels, rows, 2), generator=gen)


def _stream(dumps=DUMPS, channels=64, baselines=8):
    source = resource_pipeline.RandomDumps(channels, baselines, seed=1, pin=False)
    results, _ = asyncio.run(resource_pipeline.stream(source, dumps, "fused", context("cpu"),
                                                      (channels, baselines)))
    return results


def _traced(tmp_path, fn):
    with profiling.trace(str(tmp_path / "trace.json")) as prof:
        result = fn()
    return result, prof, profiling.spans()


def _raise(*args, **kwargs):
    raise AssertionError("a span was opened with the profiler off")


def test_off_path_opens_no_range_and_records_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(profiling, "_Annotation", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    flags = ff.flag_dump(_vis().transpose(0, 1))
    assert flags.shape == (16, 64)
    assert sorted(_stream()) == list(range(DUMPS))
    assert profiling.spans() == []
    assert profiling.dropped_spans() == 0


def test_off_path_is_one_shared_null_context():
    assert profiling.annotate("ksp.a") is profiling.annotate("ksp.b", key=4)
    with profiling.annotate("ksp.a"):
        pass
    assert profiling.spans() == []


def test_flag_dump_spans_under_a_trace(tmp_path):
    vis = _vis()
    flags, prof, spans = _traced(tmp_path, lambda: ff.flag_dump(vis.transpose(0, 1)))
    assert torch.equal(flags, ff.flag_dump(vis.transpose(0, 1)))
    call, = [s for s in spans if s.name == "ksp.flag_dump"]
    check, = [s for s in spans if s.name == "ksp.flag_dump.check"]
    assert call.parent is None and call.key is None
    assert check.parent == call.id
    assert call.start_ns <= check.start_ns <= check.end_ns <= call.end_ns
    host = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    assert {"ksp.flag_dump", "ksp.flag_dump.check"} <= host


def test_stream_spans_under_a_trace(tmp_path):
    results, prof, spans = _traced(tmp_path, _stream)
    assert sorted(results) == list(range(DUMPS))
    by_id = {s.id: s for s in spans}
    for name in STREAM_SPANS:
        mine = [s for s in spans if s.name == name]
        assert sorted(s.key for s in mine) == list(range(DUMPS)), name
        assert all(s.parent is None for s in mine), name
    # flag_dump runs inside its dump's enqueue, and takes its key
    calls = [s for s in spans if s.name == "ksp.flag_dump"]
    assert sorted(s.key for s in calls) == list(range(DUMPS))
    for s in calls:
        outer = by_id[s.parent]
        assert outer.name == "ksp.stream.enqueue" and outer.key == s.key
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    for s in spans:  # within a dump, the stages in their order
        if s.name == "ksp.stream.flags_copy":
            wait, = [w for w in spans if w.name == "ksp.stream.flags_wait" and w.key == s.key]
            assert wait.end_ns <= s.start_ns
    host = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    assert set(STREAM_SPANS) <= host


def test_overlapping_spans_keep_their_own_times(tmp_path):
    """Two tasks' spans on one thread, closed out of order: a opens, b opens, a closes, b closes."""

    async def a():
        with profiling.annotate("ksp.test.a", key="a"):
            await asyncio.sleep(0.03)

    async def b():
        await asyncio.sleep(0.01)
        with profiling.annotate("ksp.test.b", key="b"):
            await asyncio.sleep(0.04)

    async def both():
        await asyncio.gather(a(), b())

    _, prof, spans = _traced(tmp_path, lambda: asyncio.run(both()))
    sa, = [s for s in spans if s.name == "ksp.test.a"]
    sb, = [s for s in spans if s.name == "ksp.test.b"]
    assert sa.parent is None and sb.parent is None
    assert (sa.key, sb.key) == ("a", "b")
    assert sa.start_ns < sb.start_ns < sa.end_ns < sb.end_ns
    assert sa.end_ns - sa.start_ns >= 0.03e9 and sb.end_ns - sb.start_ns >= 0.04e9
    ea, = [e for e in prof.events() if e.name == "ksp.test.a"]
    eb, = [e for e in prof.events() if e.name == "ksp.test.b"]
    assert ea.time_range.start < eb.time_range.start < ea.time_range.end < eb.time_range.end
    assert ea.time_range.elapsed_us() >= 0.03e6 and eb.time_range.elapsed_us() >= 0.04e6


def test_spans_nest_and_inherit_their_key(tmp_path):
    def nested():
        with profiling.annotate("ksp.test.outer", key=7):
            with profiling.annotate("ksp.test.inner"):
                pass
            with profiling.annotate("ksp.test.own", key=8):
                pass

    _, _, spans = _traced(tmp_path, nested)
    outer, inner, own = (next(s for s in spans if s.name == f"ksp.test.{n}")
                         for n in ("outer", "inner", "own"))
    assert inner.parent == outer.id and own.parent == outer.id
    assert (outer.key, inner.key, own.key) == (7, 7, 8)


def test_the_list_is_capped_and_counts_what_it_drops(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)

    def many():
        for i in range(5):
            with profiling.annotate("ksp.test.many", key=i):
                pass

    _, _, spans = _traced(tmp_path, many)
    assert [s.key for s in spans] == [0, 1, 2]
    assert profiling.dropped_spans() == 2
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def _span_names_in_the_package():
    root = Path(katsdpsigproc_tpu_torch.__file__).parent
    found = set()
    for path in root.rglob("*.py"):
        found |= set(re.findall(r"annotate\(\s*\"([^\"]+)\"", path.read_text()))
    return found


def test_no_span_name_matches_the_kernel_patterns(tmp_path):
    names = _span_names_in_the_package()
    assert {"ksp.flag_dump", "ksp.flag_dump.check", "ksp.transpose", "ksp.launch.k5",
            "ksp.launch.k1", "ksp.launch.k1_wide", "ksp.stream.flags_copy.work",
            *STREAM_SPANS} <= names
    _, _, spans = _traced(tmp_path, lambda: (ff.flag_dump(_vis().transpose(0, 1)), _stream()))
    names |= {s.name for s in spans}
    for name in names:
        assert name.startswith("ksp.") and not KERNEL_PATTERN.search(name), name


def test_the_flags_copy_is_a_span_on_the_executors_thread(tmp_path):
    """The stream's copy out of the ring, run as on the card in a worker: its own span and key."""
    ring = torch.arange(12, dtype=torch.uint8).reshape(3, 4)

    def copy():
        with ThreadPoolExecutor(1) as pool:
            return pool.submit(resource_pipeline._copy_out, ring, 5).result()

    copied, _, spans = _traced(tmp_path, copy)
    assert torch.equal(torch.from_numpy(copied), ring)
    assert copied.ctypes.data != ring.data_ptr()
    work, = spans
    assert (work.name, work.key, work.parent) == ("ksp.stream.flags_copy.work", 5, None)
    assert work.thread != threading.get_ident()
    assert work.start_ns <= work.end_ns


def test_row_major_counts_turns_and_copies():
    before = dict(ff.row_major)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    assert ff._row_major(x) is x
    assert ff.row_major == before
    turned = ff._row_major(x.t())
    assert turned.is_contiguous() and torch.equal(turned, x.t())
    assert ff.row_major == {"turned": before["turned"] + 1, "copied": before["copied"]}
    strided = x[:, ::2]
    copied = ff._row_major(strided)
    assert copied.is_contiguous() and torch.equal(copied, strided)
    assert ff.row_major == {"turned": before["turned"] + 1, "copied": before["copied"] + 1}


@pytest.mark.cuda
def test_no_span_is_device_work_on_the_card(cuda):
    """The channel-major view through K5 and K1 under the profiler: the spans stay on the host."""
    from torch.profiler import ProfilerActivity, profile

    vis = _vis(channels=4096, rows=256).to(cuda)
    ff.flag_dump(vis.transpose(0, 1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        flags = ff.flag_dump(vis.transpose(0, 1))
        torch.cuda.synchronize()
    assert torch.equal(flags.cpu(), ff.flag_dump(vis.cpu().transpose(0, 1)))
    events = prof.events()
    device = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(KERNEL_PATTERN.search(name) for name in device), device
    assert not [name for name in device if name.startswith("ksp.")]
    host = {e.name for e in events if e.name.startswith("ksp.")}
    assert host == {"ksp.flag_dump", "ksp.flag_dump.check", "ksp.transpose", "ksp.launch.k5",
                    "ksp.launch.k1"}
    spans = profiling.spans()
    by_name = {s.name: s for s in spans}
    assert by_name["ksp.launch.k5"].parent == by_name["ksp.transpose"].id
    assert by_name["ksp.transpose"].parent == by_name["ksp.flag_dump"].id
    assert by_name["ksp.launch.k1"].parent == by_name["ksp.flag_dump"].id


@pytest.mark.cuda
def test_stream_spans_on_the_card(cuda, tmp_path):
    """The fused stream on the card under the profiler: every span a dump, the copy's in a worker."""
    source = resource_pipeline.RandomDumps(4096, 64, seed=1, pin=True)
    with profiling.trace(str(tmp_path / "trace.json")):
        results, _ = asyncio.run(resource_pipeline.stream(source, DUMPS, "fused",
                                                          context("cuda"), (4096, 64)))
    assert sorted(results) == list(range(DUMPS))
    spans = profiling.spans()
    for name in (*STREAM_SPANS, "ksp.stream.flags_copy.work", "ksp.flag_dump"):
        assert sorted(s.key for s in spans if s.name == name) == list(range(DUMPS)), name
    loop_thread = {s.thread for s in spans if s.name == "ksp.stream.flags_copy"}
    work_thread = {s.thread for s in spans if s.name == "ksp.stream.flags_copy.work"}
    assert not loop_thread & work_thread
    for s in spans:
        if s.name == "ksp.stream.flags_copy.work":
            wait, = [w for w in spans if w.name == "ksp.stream.flags_copy" and w.key == s.key]
            assert wait.start_ns <= s.start_ns <= s.end_ns <= wait.end_ns
