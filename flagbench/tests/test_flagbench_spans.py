"""The readers of the program's spans: None with nothing to read, the right mean from made-up spans."""

from types import SimpleNamespace

import pytest

from flagbench import harness

READERS = ("host_us", "prelaunch_us", "flags_copy_ms", "flags_wait_ms", "flags_copy_work_ms")


def _span(id, name, start_us, end_us, parent=None, key=None):
    return SimpleNamespace(id=id, name=name, start_ns=int(start_us * 1e3),
                           end_ns=int(end_us * 1e3), parent=parent, key=key, thread=1)


def _give(monkeypatch, spans, dropped=0):
    from katsdpsigproc_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: list(spans), raising=False)
    monkeypatch.setattr(profiling, "dropped_spans", lambda: dropped, raising=False)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(monkeypatch, name):
    from katsdpsigproc_tpu_torch.utils import profiling

    read = harness.load_reader(name)
    _give(monkeypatch, [])
    assert read(None) is None
    monkeypatch.delattr(profiling, "spans")  # a program that records no spans
    assert read(None) is None
    _give(monkeypatch, [_span(1, "ksp.other", 0, 5)])
    assert read(None) is None


@pytest.mark.parametrize("name, span", [("host_us", "ksp.flag_dump"),
                                        ("flags_copy_ms", "ksp.stream.flags_copy"),
                                        ("flags_wait_ms", "ksp.stream.flags_wait"),
                                        ("flags_copy_work_ms", "ksp.stream.flags_copy.work")])
def test_a_list_that_dropped_spans_is_not_read(monkeypatch, name, span):
    """A full list kept only the stretch's first spans: no mean is read from it."""
    read = harness.load_reader(name)
    _give(monkeypatch, [_span(1, span, 0, 300, key=0)])
    assert read(None) is not None
    _give(monkeypatch, [_span(1, span, 0, 300, key=0)], dropped=1)
    assert read(None) is None


def test_host_us(monkeypatch):
    _give(monkeypatch, [_span(1, "ksp.flag_dump.check", 0, 20, parent=2),
                        _span(2, "ksp.flag_dump", 0, 300),
                        _span(3, "ksp.flag_dump", 1000, 1100)])
    assert harness.load_reader("host_us")(None) == pytest.approx(200.0)


def test_prelaunch_us(monkeypatch):
    _give(monkeypatch, [
        # a resident call: K5 inside the transpose, then K1
        _span(2, "ksp.flag_dump.check", 100, 150, parent=1),
        _span(4, "ksp.launch.k5", 230, 240, parent=3),
        _span(3, "ksp.transpose", 160, 245, parent=1),
        _span(5, "ksp.launch.k1", 260, 270, parent=1),
        _span(1, "ksp.flag_dump", 100, 280),
        # a call with K1 alone, inside the stream's enqueue
        _span(8, "ksp.launch.k1_wide", 1050, 1060, parent=7),
        _span(7, "ksp.flag_dump", 1000, 1070, parent=6),
        _span(6, "ksp.stream.enqueue", 990, 1080),
        # a call that launched nothing is left out
        _span(9, "ksp.flag_dump", 2000, 2100),
    ])
    assert harness.load_reader("prelaunch_us")(None) == pytest.approx((130 + 50) / 2)


@pytest.mark.parametrize("name, span", [("flags_copy_ms", "ksp.stream.flags_copy"),
                                        ("flags_wait_ms", "ksp.stream.flags_wait"),
                                        ("flags_copy_work_ms", "ksp.stream.flags_copy.work")])
def test_stream_means(monkeypatch, name, span):
    _give(monkeypatch, [_span(1, span, 0, 30_000, key=0), _span(2, span, 40_000, 90_000, key=1),
                        _span(3, "ksp.stream.enqueue", 0, 1000, key=0)])
    assert harness.load_reader(name)(None) == pytest.approx(40.0)


def test_the_readers_read_a_traced_run(monkeypatch):
    """The program's own spans, from a CPU flag_dump under the profiler."""
    import torch

    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger
    from katsdpsigproc_tpu_torch.utils import profiling

    profiling.reset_spans()
    vis = torch.randn((64, 8, 2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fused_flagger.flag_dump(vis.transpose(0, 1))
    try:
        assert harness.load_reader("host_us")(None) > 0
        assert harness.load_reader("prelaunch_us")(None) is None  # the CPU launches nothing
    finally:
        profiling.reset_spans()


def test_row_major_copied_share(monkeypatch):
    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

    read = harness.load_reader("row_major_copied_share")
    monkeypatch.setattr(fused_flagger, "row_major", {"turned": 0, "copied": 0})
    assert read(None) is None  # no strided input
    monkeypatch.setattr(fused_flagger, "row_major", {"turned": 30, "copied": 0})
    assert read(None) == 0.0
    monkeypatch.setattr(fused_flagger, "row_major", {"turned": 3, "copied": 1})
    assert read(None) == pytest.approx(25.0)
    monkeypatch.delattr(fused_flagger, "row_major")  # a program without the counter
    assert read(None) is None
