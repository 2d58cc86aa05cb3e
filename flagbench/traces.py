"""The traced run's profiler session and what the metrics read from it.

A traced run opens exactly one ``torch.profiler`` session, around a short
steady stretch of its window (the traffic file's ``trace_seconds``): in a
process that has opened earlier sessions the profiler was seen to stop
tracing kernels launched through ctypes libraries, which K1 and K5 are.
The session is reduced here to a :class:`Summary` (time on the device by
kernel, the union of device work, idle gaps labelled by what the host was
doing) and nothing of it is written to disk.
"""

import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "flagbench.window"
# The harness's spans; the profiler mirrors them on the device's timeline,
# where they are annotations and not work.
SPAN_PREFIX = "flagbench."
# Longest names kept in the breakdown (kernel signatures run long).
NAME_CHARS = 120


class Tracer:
    """Spans around the harness's calls into the program, and the profiler session.

    Off, every span is a null context and nothing is recorded.
    """

    def __init__(self, on: bool, device: torch.device) -> None:
        self.on = on
        self.device = device
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        """The traced stretch: the one profiler session, when tracing."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                yield
        self.prof = prof

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


@dataclass
class Summary:
    """A traced stretch, reduced: seconds of device time by kernel, busy and window."""

    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # name: (count, s)
    idle_by_host: Dict[str, float] = field(default_factory=dict)  # host activity: idle s

    def kernel(self, pattern: str) -> Optional[Tuple[int, float]]:
        """(launches, device seconds) of the kernels whose name matches `pattern`, or None."""
        count, seconds = 0, 0.0
        for name, (n, s) in self.kernels.items():
            if re.search(pattern, name):
                count, seconds = count + n, seconds + s
        return (count, seconds) if count else None

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:NAME_CHARS], s] for name, (_, s) in top],
                "idle_gaps": [[name[:NAME_CHARS], s] for name, s in gaps]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _label_gaps(gaps, host_events) -> Dict[str, float]:
    """Idle seconds by the innermost host event that spans each gap's midpoint."""
    out: Dict[str, float] = {}
    events = sorted(host_events, key=lambda e: e[1])
    active: List[Tuple[str, float, float]] = []
    k = 0
    for start, end in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (start + end) / 2
        while k < len(events) and events[k][1] <= mid:
            active.append(events[k])
            k += 1
        active = [e for e in active if e[2] >= mid]
        name = min(active, key=lambda e: e[2] - e[1])[0] if active else "(no host span)"
        out[name] = out.get(name, 0.0) + (end - start) * 1e-6
    return out


def summarize(prof) -> Optional[Summary]:
    """The :class:`Summary` of a profiler session around :data:`WINDOW_SPAN`.

    Device work is clipped to the window span.  None when the session holds
    no window span.
    """
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == WINDOW_SPAN]
    if not window:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    kernels: Dict[str, Tuple[int, float]] = {}
    busy: List[Tuple[float, float]] = []
    host: List[Tuple[str, float, float]] = []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(SPAN_PREFIX):
                continue
            start, end = max(start, w0), min(end, w1)
            if end <= start:
                continue
            busy.append((start, end))
            n, s = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, s + (end - start) * 1e-6)
        elif e.name != WINDOW_SPAN and end > w0 and start < w1:  # the host's work
            host.append((e.name, start, end))
    merged = _merge(busy)
    busy_us = sum(b - a for a, b in merged)
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, kernels=kernels,
                   idle_by_host=_label_gaps(gaps, host))
