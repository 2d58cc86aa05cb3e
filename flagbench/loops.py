"""The two ways a cell drives the program: the resident loop and the stream.

Each loop warms up its own shapes (:meth:`warm`), then runs its window
(:meth:`window`): dumps back to back for at least the window's seconds,
each dump's latency, the program's counters, and a sample of the flags it
produced, drawn from the seed, for the comparison after the window.  The
program is reached through its module attributes at the time of each
call, so a test can put a broken flagger in its place.
"""

import asyncio
import random
import time
from typing import List, Tuple

import numpy as np
import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A reservoir of `size` (dump, ring slot, flags) drawn uniformly from the seed."""

    def __init__(self, size: int, seed: int) -> None:
        self.size = size
        self.rng = random.Random(seed)
        self.items: List[Tuple[int, int, object]] = []
        self.seen = 0

    def offer(self, dump: int, slot: int, flags) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((dump, slot, flags))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = (dump, slot, flags)


class Resident:
    """A closed loop with one dump in flight on a ring of dumps on the card.

    Each dump is ``flag_dump(vis.transpose(0, 1))`` (K5 turns the
    channel-major view, K1 flags it) and a synchronise; its latency runs on
    the host's clock from the call to the synchronise's return.
    """

    def __init__(self, cell) -> None:
        from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

        if cell.traffic["in_flight"] != 1:
            raise ValueError("the resident loop keeps 1 dump in flight; the mix must say 1")
        self.cell = cell
        self.ff = fused_flagger
        self.ring = cell.ring

    def _call(self, i: int):
        vis = self.ring[i % len(self.ring)]
        return self.ff.flag_dump(vis.transpose(0, 1), channel_flags=self.cell.channel_flags,
                                 **self.cell.flagger)

    def warm(self) -> None:
        # As many outputs alive at once as the window's sample holds, so
        # that the caching allocator already has every block it will use.
        held = [self._call(i) for i in range(self.cell.traffic["sample"] + 2)]
        sync(self.cell.device)
        del held

    def window(self, seconds: float, tracer, sample: Sample) -> dict:
        dev = self.cell.device
        launches0 = self.ff.launches["flagger"]
        latency, dispatch = [], []
        i = 0
        with tracer.window():
            start = time.perf_counter()  # the profiler, when on, has started
            while True:
                t0 = time.perf_counter()
                with tracer.span("flagbench.flag_dump"):
                    flags = self._call(i)
                t1 = time.perf_counter()
                with tracer.span("flagbench.synchronize"):
                    sync(dev)
                t2 = time.perf_counter()
                latency.append(t2 - t0)
                dispatch.append(t1 - t0)
                sample.offer(i, i % len(self.ring), flags)
                del flags
                i += 1
                if t2 - start >= seconds:
                    break
        return {"dumps": i, "window_s": t2 - start, "latency_s": latency,
                "dispatch_s": dispatch, "missing": 0,
                "k1_launches": self.ff.launches["flagger"] - launches0}

    def dump_on_device(self, slot: int) -> torch.Tensor:
        return self.ring[slot]

    def flags_on_device(self, flags) -> torch.Tensor:
        return flags


class _RingSource:
    """``stream``'s source: dump ``i`` of a call is the ring's dump ``offset + i``.

    Records the host's clock when each dump's buffer is handed over.
    """

    def __init__(self, host: list, offset: int) -> None:
        self.host = host
        self.offset = offset
        self.handed = {}

    def slot(self, i: int) -> int:
        return (self.offset + i) % len(self.host)

    async def get(self, i: int) -> torch.Tensor:
        buf = self.host[self.slot(i)]
        self.handed[i] = time.perf_counter()
        return buf

    def uploaded(self, i: int, event) -> None:
        """The ring's buffers are never written: nothing waits for an upload."""


class Stream:
    """The streaming ingest: ``resource_pipeline.stream`` over a ring in pinned host memory.

    ``stream`` flags a fixed number of dumps a call (``dumps_per_call``)
    with the fused flagger, at most two in flight by its ``JobQueue``, and
    keeps every dump's flags until it returns; the window runs calls back to
    back.  A dump's latency runs from the moment ``get`` hands its buffer
    to the pipeline to the moment its flags are in host memory (the
    download's end, on the device's clock, placed on the host's by an event
    recorded at a known host time before each call).
    """

    def __init__(self, cell) -> None:
        from katsdpsigproc_tpu_torch import examples
        from katsdpsigproc_tpu_torch.examples import resource_pipeline
        from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

        if cell.traffic["in_flight"] != 2:
            raise ValueError("the stream's JobQueue keeps 2 dumps in flight; the mix must say 2")
        self.cell = cell
        self.ff = fused_flagger
        self.pipeline = resource_pipeline
        self.ctx = examples.context(cell.device.type)
        on_card = cell.device.type == "cuda"
        self.host = []
        for vis in cell.ring:
            buf = torch.empty(vis.shape, dtype=vis.dtype, pin_memory=on_card)
            buf.copy_(vis)
            self.host.append(buf)
        cell.ring.clear()  # the stream's dumps live on the host
        self.offset = 0

    def _call(self, dumps: int):
        source = _RingSource(self.host, self.offset)
        self.offset += dumps
        shape = (self.cell.config["channels"], self.cell.config["rows"])
        anchor, host_at_anchor = None, None
        if self.cell.device.type == "cuda":
            sync(self.cell.device)
            anchor = torch.cuda.Event(enable_timing=True)
            host_at_anchor = time.perf_counter()
            anchor.record()
        results, timings = asyncio.run(
            self.pipeline.stream(source, dumps, "fused", self.ctx, shape))
        ended = time.perf_counter()
        latency, upload_s = [], 0.0
        for i in range(dumps):
            if timings is None:  # on the CPU: no device clock, the call's end
                latency.append(ended - source.handed[i])
                continue
            events = timings[0][i].events
            done = host_at_anchor + anchor.elapsed_time(events["download_end"]) * 1e-3
            latency.append(done - source.handed[i])
            upload_s += events["upload_start"].elapsed_time(events["upload_end"]) * 1e-3
        return source, results, latency, upload_s

    def warm(self) -> None:
        self._call(self.cell.traffic["warmup_dumps"])
        self.offset = 0

    def window(self, seconds: float, tracer, sample: Sample) -> dict:
        per_call = self.cell.traffic["dumps_per_call"]
        dump_bytes = self.host[0].numel() * self.host[0].element_size()
        launches0 = self.ff.launches["flagger"]
        latency, upload_s, dumps, missing, calls = [], 0.0, 0, 0, []
        with tracer.window():
            start = time.perf_counter()  # the profiler, when on, has started
            while True:
                with tracer.span("flagbench.stream_call"):
                    source, results, lat, up = self._call(per_call)
                end = time.perf_counter()
                calls.append(end - start - sum(calls))
                latency += lat
                upload_s += up
                missing += sum(1 for i in range(per_call) if i not in results)
                for i in sorted(results):
                    sample.offer(dumps + i, source.slot(i), results[i])
                del results
                dumps += per_call
                if end - start >= seconds:
                    break
        return {"dumps": dumps, "window_s": end - start, "latency_s": latency,
                "missing": missing, "upload_bytes": dumps * dump_bytes, "upload_s": upload_s,
                "call_s": calls,
                "k1_launches": self.ff.launches["flagger"] - launches0}

    def dump_on_device(self, slot: int) -> torch.Tensor:
        return self.host[slot].to(self.cell.device)

    def flags_on_device(self, flags: np.ndarray) -> torch.Tensor:
        # stream returns (channels, rows); the reference gives (rows, channels)
        return torch.from_numpy(flags).to(self.cell.device).transpose(0, 1)


LOOPS = {"resident": Resident, "stream": Stream}
