"""The streaming ingest loop: the 1-D flagger's dumps from host memory, through ``stream``."""

import asyncio
import time

import numpy as np
import torch

from . import Sample, sync
from .resident import Resident


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


class Stream(Resident):
    """The streaming ingest: ``resource_pipeline.stream`` over a ring in pinned host memory.

    ``stream`` flags a fixed number of dumps a call (``dumps_per_call``)
    with the fused flagger, at most two in flight by its ``JobQueue``, and
    keeps every dump's flags until it returns; the window runs calls back to
    back.  A dump's latency runs from the moment ``get`` hands its buffer
    to the pipeline to the moment its flags are in host memory (the
    download's end, on the device's clock, placed on the host's by an event
    recorded at a known host time before each call).  The dumps, the
    reference and the checks are the resident loop's.
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
