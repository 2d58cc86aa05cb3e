"""Streaming ingest with the resource layer.

Port of ``doc/examples/resource_pipeline.py``: the reference's "acquire
early, wait late" workflow on a stream of visibility dumps.  One device
buffer, the slot, is contended between the upload of the next dump and the
flagging of the current one; a ``JobQueue`` bounds the dumps in flight to
two, and a spike planted in channel ``20 + i`` of dump ``i`` must come out
flagged.

On the card each dump is a channel-major planar (channels, baselines, 2)
float32 tensor in pinned host memory.  Its upload is a ``non_blocking``
copy into the slot on an upload stream; the flagger runs on a compute
stream.  They are ordered by CUDA events passed through the resource layer,
without blocking the host: the upload waits (``stream.wait_event``) for the
events the previous holder of the slot handed on, the flagger for the
upload's; the flags come back to pinned host memory on a download stream
after the flagger's event.  What a holder hands on decides what overlaps:

* ``fused`` (the default on the card): the flagger's first step, the
  corner turn to (baselines, channels, 2), is the last read of the slot,
  so the slot is released with the corner turn's event and the next
  dump's upload overlaps the fused flagger kernel (K1,
  :func:`..models.rfi.fused_flagger.flag_dump`);
* ``torch`` and ``hybrid`` (:func:`..models.rfi.device.make_flagger_fn`
  engines, as the JAX example uses) read the slot until their flags are
  done, so the slot is released with the flags' event.

Run (defaults: the JAX example's 256 channels x 16 baselines, 5 dumps,
seed 1)::

    python -m katsdpsigproc_tpu_torch.examples.resource_pipeline [--device cpu]
        [--channels 256] [--baselines 16] [--dumps 5]
        [--flagger {torch,hybrid,fused}] [--trace PATH]

On the card it prints each dump's upload, flag and download times, the
interval between successive dumps' flags reaching the host, their
medians, and what overlapped; ``--trace`` writes a Chrome trace of the
run.
"""

import asyncio
import contextlib
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.rfi import device as rfi_device, fused_flagger
from ..utils import profiling
from ..utils.resource import JobQueue, Resource, async_wait_for_events
from . import context, parser

CHANNELS, BASELINES, DUMPS, SEED = 256, 16, 5, 1
FLAGGERS = ("torch", "hybrid", "fused")


def spike_channel(dump: int) -> int:
    """The channel whose samples dump `dump` scales by 50."""
    return 20 + dump


class RandomDumps:
    """The JAX example's dumps: fresh complex noise from one seeded
    ``RandomState``, with :func:`spike_channel` scaled by 50, each in a
    host buffer of its own (pinned when `pin`)."""

    def __init__(self, channels: int, baselines: int, seed: int, pin: bool) -> None:
        self.shape = (channels, baselines)
        self.rs = np.random.RandomState(seed=seed)
        self.pin = pin

    async def get(self, dump: int) -> torch.Tensor:
        vis = (self.rs.standard_normal(self.shape)
               + 1j * self.rs.standard_normal(self.shape)).astype(np.complex64)
        vis[spike_channel(dump), :] *= 50.0
        host = torch.from_numpy(rfi_device.to_planar(vis))
        return host.pin_memory() if self.pin else host

    def uploaded(self, dump: int, event) -> None:
        """Each dump has its own buffer: nothing waits for its upload."""


class SpikedDumps:
    """Dumps made from one base dump in one (pinned) host buffer, in place.

    Dump ``i`` is the base with :func:`spike_channel` ``(i)`` scaled by 50
    (a float32 multiply).  Before planting it, :meth:`get` waits, off the
    event loop's thread, for the previous dump's upload from the buffer,
    then restores the previous spike's channel from a saved copy.
    """

    def __init__(self, host: torch.Tensor) -> None:
        self.host = host  # (channels, baselines, 2) float32
        self._saved = None  # (channel, its base values)
        self._uploads: Dict[int, asyncio.Future] = {}

    def _upload(self, dump: int) -> asyncio.Future:
        if dump not in self._uploads:
            self._uploads[dump] = asyncio.get_running_loop().create_future()
        return self._uploads[dump]

    async def get(self, dump: int) -> torch.Tensor:
        if dump > 0:
            event = await self._upload(dump - 1)
            del self._uploads[dump - 1]
            await async_wait_for_events([] if event is None else [event])
        if self._saved is not None:
            channel, values = self._saved
            self.host[channel] = values
        channel = spike_channel(dump)
        self._saved = (channel, self.host[channel].clone())
        self.host[channel] *= 50.0
        return self.host

    def uploaded(self, dump: int, event) -> None:
        self._upload(dump).set_result(event)


def flag_function(flagger: str) -> Callable:
    """``fn(vis) -> flags``: (channels, baselines, 2) float32 to (channels, baselines) uint8.

    ``fused`` takes (baselines, channels, 2), the corner-turned slot, and
    returns a (channels, baselines) view of K1's (baselines, channels)
    flags.
    """
    if flagger == "fused":
        return lambda vis_t: fused_flagger.flag_dump(vis_t, width=13, n_sigma=11.0).transpose(0, 1)
    if flagger in ("torch", "hybrid"):
        return rfi_device.make_flagger_fn(width=13, n_sigma=11.0, threshold="sum", engine=flagger)
    raise ValueError(f"unknown flagger {flagger!r}; expected one of {FLAGGERS}")


class _Timeline:
    """The CUDA events of one dump."""

    def __init__(self) -> None:
        self.events = {k: torch.cuda.Event(enable_timing=True)
                       for k in ("upload_start", "upload_end", "flag_start", "flag_end",
                                 "download_start", "download_end")}

    def record(self, name: str) -> torch.cuda.Event:
        self.events[name].record()
        return self.events[name]

    def at(self, name: str, origin: torch.cuda.Event) -> float:
        return origin.elapsed_time(self.events[name])


def _copy_out(flags: torch.Tensor, i: int) -> np.ndarray:
    """Dump `i`'s flags copied out of the pinned ring into an array of their own."""
    with profiling.annotate("ksp.stream.flags_copy.work", i):
        return np.array(flags.numpy())


async def stream(source, dumps: int, flagger: str, ctx, shape) -> tuple:
    """Flag `dumps` dumps from `source` through one slot; returns (flags, timings).

    `source` has ``async get(i)`` (the host buffer of dump ``i``) and
    ``uploaded(i, event)`` (the upload of dump ``i`` is queued; `event` is
    its CUDA event, or ``None`` on the CPU).  The flags of dump ``i`` come
    back as a (channels, baselines) uint8 numpy array.  The timings (on the
    card only) are each dump's :class:`_Timeline`, the origin event and the
    host's milliseconds from the origin to the last dump's flags.

    While a profiler session records, each dump's host work on the event
    loop's thread is a span keyed by its index
    (:func:`..utils.profiling.annotate`): ``ksp.stream.get`` (the source's
    ``get``), ``ksp.stream.slot_wait`` (the wait for the slot),
    ``ksp.stream.enqueue`` (queueing its upload, flagger and download),
    ``ksp.stream.flags_wait`` (the wait for its flags on the host),
    ``ksp.stream.flags_copy`` (the wait for their copy out of the ring) and
    ``ksp.stream.backpressure`` (the wait until at most two dumps are in
    flight).  On the card the copy itself, in an executor's thread, is
    ``ksp.stream.flags_copy.work`` (:func:`_copy_out`).
    """
    on_card = ctx.device.type == "cuda"
    flag = flag_function(flagger)
    corner_turn = flagger == "fused"
    slot = Resource(torch.empty(tuple(shape) + (2,), dtype=torch.float32, device=ctx.device))
    jobs = JobQueue()
    results: Dict[int, np.ndarray] = {}
    timelines: Dict[int, _Timeline] = {}
    loop = asyncio.get_running_loop()
    if on_card:
        upload_stream, compute_stream, download_stream = (
            torch.cuda.Stream(ctx.device) for _ in range(3))
        # The flags come back into pinned host buffers, a ring of three: the
        # job queue keeps at most two dumps in flight, so the buffer of dump i
        # is free again by the time dump i + 3 is queued.
        ring = [torch.empty(tuple(shape), dtype=torch.uint8, pin_memory=True) for _ in range(3)]
        origin = torch.cuda.Event(enable_timing=True)
        origin.record()
    t0 = time.perf_counter()  # after the set-up: slot, streams, ring

    async def process(i: int, host: torch.Tensor) -> None:
        acq = slot.acquire()  # acquire EARLY: the FIFO position
        with profiling.annotate("ksp.stream.slot_wait", i):
            events = await acq.wait()  # the previous holder's events, not waited on here
        with profiling.annotate("ksp.stream.enqueue", i), acq as buf:
            if not on_card:
                buf.copy_(host)
                source.uploaded(i, None)
                vis = buf.transpose(0, 1).contiguous() if corner_turn else buf
                flags = flag(vis)
                acq.ready([flags])
                done = flags
            else:
                tl = timelines[i] = _Timeline()
                with torch.cuda.stream(upload_stream):
                    for event in events:  # wait LATE, on the device
                        upload_stream.wait_event(event)
                    tl.record("upload_start")
                    buf.copy_(host, non_blocking=True)
                    uploaded = tl.record("upload_end")
                source.uploaded(i, uploaded)
                with torch.cuda.stream(compute_stream):
                    compute_stream.wait_event(uploaded)
                    tl.record("flag_start")
                    vis = buf
                    if corner_turn:
                        vis = buf.transpose(0, 1).contiguous()
                        turned = torch.cuda.Event()
                        turned.record()
                        acq.ready([turned])  # the slot is free once turned
                    flags = flag(vis)
                    flagged = tl.record("flag_end")
                if not corner_turn:
                    acq.ready([flagged])
                with torch.cuda.stream(download_stream):
                    download_stream.wait_event(flagged)
                    tl.record("download_start")
                    out = ring[i % len(ring)]
                    out.copy_(flags, non_blocking=True)
                    done = tl.record("download_end")
        with profiling.annotate("ksp.stream.flags_wait", i):
            await async_wait_for_events([done])
        # Copied out of the ring in a worker thread, off the event loop.
        with profiling.annotate("ksp.stream.flags_copy", i):
            results[i] = (await loop.run_in_executor(None, _copy_out, out, i) if on_card
                          else flags.numpy())

    for i in range(dumps):
        with profiling.annotate("ksp.stream.get", i):
            host = await source.get(i)
        jobs.add(process(i, host))
        jobs.clean()
        with profiling.annotate("ksp.stream.backpressure", i):
            await jobs.finish(max_remaining=2)  # at most two dumps in flight
    await jobs.finish()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return results, (timelines, origin, wall_ms) if on_card else None


def run(source, dumps: int, flagger: str, ctx, shape, card: str = "",
        trace: Optional[str] = None) -> Dict[int, np.ndarray]:
    """:func:`stream` in a new event loop; checks and prints the flags and, on the card, times.

    Raises ``AssertionError`` unless every dump's spike channel is flagged.
    """
    channels, baselines = shape
    tracing = profiling.trace(trace) if trace else contextlib.nullcontext()
    with tracing:
        results, timings = asyncio.run(stream(source, dumps, flagger, ctx, shape))
    if sorted(results) != list(range(dumps)):
        raise AssertionError(f"dumps {sorted(results)} came back, expected {dumps}")
    for i in range(dumps):
        rows = np.flatnonzero(results[i].any(axis=1))
        if spike_channel(i) not in rows:
            raise AssertionError(f"dump {i}: spike channel {spike_channel(i)} not flagged")
        shown = rows.tolist() if len(rows) <= 64 else f"{len(rows)} channels"
        print(f"dump {i}: flagged rows {shown}")
    if timings is None:
        return results
    timelines, origin, wall_ms = timings
    n_vis = channels * baselines
    tl = [timelines[i] for i in range(dumps)]

    def span(name: str):
        return [t.at(f"{name}_end", origin) - t.at(f"{name}_start", origin) for t in tl]

    upload, flag, download = span("upload"), span("flag"), span("download")
    ends = [t.at("download_end", origin) for t in tl]
    interval = [ends[0] - tl[0].at("upload_start", origin)] + [
        b - a for a, b in zip(ends, ends[1:])]
    print(f"streaming {dumps} dumps of {channels} x {baselines} through '{flagger}' "
          f"({n_vis * 8 / 1e9:.3f} GB each) on {card}:")
    for i in range(dumps):
        print(f"  dump {i}: upload {upload[i]:.3f} ms, flag {flag[i]:.3f} ms, download "
              f"{download[i]:.3f} ms, pipeline {interval[i]:.3f} ms [{card}]")
    for i in range(dumps - 1):
        lead = tl[i].at("flag_end", origin) - tl[i + 1].at("upload_start", origin)
        print(f"  upload {i + 1} began {lead:.3f} ms before flag {i} ended"
              if lead > 0 else f"  upload {i + 1} began {-lead:.3f} ms after flag {i} ended")
    steady = interval[1:] or interval
    med = statistics.median(steady)
    print(f"  median: upload {statistics.median(upload):.3f} ms, "
          f"flag {statistics.median(flag):.3f} ms, download {statistics.median(download):.3f} ms, "
          f"pipeline {med:.3f} ms per dump, "
          f"{n_vis / med / 1e6:.3f} Gvis/s; end to end {wall_ms / dumps:.3f} ms per dump "
          f"on the host's clock [{card}]")
    return results


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--channels", type=int, default=CHANNELS)
    ap.add_argument("--baselines", type=int, default=BASELINES)
    ap.add_argument("--dumps", type=int, default=DUMPS)
    ap.add_argument("--flagger", choices=FLAGGERS, default=None,
                    help="default: fused on the card, torch on the CPU")
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the run here")
    args = ap.parse_args(argv)
    ctx = context(args.device)
    on_card = ctx.device.type == "cuda"
    flagger = args.flagger or ("fused" if on_card else "torch")
    card = ""
    if on_card:
        from ..scripts.common import card_line

        card = card_line()
    source = RandomDumps(args.channels, args.baselines, SEED, pin=on_card)
    run(source, args.dumps, flagger, ctx, (args.channels, args.baselines), card, args.trace)


if __name__ == "__main__":
    main()
