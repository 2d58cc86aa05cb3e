"""Utilities for scheduling device work with asyncio.

Port of ``katsdpsigproc_tpu/utils/resource.py:28-195``: the reference's
"acquire early, wait late" ordering of a contended resource, with FIFO
futures that carry device events so pipeline stages order themselves
without host stalls, and a bounded queue of in-flight jobs.

What changes is the event.  An event here is

* a ``torch.cuda.Event`` (or any object with ``synchronize()``): the host
  waits with ``synchronize()``.  Its ``wait()`` would make the current
  stream wait and return at once, so ``synchronize()`` is tried first;
* an object with ``wait()`` that blocks the host (a custom event);
* a tensor: a CUDA tensor carries no event of its own, and the stream
  that produced it is not known (the waiting thread's current stream is
  its own, not the producer's), so waiting on one synchronises its whole
  device, which covers work queued on any stream; a CPU tensor is
  complete already;
* a list, tuple or dict of these, waited on element by element.

Anything else (a number, ``None``, a numpy array) is a host value and
complete.  A consumer on another stream need not block the host: it
orders itself after the previous holder's events with
``stream.wait_event(event)`` on the events that
:meth:`ResourceAllocation.wait` resolves to, the reference's "wait late"
on the device.
"""

import asyncio
import collections
import logging
from types import TracebackType
from typing import Awaitable, Deque, Generic, Iterable, List, Optional, Type, TypeVar

import torch

_T = TypeVar("_T")
_logger = logging.getLogger(__name__)


def _wait(event) -> None:
    if isinstance(event, torch.Tensor):
        if event.is_cuda:
            torch.cuda.synchronize(event.device)
    elif hasattr(event, "synchronize"):
        event.synchronize()
    elif hasattr(event, "wait"):
        event.wait()
    elif isinstance(event, (list, tuple)):
        for item in event:
            _wait(item)
    elif isinstance(event, dict):
        for item in event.values():
            _wait(item)


def wait_for_events(events: List) -> None:
    """Block the calling thread until all events' work is done (see the module docstring)."""
    for event in events:
        _wait(event)


def _event_loop(loop: Optional[asyncio.AbstractEventLoop]) -> asyncio.AbstractEventLoop:
    if loop is not None:
        return loop
    try:
        return asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.get_event_loop()


async def wait_until(future: Awaitable[_T], when: float,
                     loop: Optional[asyncio.AbstractEventLoop] = None) -> _T:
    """Like :func:`asyncio.wait_for`, but with an absolute deadline.

    ``when`` is a time on the event loop's clock (``loop.time()``).  As in
    the JAX package, the deadline fires even when the work cannot be
    cancelled (an executor thread blocked in a device wait): cancellation
    is requested and ``asyncio.TimeoutError`` raised at once.
    """
    loop = _event_loop(loop)
    pending = asyncio.ensure_future(future, loop=loop)
    done, _ = await asyncio.wait((pending,), timeout=max(0.0, when - loop.time()))
    if not done:
        pending.cancel()
        raise asyncio.TimeoutError()
    return pending.result()


async def async_wait_for_events(events: Iterable,
                                loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
    """Wait for `events` in an executor thread, so the event loop stays live.

    The worker drops its references to the events before the future
    resolves; the caller's list is not touched.
    """

    def wait_all(events: List) -> None:
        wait_for_events(events)
        events.clear()

    loop = _event_loop(loop)
    events = list(events)
    if events:
        await loop.run_in_executor(None, wait_all, events)


class ResourceAllocation(Generic[_T]):
    """A handle representing a future acquisition of a resource.

    :meth:`wait` (or :meth:`wait_events`) gives the previous holder's
    completion events; :meth:`ready` hands this holder's to the next.
    Used as a context manager, it releases with a warning (or passes the
    exception on) if :meth:`ready` was never called.
    """

    def __init__(self, start: "asyncio.Future[List]", end: "asyncio.Future[List]",
                 value: _T, loop: asyncio.AbstractEventLoop) -> None:
        self._start = start
        self._end = end
        self._loop = loop
        self.value = value

    def wait(self) -> "asyncio.Future[List]":
        """Future resolving to the events to wait for before use."""
        return self._start

    async def wait_events(self) -> None:
        """Wait on the host for previous use of the resource to complete."""
        events = await self._start
        await async_wait_for_events(events, loop=self._loop)

    def ready(self, events: Optional[List] = None) -> None:
        """Release to the next acquirer, handing over completion `events`."""
        self._end.set_result([] if events is None else events)

    def __enter__(self) -> _T:
        return self.value

    def __exit__(self, exc_type: Optional[Type[BaseException]],
                 exc_value: Optional[BaseException],
                 exc_tb: Optional[TracebackType]) -> None:
        if not self._end.done():
            if exc_value is not None:
                self._end.set_exception(exc_value)
                self._end.exception()  # mark it retrieved; it also propagates
            else:
                _logger.warning("Resource allocation was not explicitly made ready")
                self.ready()


class Resource(Generic[_T]):
    """A contended resource: :meth:`acquire` is non-blocking and strictly FIFO.

    Each acquisition's start future is the previous acquisition's end
    future.
    """

    def __init__(self, value: _T, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        self._loop = _event_loop(loop)
        self._future: "asyncio.Future[List]" = self._loop.create_future()
        self._future.set_result([])
        self.value = value

    def acquire(self) -> ResourceAllocation[_T]:
        old = self._future
        self._future = self._loop.create_future()
        return ResourceAllocation(old, self._future, self.value, loop=self._loop)


class JobQueue:
    """A bounded list of in-flight asynchronous jobs."""

    def __init__(self) -> None:
        self._jobs: Deque[asyncio.Future] = collections.deque()

    def add(self, job: Awaitable) -> None:
        """Append a job (a coroutine is wrapped in a task)."""
        self._jobs.append(asyncio.ensure_future(job))

    def clean(self) -> None:
        """Remove completed jobs from the front, raising a failed job's exception."""
        while self._jobs:
            head = self._jobs[0]
            if not head.done():
                break
            self._jobs.popleft()
            head.result()

    async def finish(self, max_remaining: int = 0) -> None:
        """Wait until at most `max_remaining` jobs are outstanding.

        The length is checked again after every await, so jobs added
        meanwhile are drained too.
        """
        while len(self._jobs) > max_remaining:
            await self._jobs.popleft()

    def __len__(self) -> int:
        return len(self._jobs)

    def __bool__(self) -> bool:
        return len(self._jobs) > 0

    def __contains__(self, item: asyncio.Future) -> bool:
        return any(job is item for job in self._jobs)


__all__ = [
    "wait_for_events",
    "wait_until",
    "async_wait_for_events",
    "Resource",
    "ResourceAllocation",
    "JobQueue",
]
