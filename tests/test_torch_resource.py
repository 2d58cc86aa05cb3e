"""The port's resource layer (katsdpsigproc_tpu_torch.utils.resource), its
deprecated shim and its protocols, on the cases of tests/test_resource.py,
tests/test_asyncio_shim.py and tests/test_abc.py.

An event here is a ``torch.cuda.Event`` (waited on with ``synchronize()``),
an object with a host-blocking ``wait()``, or a tensor.  The fakes below
stand in for a CUDA event, which needs a card.
"""

import asyncio
import importlib
import warnings

import numpy as np
import pytest
import torch

from katsdpsigproc_tpu_torch import abc as fw_abc
from katsdpsigproc_tpu_torch.ops import fill, transpose
from katsdpsigproc_tpu_torch.pytest_plugin import patch_autotune  # noqa: F401
from katsdpsigproc_tpu_torch.utils import backend, resource


class DummyEvent:
    """A custom event whose ``wait()`` blocks the host."""

    def __init__(self):
        self.waited = 0

    def wait(self):
        self.waited += 1


class FakeCudaEvent:
    """Like ``torch.cuda.Event``: ``wait()`` would order a stream, ``synchronize()`` the host."""

    def __init__(self):
        self.calls = []

    def wait(self, stream=None):
        self.calls.append("wait")

    def synchronize(self):
        self.calls.append("synchronize")


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


class TestWaitForEvents:
    def test_custom_events(self):
        events = [DummyEvent(), DummyEvent()]
        resource.wait_for_events(events)
        assert all(e.waited == 1 for e in events)

    def test_tensors(self):
        x = torch.ones(8) * 2
        resource.wait_for_events([x, [x, {"y": x}], None, 3])  # must not raise

    def test_cuda_event_is_host_waited_with_synchronize(self):
        event = FakeCudaEvent()
        resource.wait_for_events([event])
        assert event.calls == ["synchronize"]

    def test_nested_events(self):
        inner = [DummyEvent(), DummyEvent()]
        resource.wait_for_events([(inner[0],), {"a": inner[1]}])
        assert [e.waited for e in inner] == [1, 1]

    def test_async(self):
        async def main():
            events = [DummyEvent(), torch.ones(4)]
            await resource.async_wait_for_events(events)
            return events

        events = run(main())
        # the async variant clears its internal copy, not the caller's list
        assert len(events) == 2
        assert events[0].waited == 1


class TestResource:
    def test_fifo_ordering(self):
        async def main():
            r = resource.Resource("buffer")
            order = []

            a = r.acquire()
            b = r.acquire()

            async def user(name, alloc, events):
                got = await alloc.wait()
                order.append((name, list(got)))
                alloc.ready(events)

            # Run b's wait first; it must still be served after a releases.
            tb = asyncio.ensure_future(user("b", b, []))
            await asyncio.sleep(0)
            ta = asyncio.ensure_future(user("a", a, ["ev-a"]))
            await asyncio.gather(ta, tb)
            return order

        order = run(main())
        assert order == [("a", []), ("b", ["ev-a"])]

    def test_wait_events_waits_for_the_previous_holder(self):
        async def main():
            r = resource.Resource("buffer")
            a, b = r.acquire(), r.acquire()
            event = FakeCudaEvent()
            a.ready([event])
            await b.wait_events()
            b.ready()
            return event

        assert run(main()).calls == ["synchronize"]

    def test_context_manager_value(self):
        async def main():
            r = resource.Resource(42)
            acq = r.acquire()
            with acq as value:
                assert value == 42
                acq.ready()

        run(main())

    def test_context_manager_releases_with_a_warning(self, caplog):
        async def main():
            r = resource.Resource(1)
            acq, nxt = r.acquire(), r.acquire()
            with acq:
                pass
            return await nxt.wait()

        assert run(main()) == []
        assert "not explicitly made ready" in caplog.text

    def test_context_manager_exception_propagates(self):
        async def main():
            r = resource.Resource(1)
            acq = r.acquire()
            nxt = r.acquire()
            with pytest.raises(RuntimeError):
                with acq:
                    raise RuntimeError("boom")
            with pytest.raises(RuntimeError):
                await nxt.wait()

        run(main())


class TestJobQueue:
    def test_clean_and_finish(self):
        async def main():
            q = resource.JobQueue()

            async def job(result):
                return result

            q.add(job(1))
            q.add(job(2))
            assert len(q) == 2
            assert bool(q)
            await q.finish()
            assert len(q) == 0
            assert not q

        run(main())

    def test_clean_rethrows(self):
        async def main():
            q = resource.JobQueue()

            async def bad():
                raise ValueError("broken job")

            q.add(bad())
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            with pytest.raises(ValueError):
                q.clean()

        run(main())

    def test_clean_keeps_pending_jobs(self):
        async def main():
            q = resource.JobQueue()
            gate = asyncio.Event()

            async def done():
                return 1

            async def waits():
                await gate.wait()

            q.add(done())
            q.add(waits())
            await asyncio.sleep(0)
            q.clean()
            assert len(q) == 1
            gate.set()
            await q.finish()

        run(main())

    def test_finish_max_remaining(self):
        async def main():
            q = resource.JobQueue()
            ev = asyncio.Event()

            async def job():
                await ev.wait()

            q.add(job())
            q.add(job())
            q.add(job())
            ev.set()
            await q.finish(max_remaining=1)
            assert len(q) <= 1

        run(main())

    def test_contains(self):
        async def main():
            q = resource.JobQueue()
            fut = asyncio.get_running_loop().create_future()
            q.add(fut)
            assert fut in q
            fut.set_result(None)
            await q.finish()
            assert fut not in q

        run(main())


class TestWaitUntil:
    def test_completes(self):
        async def main():
            loop = asyncio.get_running_loop()

            async def quick():
                return 7

            return await resource.wait_until(quick(), loop.time() + 5)

        assert run(main()) == 7

    def test_times_out(self):
        async def main():
            loop = asyncio.get_running_loop()
            never = loop.create_future()
            with pytest.raises(asyncio.TimeoutError):
                await resource.wait_until(never, loop.time() + 0.05)
            return never

        assert run(main()).cancelled()


def test_shim_warns_and_reexports():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        import katsdpsigproc_tpu_torch.asyncio.resource as shim

        importlib.reload(shim)
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert shim.Resource is resource.Resource
    assert shim.JobQueue is resource.JobQueue
    assert shim.__all__ == resource.__all__


def test_templates_and_ops_satisfy_protocols(patch_autotune):  # noqa: F811
    ctx = backend.create_some_context(devices=[torch.device("cpu")])
    template = fill.FillTemplate(ctx, np.float32)
    assert isinstance(template, fw_abc.AbstractTemplate)
    op = template.instantiate(None, (8, 8))
    assert isinstance(op, fw_abc.AbstractOperation)
    t2 = transpose.TransposeTemplate(ctx, np.float32)
    assert isinstance(t2, fw_abc.AbstractTemplate)
    assert isinstance(t2.instantiate(None, (8, 8)), fw_abc.AbstractOperation)


def test_event_protocol():
    class Ev:
        def wait(self):
            return None

    assert isinstance(Ev(), fw_abc.AbstractEventLike)
    assert isinstance(FakeCudaEvent(), fw_abc.AbstractEventLike)
    assert not isinstance(object(), fw_abc.AbstractEventLike)


def test_cuda_tensor_is_waited_on_with_its_whole_device(monkeypatch):
    """A CUDA tensor's producer may have queued it on any stream, and the
    waiting thread's current stream is its own: the wait synchronises the
    tensor's device, not a stream.  (A stand-in tensor, as this runs on the
    CPU; tests/test_torch_cuda.py holds the real case on the card.)"""

    class CudaLike(torch.Tensor):
        @property
        def is_cuda(self):
            return True

        @property
        def device(self):
            return torch.device("cuda", 1)

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *args: pytest.fail("waited on the current stream only"))
    t = torch.Tensor._make_subclass(CudaLike, torch.zeros(2))
    resource.wait_for_events([t, [t]])
    assert calls == [torch.device("cuda", 1)] * 2
