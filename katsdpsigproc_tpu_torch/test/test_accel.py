"""Framework-agnostic device-test decorators for downstream packages.

Port of ``katsdpsigproc_tpu/test/test_accel.py``, for packages whose
tests are plain ``unittest`` (not the pytest plugin):

* :func:`device_test`: append a context and its device to the test's
  arguments, stub the autotuner to its deterministic ``test=`` values,
  and skip when no device is available;
* :func:`cuda_test`: skip unless the shared device is a CUDA card (the
  JAX package's ``tpu_test``, and the reference library's own name);
* :func:`force_autotune`: run the real autotune search inside a test.

The shared context is the port's
``backend.create_some_context(interactive=False)``: the card where there
is one, else the CPU.  ``unittest.SkipTest`` is recognised by unittest
and pytest alike.  For pytest suites prefer the fixtures of
:mod:`katsdpsigproc_tpu_torch.pytest_plugin`.
"""

import functools
import inspect
import sys
import unittest
from typing import Callable, Optional, Tuple, TypeVar
from unittest import mock

import torch

from ..utils import backend, tune

_T = TypeVar("_T")
_F = TypeVar("_F", bound=Callable)

_test_initialized = False
_test_context: Optional[backend.DeviceContext] = None


def _prepare_device_test() -> Tuple[backend.DeviceContext, torch.device]:
    """Create (once) and return the shared test context and its device."""
    global _test_initialized, _test_context
    if not _test_initialized:
        try:
            _test_context = backend.create_some_context(interactive=False)
            print(f"Testing on {_test_context.device_kind} ({_test_context.platform})",
                  file=sys.stderr)
        except RuntimeError:
            pass  # no devices available
        _test_initialized = True
    if _test_context is None:
        raise unittest.SkipTest("no torch device found")
    return _test_context, _test_context.device


def _device_test_sync(test: Callable[..., _T]) -> Callable[..., _T]:
    @functools.wraps(test)
    def wrapper(*args, **kwargs) -> _T:
        context, device = _prepare_device_test()
        with mock.patch.object(tune, "autotuner_impl", new=tune.stub_autotuner):
            return test(*(args + (context, device)), **kwargs)

    return wrapper


def _device_test_async(test: Callable[..., _T]) -> Callable[..., _T]:
    @functools.wraps(test)
    async def wrapper(*args, **kwargs):
        context, device = _prepare_device_test()
        with mock.patch.object(tune, "autotuner_impl", new=tune.stub_autotuner):
            return await test(*(args + (context, device)), **kwargs)

    return wrapper


def device_test(test: Callable[..., _T]) -> Callable[..., _T]:
    """Decorate an on-device test (sync or async).

    Appends ``(context, device)`` to the test's positional arguments,
    skips the test when no device is available, and stubs autotuning to
    the deterministic ``test=`` values.  For a real autotune search stack
    :func:`force_autotune` inside (after) this decorator.
    """
    if inspect.iscoroutinefunction(test):
        return _device_test_async(test)
    return _device_test_sync(test)


def cuda_test(test: _F) -> _F:
    """Skip a test unless the shared device is a CUDA card.

    Guards the hand-written kernels, which a tensor on the CPU reaches only
    through their plain versions.  Put this after (inside)
    :func:`device_test`.
    """

    @functools.wraps(test)
    def wrapper(*args, **kwargs):
        if _test_context is None or _test_context.platform != "cuda":
            raise unittest.SkipTest("device is not a CUDA card")
        return test(*args, **kwargs)

    return wrapper  # type: ignore[return-value]


def force_autotune(test: Callable[..., _T]) -> Callable[..., _T]:
    """Force the real autotune search inside a test."""

    @functools.wraps(test)
    def wrapper(*args, **kwargs) -> _T:
        with mock.patch.object(tune, "autotuner_impl", new=tune.force_autotuner):
            return test(*args, **kwargs)

    return wrapper


# Keep test collectors from taking the decorators for tests.
device_test.__test__ = False  # type: ignore[attr-defined]
cuda_test.__test__ = False  # type: ignore[attr-defined]
force_autotune.__test__ = False  # type: ignore[attr-defined]
