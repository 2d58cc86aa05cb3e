"""Pytest plugin: device-parametrised fixtures and autotune stubbing.

Port of ``katsdpsigproc_tpu/pytest_plugin.py``:

* fixture ``device``: parametrised over :func:`..utils.backend.candidate_devices`
  (every CUDA card, then the CPU), filtered by the marks and the
  ``--devices`` option (``first-per-api``, the default: the first device
  of each type, so ``cuda:0`` and the CPU on a machine with a card;
  ``all``; ``none``).  With no matching device the test xfails with "No
  matching device found" rather than passing unseen;
* fixture ``context``: a :class:`..utils.backend.DeviceContext` on that
  device, with autotuning stubbed;
* fixture ``command_queue``: the context, as in the JAX package (the
  templates' ``instantiate`` takes it as its ``command_queue``);
* fixture ``patch_autotune``: patches
  :data:`katsdpsigproc_tpu_torch.utils.tune.autotuner_impl` to the stub,
  so a template built in a test measures nothing, or to the real search
  when the test carries the ``force_autotune`` mark;
* marks ``cuda_only`` (the JAX package's ``tpu_only``), ``cpu_only`` and
  ``device_filter(fn)``, where ``fn`` takes a ``torch.device``.

Load it with ``-p katsdpsigproc_tpu_torch.pytest_plugin`` or
``pytest_plugins = ["katsdpsigproc_tpu_torch.pytest_plugin"]`` in a
top-level conftest.  It adds the same ``--devices`` option as the JAX
package's plugin, so the two cannot be loaded in one session.  The
port's own test files import ``patch_autotune`` from here by name
(``from katsdpsigproc_tpu_torch.pytest_plugin import patch_autotune``),
which loads no hook, because the machine with the card runs them with
``--noconftest``.
"""

from typing import List

import pytest
import torch

from .utils import backend, tune


def pytest_addoption(parser):
    group = parser.getgroup("katsdpsigproc_tpu_torch")
    group.addoption(
        "--devices",
        choices=["first-per-api", "all", "none"],
        default="first-per-api",
        help="Which torch devices to parametrise device tests over",
    )


def pytest_configure(config):
    for mark in ["cuda_only", "cpu_only", "device_filter", "force_autotune"]:
        config.addinivalue_line("markers",
                                f"{mark}: see katsdpsigproc_tpu_torch.pytest_plugin")


def _candidate_devices(config) -> List[torch.device]:
    mode = config.getoption("--devices", default="first-per-api")
    if mode == "none":
        return []
    devices = backend.candidate_devices()
    if mode == "first-per-api":
        seen = set()
        picked = []
        for d in devices:
            if d.type not in seen:
                seen.add(d.type)
                picked.append(d)
        return picked
    return devices


def pytest_generate_tests(metafunc):
    if "device" in metafunc.fixturenames:
        devices = _candidate_devices(metafunc.config)
        for _ in metafunc.definition.iter_markers("cuda_only"):
            devices = [d for d in devices if d.type == "cuda"]
        for _ in metafunc.definition.iter_markers("cpu_only"):
            devices = [d for d in devices if d.type == "cpu"]
        for mark in metafunc.definition.iter_markers("device_filter"):
            devices = [d for d in devices if mark.args[0](d)]
        # Through the fixture (indirect), so that the sentinel None reaches it and
        # xfails rather than being handed to the test as its device.
        if not devices:
            metafunc.parametrize("device", [None], ids=["no-device"], indirect=True)
        else:
            metafunc.parametrize("device", devices, ids=[str(d) for d in devices],
                                 indirect=True)


@pytest.fixture
def device(request):
    dev = request.param
    if dev is None:
        pytest.xfail("No matching device found")
    return dev


@pytest.fixture
def patch_autotune(request, monkeypatch):
    if request.node.get_closest_marker("force_autotune"):
        monkeypatch.setattr(tune, "autotuner_impl", tune.force_autotuner)
    else:
        monkeypatch.setattr(tune, "autotuner_impl", tune.stub_autotuner)


@pytest.fixture
def context(device, patch_autotune):
    return backend.DeviceContext(device)


@pytest.fixture
def command_queue(context):
    """The placement context: PyTorch queues work on the device's current
    stream, so the context stands in wherever the reference passes a queue."""
    return context
