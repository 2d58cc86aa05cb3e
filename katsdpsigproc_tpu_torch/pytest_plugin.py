"""Pytest fixture that stubs the port's autotuning.

Port of ``katsdpsigproc_tpu/pytest_plugin.py:85-94`` (``patch_autotune``):
it patches :data:`katsdpsigproc_tpu_torch.utils.tune.autotuner_impl` to
the stub, so a template built in a test measures nothing, or to the real
search when the test carries the ``force_autotune`` mark.

The port's tests import the fixture from here
(``from katsdpsigproc_tpu_torch.pytest_plugin import patch_autotune``)
rather than through a conftest, because the machine with the card runs
its tests with ``--noconftest``.
"""

import pytest

from .utils import tune


@pytest.fixture
def patch_autotune(request, monkeypatch):
    if request.node.get_closest_marker("force_autotune"):
        monkeypatch.setattr(tune, "autotuner_impl", tune.force_autotuner)
    else:
        monkeypatch.setattr(tune, "autotuner_impl", tune.stub_autotuner)
