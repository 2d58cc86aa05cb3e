"""The port's test support: the pytest plugin and the ``test.test_accel`` decorators.

The plugin (``katsdpsigproc_tpu_torch.pytest_plugin``) adds the same
``--devices`` option as the JAX package's plugin, which this session loads
through ``tests/conftest.py``, and parametrises every test that asks for
a fixture named ``device``.  So it is never loaded here: each case runs a
pytest subprocess on a test file written to ``tmp_path``, with
``--noconftest -p katsdpsigproc_tpu_torch.pytest_plugin`` and an empty
ini file, as the machine with the card runs the port's tests.  Without a
card the candidates are the CPU alone; a second pair of runs reports two
CUDA devices (``torch.cuda.device_count`` patched before pytest starts;
nothing touches a card) to show which devices each mode and mark keeps.

The decorators are held to ``tests/test_legacy_helpers.py``'s cases for
the JAX package's, in this process.
"""

import asyncio
import os
import re
import subprocess
import sys
import unittest
from pathlib import Path

import pytest
import torch

from katsdpsigproc_tpu_torch.test import test_accel
from katsdpsigproc_tpu_torch.utils import backend, tune

ROOT = Path(__file__).resolve().parent.parent

PLUGIN_TESTS = '''
import pytest
import torch

from katsdpsigproc_tpu_torch.utils import backend, tune


def test_device(device):
    assert isinstance(device, torch.device)


@pytest.mark.cuda_only
def test_cuda_only(device):
    assert device.type == "cuda"


@pytest.mark.cpu_only
def test_cpu_only(device):
    assert device.type == "cpu"


@pytest.mark.device_filter(lambda d: False)
def test_filtered_out(device):
    raise AssertionError("no device passes this filter")


@pytest.mark.device_filter(lambda d: d.type == "cpu")
def test_filtered_to_the_cpu(device):
    assert device == torch.device("cpu")


def test_context(context, device):
    assert isinstance(context, backend.DeviceContext)
    assert context.device == device
    assert tune.autotuner_impl is tune.stub_autotuner


def test_command_queue(command_queue, context):
    assert command_queue is context


@pytest.mark.force_autotune
def test_force_autotune(context):
    assert tune.autotuner_impl is tune.force_autotuner


def test_without_a_device():
    assert tune.autotuner_impl is not tune.stub_autotuner
'''

# Starts pytest in a process where torch reports `cards` CUDA devices.
_BOOTSTRAP = (
    "import sys, torch, pytest\n"
    "cards = int(sys.argv[1])\n"
    "if cards:\n"
    "    torch.cuda.device_count = lambda: cards\n"
    "sys.exit(pytest.main(sys.argv[2:]))\n"
)

_OUTCOME = re.compile(r"::(\S+) (PASSED|FAILED|ERROR|XFAIL|XPASS|SKIPPED)")


def run_plugin(tmp_path, *options, cards: int = 0):
    """Run PLUGIN_TESTS under the port's plugin in a subprocess; returns
    ({test id: outcome}, the process)."""
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "test_plugin_cases.py").write_text(PLUGIN_TESTS)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PYTEST_ADDOPTS")}
    env["PYTHONPATH"] = str(ROOT)
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    args = ["-c", str(tmp_path / "pytest.ini"), "--rootdir", str(tmp_path), "--noconftest",
            "-p", "katsdpsigproc_tpu_torch.pytest_plugin", "-p", "no:cacheprovider",
            "-p", "no:randomly", "--strict-markers", "-v", "-rxs", *options,
            str(tmp_path / "test_plugin_cases.py")]
    proc = subprocess.run([sys.executable, "-c", _BOOTSTRAP, str(cards), *args], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    return dict(_OUTCOME.findall(proc.stdout)), proc


def test_plugin_parametrises_over_the_cpu_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the CPU-only candidates; tests/test_torch_cuda.py runs the card's")
    outcomes, proc = run_plugin(tmp_path)
    assert outcomes == {
        "test_device[cpu]": "PASSED",
        "test_cuda_only[no-device]": "XFAIL",
        "test_cpu_only[cpu]": "PASSED",
        "test_filtered_out[no-device]": "XFAIL",
        "test_filtered_to_the_cpu[cpu]": "PASSED",
        "test_context[cpu]": "PASSED",
        "test_command_queue[cpu]": "PASSED",
        "test_force_autotune[cpu]": "PASSED",
        "test_without_a_device": "PASSED",
    }, proc.stdout
    assert proc.returncode == 0, proc.stdout
    assert proc.stdout.count("No matching device found") == 2, proc.stdout


def test_plugin_devices_none_xfails_every_device_test(tmp_path):
    outcomes, proc = run_plugin(tmp_path, "--devices", "none")
    assert proc.returncode == 0, proc.stdout
    assert outcomes.pop("test_without_a_device") == "PASSED"
    assert set(outcomes.values()) == {"XFAIL"}, outcomes
    assert all(name.endswith("[no-device]") for name in outcomes), outcomes
    assert len(outcomes) == 8
    assert proc.stdout.count("No matching device found") == 8, proc.stdout


def test_plugin_first_per_api_takes_the_first_card_and_the_cpu(tmp_path):
    outcomes, proc = run_plugin(tmp_path, cards=2)
    assert proc.returncode == 0, proc.stdout
    assert {k for k in outcomes if k.startswith("test_device[")} == {
        "test_device[cuda:0]", "test_device[cpu]"}
    assert outcomes["test_cuda_only[cuda:0]"] == "PASSED"
    assert "test_cuda_only[cuda:1]" not in outcomes
    assert outcomes["test_cpu_only[cpu]"] == "PASSED"
    assert "test_cpu_only[cuda:0]" not in outcomes
    assert outcomes["test_filtered_to_the_cpu[cpu]"] == "PASSED"
    assert outcomes["test_filtered_out[no-device]"] == "XFAIL"
    assert outcomes["test_context[cuda:0]"] == outcomes["test_context[cpu]"] == "PASSED"
    assert outcomes["test_command_queue[cuda:0]"] == "PASSED"
    assert len(outcomes) == 13, outcomes


def test_plugin_devices_all_takes_every_card(tmp_path):
    outcomes, proc = run_plugin(tmp_path, "--devices", "all", cards=2)
    assert proc.returncode == 0, proc.stdout
    assert {k for k in outcomes if k.startswith("test_device[")} == {
        "test_device[cuda:0]", "test_device[cuda:1]", "test_device[cpu]"}
    assert outcomes["test_cuda_only[cuda:1]"] == "PASSED"
    assert {k for k in outcomes if k.startswith("test_cpu_only")} == {"test_cpu_only[cpu]"}


def test_plugin_registers_its_marks(tmp_path):
    """--strict-markers accepts the marks (the runs above use it), and
    --markers lists them."""
    outcomes, proc = run_plugin(tmp_path, "--markers")
    assert proc.returncode == 0 and not outcomes, proc.stdout
    for mark in ("cuda_only", "cpu_only", "device_filter", "force_autotune"):
        assert f"@pytest.mark.{mark}:" in proc.stdout, proc.stdout


def test_plugin_rejects_an_unknown_devices_mode(tmp_path):
    outcomes, proc = run_plugin(tmp_path, "--devices", "some")
    assert proc.returncode == pytest.ExitCode.USAGE_ERROR and not outcomes
    assert "invalid choice: 'some'" in proc.stderr, proc.stderr


def test_device_test_injects_context_and_stubs_autotune():
    seen = {}

    @test_accel.device_test
    def my_test(context, device):
        seen["context"] = context
        seen["device"] = device
        # autotuning is stubbed to the deterministic test= values
        seen["tuning"] = tune.autotuner_impl({"engine": "rank"}, None)

    my_test()
    assert isinstance(seen["context"], backend.DeviceContext)
    assert seen["device"] is seen["context"].device
    assert seen["device"] == backend.create_some_context(interactive=False).device
    assert seen["tuning"] == {"engine": "rank"}
    # the stub is removed outside the test
    assert tune.autotuner_impl is not tune.stub_autotuner


def test_device_test_async():
    seen = {}

    @test_accel.device_test
    async def my_test(context, device):
        seen["context"] = context
        return device

    device = asyncio.run(my_test())
    assert isinstance(seen["context"], backend.DeviceContext)
    assert device is seen["context"].device


def test_device_test_passes_positional_arguments_first():
    @test_accel.device_test
    def my_test(first, context, device, keyword=None):
        return first, keyword, device

    first, keyword, device = my_test(7, keyword="k")
    assert (first, keyword) == (7, "k")
    assert isinstance(device, torch.device)


def test_cuda_test_skips_without_a_card():
    @test_accel.device_test
    @test_accel.cuda_test
    def my_test(context, device):  # pragma: nocover - skipped without a card
        raise AssertionError("should have been skipped")

    test_accel._prepare_device_test()
    if test_accel._test_context.platform == "cuda":  # pragma: nocover
        pytest.skip("running on a card: tests/test_torch_cuda.py runs cuda_test there")
    with pytest.raises(unittest.SkipTest, match="not a CUDA card"):
        my_test()


def test_force_autotune():
    seen = {}

    @test_accel.force_autotune
    def my_test():
        seen["impl"] = tune.autotuner_impl

    my_test()
    assert seen["impl"] is tune.force_autotuner
    assert tune.autotuner_impl is not tune.force_autotuner


def test_decorators_not_collected():
    assert test_accel.device_test.__test__ is False
    assert test_accel.cuda_test.__test__ is False
    assert test_accel.force_autotune.__test__ is False
