"""The port's examples (katsdpsigproc_tpu_torch.examples) on the CPU, against
the JAX examples of ``doc/examples/``.

Every example runs as a subprocess with ``--device cpu``, as
tests/test_examples.py runs the JAX ones.  The tutorial kernels' plain
versions are held to the JAX examples' Pallas kernels in interpret mode
(the example files are loaded by path, unedited): K6 ``triple_kernel``
and K7 ``multiply_kernel``.  The streaming example flags the JAX
example's dumps (256 x 16, 5 dumps, seed 1) as the JAX example does.

Tolerance: exact.  A float32 product by 3 is rounded once in both; the
flagged channels are compared as sets, the masks flag for flag.
"""

import asyncio
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katsdpsigproc_tpu.models.rfi import device as jdev
from katsdpsigproc_tpu_torch import examples
from katsdpsigproc_tpu_torch.examples import (fill_reduce, resource_pipeline, triple,
                                              triple_op, triple_pallas)
from katsdpsigproc_tpu_torch.utils import backend

from .test_torch_probes import _environment_kept

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("hello_device", "triple_fn", "triple", "triple_pallas", "triple_op", "fill_reduce",
            "resource_pipeline")


def _jax_example(name: str):
    """A JAX example loaded by path (top-level code runs, in interpret mode here)."""
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  ROOT / "doc" / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    with _environment_kept(), contextlib.redirect_stdout(io.StringIO()):
        spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["KATSDPSIGPROC_TPU_TORCH_TUNE_DB"] = str(tmp_path / "tuning.json")
    proc = subprocess.run(
        [sys.executable, "-m", f"katsdpsigproc_tpu_torch.examples.{name}", "--device", "cpu"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip()


@pytest.mark.parametrize("name", EXAMPLES + ("sharded_flagger",))
def test_example_raises_without_a_card(name, monkeypatch):
    """No silent CPU fallback: without CUDA the default --device cuda exits."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = __import__(f"katsdpsigproc_tpu_torch.examples.{name}", fromlist=["main"])
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main([])


def test_sharded_flagger_runs_on_eight_cpu_ranks(tmp_path):
    """The sharded example spawns 8 gloo ranks; both halves show 0 mismatches."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "katsdpsigproc_tpu_torch.examples.sharded_flagger", "--device",
         "cpu", "--world-size", "8"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "devices: 8 × cpu", proc.stdout
    assert lines[1].startswith("1-D sharded flagger on a (2, 4) mesh: flagged ")
    assert lines[1].endswith("mismatches vs host oracle: 0"), proc.stdout
    assert lines[2].startswith("2-D sharded flagger over 8 ranks")
    assert lines[2].endswith("mismatches vs single-device: 0"), proc.stdout


@pytest.mark.parametrize("n", [256, 4 * 256, 64 * 256])
def test_k6_plain_matches_the_pallas_kernel(n):
    module = _jax_example("triple_pallas")
    x = np.random.RandomState(n).uniform(-10, 10, n).astype(np.float32)
    want = np.asarray(module.triple(jnp.asarray(x)))  # interpret=True off the TPU
    got = triple_pallas.triple(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(triple_pallas.triple_plain(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("scale", [3.0, 0.1, -7.25])
@pytest.mark.parametrize("shape", [(8, 128), (16, 256)])
def test_k7_plain_matches_the_pallas_kernel(shape, scale):
    module = _jax_example("triple")
    data = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(module.multiply(jnp.asarray(data), scale, interpret=True))
    got = triple.multiply(torch.from_numpy(data), scale)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(triple.multiply_plain(torch.from_numpy(data), scale).numpy(),
                                  want)


def test_tutorial_wrappers_take_the_plain_versions_on_the_cpu():
    before = (dict(triple.launches), dict(triple_pallas.launches))
    x = torch.arange(1000, dtype=torch.float32)
    assert torch.equal(triple_pallas.triple(x), x * 3)  # a ragged tail of 1000 % 256
    assert torch.equal(triple.multiply(x.reshape(10, 100), 2.5), x.reshape(10, 100) * 2.5)
    assert (triple.launches, triple_pallas.launches) == before  # no kernel on the CPU
    with pytest.raises(TypeError, match="float32"):
        triple.multiply(x.double(), 3.0)
    with pytest.raises(TypeError, match="1-D"):
        triple_pallas.triple(x.reshape(10, 100))


def test_ab_tool_and_examples_import_without_triton_or_nvcc(tmp_path):
    """Where `import triton` fails and no nvcc is found, an A/B tool (K9's)
    and both tutorial modules import, their CPU paths run, and the tool
    exits asking for a card."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from katsdpsigproc_tpu_torch.examples import triple, triple_pallas\n"
        "from katsdpsigproc_tpu_torch.scripts import rollchain_ab\n"
        "x = torch.arange(5000, dtype=torch.float32)\n"
        "assert torch.equal(triple_pallas.triple(x), x * 3)\n"
        "assert torch.equal(triple.multiply(x, 0.5), x * 0.5)\n"
        "torch.cuda.is_available = lambda: False\n"
        "try:\n"
        "    rollchain_ab.main([])\n"
        "except SystemExit as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('the A/B tool ran without a card')\n"
        "assert 'triton' not in sys.modules or sys.modules['triton'] is None\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(os.pathsep)
                                  if not (Path(p) / "nvcc").exists())
    env["CUDA_HOME"] = str(tmp_path / "no-cuda")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_triple_op_both_call_styles():
    ctx = backend.create_some_context(devices=[torch.device("cpu")])
    template = triple_op.MultiplyTemplate(ctx, tuning={"block": 128})
    op = template.instantiate(size=50, scale=3.0)
    host = np.random.RandomState(2).uniform(size=50).astype(np.float32)
    out = op(data=ctx.put(host))["out"]
    op.bind(data=ctx.put(host))
    op()
    np.testing.assert_array_equal(out.numpy(), host * np.float32(3))
    np.testing.assert_array_equal(op.buffer("out").numpy(), host * np.float32(3))
    assert op.parameters() == {"scale": 3.0, "block": 128}


def test_fill_reduce_matches_the_jax_example():
    module = _jax_example("fill_reduce")
    want = np.asarray(module.op.buffer("dest"))
    ctx = backend.create_some_context(devices=[torch.device("cpu")])
    op = fill_reduce.FillReduceTemplate(ctx).instantiate(shape=(10, 5))
    op(42)
    np.testing.assert_array_equal(op.buffer("dest").numpy(), want)


def _jax_pipeline_rows() -> dict:
    """Run the JAX streaming example; its flagged channels per dump, as printed."""
    module = _jax_example("resource_pipeline")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        asyncio.run(module.main())
    rows = {}
    for line in out.getvalue().splitlines():
        m = re.match(r"dump (\d+): flagged rows (\[.*\])", line)
        if m:
            rows[int(m.group(1))] = json.loads(m.group(2))
    return rows


@pytest.mark.parametrize("flagger", resource_pipeline.FLAGGERS)
def test_resource_pipeline_flags_as_the_jax_example(flagger, capsys):
    want_rows = _jax_pipeline_rows()
    capsys.readouterr()
    ctx = backend.create_some_context(devices=[torch.device("cpu")])
    shape = (resource_pipeline.CHANNELS, resource_pipeline.BASELINES)
    source = resource_pipeline.RandomDumps(*shape, seed=resource_pipeline.SEED, pin=False)
    results = resource_pipeline.run(source, resource_pipeline.DUMPS, flagger, ctx, shape)
    assert sorted(want_rows) == list(range(resource_pipeline.DUMPS))
    for i, flags in results.items():
        assert flags.shape == shape and flags.dtype == np.uint8
        assert np.flatnonzero(flags.any(axis=1)).tolist() == want_rows[i], i
    # Mask for mask: the JAX flagger on the same dumps (complex64, as the JAX
    # example feeds it; the port's dumps are the same values as planar pairs).
    rs = np.random.RandomState(seed=resource_pipeline.SEED)
    jax_flagger = jdev.make_flagger_fn(width=13, n_sigma=11.0, threshold="sum")
    for i in range(resource_pipeline.DUMPS):
        vis = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
        vis[resource_pipeline.spike_channel(i), :] *= 50.0
        np.testing.assert_array_equal(results[i], np.asarray(jax_flagger(jnp.asarray(vis))))
    assert "dump 4: flagged rows" in capsys.readouterr().out


def test_spiked_dumps_plant_and_restore_in_place():
    base = torch.from_numpy(np.random.RandomState(3).standard_normal((40, 6, 2)).astype(
        np.float32))
    source = resource_pipeline.SpikedDumps(base.clone())

    async def take(n):
        dumps = []
        for i in range(n):
            host = await source.get(i)
            dumps.append(host.clone())
            source.uploaded(i, None)
        return dumps

    dumps = asyncio.run(take(3))
    for i, dump in enumerate(dumps):
        want = base.clone()
        want[resource_pipeline.spike_channel(i)] *= 50.0
        assert torch.equal(dump, want), i


def test_examples_import_and_run_without_jax():
    """A subprocess where `import jax` and `import triton` fail imports every
    new module of the port (examples, resource layer, cost probes) and runs
    the examples on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['triton'] = None\n"
        "import warnings, pkgutil, importlib\n"
        "import katsdpsigproc_tpu_torch as port\n"
        "warnings.simplefilter('ignore', DeprecationWarning)\n"
        "for m in pkgutil.walk_packages(port.__path__, 'katsdpsigproc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from katsdpsigproc_tpu_torch import abc, asyncio\n"
        "from katsdpsigproc_tpu_torch.asyncio import resource\n"
        "from katsdpsigproc_tpu_torch.examples import (fill_reduce, hello_device,\n"
        "    resource_pipeline, sharded_flagger, triple, triple_fn, triple_op, triple_pallas)\n"
        "from katsdpsigproc_tpu_torch.scripts import prim_cost, roofline_skeleton\n"
        "for ex in (hello_device, triple_fn, triple, triple_pallas, triple_op, fill_reduce,\n"
        "           resource_pipeline):\n"
        "    ex.main(['--device', 'cpu'])\n"
        "assert 'katsdpsigproc_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["KATSDPSIGPROC_TPU_TORCH_TUNE_STUB"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_context_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        examples.context("cuda")
    assert examples.context("cpu").device == torch.device("cpu")
