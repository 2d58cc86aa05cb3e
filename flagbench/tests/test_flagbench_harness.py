"""The harness takes a cell of another shape as new files, and the 1-D loops keep their inputs.

A loop is found by the name its mix gives (``loops/<loop>.py``) and owns
its inputs, its visibilities a dump, its reference flags and its checks.
Here a loop of (time, channels, baselines) cubes with a reference of its
own is added to a copy of the benchmark as new files and new entries only,
and run through ``run_cell`` in a process of its own.
"""

import hashlib
import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from flagbench import data, harness, loops
from flagbench.loops import resident, stream

SPEC = harness.load_spec()
SMALL = {"channels": 512, "rows": 16}
CELLS = [c["name"] for c in SPEC["workloads"]]

CUBE_LOOP = '''
"""A loop of another shape: (time, channels, baselines) cubes, flagged by a threshold."""

import time

import torch

from .. import reference_cube
from . import Loop


class Cube(Loop):
    @staticmethod
    def n_vis(config):
        return config["time"] * config["channels"] * config["baselines"]

    @staticmethod
    def inputs(cell, seed):
        gen = torch.Generator().manual_seed(seed)
        shape = (cell.config["time"], cell.config["channels"], cell.config["baselines"])
        cell.ring = [torch.randn(shape, generator=gen) for _ in range(cell.traffic["ring"])]

    def warm(self):
        self._call(0)

    def _call(self, i):
        cube = self.cell.ring[i % len(self.cell.ring)]
        return (cube.abs() > self.cell.traffic["threshold"]).to(torch.uint8)

    def window(self, seconds, tracer, sample):
        latency, i = [], 0
        with tracer.window():
            start = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                flags = self._call(i)
                t1 = time.perf_counter()
                latency.append(t1 - t0)
                sample.offer(i, i % len(self.cell.ring), flags)
                i += 1
                if t1 - start >= seconds:
                    break
        return {"dumps": i, "window_s": t1 - start, "latency_s": latency, "missing": 0}

    def reference_flags(self, slot, dtype=torch.float32):
        return reference_cube.flags(self.cell.ring[slot].to(dtype), self.cell.traffic["threshold"])

    def flags_on_device(self, flags):
        return flags
'''

CUBE_REFERENCE = '''
"""The cube loop's plain reference: 1 where a sample's magnitude passes the threshold."""

import torch


def flags(cube, threshold):
    return (cube.abs() > {threshold}).to(torch.uint8)
'''

RUN = '''
import json
from pathlib import Path
import torch
from flagbench import harness
assert harness.ROOT == Path.cwd().resolve(), harness.ROOT
print(json.dumps(harness.run_cell(harness.load_spec(), "toy-cube", 2**31 + 9, 0.2, False,
                                  torch.device("cpu"), 0.0)))
'''


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _add_cube_cell(root, threshold):
    """The cube cell as new files and new entries in the copy of the benchmark at `root`."""
    bench = root / "flagbench"
    (bench / "loops" / "cube.py").write_text(CUBE_LOOP)
    (bench / "reference_cube.py").write_text(CUBE_REFERENCE.replace("{threshold}", repr(threshold)))
    (bench / "traffic" / "cube.json").write_text(json.dumps(
        {"loop": "cube", "ring": 2, "sample": 4, "trace_seconds": 1, "threshold": 2.0}))
    (bench / "configs" / "toy-cube.json").write_text(json.dumps(
        {"name": "toy-cube", "time": 6, "channels": 32, "baselines": 5}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-cube", "source": "a test", "reduced": [], "why": "a test",
                            "file": "flagbench/configs/toy-cube.json"})
    spec["workloads"].append({"name": "toy-cube", "config": "toy-cube", "traffic": "cube",
                              "chips": 1, "why": "a test"})
    for metric in spec["end_to_end"]:
        if metric["name"] in ("gvis_per_s", "dump_ms_p95"):
            metric["workloads"].append("toy-cube")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("threshold, correct", [(2.0, True), (1.5, False)],
                         ids=["reference_agrees", "reference_disagrees"])
def test_a_loop_of_another_shape_is_new_files(tmp_path, threshold, correct):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "flagbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _add_cube_cell(tmp_path, threshold)
    before, after = _digests(harness.HERE), _digests(tmp_path / "flagbench")
    assert {name: after[name] for name in before} == before  # no file of the benchmark edited
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is correct
    assert list(result["checks"]) == ["flag_mismatches", "dumps_missing"]
    assert set(result["metrics"]) == {"gvis_per_s", "dump_ms_p95", "setup_s"}
    assert result["attempted"] > 0
    mismatches = result["checks"]["flag_mismatches"]["value"]
    assert (mismatches == 0) is correct and (result["failed"] == 0) is correct


def test_an_unknown_loop_names_the_path_it_looked_for():
    with pytest.raises(FileNotFoundError) as raised:
        loops.load("no_such_loop")
    assert str(loops.HERE / "no_such_loop.py") in str(raised.value)


@pytest.mark.parametrize("workload", CELLS)
def test_the_ring_is_make_ring_s(workload):
    seed = 2**31 + 21
    cell, loop = harness.build_cell(SPEC, workload, seed, torch.device("cpu"), SMALL)
    traffic = cell.traffic
    expected = data.make_ring(seed, 512, 16, traffic["data"], traffic["ring"], "cpu")
    assert all(torch.equal(loop.dump_on_device(slot), dump) for slot, dump in enumerate(expected))
    assert cell.n_vis == 512 * 16
    mask = resident.channel_mask(cell.config, traffic["channel_ranges_mhz"], "cpu")
    if mask is None:
        assert cell.channel_flags is None
    else:
        assert traffic["input_flags"] == "channel" and torch.equal(cell.channel_flags, mask)


@pytest.mark.parametrize("loop_class", [resident.Resident, stream.Stream])
def test_the_1d_loops_check_k1_s_launches_on_the_card(loop_class):
    loop = loop_class.__new__(loop_class)
    loop.cell = SimpleNamespace(device=torch.device("cuda", 0))
    gap = {"k1_launch_gap": {"value": 2, "limit": 0}}
    assert loop.checks({"k1_launches": 7, "dumps": 9}) == gap
    loop.cell = SimpleNamespace(device=torch.device("cpu"))
    assert loop.checks({"k1_launches": 0, "dumps": 9}) == {}
