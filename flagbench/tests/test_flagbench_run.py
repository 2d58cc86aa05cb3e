"""A run without a card, and the rest of a run on the CPU, sound and with the timed path broken.

On the CPU each kernel wrapper takes its plain version; the harness's look
for a card is skipped by calling :func:`flagbench.harness.run_cell`
directly at a small size.  A fault put in the program's place must come
out as ``correct`` false, in each loop.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from flagbench import harness
from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

SPEC = harness.load_spec()
SMALL = {"channels": 512, "rows": 16}
CELLS = [c["name"] for c in SPEC["workloads"]]
CPU = torch.device("cpu")


def run(workload, trace=False, seed=2**31 + 3):
    return harness.run_cell(SPEC, workload, seed, 0.2, trace, CPU, 0.0, SMALL)


def run_script(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "flagbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_exits_non_zero_with_no_result():
    proc = run_script(harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_files_alone_exit_non_zero(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "flagbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_script(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    result = run(workload, trace)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result) == (["correct", "attempted", "failed", "metrics", "device"]
                            + (["breakdown"] if trace else []) + ["checks"])
    assert list(result["checks"]) == ["flag_mismatches", "dumps_missing"]  # k1_launch_gap: card
    assert result["checks"]["flag_mismatches"] == {"value": 0, "limit": 0}
    if not trace:
        names = {m["name"] for m in harness.end_to_end_metrics(SPEC, workload)}
        assert set(result["metrics"]) == names
        assert all(m["value"] > 0 for m in result["metrics"].values())


def zeros(vis_t, *args, **kw):
    """A step that returns its state unchanged: the flags never written."""
    return torch.zeros(vis_t.shape[:2], dtype=torch.uint8)


def stale():
    """Every call returns the first call's flags: the state never moves on."""
    first = []
    real = fused_flagger.flag_dump

    def flag_dump(vis_t, *args, **kw):
        if not first:
            first.append(real(vis_t, *args, **kw))
        return first[0].clone()
    return flag_dump


def half_rows(vis_t, *args, **kw):
    """Half of the batch left out: the second half of the rows never flagged."""
    flags = REAL(vis_t, *args, **kw)
    flags[flags.shape[0] // 2:] = 0
    return flags


def one_flag(vis_t, *args, **kw):
    """An answer altered where it is produced: one flag flipped."""
    flags = REAL(vis_t, *args, **kw)
    flags[0, 0] ^= 1
    return flags


REAL = fused_flagger.flag_dump
FAULTS = {"unchanged": lambda: zeros, "stale": stale, "half_rows": lambda: half_rows,
          "one_flag": lambda: one_flag}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, workload, fault):
    monkeypatch.setattr(fused_flagger, "flag_dump", FAULTS[fault]())
    result = run(workload)
    assert result["correct"] is False
    assert result["checks"]["flag_mismatches"]["value"] > 0
    assert result["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_card_run_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = harness.run_cell(SPEC, workload, 5, 0.5, False, torch.device("cuda", 0), 0.0,
                              {"channels": 4096, "rows": 512})
    assert result["correct"] is True
    assert result["checks"]["k1_launch_gap"]["value"] == 0
