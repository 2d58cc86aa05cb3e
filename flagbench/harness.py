"""One run of one cell: set-up, the measured window, the check, the result line.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that entry names, its
traffic mix in ``traffic/<mix>.json``, the loop the mix names in
``loops/<loop>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The loop owns what belongs to the shape it
drives (set-up, inputs, visibilities a dump, reference flags, its own
checks); this module names no flagger, kernel or reference.  See
``README.md``.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import loops, traces

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "katsdpsigproc_tpu_torch"
# Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "katsdpsigproc_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r}")


def load_config(spec: dict, name: str, root: Path = ROOT) -> dict:
    with open(root / _by_name(spec["configs"], name, "configuration")["file"]) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def quantity(name: str) -> str:
    """What a metric measures: its name up to the first dot.

    A quantity whose cells report different end-to-end metrics is split
    into metrics of one quantity (``idle_share``, ``idle_share.ingest``).
    """
    return name.split(".")[0]


def load_reader(name: str):
    """The ``read(cell)`` function of ``metrics/<quantity>.py``."""
    base = quantity(name)
    path = HERE / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(f"flagbench.metrics.{base}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer_metrics(spec: dict, workload: str) -> list:
    """The per-layer metrics a traced run of `workload` reports.

    A metric with a ``workloads`` list is read in those cells; one without
    in every cell that reports the end-to-end metric it moves.
    """
    reported = {m["name"] for m in spec["end_to_end"]
                if workload in m.get("workloads", [workload])}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload]) and m["moves"] in reported]


def end_to_end_metrics(spec: dict, workload: str) -> list:
    return [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]


def build_cell(spec: dict, workload: str, seed: int, device, overrides=None):
    """The cell and its loop: the configuration, the mix and the inputs made from the seed."""
    entry = _by_name(spec["workloads"], workload, "workload")
    config = dict(load_config(spec, entry["config"]), **(overrides or {}))
    traffic = load_traffic(entry["traffic"])
    loop_class = loops.load(traffic["loop"])
    cell = SimpleNamespace(config=config, traffic=traffic, device=device,
                           n_vis=loop_class.n_vis(config), counters={}, trace=None)
    loop_class.inputs(cell, seed)
    return cell, loop_class(cell)


def check(loop, sample: loops.Sample, counters: dict) -> dict:
    """Each number compared, with its limit; the reference is computed per ring slot."""
    refs = {}
    mismatches, failed = 0, 0
    for dump, slot, flags in sorted(sample.items, key=lambda item: item[0]):
        if slot not in refs:
            refs[slot] = loop.reference_flags(slot)
        bad = int((loop.flags_on_device(flags) != refs[slot]).sum())
        mismatches += bad
        failed += bad > 0
    checks = {
        "flag_mismatches": {"value": mismatches, "limit": 0},
        "dumps_missing": {"value": counters["missing"], "limit": 0},
    }
    checks.update(loop.checks(counters))
    return checks, failed


def _describe(counters: dict, setup_s: float) -> None:
    """The window's shape on standard error: what the metrics summarise."""
    lat = np.array(counters["latency_s"]) * 1e3
    line = (f"flagbench: set-up {setup_s:.3f} s; window {counters['window_s']:.3f} s, "
            f"{counters['dumps']} dumps; latency ms median {np.median(lat):.3f}, p95 "
            f"{np.percentile(lat, 95):.3f}, max {lat.max():.3f}")
    if counters.get("upload_s"):
        line += f"; upload {counters['upload_bytes'] / counters['upload_s'] / 1e9:.3f} GB/s"
    if "call_s" in counters:
        line += f"; stream calls s {[round(c, 3) for c in counters['call_s']]}"
    print(line, file=sys.stderr)


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             started: float, overrides=None, marks=None) -> dict:
    """One run of `workload`; returns the result line's object.

    `started` is when set-up began; `marks` lists (stage, seconds since
    then) of the set-up done before this call.
    """
    marks = list(marks or [])
    cell, loop = build_cell(spec, workload, seed, device, overrides)
    loops.sync(device)
    marks.append(("inputs made", time.perf_counter() - started))
    loop.warm()
    loops.sync(device)
    setup_s = time.perf_counter() - started
    print("flagbench: set-up at " + ", ".join(f"{name} {t:.3f} s" for name, t in marks),
          file=sys.stderr)
    tracer = traces.Tracer(trace, device)
    sample = loops.Sample(cell.traffic["sample"], seed)
    window = cell.traffic["trace_seconds"] if trace else seconds
    counters = loop.window(window, tracer, sample)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    _describe(counters, setup_s)
    cell.counters = counters
    if tracer.prof is not None:
        cell.trace = traces.summarize(tracer.prof)
        tracer.prof = None
    checks, failed = check(loop, sample, counters)
    failed += counters["missing"]
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and counters["dumps"] > 0 and bool(sample.items))
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": counters["dumps"], "failed": failed}
    if trace:
        metrics = {}
        for m in per_layer_metrics(spec, workload):
            value = load_reader(m["name"])(cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if cell.trace is not None:
            device_info["busy_s"] = cell.trace.busy_s
            device_info["window_s"] = cell.trace.window_s
        result["metrics"] = metrics
        result["device"] = device_info
        if cell.trace is not None:
            result["breakdown"] = cell.trace.breakdown()
    else:
        n_vis = (counters["dumps"] - counters["missing"]) * cell.n_vis  # flagged, not asked
        values = {"gvis_per_s": n_vis / counters["window_s"] / 1e9,
                  "dump_ms_p95": float(np.percentile(counters["latency_s"], 95)) * 1e3,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[quantity(m["name"])], "unit": m["unit"]}
                             for m in end_to_end_metrics(spec, workload)}
        result["device"] = device_info
    result["checks"] = checks
    return result


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"
    return out[0] if out else "nvidia-smi gave nothing"


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, started: float) -> int:
    args = parse_args(argv)
    spec = load_spec()
    entry = _by_name(spec["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"flagbench: {args.workload} needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    marks = [("torch imported", time.perf_counter() - started)]
    import katsdpsigproc_tpu_torch

    program = Path(katsdpsigproc_tpu_torch.__file__).resolve()
    if ROOT not in program.parents:
        print(f"flagbench: {PROGRAM} was loaded from {program}, outside this checkout",
              file=sys.stderr)
        return 2
    marks.append(("program imported", time.perf_counter() - started))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    marks.append(("card ready", time.perf_counter() - started))
    loop_class = loops.load(load_traffic(entry["traffic"])["loop"])
    prepared = loop_class.prepare(load_config(spec, entry["config"]))
    if prepared is not None:
        marks.append((prepared[0], time.perf_counter() - started))
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                      started, marks=marks)
    print(f"flagbench: {args.workload} seed {args.seed} on {_card_line()}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}"
          + (f"; {prepared[1]}" if prepared is not None else ""), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"flagbench: the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    print(f"flagbench: {result['attempted']} dumps, {result['failed']} failed; "
          f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
