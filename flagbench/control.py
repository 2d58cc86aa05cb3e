"""The readings the limits of ``correct`` are set from: the program's and the control's.

For each seed this builds the cell as a run does, drives a short window of
its own loop, and reads the number a run compares (flag mismatches
against the float32 reference over the run's sample of dumps) twice:

* ``program``: the program's flags, as a run reads them (the lower reading);
* ``control``: the reference computed in bfloat16 put in the program's
  place, the nearest precision below the float32 that the configurations
  state (the upper reading).

Needs a CUDA device, as the benchmark does.  The benchmark's own runs never
run this::

    python3 flagbench/control.py --workload l32k-resident --seeds 11 12 13 --seconds 2
"""

import argparse
import json
import os
import sys
import time

import torch

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from flagbench import harness, loops, reference, traces  # noqa: E402


def readings(spec: dict, workload: str, seed: int, seconds: float, device,
             overrides=None) -> dict:
    """The program's and the control's flag mismatches on `seed`, and the reference's time."""
    cell = harness.build_cell(spec, workload, seed, device, overrides)
    loop = loops.LOOPS[cell.traffic["loop"]](cell)
    loop.warm()
    sample = loops.Sample(cell.traffic["sample"], seed)
    counters = loop.window(seconds, traces.Tracer(False, device), sample)
    t0 = time.perf_counter()
    checks, _ = harness.check(cell, loop, sample, counters)
    loops.sync(device)
    check_s = time.perf_counter() - t0
    control = 0
    slots = {slot for _, slot, _ in sample.items}
    for slot in slots:
        vis = loop.dump_on_device(slot)
        exact = reference.flag_dump(vis, cell.flagger, cell.channel_flags)
        low = reference.flag_dump(vis, cell.flagger, cell.channel_flags, dtype=torch.bfloat16)
        per_dump = int((exact != low).sum())
        control += per_dump * sum(1 for _, s, _ in sample.items if s == slot)
    return {"workload": workload, "seed": seed, "dumps": counters["dumps"],
            "compared": len(sample.items), "program": checks["flag_mismatches"]["value"],
            "control": control, "check_s": check_s,
            "flagged_share": float(exact.float().mean()) if slots else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in args.seeds:
        print(json.dumps(readings(spec, args.workload, seed, args.seconds,
                                  torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
