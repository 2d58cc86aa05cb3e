"""Run one cell of the benchmark of the PyTorch and CUDA port; see README.md.

    python3 flagbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output, and the numbers compared
with their limits last on standard error.  Exits non-zero, with no result,
without a CUDA device.
"""

import time

STARTED = time.perf_counter()  # set-up runs from here to the first timed dump

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    # Triton's cache at a fixed place inside the checkout, so that only a
    # checkout's first run compiles; the CUDA libraries are cached in
    # build/katsdpsigproc_tpu_torch/ by the program itself.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "flagbench", "triton")
    # Run as a script, the interpreter puts this directory first on the path,
    # where its modules would shadow others of the same name: the checkout
    # takes its place.
    sys.path[0] = ROOT
    from flagbench import harness

    return harness.main(sys.argv[1:], STARTED)


if __name__ == "__main__":
    sys.exit(main())
