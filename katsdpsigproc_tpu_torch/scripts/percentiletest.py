"""Percentile benchmark and parity check, 4000 x 5000 float32 by default.

Port of ``scripts/percentiletest.py``: the seed-1 amplitudes
``|N(0, 1)|`` through ``Percentile5Template`` (engine ``cuda``: the
kernel K4, ``csrc/percentile.cu::percentile5_radix_kernel``; ``rank`` or
``sort``; by default the tuning table's pick), held exactly to
``np.r_[min, max, np.percentile(..., [25, 75, 50], method="lower")]``
per row ("exact match vs np.percentile(..., 'lower')"), then timed with
CUDA events (``utils/profiling.time_fn``).

Run::

    python -m katsdpsigproc_tpu_torch.scripts.percentiletest [--device cpu] [options]

It runs on the card, and exits without one, unless given ``--device
cpu``, where the cuda engine takes K4's plain version.
"""

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import percentile
from ..utils import backend
from ..utils.profiling import time_fn
from . import common


def make_source(rows: int, cols: int) -> np.ndarray:
    """The JAX harness's seed-1 (rows, cols) float32 amplitudes."""
    rs = np.random.RandomState(seed=1)
    return np.abs(rs.standard_normal((rows, cols))).astype(np.float32)


def expected(src: np.ndarray) -> np.ndarray:
    """numpy's (5, rows) [min, max, p25, p75, p50], the lower element of each percentile."""
    return np.r_[
        [np.min(src, axis=1), np.max(src, axis=1)],
        np.percentile(src, [25, 75, 50], axis=1, method="lower"),
    ].astype(np.float32)


def make_op(device: torch.device, shape, engine=None) -> percentile.Percentile5:
    """``Percentile5Template`` on `device` at `shape`; `engine` None takes the tuned pick."""
    tuning = {"engine": engine} if engine else None
    template = percentile.Percentile5Template(backend.DeviceContext(device), shape[1], True,
                                              tuning=tuning)
    return template.instantiate(None, shape)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=4000)
    parser.add_argument("--cols", type=int, default=5000)
    parser.add_argument("--engine", choices=["rank", "sort", "cuda"], default=None,
                        help="force an engine (default: the tuned-table choice); cuda is the "
                             "JAX harness's pallas")
    parser.add_argument("--iters", type=int, default=5)
    common.add_device_option(parser)
    args = parser.parse_args(argv)
    device = common.harness_device(args.device)

    src = make_source(args.rows, args.cols)
    op = make_op(device, src.shape, args.engine)
    print(f"engine: {op.template.engine}", file=sys.stderr)
    v = torch.from_numpy(src).to(device)
    out = op(src=v)["dest"].cpu().numpy()

    start = time.perf_counter()
    want = expected(src)
    print(f"numpy: {(time.perf_counter() - start) * 1e3:.1f} ms", file=sys.stderr)
    bad = int((out.view(np.int32) != want.view(np.int32)).sum())
    if bad:
        print(f"Mismatches: {bad} / {want.size} against np.percentile(..., 'lower')",
              file=sys.stderr)
    else:
        print("exact match vs np.percentile(..., 'lower')", file=sys.stderr)

    ms = time_fn(lambda: op(src=v)["dest"], iters=args.iters)
    print(f"time on {device}: {ms:.3f} ms/iter ({common.clock_name(device)}, "
          f"median of {args.iters}), "
          f"{src.nbytes / ms / 1e6:.1f} GB/s read [{common.device_line(device)}]",
          file=sys.stderr)
    sys.exit(0 if bad == 0 else 1)


if __name__ == "__main__":
    main()
