"""Transpose benchmark and parity check, 3072 x 8320 complex64 by default.

Port of ``scripts/transposetest.py``: the seed-1 complex64 source, planar
(rows, cols, 2) float32 on the device, turned by ``TransposeTemplate``
(engine ``cuda``: the kernel K5 of ``csrc/transpose.cu``; ``torch``: a
``transpose(0, 1).contiguous()`` copy; by default the tuning table's
pick).  The whole output is held to numpy's ``.T``, bit for bit
("Mismatches: 0 / N", N complex elements), where the JAX harness checks
an 8 x 8 corner; then the call is timed with CUDA events
(``utils/profiling.time_fn``) and its GB/s printed, reading and writing
the source's bytes once each.

Run::

    python -m katsdpsigproc_tpu_torch.scripts.transposetest [--device cpu] [options]

It runs on the card, and exits without one, unless given ``--device
cpu``, where the cuda engine takes K5's plain version.
"""

import argparse
import sys

import numpy as np
import torch

from ..models.rfi.device import to_planar
from ..ops import transpose
from ..utils import backend
from ..utils.profiling import time_fn
from . import common


def make_source(rows: int, cols: int) -> np.ndarray:
    """The JAX harness's seed-1 (rows, cols) complex64 source."""
    rs = np.random.RandomState(seed=1)
    return (rs.standard_normal((rows, cols))
            + 1j * rs.standard_normal((rows, cols))).astype(np.complex64)


def make_template(device: torch.device, engine=None) -> transpose.TransposeTemplate:
    """``TransposeTemplate`` for complex64 on `device`; `engine` None takes the tuned pick."""
    tuning = {"engine": engine} if engine else None
    return transpose.TransposeTemplate(backend.DeviceContext(device), np.complex64,
                                       tuning=tuning)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=3072)
    parser.add_argument("--cols", type=int, default=8320)
    parser.add_argument("--engine", choices=["torch", "cuda"], default=None,
                        help="force an engine (default: the tuned-table choice); cuda is the "
                             "JAX harness's pallas, torch its xla")
    parser.add_argument("--iters", type=int, default=10)
    common.add_device_option(parser)
    args = parser.parse_args(argv)
    device = common.harness_device(args.device)

    template = make_template(device, args.engine)
    print(f"engine: {template.engine}", file=sys.stderr)
    src = make_source(args.rows, args.cols)
    v = torch.from_numpy(to_planar(src)).to(device)
    out = transpose.transpose(v, template).cpu().numpy()
    want = to_planar(src.T)
    bad = int((out.view(np.int32) != want.view(np.int32)).any(axis=-1).sum())
    print(f"Mismatches: {bad} / {src.size}", file=sys.stderr)

    ms = time_fn(lambda: transpose.transpose(v, template), iters=args.iters)
    print(f"time on {device}: {ms:.3f} ms/iter ({common.clock_name(device)}, "
          f"median of {args.iters}), "
          f"{2 * src.nbytes / ms / 1e6:.1f} GB/s effective [{common.device_line(device)}]",
          file=sys.stderr)
    sys.exit(0 if bad == 0 else 1)


if __name__ == "__main__":
    main()
