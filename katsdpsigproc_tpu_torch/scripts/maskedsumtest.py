"""Masked-sum benchmark and parity check, 4000 x 5000 complex64 by default.

Port of ``scripts/maskedsumtest.py``: the seed-1 complex64 source, planar
(rows, cols, 2) float32 on the device, and a uniform float32 mask per
row, through ``ops/maskedsum.maskedsum`` (a ``torch.matmul``, cuBLAS on
the card in full float32, as the JAX op leaves it to XLA: no kernel of
the port's own), with ``MaskedSumTemplate`` built as the JAX harness
builds it; ``--amplitudes`` sums the amplitudes (``maskedsumabstest``).
The output is held to numpy at rtol 1e-4, atol 1e-3
("Mismatches: 0 / N"), then timed with CUDA events
(``utils/profiling.time_fn``).

Run::

    python -m katsdpsigproc_tpu_torch.scripts.maskedsumtest [--amplitudes] [--device cpu] [options]

It runs on the card, and exits without one, unless given ``--device cpu``.
"""

import argparse
import sys
import time

import numpy as np
import torch

from ..models.rfi.device import to_planar
from ..ops import maskedsum
from ..utils import backend
from ..utils.profiling import time_fn
from . import common

#: The JAX harness's tolerance against numpy.
RTOL, ATOL = 1e-4, 1e-3


def make_source(rows: int, cols: int):
    """The JAX harness's seed-1 (rows, cols) complex64 source and (rows,) float32 mask."""
    rs = np.random.RandomState(seed=1)
    src = (rs.standard_normal((rows, cols))
           + 1j * rs.standard_normal((rows, cols))).astype(np.complex64)
    mask = rs.uniform(size=(rows,)).astype(np.float32)
    return src, mask


def expected(src: np.ndarray, mask: np.ndarray, amplitudes: bool) -> np.ndarray:
    """numpy's masked column sums: (cols,) float32 amplitudes, or planar (cols, 2)."""
    if amplitudes:
        return (mask[:, None] * np.abs(src)).sum(axis=0)
    return to_planar((mask[:, None] * src).sum(axis=0))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=4000)
    parser.add_argument("--cols", type=int, default=5000)
    parser.add_argument("--amplitudes", action="store_true")
    parser.add_argument("--iters", type=int, default=10)
    common.add_device_option(parser)
    args = parser.parse_args(argv)
    device = common.harness_device(args.device)

    src, mask = make_source(args.rows, args.cols)
    template = maskedsum.MaskedSumTemplate(backend.DeviceContext(device), args.amplitudes)
    v = torch.from_numpy(to_planar(src)).to(device)
    m = torch.from_numpy(mask).to(device)
    out = maskedsum.maskedsum(v, m, template.use_amplitudes).cpu().numpy()

    start = time.perf_counter()
    want = expected(src, mask, args.amplitudes)
    print(f"numpy: {(time.perf_counter() - start) * 1e3:.1f} ms", file=sys.stderr)
    bad = int((~np.isclose(out, want, rtol=RTOL, atol=ATOL)).sum())
    err = float(np.abs(out - want).max())
    print(f"Mismatches: {bad} / {want.size} (rtol {RTOL:g}, atol {ATOL:g}; "
          f"max |err| {err:.3g})", file=sys.stderr)

    ms = time_fn(lambda: maskedsum.maskedsum(v, m, template.use_amplitudes), iters=args.iters)
    print(f"time on {device}: {ms:.3f} ms/iter ({common.clock_name(device)}, "
          f"median of {args.iters}), "
          f"{(v.nbytes + m.nbytes) / ms / 1e6:.1f} GB/s read [{common.device_line(device)}]",
          file=sys.stderr)
    sys.exit(0 if bad == 0 else 1)


if __name__ == "__main__":
    main()
