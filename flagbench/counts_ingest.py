"""The least work of the kernels that per-sample input flags add to a dump (FULL mode).

With the peaks and the operation count of :mod:`flagbench.counts`:

* K1 in FULL mode reads each (re, im) float32 pair and its flag byte once
  and writes one flag byte: 10 B a visibility.  Its operations are at
  least the no-input-flags count, :func:`counts.k1_ops_per_vis`.
* K5's 1-byte instance turns the channel-major flags: it reads and
  writes each flag byte once, 2 B a visibility.
"""

from . import counts

K1_FULL_BYTES_PER_VIS = 8 + 1 + 1
K5_FLAGS_BYTES_PER_VIS = 1 + 1


def k1_full_bound_s(n_vis: int, width: int, n_windows: int) -> float:
    """K1's least time in FULL mode for `n_vis` visibilities: bytes or operations, the larger."""
    return max(K1_FULL_BYTES_PER_VIS * n_vis / counts.HBM_BYTES_PER_S,
               counts.k1_ops_per_vis(width, n_windows) * n_vis / counts.F32_OPS_PER_S)


def k5_flags_bound_s(n_vis: int) -> float:
    """K5's least time turning `n_vis` flag bytes."""
    return K5_FLAGS_BYTES_PER_VIS * n_vis / counts.HBM_BYTES_PER_S
