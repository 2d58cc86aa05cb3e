"""The least work of the separate-pass flagger's two passes, at the peaks of :mod:`flagbench.counts`.

The operations are the stages of :func:`counts.k1_op_inventory` that each
pass computes:

* K2, MAD noise and SumThreshold on the deviations: it reads each float32
  deviation once and writes one flag byte, 5 B a visibility; its
  operations are the inventory's ``rank``, ``threshold`` and ``output``
  (65 a visibility at 4 windows).
* The background pass: it reads each (re, im) float32 pair once and
  writes one float32 deviation, 12 B a visibility; its operations are the
  inventory's ``amplitude`` and ``median`` (79 a visibility at width 13).
"""

from . import counts

K2_BYTES_PER_VIS = 4 + 1
BACKGROUND_BYTES_PER_VIS = 8 + 4
K2_STAGES = ("rank", "threshold", "output")
BACKGROUND_STAGES = ("amplitude", "median")


def stage_ops_per_vis(stages, width: int, n_windows: int) -> int:
    """Operations per visibility of the inventory's `stages`."""
    return sum(n for stage, n in counts.k1_op_inventory(width, n_windows) if stage in stages)


def _bound_s(n_vis: int, bytes_per_vis: int, ops_per_vis: int) -> float:
    return max(bytes_per_vis * n_vis / counts.HBM_BYTES_PER_S,
               ops_per_vis * n_vis / counts.F32_OPS_PER_S)


def k2_bound_s(n_vis: int, width: int, n_windows: int) -> float:
    """K2's least time for `n_vis` visibilities: bytes or operations, the larger."""
    return _bound_s(n_vis, K2_BYTES_PER_VIS, stage_ops_per_vis(K2_STAGES, width, n_windows))


def background_bound_s(n_vis: int, width: int, n_windows: int) -> float:
    """The background pass's least time for `n_vis` visibilities: bytes or operations, the larger."""
    return _bound_s(n_vis, BACKGROUND_BYTES_PER_VIS,
                    stage_ops_per_vis(BACKGROUND_STAGES, width, n_windows))
