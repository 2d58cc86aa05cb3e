"""K1's share of its roofline in FULL mode, in %: its least time over its mean time a launch.

Only the launches of ``flagger_kernel<1, ...>`` (per-sample input flags).
The least time is the larger of 10 B a visibility at the HBM rate and the
no-input-flags operation count at the float32 rate
(:mod:`flagbench.counts_ingest`).  None where no such launch was traced.
"""

from flagbench import counts_ingest


def read(cell):
    if cell.trace is None:
        return None
    k1 = cell.trace.kernel(r"\bflagger_kernel<1,")
    if k1 is None:
        return None
    launches, seconds = k1
    fl = cell.flagger
    bound = counts_ingest.k1_full_bound_s(cell.n_vis, fl["width"], fl["n_windows"])
    return 100.0 * bound / (seconds / launches)
