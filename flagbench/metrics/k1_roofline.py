"""K1's share of its roofline, in %: its least time over its mean time a launch.

The least time is the larger of its bytes over the HBM rate and the exact
flagger's least operations over the float32 instruction rate
(:mod:`flagbench.counts`); the no-input-flags count, so a lower bound
where a channel mask is given.  K1's time is its mean on the device over
the traced stretch's launches, from the profiler.
"""

from flagbench import counts


def read(cell):
    if cell.trace is None:
        return None
    k1 = cell.trace.kernel(r"\bflagger_kernel\b")
    if k1 is None:
        return None
    launches, seconds = k1
    fl = cell.flagger
    bound = counts.k1_bound_s(cell.n_vis, fl["width"], fl["n_windows"])
    return 100.0 * bound / (seconds / launches)
