"""K2's share of its roofline, in %: its least time for one launch's rows over its mean time a launch.

A launch flags one slab, ``channels x baseline_block`` visibilities (the
configuration's ``flagger_fn``).  The least time is the larger of 5 B a
visibility at the HBM rate and the MAD noise and SumThreshold operations
at the float32 rate (:mod:`flagbench.counts_hybrid`).  Only the launches
of ``madnz_threshold_kernel`` (not the wide-row path's).  None where no
such launch was traced.
"""

from flagbench import counts_hybrid


def read(cell):
    if cell.trace is None:
        return None
    k2 = cell.trace.kernel(r"\bmadnz_threshold_kernel\b")
    if k2 is None:
        return None
    launches, seconds = k2
    config, fl = cell.config, cell.flagger
    rows = min(config["flagger_fn"].get("baseline_block") or config["rows"], config["rows"])
    bound = counts_hybrid.k2_bound_s(config["channels"] * rows, fl["width"], fl["n_windows"])
    return 100.0 * bound / (seconds / launches)
