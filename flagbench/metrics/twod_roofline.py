"""The 2-D flagger's share of its roofline, in %: a scan's least time over the device's busy time a scan.

The least time is a scan's least bytes, 10 a visibility, at the HBM rate
(:mod:`flagbench.counts_twod`); the busy time is the union of the device's
work over the traced stretch (:class:`flagbench.traces.Summary`'s
``busy_s``) over the scans flagged in it.
"""

from flagbench import counts_twod


def read(cell):
    scans = cell.counters.get("dumps")
    if cell.trace is None or cell.trace.busy_s <= 0 or not scans:
        return None
    return 100.0 * counts_twod.twod_bound_s(cell.n_vis) / (cell.trace.busy_s / scans)
