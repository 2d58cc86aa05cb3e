"""The hybrid background pass's share of its roofline, in %: a dump's least time over its device time a dump.

The least time is the larger of 12 B a visibility at the HBM rate and the
amplitude and median operations at the float32 rate
(:mod:`flagbench.counts_hybrid`).  The device time is that of every
kernel in the traced stretch but K2 (``madnz_threshold``), copies and
fills (the profiler's ``Memcpy`` and ``Memset`` records) left out, over
the dumps flagged in it: the eager background, and the turn and store
copies beside it.  None where no such kernel was traced.
"""

import re

from flagbench import counts_hybrid

NOT_KERNELS = ("Memcpy", "Memset")
K2 = re.compile(r"\bmadnz_threshold")


def read(cell):
    dumps = cell.counters.get("dumps")
    if cell.trace is None or not dumps:
        return None
    seconds = sum(s for name, (_, s) in cell.trace.kernels.items()
                  if not name.startswith(NOT_KERNELS) and not K2.search(name))
    if seconds <= 0:
        return None
    fl = cell.flagger
    bound = counts_hybrid.background_bound_s(cell.n_vis, fl["width"], fl["n_windows"])
    return 100.0 * bound / (seconds / dumps)
