"""Kernels the device ran in the traced stretch over the dumps flagged in it: the hybrid path's launch load.

Copies and fills (the profiler's ``Memcpy`` and ``Memset`` records) are
not kernels and are left out.
"""

NOT_KERNELS = ("Memcpy", "Memset")


def read(cell):
    dumps = cell.counters.get("dumps")
    if cell.trace is None or not dumps:
        return None
    launched = sum(n for name, (n, _) in cell.trace.kernels.items()
                   if not name.startswith(NOT_KERNELS))
    return launched / dumps if launched else None
