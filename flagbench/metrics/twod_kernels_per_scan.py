"""Kernels the device ran in the traced stretch over the scans flagged in it: the 2-D path's launch load.

Copies and fills (the profiler's ``Memcpy`` and ``Memset`` records) are
not kernels and are left out.
"""

NOT_KERNELS = ("Memcpy", "Memset")


def read(cell):
    scans = cell.counters.get("dumps")
    if cell.trace is None or not scans:
        return None
    launched = sum(n for name, (n, _) in cell.trace.kernels.items()
                   if not name.startswith(NOT_KERNELS))
    return launched / scans if launched else None
