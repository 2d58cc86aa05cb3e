"""Microseconds of the host inside ``flag_dump``: the mean of the program's ``ksp.flag_dump`` spans.

The inside counterpart of ``dispatch_us``, which times the same calls from
the harness.
"""

from flagbench import spans


def read(cell):
    seconds = spans.mean_s("ksp.flag_dump")
    return None if seconds is None else seconds * 1e6
