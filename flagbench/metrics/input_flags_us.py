"""Microseconds of the host preparing a dump's input flags: the mean ``ksp.flag_dump.input_flags`` span.

The span holds the FULL flags' checks and their turn to row-major (K5's
launch).  A program without the span gives None.
"""

from flagbench import spans


def read(cell):
    seconds = spans.mean_s("ksp.flag_dump.input_flags")
    return None if seconds is None else seconds * 1e6
