"""Milliseconds of the host inside the hybrid flagger's call: the mean of the program's ``ksp.hybrid`` spans.

A program without the span gives None.
"""

from flagbench import spans


def read(cell):
    seconds = spans.mean_s("ksp.hybrid")
    return None if seconds is None else seconds * 1e3
