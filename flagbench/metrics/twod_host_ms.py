"""Milliseconds of the host inside the 2-D flagger's ``get_flags``: the mean of the program's ``ksp.twod.get_flags`` spans."""

from flagbench import spans


def read(cell):
    seconds = spans.mean_s("ksp.twod.get_flags")
    return None if seconds is None else seconds * 1e3
