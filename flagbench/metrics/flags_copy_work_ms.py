"""Milliseconds the copy of a stream dump's flags out of the pinned ring itself takes.

The mean of the program's ``ksp.stream.flags_copy.work`` spans, one a dump,
recorded in the executor's thread around its ``np.array`` copy; beside
``flags_copy_ms``, the event loop's wait for that copy.
"""

from flagbench import spans


def read(cell):
    seconds = spans.mean_s("ksp.stream.flags_copy.work")
    return None if seconds is None else seconds * 1e3
