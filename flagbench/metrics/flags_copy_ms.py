"""Milliseconds a dump of the stream spends copying its flags out of the pinned ring.

The mean of the program's ``ksp.stream.flags_copy`` spans, one a dump: the
event loop's wait for the executor's ``np.array`` copy of the flags.
"""

from flagbench import spans


def read(cell):
    seconds = spans.mean_s("ksp.stream.flags_copy")
    return None if seconds is None else seconds * 1e3
