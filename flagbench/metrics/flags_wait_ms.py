"""Milliseconds a dump of the stream waits for its flags to reach host memory.

The mean of the program's ``ksp.stream.flags_wait`` spans, one a dump: from
its upload, flagger and download queued to the download's event done.
"""

from flagbench import spans


def read(cell):
    seconds = spans.mean_s("ksp.stream.flags_wait")
    return None if seconds is None else seconds * 1e3
