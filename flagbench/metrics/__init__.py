"""One reader per per-layer metric, ``<metric>.py`` with ``read(cell)``.

``read`` returns the metric's value from the traced run's summary
(``cell.trace``, a :class:`flagbench.traces.Summary`) or the loop's
counters (``cell.counters``), or None where it finds nothing to read.
"""
