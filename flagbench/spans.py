"""The program's own spans of a traced run, for the readers in ``metrics/`` that read them.

The program records them (``katsdpsigproc_tpu_torch.utils.profiling.spans()``:
name, ``start_ns``, ``end_ns`` on the host's ``perf_counter_ns`` clock, the
enclosing span's id as ``parent``) only while the run's one profiler
session records, so only the traced stretch's.  A program that records no
spans gives None here, and so does a run in which none was recorded, or
one whose list filled and dropped some (``profiling.dropped_spans()``):
a mean over what was kept would not be the stretch's.
"""

from typing import List, Optional


def recorded() -> Optional[List]:
    """The program's spans, or None where it recorded none, dropped some or has no ``spans()``."""
    from katsdpsigproc_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans") or profiling.dropped_spans():
        return None
    return profiling.spans() or None


def mean_s(name: str) -> Optional[float]:
    """The mean seconds of the spans named `name`, or None where there are none."""
    durations = [s.end_ns - s.start_ns for s in recorded() or () if s.name == name]
    return sum(durations) / len(durations) * 1e-9 if durations else None
