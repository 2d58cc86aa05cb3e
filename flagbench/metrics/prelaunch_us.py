"""Microseconds from the start of each ``flag_dump`` to its first launch, the mean over calls.

From the program's spans: a ``ksp.flag_dump`` span's start to the earliest
start of a ``ksp.launch.*`` span inside it (its child, or a child's
child).  In the resident loop the card has nothing queued through that
time.  Calls that launched nothing are left out.
"""

from flagbench import spans


def read(cell):
    found = spans.recorded()
    if not found:
        return None
    by_id = {s.id: s for s in found}
    first = {}  # flag_dump span id: its first launch's start
    for s in found:
        if not s.name.startswith("ksp.launch."):
            continue
        outer = by_id.get(s.parent)
        while outer is not None and outer.name != "ksp.flag_dump":
            outer = by_id.get(outer.parent)
        if outer is not None:
            first[outer.id] = min(first.get(outer.id, s.start_ns), s.start_ns)
    if not first:
        return None
    return sum(t - by_id[i].start_ns for i, t in first.items()) / len(first) / 1e3
