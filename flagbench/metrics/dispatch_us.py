"""Microseconds of the host from the call of ``flag_dump`` to its return, the window's mean."""


def read(cell):
    dispatch = cell.counters.get("dispatch_s")
    if not dispatch:
        return None
    return sum(dispatch) / len(dispatch) * 1e6
