"""The device's idle share of the traced stretch, in %: 1 - union of kernels and copies / stretch."""


def read(cell):
    if cell.trace is None or cell.trace.window_s <= 0 or cell.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - cell.trace.busy_s / cell.trace.window_s)
