"""K5's share of its roofline, in %: 16 B a visibility at the HBM rate over its mean time a launch."""

from flagbench import counts


def read(cell):
    if cell.trace is None:
        return None
    k5 = cell.trace.kernel(r"\btranspose_kernel\b")
    if k5 is None:
        return None
    launches, seconds = k5
    return 100.0 * counts.k5_bound_s(cell.n_vis) / (seconds / launches)
