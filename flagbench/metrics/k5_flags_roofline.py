"""K5's share of its roofline turning a dump's flags, in %: 2 B a visibility at the HBM rate over its mean time a launch.

Only the launches of the 1-byte instance, ``transpose_kernel<unsigned
char>``.  None where no such launch was traced.
"""

from flagbench import counts_ingest


def read(cell):
    if cell.trace is None:
        return None
    k5 = cell.trace.kernel(r"\btranspose_kernel<(unsigned char|uint8_t)>")
    if k5 is None:
        return None
    launches, seconds = k5
    return 100.0 * counts_ingest.k5_flags_bound_s(cell.n_vis) / (seconds / launches)
