"""The 2-D flagger's least bytes a visibility, at the card's peak of :mod:`flagbench.counts`.

A scan's least traffic is its complex64 visibilities read once (8 B), its
input flags read once (1 B) and its flags written once (1 B): 10 B a
visibility, whatever the flagger keeps on the card in between.  Fixed by
the algorithm's inputs and output, so no change to the program moves it.
"""

from .counts import HBM_BYTES_PER_S

TWOD_BYTES_PER_VIS = 8 + 1 + 1


def twod_bound_s(n_vis: int) -> float:
    """The least time the card could take to flag `n_vis` visibilities: bytes at the HBM rate."""
    return TWOD_BYTES_PER_VIS * n_vis / HBM_BYTES_PER_S
