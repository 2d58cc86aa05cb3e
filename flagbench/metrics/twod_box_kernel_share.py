"""The share, in %, of the run's masked Gaussian filters that took the box-filter kernels.

From the program's counter ``twodflag.box_filters``: the calls of
``masked_gaussian_filter`` by route, "kernel" for a tensor on the card
(``csrc/box_filter.cu``) and "plain" for one on the CPU.  A program
without the counter, or a run that filtered nothing, gives None.
"""


def read(cell):
    from katsdpsigproc_tpu_torch.models.rfi import twodflag

    counts = getattr(twodflag, "box_filters", None)
    if not counts or not sum(counts.values()):
        return None
    return 100.0 * counts.get("kernel", 0) / sum(counts.values())
