"""The share, in %, of the kernels' strided inputs that ``flag_dump`` copied whole.

From the program's counter ``fused_flagger.row_major`` over the run: of
the inputs not already row-major, those ``contiguous()`` copied
(``copied``) against those K5 corner-turned (``turned``).  A program
without the counter, or a run that gave the kernels no strided input,
gives None.
"""


def read(cell):
    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

    counts = getattr(fused_flagger, "row_major", None)
    if not counts or not counts["turned"] + counts["copied"]:
        return None
    return 100.0 * counts["copied"] / (counts["turned"] + counts["copied"])
