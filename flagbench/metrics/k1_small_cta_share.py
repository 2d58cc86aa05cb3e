"""The share, in %, of the run's K1 launches whose CTA had fewer than 1024 threads.

From the program's counter ``fused_flagger.k1_ctas`` over the run: K1's
launches by the threads of their CTAs, which the program picks from the
row's length.  A program without the counter, or a run that launched no
K1, gives None.
"""


def read(cell):
    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

    counts = getattr(fused_flagger, "k1_ctas", None)
    if not counts or not sum(counts.values()):
        return None
    return 100.0 * sum(n for threads, n in counts.items() if threads < 1024) / sum(counts.values())
