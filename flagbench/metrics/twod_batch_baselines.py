"""The mean baselines of a batch of the 2-D flagger over the window.

From the program's counter ``twodflag.batches`` (the calls, batches and
baselines of ``SumThresholdFlagger.get_flags``), which the loop reads at
the window's start and end (its ``twod_batches`` counter).  A program
without the counter, or a window that flagged no batch, gives None.
"""


def read(cell):
    counted = cell.counters.get("twod_batches")
    if not counted or not counted["batches"]:
        return None
    return counted["baselines"] / counted["batches"]
