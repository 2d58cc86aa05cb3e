"""The median's members by warp shuffles against shared-memory loads, interleaved.

Port of ``scripts/rollchain_ab.py``, on the strided layout
(``csrc/ff_device.cuh``), where K1's earlier design ``strided_full``
builds each channel's 13 median members with 12 shared-memory loads at
offsets -6..6.  ``shfl`` takes the members inside a warp from
``__shfl_sync`` (one rotation per offset) and loads from shared memory
only the two values 32 channels away that the warp's edge lanes need.
On the TPU the question was the cost of lane rolls by distance; on the
card it is shuffles against shared-memory loads.  Bit-exact either way
(same values, same network), checked here before timing.

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.rollchain_ab [--channels 32768] [--baselines 8064]
"""

from . import common, rankpair_ab

RUNS = {"direct": "strided_full", "shfl": "shfl_median"}


def run(vis_t, *, iters: int = 3, reps: int = 5, card: str = ""):
    """Check parity, then time both interleaved; print and return ms."""
    return rankpair_ab.run(vis_t, iters=iters, reps=reps, card=card, runs=RUNS)


def main(argv=None) -> None:
    args = common.parser(__doc__).parse_args(argv)
    card = common.require_card()
    vis_t = common.dump_on_card(args.channels, args.baselines).transpose(0, 1).contiguous()
    run(vis_t, iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
