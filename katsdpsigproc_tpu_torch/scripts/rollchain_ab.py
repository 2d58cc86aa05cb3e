"""The median's members built another way than by shared-memory loads, interleaved.

Port of ``scripts/rollchain_ab.py``.  K1's median (``csrc/ff_runs.cuh``)
builds each channel's 13 members with 13 loads of the unpadded amplitudes
at offsets -6..6.  On the TPU the question was whether lane rolls by 1,
chained, are cheaper than rolls by distance; on the card it is whether
anything is cheaper than those loads.  Every run is K1 on its run layout
and at its launch (``csrc/flagger_probe.cu``), with only the members'
source changed:

  full           K11's ``full``, K1's own median: 13 loads a channel (the
                 TPU probe's "direct");
  shfl_median    one load a lane (two at a warp's edge), the other members
                 by ``__shfl_sync`` rotations;
  window_median  a thread's 4 consecutive channels from one load of their
                 16 members as five 16-byte words, 1.25 loads a channel;
                 member d of channel c + 1 is member d + 1 of channel c (the
                 TPU probe's "chained").

Bit-exact (same values, same network), checked here before timing.  Each
variant less ``full`` is printed against both spreads (max - min).

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.rollchain_ab [--channels 32768] [--baselines 8064]
"""

from ..models.rfi import flagger_probe as fp
from . import common, rankpair_ab

RUNS = ("full",) + fp.MEDIANS


def run(vis_t, *, iters: int = 3, reps: int = 5, card: str = ""):
    """Check parity, then time the runs interleaved (``rankpair_ab.run``); print
    each variant less ``full`` and return the median ms of each."""
    med, samples = rankpair_ab.run(vis_t, iters=iters, reps=reps, card=card,
                                   runs={v: v for v in RUNS})
    spread = {v: max(samples[v]) - min(samples[v]) for v in RUNS}
    for v in fp.MEDIANS:
        gap = med[v] - med["full"]
        print(f"{v} - full = {gap:+.3f} ms against spreads full {spread['full']:.3f}, {v} "
              f"{spread[v]:.3f} ms: {common.verdict(gap, spread['full'], spread[v])} [{card}]")
    return med


def main(argv=None) -> None:
    args = common.parser(__doc__).parse_args(argv)
    card = common.require_card()
    vis_t = common.dump_on_card(args.channels, args.baselines).transpose(0, 1).contiguous()
    run(vis_t, iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
