"""Other rank searches against K1's binary search, interleaved on the card.

Port of ``scripts/rankpair_ab.py``.  K1's rank search is 31 dependent
rounds, each a count over the thread's 32 |dev| registers and a
block-wide reduction behind a barrier.  Every variant is K1 on its run
layout and at its launch with another search (``csrc/flagger_probe.cu``):
``rank_pair`` resolves two bits per round from three independent counts
(cur|hi, cur|lo, cur|hi|lo) in one pass and one reduction: 16 dependent
rounds instead of 31, at three compares per element instead of one.
``zeros_fold`` counts bit 30's candidate in the zeros pass: 31 passes
instead of 32.  ``radix_select`` is K4's radix select: four passes of
8 + 8 + 8 + 7 bits, each a shared histogram of the keys still under the
prefix behind one barrier.  The TPU probe's
``pair_i32`` and ``pair_f32`` pack two of the counts into one reduce; on
the card one block reduction takes three ints, so both are
``rank_pair``.

Parity: each ends where the binary search ends, so the flags must equal
K1's (``binary``, K11's ``full``) flag for flag; checked here before
timing.

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.rankpair_ab [--channels 32768] [--baselines 8064]
"""

import functools

from ..models.rfi import flagger_probe as fp
from ..utils import profiling
from . import common

RUNS = {"binary": "full", "rank_pair": "rank_pair", "zeros_fold": "zeros_fold",
        "radix_select": "radix_select"}


def check_parity(vis_t, runs) -> None:
    """Raise unless every run's flags equal the first run's."""
    outs = {name: fp.probe(vis_t, v) for name, v in runs.items()}
    first = next(iter(outs))
    for name, out in outs.items():
        bad = int((out != outs[first]).sum())
        if bad:
            raise RuntimeError(f"PARITY MISMATCH: {name} differs from {first} in {bad} flags")
    print(f"parity: all variants == {first} (bit-exact)")


def run(vis_t, *, iters: int = 3, reps: int = 5, card: str = "", runs=RUNS):
    """Check parity, then time the runs interleaved; print them and return the
    median ms and the samples of each, by name."""
    check_parity(vis_t, runs)
    fns = {name: functools.partial(fp.probe, vis_t, v) for name, v in runs.items()}
    med, samples = profiling.time_interleaved(fns, reps=reps, iters=iters)
    for name in runs:
        common.report(name, med[name], samples[name], card)
    return med, samples


def main(argv=None) -> None:
    args = common.parser(__doc__).parse_args(argv)
    card = common.require_card()
    vis_t = common.dump_on_card(args.channels, args.baselines).transpose(0, 1).contiguous()
    run(vis_t, iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
