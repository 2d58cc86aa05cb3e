"""What ingest costs when the kernel reads the main path's layout in place.

Port of ``scripts/deinterleave_probe.py``.  The main path's input is
channel-major planar (channels, rows, 2) float32; K1 reads rows of
baseline-major (rows, channels, 2) pairs, so ``flag_dump`` first makes a
corner-turned copy.  On the TPU the question was whether Mosaic could
split interleaved pairs in the kernel; on the card any layout can be
read, and the question is its cost.  K12 (``amp_pairs``) writes each
row's amplitudes from one CTA per row at K1's occupancy:

  baseline-major    amp_pairs on the corner-turned copy (what K1 reads)
  channel-major     amp_pairs reading the main path's input in place
  K5 + baseline     the corner turn by K5, then amp_pairs: the unfused way
  K5 alone          the corner turn by itself

Every amplitude must equal the plain amplitude bit for bit; checked here
before timing.

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.deinterleave_probe [--channels 32768] [--baselines 8064]
"""

import torch

from ..models.rfi import flagger_probe as fp
from ..ops import transpose as tr
from ..utils import profiling
from . import common


def run(vis, *, iters: int = 3, reps: int = 5, card: str = ""):
    """Check, then time the layouts on channel-major (channels, rows, 2) `vis`; return ms."""
    vis_t = tr.transpose_cuda(vis)
    want = fp.amp_pairs_plain(vis_t)
    for label, got in (("baseline-major", fp.amp_pairs(vis_t)),
                       ("channel-major", fp.amp_pairs(vis, channel_major=True))):
        if got.shape != want.shape:
            raise RuntimeError(f"MISMATCH: amp_pairs {label} gave {tuple(got.shape)}")
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if bad:
            raise RuntimeError(f"MISMATCH: amp_pairs {label} differs in {bad} amplitudes")
    print("parity: amp_pairs in both layouts == plain amplitude (bit-exact)")
    fns = {
        "baseline-major": lambda: fp.amp_pairs(vis_t),
        "channel-major": lambda: fp.amp_pairs(vis, channel_major=True),
        "K5 + baseline": lambda: fp.amp_pairs(tr.transpose_cuda(vis)),
        "K5 alone": lambda: tr.transpose_cuda(vis),
    }
    med, samples = profiling.time_interleaved(fns, reps=reps, iters=iters)
    for name in fns:
        common.report(name, med[name], samples[name], card)
    saved = med["K5 + baseline"] - med["channel-major"]
    print(f"reading in place saves {saved:8.3f} ms per dump against K5 + amp_pairs [{card}]")
    return med


def main(argv=None) -> None:
    args = common.parser(__doc__).parse_args(argv)
    card = common.require_card()
    run(common.dump_on_card(args.channels, args.baselines), iters=args.iters, reps=args.reps,
        card=card)


if __name__ == "__main__":
    main()
