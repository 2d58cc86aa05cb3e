"""What ingest costs when the kernel reads the main path's layout in place.

Port of ``scripts/deinterleave_probe.py``.  The main path's input is
channel-major planar (channels, rows, 2) float32; K1 reads rows of
baseline-major (rows, channels, 2) pairs, so ``flag_dump`` first makes a
corner-turned copy (K5).  On the TPU the question was whether Mosaic could
split interleaved pairs in the kernel; on the card any layout can be
read, and the question is its cost.  K12 (``amp_pairs``) takes each row's
amplitudes through K1's amplitude words at K1's launch, and
``channel_major`` is K1 with that in-place read as its load stage.  Timed,
interleaved in one process:

  K12 g1 .. g8        amp_pairs reading the channel-major dump in place, in
                      clusters of 1, 2, 4 and 8 rows
  K12 baseline-major  amp_pairs on the corner-turned copy (what K1 reads)
  K5 + baseline-major the corner turn by K5, then amp_pairs: the unfused way
  K5 alone            the corner turn by itself
  K1                  flag_dump of the corner-turned copy
  K5 + K1             flag_dump(vis.transpose(0, 1)), the bench's call
  channel_major g1 .. g8
                      K1 reading the channel-major dump in place, in
                      clusters of 1, 2, 4 and 8 rows

Every amplitude must equal the plain amplitude bit for bit, and
``channel_major``'s flags K1's: checked here before timing.  Then the
fastest ``channel_major`` less K5 + K1 and less K1, against both spreads
(max - min).

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.deinterleave_probe [--channels 32768] [--baselines 8064]
"""

import torch

from ..models.rfi import flagger_probe as fp, fused_flagger as ff
from ..ops import transpose as tr
from ..utils import profiling
from . import common


def _k12(g: int) -> str:
    return f"K12 g{g}"


def _inplace(g: int) -> str:
    return f"channel_major g{g}"


def run(vis, *, iters: int = 3, reps: int = 5, card: str = ""):
    """Check, then time on channel-major (channels, rows, 2) `vis`.

    Returns ``{name: (median, min, max)}`` in ms per call.
    """
    vis_t = tr.transpose_cuda(vis)
    want = fp.amp_pairs_plain(vis_t)
    kernels = {f"amp_pairs channel-major g{g}":
               lambda g=g: fp.amp_pairs(vis, channel_major=True, cluster=g) for g in fp.CLUSTERS}
    kernels.update({
        "amp_pairs baseline-major": lambda: fp.amp_pairs(vis_t),
    })
    for label, fn in kernels.items():
        got = fn()
        if got.shape != want.shape:
            raise RuntimeError(f"MISMATCH: {label} gave {tuple(got.shape)}")
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if bad:
            raise RuntimeError(f"MISMATCH: {label} differs in {bad} amplitudes")
        del got
    del want
    print("parity: amp_pairs (every cluster, both layouts) == plain amplitude (bit-exact)")
    k1 = ff.flag_dump(vis_t)
    for g in fp.CLUSTERS:
        bad = int((fp.probe(vis.transpose(0, 1), "channel_major", cluster=g) != k1).sum())
        if bad:
            raise RuntimeError(f"MISMATCH: channel_major in clusters of {g} differs from K1 in "
                               f"{bad} flags")
    del k1
    print("parity: channel_major (every cluster) == K1 on the corner-turned dump "
          "(flag for flag)")
    fns = {_k12(g): lambda g=g: fp.amp_pairs(vis, channel_major=True, cluster=g)
           for g in fp.CLUSTERS}
    fns.update({
        "K12 baseline-major": lambda: fp.amp_pairs(vis_t),
        "K5 + baseline-major": lambda: fp.amp_pairs(tr.transpose_cuda(vis)),
        "K5 alone": lambda: tr.transpose_cuda(vis),
        "K1": lambda: ff.flag_dump(vis_t),
        "K5 + K1": lambda: ff.flag_dump(vis.transpose(0, 1)),
    })
    fns.update({_inplace(g): lambda g=g: fp.probe(vis.transpose(0, 1), "channel_major",
                                                   cluster=g) for g in fp.CLUSTERS})
    med, samples = profiling.time_interleaved(fns, reps=reps, iters=iters)
    out = {}
    for name in fns:
        common.report(name, med[name], samples[name], card)
        out[name] = (med[name], min(samples[name]), max(samples[name]))
    spread = {name: hi - lo for name, (_, lo, hi) in out.items()}
    best = min(fp.CLUSTERS, key=lambda g: med[_k12(g)])
    print(f"K12 fastest cluster: {best} rows, {med[_k12(best)]:.3f} ms against "
          f"baseline-major {med['K12 baseline-major']:.3f} ms [{card}]")
    name = _inplace(min(fp.CLUSTERS, key=lambda g: med[_inplace(g)]))
    for other in ("K5 + K1", "K1"):
        gap = med[name] - med[other]
        print(f"{name} - ({other}) = {gap:+.3f} ms against spreads {name} {spread[name]:.3f}, "
              f"{other} {spread[other]:.3f} ms: "
              f"{common.verdict(gap, spread[name], spread[other])} [{card}]")
    return out


def main(argv=None) -> None:
    args = common.parser(__doc__).parse_args(argv)
    card = common.require_card()
    run(common.dump_on_card(args.channels, args.baselines), iters=args.iters, reps=args.reps,
        card=card)


if __name__ == "__main__":
    main()
