"""Stage ablation of the fused flagger K1 on the card.

Port of ``scripts/stage_ablate.py``.  Times K1 (``full``) and K1 with one
stage replaced by a near-free stand-in, all variants interleaved in one
process, each on K1's run layout (``csrc/ff_runs.cuh``) and at K1's own
launch (1024 threads, K1's shared memory, one CTA per SM at 32768
channels); the difference to ``full`` is that stage's cost in the K1 that
runs.  The stand-ins' flags mean nothing; only their times do.

Variants (``katsdpsigproc_tpu_torch/csrc/flagger_probe.cu``):
  full         amplitude -> median -> MAD noise -> SumThreshold -> store: K1
  no_median    median := amp * 0.5
  no_rank      noise := 1.0
  no_thresh    flags := dev > noise (one compare)
  skeleton     flags := amp > 1.0 (amplitude + store at K1's occupancy)

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.stage_ablate [--channels 32768] [--baselines 8064]
"""

import functools

from ..models.rfi import flagger_probe as fp
from ..utils import profiling
from . import common

STAGES = (("median", "no_median"), ("rank", "no_rank"), ("threshold", "no_thresh"))


def run(vis_t, *, width: int = 13, iters: int = 3, reps: int = 5, card: str = ""):
    """Time the variants on (rows, channels, 2) `vis_t`; print and return ms.

    Returns the median time of each variant and each stage's cost (the
    median of ``full`` less that of the stage's stand-in), in ms per call.
    """
    fns = {v: functools.partial(fp.probe, vis_t, v, width=width) for v in fp.STAGE_ABLATE}
    med, samples = profiling.time_interleaved(fns, reps=reps, iters=iters)
    rows = vis_t.shape[0]
    for v in fp.STAGE_ABLATE:
        common.report(v, med[v], samples[v], card)
        print(f"{'':12s} {med[v] / rows * 1e3:.4f} us/row")
    stages = {label: med["full"] - med[v] for label, v in STAGES}
    for label, ms in stages.items():
        print(f"stage {label:10s} ~ {ms:8.3f} ms per call [{card}]")
    print(f"stage skeleton   ~ {med['skeleton']:8.3f} ms per call "
          f"(amplitude + store at K1's occupancy) [{card}]")
    return med, stages


def main(argv=None) -> None:
    ap = common.parser(__doc__)
    ap.add_argument("--width", type=int, default=13)
    args = ap.parse_args(argv)
    card = common.require_card()
    vis_t = common.dump_on_card(args.channels, args.baselines).transpose(0, 1).contiguous()
    run(vis_t, width=args.width, iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
