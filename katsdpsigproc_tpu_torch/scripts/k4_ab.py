"""K4 against its measurement builds, the original design and torch.quantile, on the card.

Times, interleaved in one process so that a drift of the card's clocks
falls on all of them alike, at each shape:

  k4        ``percentile.percentile5_cuda``: K4, the radix select with the
            row's keys in registers (``csrc/percentile.cu``);
  search    K4's measurement build: the 31-round search from the same
            registers, one barrier a round;
  match     K4 with its first pass aggregated within a warp: equal
            exponents counted by one shared atomic (``__match_any_sync``);
  smem      K4 with the row's keys in shared memory instead of registers,
            at the same CTA size (fewer registers, more CTAs an SM);
  original  K4's original design: one 256-thread CTA a row, 31 rounds
            from shared memory;
  quantile  ``torch.quantile(x, [0, .25, .5, .75, 1], dim=1,
            interpolation="lower")``, the library call of the same
            function.

The shapes are the ops path's: 4000 x 5000 (the percentile test) and
64 x 4096 (``bench.py`` config 2), |N(0, 1)| float32 from seed 1.  Each
is timed two ways, in one window: host-paced (``time_interleaved``, CUDA
events around calls as the host issues them, the ``kernels`` line's
record) and device-paced (``time_queued``, each sample queued behind a
spin on the card, so the card's time and not the host's launch).  Each
prints its median, min and all samples, with the card's SM clock and
power before and after the window; then, for each rival, whether K4's
gap to it exceeds both spreads; then the host's time per call of K4 and
the original design, which paces a host-paced sample of a call shorter than
it.  The builds count their own launches; no
entry point of the package launches them.

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.k4_ab [--iters 3] [--reps 5]
"""

import argparse
import functools

import numpy as np
import torch

from ..ops import percentile as pct
from ..utils import profiling
from . import common

# The designs of csrc/percentile.cu other than K4: name -> design number.
BUILDS = {"search": 1, "original": 2, "match": 3, "smem": 4}
SHAPES = {"4000x5000": (4000, 5000), "64x4096": (64, 4096)}
QUANTILES = (0.0, 0.25, 0.5, 0.75, 1.0)

# Launches since the counts were last reset, per build.  The wrapper adds
# one where it launches, and nowhere else.
launches = {name: 0 for name in BUILDS}


def build(values, name: str):
    """The design `name` of ``csrc/percentile.cu`` on CUDA (rows, n) float32 `values`."""
    if name not in BUILDS:
        raise ValueError(f"unknown build {name!r}; expected one of {tuple(BUILDS)}")
    out = pct.launch(values, BUILDS[name])
    launches[name] += 1
    return out


def data(rows: int, n: int, device) -> torch.Tensor:
    """|N(0, 1)| float32 from seed 1, as ``bench.py`` makes the percentile input."""
    return torch.from_numpy(np.abs(np.random.RandomState(seed=1).standard_normal(
        (rows, n))).astype(np.float32)).to(device)


def adversarial_rows(rows: int, n: int, seed: int, *, xla_cpu: bool = False) -> np.ndarray:
    """(rows, n) float32: |N(0, 1)| rows from `seed`, and by turns rows K4 never sees.

    Row i has, by i % 10: 1, every third NaN; 2, all NaN (min +inf, max
    -inf, every percentile 0x7fffffff); 3, negatives (key 0, percentiles
    +0); 4, every other -0 with no +0 beside it; 5, every fourth +inf
    (a p75 of +inf gives 0x7fffffff); 6, denormals; 7, every value equal;
    8, every fifth -inf; 9, every other NaN.  With `xla_cpu` the rows read
    alike on XLA's CPU backend, which flushes denormals to zero and returns
    +0 for a min or max of -0: row 6 is scaled by 1e-30, and row 4's -0
    lies between a -1 and a 2.
    """
    x = np.abs(np.random.RandomState(seed).standard_normal((rows, n))).astype(np.float32)
    x[1::10, ::3] = np.nan
    x[2::10] = np.nan
    x[3::10] *= -1.0
    x[4::10, ::2] = -0.0
    if xla_cpu:
        x[4::10, 0] = -1.0
        x[4::10, -1] = 2.0
    x[5::10, ::4] = np.inf
    x[6::10] *= 1e-30 if xla_cpu else 1e-40
    x[7::10] = 1.5
    x[8::10, ::5] = -np.inf
    x[9::10, 1::2] = np.nan
    return x


def quantile(values):
    """The library call: torch.quantile of the five percentiles, lower element."""
    q = torch.tensor(QUANTILES, dtype=values.dtype, device=values.device)
    return torch.quantile(values, q, dim=1, interpolation="lower")


WAYS = {"host-paced": profiling.time_interleaved, "device-paced": profiling.time_queued}


def run(cases, *, iters: int = 3, reps: int = 5, card: str = ""):
    """Time K4, the builds and the library call at each (label, tensor) of `cases`, both ways.

    Returns ``{label: {way: {name: (median, min, max)}}}`` in ms per call.
    """
    result = {}
    for label, x in cases:
        threads, per = pct.launch_shape(*x.shape)
        print(f"{label}: K4 at {threads} threads a row, {per} register slots a thread")
        # K4 last in each round: the first call after torch.quantile's host
        # work measured slower host-paced, whatever it was.
        fns = {"quantile": functools.partial(quantile, x),
               **{name: functools.partial(build, x, name) for name in BUILDS},
               "k4": functools.partial(pct.percentile5_cuda, x)}
        print(f"  card state before: {common.card_state()}")
        timed = {way: timer(fns, reps=reps, iters=iters) for way, timer in WAYS.items()}
        print(f"  card state after: {common.card_state()}")
        result[label] = {}
        for way, (med, samples) in timed.items():
            print(f"  {way}:")
            out = {}
            for name in fns:
                common.report(name, med[name], samples[name], card)
                out[name] = (med[name], min(samples[name]), max(samples[name]))
            spread = {name: hi - lo for name, (_, lo, hi) in out.items()}
            for rival in fns:
                if rival == "k4":
                    continue
                gap = med[rival] - med["k4"]
                print(f"  {label} {way}: k4 / {rival} = {med['k4'] / med[rival]:.3f}; gap "
                      f"{gap:.4f} ms against spreads k4 {spread['k4']:.4f}, {rival} "
                      f"{spread[rival]:.4f} ms: "
                      f"{'beyond both' if gap > max(spread['k4'], spread[rival]) else 'within'} "
                      f"[{card}]")
            result[label][way] = out
        us = common.host_us({name: fns[name] for name in ("k4", "original")})
        print(f"  {label}: host us per call, {', '.join(f'{k} {v:.1f}' for k, v in us.items())} "
              f"(back to back, the card drained at the end) [{card}]")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=3,
                    help="back-to-back calls per timed sample (default %(default)s)")
    ap.add_argument("--reps", type=int, default=5,
                    help="rounds of interleaved samples (default %(default)s)")
    args = ap.parse_args(argv)
    card = common.require_card()
    cases = [(label, data(*shape, "cuda")) for label, shape in SHAPES.items()]
    for label, x in cases:
        want = pct.percentile5_plain(x)
        for name, got in [("k4", pct.percentile5_cuda(x))] + [(b, build(x, b)) for b in BUILDS]:
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{name} disagrees with the plain version at {label}")
    run(cases, iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
