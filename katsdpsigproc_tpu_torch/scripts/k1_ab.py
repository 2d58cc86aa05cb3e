"""K1 in its run layout against K1 in the strided layout, on the card.

Times, interleaved in one process so that a drift of the card's clocks
falls on all of them alike:

  k1             ``fused_flagger.flag_transposed``: K1, the run layout of
                 ``csrc/ff_runs.cuh`` (per-thread channel runs, bit-mask
                 flags, window sums by doubling, one-instruction NaN
                 min/max);
  strided_full   ``flagger_probe.probe(..., "strided_full")``: K1 in the
                 strided layout of ``csrc/ff_device.cuh``, flag for flag the
                 same function;
  k5 + k1        ``fused_flagger.flag_dump(vis.transpose(0, 1))``: the
                 bench's call on the channel-major dump, K5's corner turn
                 then K1 (only when the channel-major dump is given);
  select_minmax  K1's source built with ``FF_RUNS_SELECT_MINMAX``: the run
                 layout with the strided design's select-based NaN min/max,
                 flag for flag K1;
  full, no_median, no_rank, no_thresh
                 K11, K1's stage probes on its run layout and at its launch
                 (``flagger_probe.STAGE_ABLATE``): K1's pipeline, and K1
                 with one stage replaced by a stand-in.

Each prints its median, min and max over the rounds; then k1 / strided_full,
and whether their gap exceeds both spreads (max - min); k1 against K11's
``full``, which runs K1's code; each stage's cost in the run layout
(``full`` less its stand-in); and the one-instruction min/max's gain
(select_minmax less k1).  The measurement build is a separate library; no
entry point of the package launches it.

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.k1_ab [--channels 32768] [--baselines 8064]
"""

import ctypes
import functools

import torch

from ..models.rfi import flagger_probe as fp, fused_flagger as ff
from ..utils import profiling
from . import common, stage_ablate

# The measurement build of K1's source: name -> macro definition.
BUILDS = {"select_minmax": "FF_RUNS_SELECT_MINMAX"}

# Launches since the counts were last reset, per build.  The wrapper adds
# one where it launches, and nowhere else.
launches = {name: 0 for name in BUILDS}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    from ..utils import kernels

    return ff._bind(kernels.load(f"fused_flagger_{name}", ["fused_flagger.cu"],
                                 {"ff_network.h": ff._network_header(13)}, (BUILDS[name],)))


def build_plain(vis_t, name: str):
    """The plain version of the build `name`: K1's."""
    if name not in BUILDS:
        raise ValueError(f"unknown build {name!r}; expected one of {tuple(BUILDS)}")
    return ff.flag_transposed_plain(vis_t, **fp.PARAMS)


def build(vis_t, name: str):
    """The build `name` of K1 on (rows, channels, 2) float32 `vis_t`, no input flags.

    Width 13 and the stage probes' parameters (:data:`.flagger_probe.PARAMS`).
    A CPU tensor takes :func:`build_plain`; a CUDA tensor must be contiguous.
    """
    if name not in BUILDS:
        raise ValueError(f"unknown build {name!r}; expected one of {tuple(BUILDS)}")
    fp._check_vis(vis_t, "vis_t")
    if vis_t.device.type == "cpu":
        return build_plain(vis_t, name)
    rows, channels = vis_t.shape[:2]
    out = torch.empty((rows, channels), dtype=torch.uint8, device=vis_t.device)
    with torch.cuda.device(vis_t.device):
        lib = _library(name)
        ff._check_limit(channels, lib.ff_max_channels())
        scales, sigma, stream = ff._launch_args([vis_t], channels, fp.PARAMS["n_sigma"],
                                                fp.PARAMS["falloff"], fp.PARAMS["n_windows"])
        err = lib.ff_flagger(vis_t.data_ptr(), None, 0, out.data_ptr(), rows, channels, sigma,
                             scales.ctypes.data, len(scales), fp.PARAMS["flag_value"],
                             ff.k1_threads(channels), stream)
    ff._raise_on(lib, err, f"flagger build {name}")
    launches[name] += 1
    return out


def run(vis_t, vis=None, *, iters: int = 3, reps: int = 5, card: str = ""):
    """Time K1, ``strided_full``, the build and K11 on (rows, channels, 2) `vis_t`, K5 + K1 on `vis`.

    `vis` is the same dump channel-major, (channels, rows, 2), or None.
    Returns ``{name: (median, min, max)}`` in ms per call, and the stage
    costs ``{stage: ms}`` in the run layout (K11's ``full`` less each
    stand-in).
    """
    fns = {"k1": functools.partial(ff.flag_transposed, vis_t),
           "strided_full": functools.partial(fp.probe, vis_t, "strided_full")}
    if vis is not None:
        fns["k5 + k1"] = lambda: ff.flag_dump(vis.transpose(0, 1))
    fns.update({name: functools.partial(build, vis_t, name) for name in BUILDS})
    fns.update({v: functools.partial(fp.probe, vis_t, v)
                for v in ["full"] + [name for _, name in stage_ablate.STAGES]})
    med, samples = profiling.time_interleaved(fns, reps=reps, iters=iters)
    out = {}
    for name in fns:
        common.report(name, med[name], samples[name], card)
        out[name] = (med[name], min(samples[name]), max(samples[name]))
    spread = {name: hi - lo for name, (_, lo, hi) in out.items()}
    gap = med["strided_full"] - med["k1"]
    print(f"k1 / strided_full = {med['k1'] / med['strided_full']:.3f}; gap {gap:.3f} ms against "
          f"spreads k1 {spread['k1']:.3f}, strided_full {spread['strided_full']:.3f} ms: "
          f"{common.verdict(gap, spread['k1'], spread['strided_full'])} [{card}]")
    gap = med["full"] - med["k1"]
    print(f"K11 full - k1 = {gap:+.3f} ms against spreads k1 {spread['k1']:.3f}, full "
          f"{spread['full']:.3f} ms: {common.verdict(gap, spread['k1'], spread['full'])} [{card}]")
    stages = {label: med["full"] - med[name] for label, name in stage_ablate.STAGES}
    print("run-layout stage costs (K11 full less the stand-in): "
          + ", ".join(f"{label} {ms:.3f} ms" for label, ms in stages.items())
          + f"; min.NaN/max.NaN gain (select_minmax - k1) "
          f"{med['select_minmax'] - med['k1']:+.3f} ms [{card}]")
    return out, stages


def main(argv=None) -> None:
    ap = common.parser(__doc__)
    args = ap.parse_args(argv)
    card = common.require_card()
    vis = common.dump_on_card(args.channels, args.baselines)
    run(vis.transpose(0, 1).contiguous(), vis, iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
