"""K2 in the run layout against K2's strided design, on the card.

Times, interleaved in one process so that a drift of the card's clocks
falls on both alike, on the deviations of the main path's dump (the plain
background's general path, as the hybrid engine computes them):

  k2       ``fused_flagger.madnz_threshold``: K2 in the run layout of
           ``csrc/ff_runs.cuh`` (K1's rank search with |dev| in registers,
           SumThreshold on per-thread runs with bit-mask flags);
  strided  :func:`strided`: K2's earlier design on the strided layout of
           ``csrc/ff_device.cuh``, flag for flag the same function.

Each prints its median, min and all samples, with the card's SM clock and
power before and after the window; then k2 / strided, and whether their
gap exceeds both spreads (max - min).  The strided design is a
measurement build; no entry point of the package launches it.

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.k2_ab [--channels 32768] [--baselines 8064]
"""

import functools

import numpy as np
import torch

from ..models.rfi import device, fused_flagger as ff
from ..utils import profiling
from . import common

# Launches of the strided design since the count was last reset.  The
# wrapper adds one where it launches, and nowhere else.
launches = {"strided": 0}


def strided(dev_t, *, n_sigma: float = 11.0, n_windows: int = 4, falloff: float = 1.2,
            flag_value: int = 1):
    """K2's strided design on contiguous CUDA (rows, channels) float32 deviations.

    The parameters are :func:`.fused_flagger.madnz_threshold`'s; a row
    holds up to the strided layout's channel limit.
    """
    ff._check_params(n_windows, flag_value)
    if dev_t.device.type != "cuda" or dev_t.dtype != torch.float32 or dev_t.ndim != 2:
        raise ValueError("the strided K2 takes (rows, channels) float32 on a CUDA device")
    rows, channels = dev_t.shape
    out = torch.empty((rows, channels), dtype=torch.uint8, device=dev_t.device)
    with torch.cuda.device(dev_t.device):
        lib = ff._library(13)
        ff._check_limit(channels, lib.ff_strided_max_channels())
        scales, sigma, stream = ff._launch_args([dev_t], channels, n_sigma, falloff, n_windows)
        err = lib.ff_madnz_threshold_strided(dev_t.data_ptr(), out.data_ptr(), rows, channels,
                                             sigma, scales.ctypes.data, len(scales), flag_value,
                                             stream)
    ff._raise_on(lib, err, "madnz_threshold (strided)")
    launches["strided"] += 1
    return out


def adversarial_deviations(rows: int, channels: int, seed: int, *, denormals: bool = True):
    """(rows, channels) float32 deviations K1 never hands its back half, from `seed`.

    Noise with spikes, and rows 1-7: every seventh NaN, one +inf and one
    -inf, all zero (a MAD of the non-zero values with none), every third
    -0, denormals, all NaN, every fifth +inf.  With `denormals` False
    row 5 has every other value 0 instead: XLA on the CPU flushes
    denormals to zero.  Needs rows >= 8.
    """
    rs = np.random.RandomState(seed)
    d = rs.standard_normal((rows, channels)).astype(np.float32)
    d[:, rs.randint(0, channels, size=max(1, channels // 40))] += 30.0
    d[1, ::7] = np.nan
    d[2, rs.randint(0, channels, size=2)] = (np.inf, -np.inf)
    d[3] = 0.0
    d[4, ::3] = -0.0
    if denormals:
        d[5] *= 1e-39
    else:
        d[5, ::2] = 0.0
    d[6] = np.nan
    d[7, ::5] = np.inf
    return d


def deviations(vis, block: int = 1008):
    """(rows, channels) deviations of channel-major (channels, rows, 2) `vis`.

    As the hybrid engine has them: the plain background's general path,
    `block` rows at a time to bound its memory.
    """
    channels, rows = vis.shape[:2]
    dev_t = torch.empty((rows, channels), dtype=torch.float32, device=vis.device)
    for s in range(0, rows, block):
        dev_t[s:s + block] = device.background_median_filter(
            vis[:, s:s + block], None, 13, False, device.BackgroundFlags.NONE,
            fast_path=False).T
    return dev_t


def run(dev_t, *, iters: int = 3, reps: int = 5, card: str = ""):
    """Time K2 and its strided design on (rows, channels) deviations `dev_t`.

    Returns ``{name: (median, min, max)}`` in ms per call.
    """
    fns = {"k2": functools.partial(ff.madnz_threshold, dev_t),
           "strided": functools.partial(strided, dev_t)}
    print(f"  card state before: {common.card_state()}")
    med, samples = profiling.time_interleaved(fns, reps=reps, iters=iters)
    print(f"  card state after: {common.card_state()}")
    out = {}
    for name in fns:
        common.report(name, med[name], samples[name], card)
        out[name] = (med[name], min(samples[name]), max(samples[name]))
    spread = {name: hi - lo for name, (_, lo, hi) in out.items()}
    gap = med["strided"] - med["k2"]
    print(f"k2 / strided = {med['k2'] / med['strided']:.3f}; gap {gap:.3f} ms against spreads "
          f"k2 {spread['k2']:.3f}, strided {spread['strided']:.3f} ms: "
          f"{'beyond both' if gap > max(spread.values()) else 'within'} [{card}]")
    return out


def main(argv=None) -> None:
    ap = common.parser(__doc__)
    args = ap.parse_args(argv)
    card = common.require_card()
    dev_t = deviations(common.dump_on_card(args.channels, args.baselines))
    if not torch.equal(ff.madnz_threshold(dev_t), strided(dev_t)):
        raise AssertionError("K2 and its strided design disagree on the dump")
    run(dev_t, iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
