"""The tutorial kernels K7 and K6 against their other designs and PyTorch's calls, on the card.

Times, interleaved in one process so that a drift of the card's clocks
falls on all of them alike, on float32 vectors of 2**28 elements:

  k7             ``examples.triple.multiply``: one CTA of 1024 threads per
                 tile of 1024 float4s, one 16-byte load a thread;
  k7 4 loads evict-first
                 K7's source built with ``K7_UNROLL=4 K7_EVICT_FIRST=1``:
                 tiles of 4 float4s a thread, all 4 loads issued before
                 the first store, evict-first loads and stores (``__ldcs``,
                 ``__stcs``), at 1024 threads;
  k7 bulk copy   K7's source built with ``K7_BULK=1``: Hopper's 1-D bulk
                 copy, one persistent CTA of 256 threads an SM streaming
                 32 KiB chunks through 4 stages of shared memory;
  k7 bulk copy 2x3
                 the same with 2 CTAs an SM and 3 stages each;
  k7 grid-stride the earlier design (``ex_multiply_grid_stride``): a
                 grid-stride loop over the resident CTAs, one float4 in
                 flight per thread, at its 256 threads;
  k7 plain       ``triple.multiply_plain``;
  data * scale   PyTorch's call, K7's yardstick;
  k6             ``examples.triple_pallas.triple``: ``TILE`` elements a
                 program at ``NUM_WARPS`` warps, one 16-byte vector a
                 thread;
  k6 4096x8 evict-first
                 the same kernel at 4096 elements and 8 warps (four
                 vectors a thread) with evict-first loads and ``.cs``
                 stores;
  k6 block 256   the earlier design: ``BLOCK`` (256) elements at 4 warps;
  k6 plain       ``triple_pallas.triple_plain``;
  x * 3          PyTorch's call, K6's yardstick;
  copy_          ``dst.copy_(src)``, the card's own streaming copy of the
                 same bytes;
  k6 TxW         with ``--sweep``, K6 at each (tile, warps) point of
                 ``triple_pallas.SWEEP``;
  k7 T threads   with ``--sweep``, K7 at each CTA size of
                 :data:`K7_THREADS`.

Every kernel is first held to its plain version, bit for bit.  Each is
then timed three ways, 5 interleaved rounds each:

  host-paced     ``profiling.time_interleaved`` with 3 back-to-back calls
                 a sample, as ``chip_smoke.py`` times the other kernels
                 and records these: CUDA events around calls the host
                 makes on an idle card, so a sample holds the host's launch
                 of its first call and any stall of the host before it;
  host-paced x10 the same with 10 calls a sample, which spreads that
                 launch and stall over 10 calls;
  device-paced   ``profiling.time_queued`` with 3 calls a sample, each
                 sample queued behind a spin on the card, so it holds the
                 card's work alone.

Each line gives the median, min and all samples in ms and the rate over
the 8 B an element moves; then each new design against the others and
against the library call, with the gap beside both spreads (max - min),
each way; then each callable's host time per call (its launch, on 2**12
elements, where the card is never the bottleneck).  Then one row at
2**24 elements (64 MiB a buffer, so in and out exceed the 50 MB L2).  The
card's name, power limit and SM clock are printed beside the times.

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.examples_ab [--log2n 28] [--sweep]
"""

import argparse
import functools

import torch

from ..examples import triple, triple_pallas
from ..utils import profiling
from . import common

SCALE = 0.1
# The measurement builds of K7's source: name -> (macro definitions, CTA
# size).  No entry point of the package launches them.
BUILDS = {
    "k7 4 loads evict-first": (("K7_UNROLL=4", "K7_EVICT_FIRST=1"), 1024),
    "k7 bulk copy": (("K7_BULK=1",), 256),
    "k7 bulk copy 2x3": (("K7_BULK=1", "K7_BULK_CTAS=2", "K7_BULK_STAGES=3"), 256),
}
GRID_STRIDE_THREADS = 256  # the earlier design's default CTA
K7_THREADS = (256, 512)  # K7's CTA sizes of the sweep, beside its 1024
# Comparisons printed: (new, old).
VERSUS = (("k7", "k7 grid-stride"), ("k7", "k7 4 loads evict-first"), ("k7", "k7 bulk copy"),
          ("k7", "k7 bulk copy 2x3"), ("k7", "data * scale"),
          ("k6", "k6 block 256"), ("k6", "k6 4096x8 evict-first"), ("k6", "x * 3"),
          ("k7", "copy_"), ("k6", "copy_"))


@functools.lru_cache(maxsize=None)
def _library(name: str):
    from ..utils import kernels

    key = "examples_" + "_".join(name.split()[1:])
    return triple._bind(kernels.load(key, ["examples.cu"], {}, BUILDS[name][0]))


def k7_build(x: torch.Tensor, name: str, scale: float = SCALE, threads: int = 0) -> torch.Tensor:
    """``x * scale`` by the build `name` of :data:`BUILDS`, at its CTA size or `threads`."""
    if name not in BUILDS:
        raise ValueError(f"unknown build {name!r}; expected one of {tuple(BUILDS)}")
    if triple._check(x):
        raise ValueError("the K7 designs run on a CUDA tensor only")
    lib = _library(name)
    return triple._launch(lib, lib.ex_multiply, x, scale, threads or BUILDS[name][1])


def k7_grid_stride(x: torch.Tensor, scale: float = SCALE,
                   threads: int = GRID_STRIDE_THREADS) -> torch.Tensor:
    """``x * scale`` by K7's earlier grid-stride design; a CUDA tensor."""
    if triple._check(x):
        raise ValueError("the K7 designs run on a CUDA tensor only")
    lib = triple._library()
    return triple._launch(lib, lib.ex_multiply_grid_stride, x, scale, threads)


def calls(x: torch.Tensor, sweep: bool = False) -> dict:
    """The timed callables on the 1-D float32 CUDA vector `x`, with their plain versions.

    Returns ``{name: (fn, plain)}``; ``plain`` is None for the PyTorch calls.
    """
    dst = torch.empty_like(x)
    k7_plain = lambda: triple.multiply_plain(x, SCALE)  # noqa: E731
    k6_plain = lambda: triple_pallas.triple_plain(x)  # noqa: E731
    fns = {
        "k7": (lambda: triple.multiply(x, SCALE), k7_plain),
        **{name: (lambda b=name: k7_build(x, b), k7_plain) for name in BUILDS},
        "k7 grid-stride": (lambda: k7_grid_stride(x), k7_plain),
        "k7 plain": (k7_plain, None),
        "data * scale": (lambda: x * SCALE, None),
        "k6": (lambda: triple_pallas.triple(x), k6_plain),
        "k6 4096x8 evict-first": (
            lambda: triple_pallas.triple_config(x, 4096, 8, evict_first=True), k6_plain),
        "k6 block 256": (lambda: triple_pallas.triple_config(x, triple_pallas.BLOCK, 4), k6_plain),
        "k6 plain": (k6_plain, None),
        "x * 3": (lambda: x * 3, None),
        "copy_": (lambda: dst.copy_(x), None),
    }
    if sweep:
        for tile, warps in triple_pallas.SWEEP:
            fns[f"k6 {tile}x{warps}"] = (
                lambda t=tile, w=warps: triple_pallas.triple_config(x, t, w), k6_plain)
        for threads in K7_THREADS:
            fns[f"k7 {threads} threads"] = (
                lambda t=threads: triple.multiply(x, SCALE, threads=t), k7_plain)
    return fns


def _check(fns: dict) -> None:
    """Each kernel bit for bit against its plain version on the same input."""
    for name, (fn, plain) in fns.items():
        if plain is None:
            continue
        got, want = fn(), plain()
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} elements differ from the plain version")
    print(f"  {', '.join(n for n, (_, p) in fns.items() if p is not None)}: "
          f"each bit for bit its plain version")


def _versus(stats: dict, new: str, old: str) -> str:
    """``new / old``, the gap and both spreads, from ``{name: (median, min, max)}``."""
    (m_new, lo_new, hi_new), (m_old, lo_old, hi_old) = stats[new], stats[old]
    gap = m_old - m_new
    spreads = (hi_new - lo_new, hi_old - lo_old)
    verdict = "beyond both" if abs(gap) > max(spreads) else "within"
    return (f"{m_new / m_old:.3f}, {'faster' if gap > 0 else 'slower'} by {abs(gap):.4f} ms "
            f"against spreads {spreads[0]:.4f}, {spreads[1]:.4f}: {verdict}")


def _time(fns: dict, reps: int, iters: int):
    """Each way: ``{way: {name: (median, min, max)}}``, and the samples of each."""
    stats, all_samples = {}, {}
    for way, timer, calls_each in (("host-paced", profiling.time_interleaved, iters),
                                   ("host-paced x10", profiling.time_interleaved, 10),
                                   ("device-paced", profiling.time_queued, iters)):
        med, samples = timer(fns, reps=reps, iters=calls_each)
        stats[way] = {k: (med[k], min(s), max(s)) for k, s in samples.items()}
        all_samples[way] = samples
    return stats, all_samples


def run(x: torch.Tensor, *, iters: int = 3, reps: int = 5, card: str = "",
        sweep: bool = False, small: int = 1 << 24) -> dict:
    """Time the calls of :func:`calls` on `x` each way, then once more on `small` elements.

    Returns ``{way: {name: (median, min, max)}}`` in ms per call at
    ``x.numel()``, `way` "host-paced", "host-paced x10" or "device-paced".
    """
    n = x.numel()
    nbytes = 2 * n * x.element_size()
    fns = calls(x, sweep)
    _check(fns)
    timed = {k: f for k, (f, _) in fns.items()}
    print(f"K7 and K6 at n = {n} float32 ({nbytes / 1e9:.2f} GB moved a call), "
          f"{reps} interleaved rounds each way, on {card}:")
    print(f"  card state before: {common.card_state()}")
    stats, samples = _time(timed, reps, iters)
    print(f"  card state after: {common.card_state()}")
    for way in stats:
        print(f"{way}:")
        for name in fns:
            med = stats[way][name][0]
            common.report(name, med, samples[way][name], card)
            print(f"{'':12s} {nbytes / med / 1e6:.1f} GB/s")
    for new, old in VERSUS:
        print(f"  {new} / {old} [{card}]:")
        for way, st in stats.items():
            print(f"    {way}: {_versus(st, new, old)}")
    tiny = calls(x[:1 << 12])
    launch = common.host_us({k: f for k, (f, _) in tiny.items()})
    print("  host time per call, us (2**12 elements): "
          + ", ".join(f"{k} {us:.1f}" for k, us in launch.items()))
    if small and small < n:
        part = calls(x[:small])
        _check(part)
        stats_small, _ = _time({k: f for k, (f, _) in part.items()}, reps, iters)
        for way, st in stats_small.items():
            print(f"  n = {small}, {way} medians: " + ", ".join(
                f"{k} {m:.4f} ms" for k, (m, _, _) in st.items()) + f" [{card}]")
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--log2n", type=int, default=28, help="elements, as a power of 2")
    ap.add_argument("--iters", type=int, default=3,
                    help="back-to-back calls per timed sample, host-paced and device-paced "
                         "(default %(default)s)")
    ap.add_argument("--reps", type=int, default=5,
                    help="rounds of interleaved samples (default %(default)s)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K6 at each (tile, warps) point of triple_pallas.SWEEP "
                         "and K7 at each CTA size of K7_THREADS")
    args = ap.parse_args(argv)
    card = common.require_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.empty(1 << args.log2n, device="cuda").uniform_(-1.0, 1.0, generator=gen)
    run(x, iters=args.iters, reps=args.reps, card=card, sweep=args.sweep)


if __name__ == "__main__":
    main()
