"""Per-primitive cost on the card: dependent chains of one operation (K8).

Port of ``scripts/prim_cost.py``.  Each body runs as a chain inside one
kernel (``csrc/prim_cost.cu``): ``steps x unroll`` reps of
``(x, y) -> (body(x, y), x)`` over a (rows, width) float32 block.  The time
over the empty kernel's, per rep and per operation of interest, is the
operation's cost for the whole block, printed and returned in ns per
operation of a 262144-element block (``--norm-elems``, the convention of
``models/rfi/roofline.py``, which prices the op inventory from this table).

An operation's cost depends on the machine it runs on, so the chains run at
K1's launch (:func:`.fused_flagger.launch_config` at 32768 channels: 1024
threads, K1's dynamic shared memory, one CTA per SM), with the row in the
run layout of ``csrc/ff_runs.cuh`` and each body executed as K1 executes
it (the neighbour read from the padded row, the rank round of
``runs::mad_noise``, K1's block sum, its min.NaN/max.NaN).  Rows of up to
32768 channels, a multiple of 64; by default 264 rows of 32768, two waves
on the H100's 132 SMs.  ``shift_reg`` (no TPU body) prices SumThreshold's
shifts in registers; it is printed beside the table and never written
into it.

Bodies, with (operations of interest, helper add-class operations) per
rep, as ``prim_cost.py:133-162``::

  add        (x, y) -> (min(x, 3) + y, x)                 2, 0
  minmax     (x, y) -> (min(x, 3) + max(y, 5), x)         3, 0
  mul        (x, y) -> (x * y + 1, x)                     1, 1
  select     (x, y) -> (where(lane < w/2, y, x) + y, x)   1, 1
  cmp_f32    (x, y) -> (x + (y < x), x)                   1, 1
  roll_lane  (x, y) -> (min(roll(y, 1), 3) + x, x)        1, 2
  shift_ch   (x, y) -> (roll(y, -1) + x, x)               1, 1  (h = 1: one lane roll)
  reduce     (x, y) -> (min(x, 3) + sum(y), x)            1, 2
  rank_round (x, y) -> (min(x, 3) + count(y < x[:, 0]), x) 1, 2
  sqrt       (x, y) -> (x + sqrt(y * y + 1), x)           1, 2  (less one mul)
  shift_reg  (x, y) -> (roll(y, -1) in pieces of 8 + x, x) 1, 1  (no TPU body)

``roll_sub`` and ``band_mm`` act on the TPU's sublane axis and the band
matrix of its multi-band fold, which the port's K1 does not have: they are
printed as having no counterpart and are not timed.

The printed ns per operation nets out the helper add-class operations at
the measured ``add`` cost, and ``sqrt`` its ``mul`` as well (the
deductions of ``prim_cost.py:219-236``).  A row below :data:`FLOOR_NS`
is printed as folded: the compiler collapsed the chain, or the noise
swallowed it.  ``--emit-json`` writes the rows at or above it to
``models/rfi/prim_ns.json``, with the card (``__card__``) and the launch
(``__launch__``, ``"k1"``).

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.prim_cost [--rows R] [--width W]
        [--steps 512] [--unroll 16] [--reps 5] [--emit-json]
"""

import argparse
import ctypes
import functools
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.rfi import fused_flagger, roofline
from ..utils import numerics, profiling
from . import common

_C, _C2 = 3.0, 5.0

# The card's floor for one operation of a 262144-element block (one place:
# the roofline's plausibility floor).  A chain measuring less per operation
# did not run.
FLOOR_NS = roofline.MIN_PLAUSIBLE_NS
NORM_ELEMS = 262144  # the table's unit: ns per op of a 262144-element block
K1_CHANNELS = 32768  # K1's row at its launch: thread t owns channels 32t .. 32t + 31
K1_ROWS = 264        # two waves of one CTA per SM on the H100's 132 SMs
_PIECE = 8           # csrc/prim_cost.cu's kPart


def _roll(x, shift):
    return torch.roll(x, shift, 1)


def _roll_pieces(x):
    """Channel c of each piece of 8 channels reads channel c + 1 of the piece, wrapped."""
    rows, width = x.shape
    return x.reshape(rows, width // _PIECE, _PIECE).roll(-1, 2).reshape(rows, width)


# name -> (plain body, operations of interest, helper add-class operations, kernel code)
BODIES: Dict[str, tuple] = {
    "add": (lambda x, y, m: torch.clamp(x, max=_C) + y, 2, 0, 1),
    "minmax": (lambda x, y, m: torch.clamp(x, max=_C) + torch.clamp(y, min=_C2), 3, 0, 2),
    "mul": (lambda x, y, m: x * y + 1.0, 1, 1, 3),
    "select": (lambda x, y, m: torch.where(m, y, x) + y, 1, 1, 4),
    "cmp_f32": (lambda x, y, m: x + (y < x).to(torch.float32), 1, 1, 5),
    "roll_lane": (lambda x, y, m: torch.clamp(_roll(y, 1), max=_C) + x, 1, 2, 6),
    "shift_ch": (lambda x, y, m: _roll(y, -1) + x, 1, 1, 7),
    "reduce": (lambda x, y, m: torch.clamp(x, max=_C) + y.sum(1, keepdim=True), 1, 2, 8),
    "rank_round": (lambda x, y, m: torch.clamp(x, max=_C)
                   + (y < x[:, :1]).sum(1, keepdim=True, dtype=torch.float32), 1, 2, 9),
    "sqrt": (lambda x, y, m: x + numerics.sqrt_rn(y * y + 1.0), 1, 2, 10),
}
# Bodies printed beside the table and never in it: SumThreshold's shifts
# in registers (no TPU body).
BESIDE_TABLE: Dict[str, tuple] = {
    "shift_reg": (lambda x, y, m: _roll_pieces(y) + x, 1, 1, 11),
}
# Every body the kernel runs.
ALL_BODIES: Dict[str, tuple] = {**BODIES, **BESIDE_TABLE}
# Helper operations beyond adds, netted out at the other body's cost.
EXTRA_DEDUCT = {"sqrt": [("mul", 1)]}
# The TPU bodies without a counterpart on the card.
NO_COUNTERPART = ("roll_sub", "band_mm")
_UNROLLS = (1, 2, 4, 8, 16)


# Kernel launches since the counts were last reset, per body (None: the
# empty kernel).  The wrapper adds one where it launches, and nowhere else.
launches: Dict[Optional[str], int] = {None: 0, **{name: 0 for name in ALL_BODIES}}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils import kernels

    lib = kernels.load("prim_cost", ["prim_cost.cu"],
                       {"ff_network.h": fused_flagger._network_header(13)})
    lib.ff_error_string.argtypes = [ctypes.c_int]
    lib.ff_error_string.restype = ctypes.c_char_p
    lib.pc_k1_launch_config.argtypes = [ctypes.c_int, ctypes.c_int] + \
        fused_flagger._LAUNCH_CONFIG_OUT
    lib.pc_k1_launch_config.restype = ctypes.c_int
    lib.pc_k1_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.pc_k1_chain.restype = ctypes.c_int
    return lib


def _code(body: Optional[str]) -> int:
    if body is None:
        return 0
    if body not in ALL_BODIES:
        raise ValueError(f"unknown body {body!r}; expected None or one of {tuple(ALL_BODIES)}")
    return ALL_BODIES[body][3]


def launch_config(body: Optional[str], unroll: int = 16) -> dict:
    """How the chain of `body` launches: the keys of :func:`.fused_flagger.launch_config`.

    It must equal ``fused_flagger.launch_config(32768)``.
    """
    lib = _library()
    return fused_flagger._query_launch_config(lib, lib.pc_k1_launch_config, _code(body), unroll)


def chain_plain(x, body: Optional[str], steps: int, unroll: int):
    """The plain PyTorch version of K8: the same chain in tensor operations."""
    _code(body)
    y = x * 0.5 + 0.125
    if body is not None:
        fn = ALL_BODIES[body][0]
        mask = torch.arange(x.shape[1], device=x.device) < x.shape[1] // 2
        for _ in range(steps * unroll):
            x, y = fn(x, y, mask), x
    return x + y


def chain(x, body: Optional[str], steps: int, unroll: int):
    """The chain of `body` over (rows, width) float32 `x` (K8 on a CUDA tensor).

    `body` is a name of :data:`ALL_BODIES`, or ``None`` (the empty
    kernel); `unroll` one of 1, 2, 4, 8, 16; `width` a multiple of 64 up
    to 32768.  Returns (rows, width) float32 on the input's device.
    """
    code = _code(body)
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError("x must be a 2-D torch.float32 tensor")
    rows, width = x.shape
    if width % 64 != 0 or not 64 <= width <= K1_CHANNELS:
        raise ValueError(f"width must be a multiple of 64 in 64..{K1_CHANNELS}, got {width}")
    if unroll not in _UNROLLS:
        raise ValueError(f"unroll must be one of {_UNROLLS}, got {unroll}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if x.device.type == "cpu":
        return chain_plain(x, body, steps, unroll)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous tensor")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pc_k1_chain(code, unroll, x.data_ptr(), out.data_ptr(), rows, width, steps,
                              stream)
    fused_flagger._raise_on(lib, err, f"prim_cost {body}")
    launches[body] += 1
    return out


def block(rows: int, width: int, device) -> torch.Tensor:
    """The tool's input: uniform(0.25, 0.75) from seed 1, as ``prim_cost.py:200-201``."""
    rs = np.random.RandomState(1)
    return torch.from_numpy(rs.uniform(0.25, 0.75, (rows, width)).astype(np.float32)).to(device)


def default_block(device) -> torch.Tensor:
    """The tool's block: 264 x 32768, two waves of K1's launch on the H100."""
    return block(K1_ROWS, K1_CHANNELS, device)


def net_ns(raw: Dict[str, float]) -> Dict[str, float]:
    """Each body's ns per operation, net of its helpers (``prim_cost.py:219-229``).

    Bodies of `raw` outside :data:`BODIES` (``shift_reg``) are netted of
    their helper adds too.
    """
    add_ns = max(raw.get("add", 0.0), 0.0)
    results: Dict[str, float] = {}
    for name in [n for n in ALL_BODIES if n in raw]:
        _, n_ops, n_helper_adds, _ = ALL_BODIES[name]
        ns = raw[name] - add_ns * n_helper_adds / n_ops
        for other, count in EXTRA_DEDUCT.get(name, []):
            ns -= max(results.get(other, 0.0), 0.0) * count / n_ops
        results[name] = ns
    return results


def measure(x, *, steps: int = 512, unroll: int = 16, iters: int = 3, reps: int = 5,
            card: str = "", timer: Optional[Callable] = None,
            norm_elems: int = NORM_ELEMS) -> Dict[str, float]:
    """Time every body's chain on `x` against the empty kernel; print and return ns
    per op of a `norm_elems`-element block.

    The chains are timed in turns, `reps` rounds of `iters` calls, on the
    card by :func:`.utils.profiling.time_queued`: the empty kernel and the
    cheap chains take less time than the host takes to launch them, so
    host-paced events would subtract the launch overhead instead of the
    empty kernel.  Returns each body of :data:`BODIES`'s net ns per
    operation (see :func:`net_ns`), scaled from the block's elements to
    `norm_elems`; ``shift_reg`` is printed beside and not returned.
    """
    if timer is None:
        timer = profiling.time_queued if x.is_cuda else profiling.time_interleaved
    fns = {name: functools.partial(chain, x, name, steps, unroll) for name in ALL_BODIES}
    fns["empty"] = functools.partial(chain, x, None, steps, unroll)
    med, _ = timer(fns, reps=reps, iters=iters)
    n_reps = steps * unroll
    scale = norm_elems / x.numel()
    raw = {name: (med[name] - med["empty"]) * 1e6 / (n_reps * spec[1]) * scale
           for name, spec in ALL_BODIES.items()}
    netted = net_ns(raw)
    rows, width = x.shape
    print(f"primitive costs at K1's launch, {rows} x {width} float32 block, {n_reps} reps "
          f"(empty kernel {med['empty']:.3f} ms), ns per op of a {norm_elems}-element block "
          f"[{card}]:")
    for name in BODIES:
        ns = netted[name]
        tag = "" if ns >= FLOOR_NS else f"   [below the {FLOOR_NS} ns floor: folded or noise]"
        print(f"  {name:10s} {ns:8.2f} ns/op  (raw chain {raw[name]:8.2f}){tag}")
    for name in NO_COUNTERPART:
        print(f"  {name:10s} no counterpart (band fold)")
    for name in BESIDE_TABLE:
        if name in netted:
            print(f"  beside the table: {name} (a shift in registers, SumThreshold's doubling) "
                  f"{netted[name]:.2f} ns/op net of its add (raw chain {raw[name]:.2f}); "
                  f"shift_ch from shared memory {netted['shift_ch']:.2f}")
    add_ns = netted["add"]
    if add_ns >= FLOOR_NS:
        print("  relative to add: "
              + ", ".join(f"{k} {netted[k] / add_ns:.2f}" for k in BODIES))
    return {name: netted[name] for name in BODIES}


def emit_json(results: Dict[str, float], card: str, path: Optional[str] = None) -> dict:
    """Write the table to `path` (default ``models/rfi/prim_ns.json``) and return it.

    The table holds the rows of `results` at or above :data:`FLOOR_NS`,
    the card (``__card__``) and the launch (``__launch__``, K1's).
    """
    out = {k: round(v, 3) for k, v in sorted(results.items()) if v >= FLOOR_NS}
    out.update(__card__=card, __launch__="k1")
    path = path or roofline.PRIM_JSON
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    dropped = sorted(set(results) - set(out))
    print(f"wrote {path}: {out}")
    if dropped:
        print(f"dropped (below the {FLOOR_NS} ns floor; the roofline uses its defaults): "
              f"{dropped}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=K1_ROWS)
    ap.add_argument("--width", type=int, default=K1_CHANNELS)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--unroll", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--norm-elems", type=int, default=NORM_ELEMS,
                    help="report ns per op of a block of this many elements "
                         "(the roofline's convention, 262144)")
    ap.add_argument("--emit-json", action="store_true",
                    help="write the table to models/rfi/prim_ns.json "
                         "(models.rfi.roofline.prim_ns reads it)")
    args = ap.parse_args(argv)
    card = common.require_card()
    results = measure(block(args.rows, args.width, "cuda"), steps=args.steps, unroll=args.unroll,
                      iters=args.iters, reps=args.reps, card=card, norm_elems=args.norm_elems)
    if args.emit_json:
        emit_json(results, card)


if __name__ == "__main__":
    main()
