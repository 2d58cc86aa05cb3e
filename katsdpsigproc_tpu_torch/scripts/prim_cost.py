"""Per-primitive cost on the card: dependent chains of one operation (K8).

Port of ``scripts/prim_cost.py``.  Each body runs as a chain inside one
kernel (``csrc/prim_cost.cu``): ``steps x unroll`` reps of
``(x, y) -> (body(x, y), x)`` over a (rows, width) float32 block, one CTA
per row and one thread per lane.  The time over the empty kernel's, per rep
and per operation of interest, is the operation's cost for the whole
block.  Chains run at the occupancy of the strided layout's kernels (its
dynamic shared memory at 32768 channels, so one CTA per SM), where K10,
K2's strided design and K1's stage probes run: an operation's cost depends on the
occupancy it runs at, as the TPU's depended on the layout.

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

``roll_sub`` and ``band_mm`` act on the TPU's sublane axis and the band
matrix of its multi-band fold, which the port's K1 does not have: they are
printed as having no counterpart and are not timed.

The printed ns per operation nets out the helper add-class operations at
the measured ``add`` cost, and ``sqrt`` its ``mul`` as well (the
deductions of ``prim_cost.py:219-236``).  A row below :data:`FLOOR_NS`
is printed as folded: the compiler collapsed the chain, or the noise
swallowed it.

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.prim_cost [--rows 256] [--width 1024]
        [--steps 512] [--unroll 16] [--reps 5]
"""

import argparse
import ctypes
import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.rfi import fused_flagger
from ..utils import numerics, profiling
from . import common

_C, _C2 = 3.0, 5.0

# The card's floor for one full-block operation: the default (256, 1024)
# block is two rows of 1024 on each SM (one CTA per SM at that occupancy,
# 256 rows over 132 SMs), 2048 elements over an SM's 128 float32 lanes:
# 16 cycles, 8.1 ns at the H100's 1.98 GHz boost clock.  A chain measuring
# less per operation did not run.
FLOOR_NS = 8.0


def _roll(x, shift):
    return torch.roll(x, shift, 1)


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
# Helper operations beyond adds, netted out at the other body's cost.
EXTRA_DEDUCT = {"sqrt": [("mul", 1)]}
# The TPU bodies without a counterpart on the card.
NO_COUNTERPART = ("roll_sub", "band_mm")
_UNROLLS = (1, 2, 4, 8, 16)

# Kernel launches since the counts were last reset, per body (None: the
# empty kernel).  The wrapper adds one where it launches, and nowhere else.
launches: Dict[Optional[str], int] = {None: 0, **{name: 0 for name in BODIES}}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils import kernels

    lib = kernels.load("prim_cost", ["prim_cost.cu"], {})
    lib.ff_error_string.argtypes = [ctypes.c_int]
    lib.ff_error_string.restype = ctypes.c_char_p
    lib.pc_needed_smem.argtypes = [ctypes.c_int]
    lib.pc_needed_smem.restype = ctypes.c_longlong
    lib.pc_launch_config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong] + fused_flagger._LAUNCH_CONFIG_OUT
    lib.pc_launch_config.restype = ctypes.c_int
    lib.pc_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_void_p]
    lib.pc_chain.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def strided_smem_bytes(channels: int = common.CHANNELS) -> int:
    """The strided layout's dynamic shared memory at `channels`, from K1's and K2's library."""
    return fused_flagger.strided_launch_config(channels)["smem_bytes"]


def _code(body: Optional[str]) -> int:
    if body is None:
        return 0
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; expected None or one of {tuple(BODIES)}")
    return BODIES[body][3]


def launch_config(body: Optional[str], width: int = 1024, unroll: int = 16) -> dict:
    """How the chain of `body` launches: the keys of ``fused_flagger.strided_launch_config``."""
    lib = _library()
    smem = max(strided_smem_bytes(), lib.pc_needed_smem(width))
    return fused_flagger._query_launch_config(lib, lib.pc_launch_config, _code(body), unroll,
                                              width, smem)


def chain_plain(x, body: Optional[str], steps: int, unroll: int):
    """The plain PyTorch version of K8: the same chain in tensor operations."""
    _code(body)
    y = x * 0.5 + 0.125
    if body is not None:
        fn = BODIES[body][0]
        mask = torch.arange(x.shape[1], device=x.device) < x.shape[1] // 2
        for _ in range(steps * unroll):
            x, y = fn(x, y, mask), x
    return x + y


def chain(x, body: Optional[str], steps: int, unroll: int):
    """The chain of `body` over (rows, width) float32 `x` (K8 on a CUDA tensor).

    `body` is a name of :data:`BODIES` or ``None`` (the empty kernel);
    `width` is a multiple of 32 up to 1024, `unroll` one of 1, 2, 4, 8, 16.
    Returns (rows, width) float32 on the input's device.
    """
    code = _code(body)
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError("x must be a 2-D torch.float32 tensor")
    rows, width = x.shape
    if width % 32 != 0 or not 32 <= width <= 1024:
        raise ValueError(f"width must be a multiple of 32 in 32..1024, got {width}")
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
        smem = max(strided_smem_bytes(), lib.pc_needed_smem(width))
        err = lib.pc_chain(code, unroll, x.data_ptr(), out.data_ptr(), rows, width, steps, smem,
                           torch.cuda.current_stream(x.device).cuda_stream)
    fused_flagger._raise_on(lib, err, f"prim_cost {body}")
    launches[body] += 1
    return out


def block(rows: int, width: int, device) -> torch.Tensor:
    """The tool's input: uniform(0.25, 0.75) from seed 1, as ``prim_cost.py:200-201``."""
    rs = np.random.RandomState(1)
    return torch.from_numpy(rs.uniform(0.25, 0.75, (rows, width)).astype(np.float32)).to(device)


def net_ns(raw: Dict[str, float]) -> Dict[str, float]:
    """Each body's ns per operation, net of its helpers (``prim_cost.py:219-229``)."""
    add_ns = max(raw.get("add", 0.0), 0.0)
    results: Dict[str, float] = {}
    for name, (_, n_ops, n_helper_adds, _) in BODIES.items():
        ns = raw[name] - add_ns * n_helper_adds / n_ops
        for other, count in EXTRA_DEDUCT.get(name, []):
            ns -= max(results.get(other, 0.0), 0.0) * count / n_ops
        results[name] = ns
    return results


def measure(x, *, steps: int = 512, unroll: int = 16, iters: int = 3, reps: int = 5,
            card: str = "", timer: Optional[Callable] = None) -> Dict[str, float]:
    """Time every body's chain on `x` against the empty kernel; print and return ns per op.

    The chains are timed in turns, `reps` rounds of `iters` calls, on the
    card by :func:`.utils.profiling.time_queued`: the empty kernel and the
    cheap chains take less time than the host takes to launch them, so
    host-paced events would subtract the launch overhead instead of the
    empty kernel.  Returns each body's net ns per operation for the whole
    block (see :func:`net_ns`).
    """
    if timer is None:
        timer = profiling.time_queued if x.is_cuda else profiling.time_interleaved
    fns = {name: functools.partial(chain, x, name, steps, unroll) for name in BODIES}
    fns["empty"] = functools.partial(chain, x, None, steps, unroll)
    med, _ = timer(fns, reps=reps, iters=iters)
    n_reps = steps * unroll
    raw = {name: (med[name] - med["empty"]) * 1e6 / (n_reps * BODIES[name][1])
           for name in BODIES}
    results = net_ns(raw)
    rows, width = x.shape
    print(f"primitive costs, {rows} x {width} float32 block, {n_reps} reps "
          f"(empty kernel {med['empty']:.3f} ms) [{card}]:")
    for name, ns in results.items():
        tag = "" if ns >= FLOOR_NS else f"   [below the {FLOOR_NS} ns floor: folded or noise]"
        print(f"  {name:10s} {ns:8.2f} ns/op  (raw chain {raw[name]:8.2f}){tag}")
    for name in NO_COUNTERPART:
        print(f"  {name:10s} no counterpart (band fold)")
    add_ns = results["add"]
    if add_ns >= FLOOR_NS:
        print("  relative to add: "
              + ", ".join(f"{k} {v / add_ns:.2f}" for k, v in results.items()))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--unroll", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    card = common.require_card()
    measure(block(args.rows, args.width, "cuda"), steps=args.steps, unroll=args.unroll,
            iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
