"""The fused flagger's op inventory, run op for op on the card (K10).

Port of ``scripts/roofline_skeleton.py``.  The compute model prices the
exact flagger's least vector work as the sum of count x ns over an op
inventory (:func:`op_inventory`, from
``katsdpsigproc_tpu_torch/models/rfi/roofline.py``).  The skeleton
kernel (``csrc/roofline_skeleton.cu``) runs that inventory on dummy
amplitudes, with none of the flagger's masks, valid counts or halfway
corrections, on K1's machine: its run layout (``csrc/ff_runs.cuh``) at
K1's launch (1024 threads, K1's dynamic shared memory, one CTA per SM;
:func:`.fused_flagger.launch_config`), up to K1's channel limit.  So its
time prices K1's design: it is the floor of the K1 that runs, set against
K11's ``full`` (K1's own code) timed in the same rounds, and against the
model:

- skeleton ms ~ model ms: the floor is priced right, and K1's time above
  it is real headroom or real work beyond the floor;
- skeleton ms >> model ms: per-op costs do not add up at this occupancy;
- skeleton ms << model ms: a chain folded or the inventory overcounts.

The model (``models/rfi/roofline.py``, whose op inventory this tool
imports) is priced two ways, printed beside K10 and K11's ``full`` timed
in the same rounds: the shipped table (``prim_ns.json``) and K8
(:mod:`.prim_cost`) measured in the call at K1's launch.  Each of the
model's stages is
printed beside K11's measured cost of it: ``full`` less ``no_median``,
``no_rank`` and ``no_thresh``, and K11's ``skeleton`` for load + store.

Per row of C float32 amplitudes x (``skeleton_block`` :64-112; a channel
shift by d reads channel c + d, wrapped)::

  a    = sqrt(min(x, 3) + x)
  w    = a and its shifts by -half..half; the shifts by -half and
         -half + 1 are 3 and 5 in the upper half of the row
  dev  = rank `half` of w by the selection network - a
  r    = 0, then 32 rounds of r = count(dev < r) / 1024   (the rank carry)
  s    = min(dev, 3) + r
  flag = s > r, or a window-2, -4 or -8 ladder of s > 1.2 r
  acc  = flag at c or at any of the 11 channels before it, times 0.5
  out  = uint8(int32(acc)), which is 0 for every input

Because ``out`` is always 0, :func:`skeleton` can also return the rank
carry, and every check compares both (``flag_scale=1`` makes the dilated
flags themselves the output, for the card's checks).

Usage::

    python -m katsdpsigproc_tpu_torch.scripts.roofline_skeleton [--channels 32768]
        [--baselines 8064] [--width 13] [--iters 3] [--reps 5]
"""

import ctypes
import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..models.rfi import flagger_probe as fp, fused_flagger as ff, roofline
from ..models.rfi.roofline import op_inventory
from ..ops import rank as rank_ops
from ..utils import numerics, profiling
from . import common, prim_cost

RANK_ROUNDS = 32  # skeleton_block's fori_loop (:90)
FLAG_SCALE = 0.5  # skeleton_block :104
_C, _C2 = 3.0, 5.0

# Kernel launches since the count was last reset.  The wrapper adds one
# where it launches the kernel, and nowhere else.
launches = {"skeleton": 0}


@functools.lru_cache(maxsize=None)
def _library(width: int) -> ctypes.CDLL:
    from ..utils import kernels

    lib = kernels.load("roofline_skeleton", ["roofline_skeleton.cu"],
                       {"ff_network.h": ff._network_header(width)})
    lib.ff_max_channels.argtypes = []
    lib.ff_max_channels.restype = ctypes.c_int
    lib.ff_error_string.argtypes = [ctypes.c_int]
    lib.ff_error_string.restype = ctypes.c_char_p
    lib.rs_launch_config.argtypes = [ctypes.c_int] + ff._LAUNCH_CONFIG_OUT
    lib.rs_launch_config.restype = ctypes.c_int
    lib.rs_skeleton.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.rs_skeleton.restype = ctypes.c_int
    return lib


def launch_config(channels: int, width: int = 13) -> dict:
    """How the skeleton launches at `channels`: the keys of
    :func:`.fused_flagger.launch_config`, which it must equal."""
    lib = _library(width)
    return ff._query_launch_config(lib, lib.rs_launch_config, channels)


def _shift(x, d: int):
    """Channel c of the result is channel c + d of `x`, wrapped (``_shift_channels`` at h = 1)."""
    return torch.roll(x, -d, 1)


def skeleton_plain(amp, *, width: int = 13, flag_scale: float = FLAG_SCALE,
                   return_rank: bool = False):
    """The plain PyTorch version of K10, op for op as ``skeleton_block``."""
    half = width // 2
    a = numerics.sqrt_rn(torch.clamp(amp, max=_C) + amp)
    members = [a] + [_shift(a, d) for d in range(-half, half + 1) if d]
    upper = torch.arange(amp.shape[1], device=amp.device) >= amp.shape[1] // 2
    members[1] = torch.where(upper, _C, members[1])
    members[2] = torch.where(upper, _C2, members[2])
    rank_ops.apply_selection_network(members, rank_ops.selection_network(width, (half, half + 1)))
    dev = members[half] - a
    r = torch.zeros((amp.shape[0], 1), dtype=torch.float32, device=amp.device)
    for _ in range(RANK_ROUNDS):
        r = (dev < r).sum(1, keepdim=True, dtype=torch.float32) * (1.0 / 1024.0)
    s = torch.clamp(dev, max=_C) + r
    r12 = r * np.float32(1.2)
    flags = (s > r).to(torch.float32)
    for wlog in (1, 2, 3):
        lad = s
        for k in range(wlog):
            lad = lad + _shift(lad, 1 << k)
        flags = torch.maximum(flags, (lad > r12).to(torch.float32))
    acc = flags * np.float32(flag_scale)
    for wlog in (1, 2, 3):
        for k in range(wlog):
            acc = torch.maximum(acc, _shift(acc, -(1 << k)))
    out = acc.to(torch.int32).to(torch.uint8)
    return (out, r[:, 0]) if return_rank else out


def skeleton(amp, *, width: int = 13, flag_scale: float = FLAG_SCALE, return_rank: bool = False):
    """The skeleton over (rows, channels) float32 amplitudes (K10 on a CUDA tensor).

    Returns (rows, channels) uint8, and with `return_rank` also each row's
    rank carry, (rows,) float32.  `flag_scale` is the scale before the
    output's integer cast (0.5 in the JAX script, which makes the output
    0; 1 makes the output the dilated flags).  A row holds at least
    ``max(width, 12)`` channels.
    """
    if width % 2 != 1 or not 3 <= width <= fp.MAX_WIDTH:
        raise ValueError(f"width must be odd and in 3..{fp.MAX_WIDTH}, got {width}")
    if not isinstance(amp, torch.Tensor) or amp.ndim != 2 or amp.dtype != torch.float32:
        raise TypeError("amp must be a 2-D torch.float32 tensor")
    rows, channels = amp.shape
    if channels < max(width, 12):
        raise ValueError(f"the skeleton takes at least {max(width, 12)} channels, got {channels}")
    if amp.device.type == "cpu":
        return skeleton_plain(amp, width=width, flag_scale=flag_scale, return_rank=return_rank)
    if amp.device.type != "cuda":
        raise ValueError(f"unsupported device {amp.device}")
    if not amp.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous tensor")
    out = torch.empty((rows, channels), dtype=torch.uint8, device=amp.device)
    rank = torch.empty((rows,), dtype=torch.float32, device=amp.device) if return_rank else None
    if rows:
        with torch.cuda.device(amp.device):
            lib = _library(width)
            limit = lib.ff_max_channels()
            if channels > limit:
                raise ValueError(f"{channels} channels exceed K1's limit of {limit} channels")
            err = lib.rs_skeleton(amp.data_ptr(), out.data_ptr(),
                                  None if rank is None else rank.data_ptr(), rows, channels,
                                  ctypes.c_float(np.float32(flag_scale)),
                                  torch.cuda.current_stream(amp.device).cuda_stream)
        ff._raise_on(lib, err, "skeleton")
        launches["skeleton"] += 1
    return (out, rank) if return_rank else out


def ops_per_element(width: int = 13, n_windows: int = 4) -> int:
    """The inventory's operations per element (per visibility of the dump)."""
    return sum(count for _, _, count in op_inventory(width, n_windows))


def compute_roofline(baselines: int, channels: int, prim_table: Mapping[str, float], *,
                     width: int = 13, n_windows: int = 4, rows: int = 256) -> Dict[str, object]:
    """The inventory priced at `prim_table` (ns per op of a ``rows * 1024``-element block):
    :func:`..models.rfi.roofline.compute_roofline`."""
    return roofline.compute_roofline(baselines, channels, width=width, n_windows=n_windows,
                                     prim_table=prim_table, rows=rows)


def plausible(measured: Mapping[str, float]) -> Dict[str, object]:
    """A table of K8's measured costs, as :func:`..models.rfi.roofline.prim_ns`
    reads one: each at or above the floor, the defaults for the rest."""
    loaded = {k: v for k, v in measured.items()
              if k in roofline.DEFAULT_PRIM_NS and v >= roofline.MIN_PLAUSIBLE_NS}
    return {**roofline.DEFAULT_PRIM_NS, **loaded, "__measured_keys__": sorted(loaded)}


# The model's stages beside K11's measured stage costs (``full`` less the
# stand-in; ``skeleton``, K11's load + store).
_K11_STAGES = (("median", "no_median"), ("rank", "no_rank"), ("threshold", "no_thresh"))


def run(vis_t, *, width: int = 13, iters: int = 3, reps: int = 5, card: str = "",
        prim_block: Optional[torch.Tensor] = None, prim_steps: int = 512,
        prim_unroll: int = 16) -> Dict[str, object]:
    """Time the skeleton on the amplitudes of (rows, channels, 2) `vis_t` and
    set it against the model, priced two ways, and K11.

    K8's primitive costs are measured first, in this call, at K1's launch
    (:func:`.prim_cost.measure`, on `prim_block` when given, else on
    :func:`.prim_cost.default_block`).  K10 and K11's ``full``,
    ``no_median``, ``no_rank``, ``no_thresh`` and ``skeleton`` (K1's code)
    on `vis_t` are timed in the same rounds.  The model
    (:func:`..models.rfi.roofline.compute_roofline`) is priced by the
    shipped table and by K8, and each of its stages is printed beside
    K11's.  Returns the skeleton's median ms, the model's ms priced by K8
    and their ratio, K8's costs, ``full``'s ms, and per pricing the
    model's ms and stages.
    """
    amp = fp.amp_pairs(vis_t)
    prim = prim_cost.measure(
        prim_block if prim_block is not None else prim_cost.default_block(amp.device),
        steps=prim_steps, unroll=prim_unroll, iters=iters, reps=reps, card=card)
    fns = {"skeleton": functools.partial(skeleton, amp, width=width),
           **{v: functools.partial(fp.probe, vis_t, v, width=width)
              for v in ("full", "no_median", "no_rank", "no_thresh")},
           "k11 skeleton": functools.partial(fp.probe, vis_t, "skeleton", width=width)}
    med, samples = profiling.time_interleaved(fns, reps=reps, iters=iters)
    rows, channels = amp.shape
    ms = med["skeleton"]
    for name in fns:
        common.report(name, med[name], samples[name], card)
    print(f"skeleton: {ms:.3f} ms over {rows} rows x {channels} channels, one launch at K1's; "
          f"K11 full (K1's code) {med['full']:.3f} ms, skeleton / full = "
          f"{ms / med['full']:.3f} [{card}]")
    pricings = {"shipped table": roofline.prim_ns(), "K8 at K1's launch": plausible(prim)}
    models = {label: compute_roofline(rows, channels, table, width=width)
              for label, table in pricings.items()}
    k11 = {stage: med["full"] - med[v] for stage, v in _K11_STAGES}
    k11["load + store"] = med["k11 skeleton"]
    per_ms = rows * channels / prim_cost.NORM_ELEMS * 1e-6  # block ns -> dump ms
    stages = {label: {k: v * per_ms for k, v in m["stage_ns"].items()}
              for label, m in models.items()}
    labels = list(models)
    print("model ms a dump by stage, priced two ways, beside K11's measured stage costs "
          f"[{card}]:")
    print(f"  {'stage':12s}" + "".join(f"{label:>20s}" for label in labels) + f"{'K11':>12s}")
    for stage in list(stages[labels[0]]) + ["load + store"]:
        print(f"  {stage:12s}"
              + "".join(f"{stages[label].get(stage, float('nan')):20.3f}" for label in labels)
              + (f"{k11[stage]:12.3f}" if stage in k11 else f"{'':>12s}"))
    print(f"  {'model':12s}"
          + "".join(f"{models[label]['seconds_per_dump'] * 1e3:20.3f}" for label in labels)
          + f"{med['full']:12.3f}  (K11: full; K10 {ms:.3f})")
    for label in labels:
        print(f"  {label}: measured fraction {models[label]['prim_ns_measured']:.2f}; "
              + ", ".join(f"{k} {pricings[label][k]:.2f}" for k in roofline.DEFAULT_PRIM_NS))
    model_ms = models["K8 at K1's launch"]["seconds_per_dump"] * 1e3
    print(f"skeleton/model = {ms / model_ms:.3f} at K1's launch (~1: floor priced right; >>1: "
          f"costs not additive; <<1: chain folded / inventory overcounts); shipped table "
          f"{ms / (models['shipped table']['seconds_per_dump'] * 1e3):.3f}")
    return {"skeleton_ms": ms, "model_ms": model_ms, "ratio": ms / model_ms,
            "prim_ns": prim, "full_ms": med["full"],
            "models_ms": {label: m["seconds_per_dump"] * 1e3 for label, m in models.items()},
            "stages_ms": stages, "k11_stages_ms": k11}


def main(argv=None) -> None:
    ap = common.parser(__doc__)
    ap.add_argument("--width", type=int, default=13)
    args = ap.parse_args(argv)
    card = common.require_card()
    vis_t = common.dump_on_card(args.channels, args.baselines).transpose(0, 1).contiguous()
    run(vis_t, width=args.width, iters=args.iters, reps=args.reps, card=card)


if __name__ == "__main__":
    main()
