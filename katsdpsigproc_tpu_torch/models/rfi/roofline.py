"""Compute roofline of the exact fused RFI flagger on the card.

Port of ``katsdpsigproc_tpu/models/rfi/roofline.py``, with its names and
semantics.  K1 moves 9 B a visibility and does far more on-chip work than
that takes at the card's memory rate (PERF.md), so its speed of light is
the *algorithm's* least vector work times what each operation costs on the
machine K1 runs.  :func:`op_inventory` is that work: the least full-block
operations any exact implementation of the reference pipeline must do per
block (the width-13 windowed median, the 31-round bitwise rank search of
the MAD noise, the 4-window SumThreshold), fixed by the reference's
algorithm whatever implements it.  :func:`compute_roofline` prices it with
a table of ns per operation of a 262144-element float32 block.

The table (:func:`prim_ns`) is ``prim_ns.json`` beside this module,
measured on the card by ``python -m katsdpsigproc_tpu_torch.scripts.prim_cost
--emit-json``: K8's chains at K1's launch (1024 threads, K1's dynamic shared
memory, one CTA per SM, the run layout), each primitive executed as K1
executes it.  Keys it lacks, or holds below :data:`MIN_PLAUSIBLE_NS`, take
:data:`DEFAULT_PRIM_NS`.  Costs depend on the launch: refresh the table
whenever K1's launch or layout changes.
"""

import json
import os
from typing import Dict, List, Mapping, Optional, Tuple

from ...ops import rank as _rank_ops

# The card's time for one float32 instruction on every element of a
# 262144-element block: 262144 / 33.5e12 instructions a second (132 SMs x
# 128 lanes x 1.98 GHz, an add, min, max or compare one instruction a lane
# a clock) = 7.825 ns.
_NS_PER_INSTRUCTION = 262144 / 33.5e12 * 1e9

# Per-primitive cost in ns at a 262144-element float32 block, the card's
# defaults: the instructions one element of the primitive takes in the
# SASS of K8's chains at K1's launch (cuobjdump -sass of csrc/prim_cost.cu,
# which chip_smoke.py phase 2 summarises), times _NS_PER_INSTRUCTION.  A
# shared-memory load counts 4: the shared-memory pipe moves 32 words a
# clock an SM, a quarter of the 128 float32 lanes.
DEFAULT_PRIM_NS: Dict[str, float] = {
    # FADD (or FMNMX, FSEL): one instruction.
    "add": 1 * _NS_PER_INSTRUCTION,
    # FMNMX.NAN, K1's min.NaN.f32 / max.NaN.f32: one instruction.
    "minmax": 1 * _NS_PER_INSTRUCTION,
    # FSET.BF, which writes 1.0 or 0.0: one instruction.
    "cmp_f32": 1 * _NS_PER_INSTRUCTION,
    # A median member: one LDS from the padded row, 4 issue slots.
    "shift_ch": 4 * _NS_PER_INSTRUCTION,
    # One FADD into the thread's partial; the block reduction is per row.
    "reduce": 1 * _NS_PER_INSTRUCTION,
    # __fsqrt_rn: MUFU.RSQ, 2 FMUL and 2 FFMA, the range test (IADD3,
    # ISETP) and its branch, and a reconvergence pair: 10 instructions run
    # (the SASS holds 4 more, the call to the slow path the test skips).
    "sqrt": 10 * _NS_PER_INSTRUCTION,
    # One round of runs::mad_noise: FSETP and the count's select and add, 3
    # instructions a value; the block reduction is per row.
    "rank_round": 3 * _NS_PER_INSTRUCTION,
}

# Below this a chain measurement is an artifact, not a cost: one
# instruction on every element of a 262144-element block at K1's launch
# takes 262144 / (132 SMs x 128 float32 lanes) clocks at 1.98 GHz, 7.84 ns
# (rounded down).  scripts/prim_cost.FLOOR_NS is this value.
MIN_PLAUSIBLE_NS = 7.8

PRIM_JSON = os.path.join(os.path.dirname(__file__), "prim_ns.json")


def prim_ns(path: Optional[str] = None) -> Dict[str, float]:
    """The primitive-cost table: measured (prim_ns.json) over defaults.

    Only plausible measurements of known primitives override defaults:
    entries below :data:`MIN_PLAUSIBLE_NS`, unknown keys and the table's
    ``__card__`` and ``__launch__`` records are ignored.  ``__measured__``
    is the fraction of :data:`DEFAULT_PRIM_NS`'s primitives that carry a
    measurement and ``__measured_keys__`` which (both absent with pure
    defaults).  A missing or malformed file or value gives the defaults.
    """
    table = dict(DEFAULT_PRIM_NS)
    try:
        with open(path or PRIM_JSON) as f:
            raw = json.load(f)
        if not isinstance(raw, dict):
            raise ValueError(f"prim_ns table must be a JSON object, got {type(raw).__name__}")
        loaded = {k: float(v) for k, v in raw.items()
                  if k in table and float(v) >= MIN_PLAUSIBLE_NS}
        table.update(loaded)
        if loaded:
            table["__measured__"] = len(set(loaded) & set(DEFAULT_PRIM_NS)) / len(
                DEFAULT_PRIM_NS)
            table["__measured_keys__"] = sorted(set(loaded) & set(DEFAULT_PRIM_NS))
    except (OSError, ValueError, TypeError):
        # TypeError: float(None) or float(list) from a malformed value.
        pass
    return table


def op_inventory(width: int = 13, n_windows: int = 4,
                 rank_rounds: int = 31) -> List[Tuple[str, str, int]]:
    """Least full-block vector ops per block: (stage, primitive, count).

    As the reference's (width 13, 4 windows, no input flags):

    - amplitude: ``re² + im²`` (2 add-class) and a sqrt.
    - median: the window's ``width - 1`` shifted members (``shift_ch``),
      2 edge parity fills, the two-middle-ranks selection network of
      :func:`..ops.rank.selection_network` (a ``both`` comparator is a min
      and a max: 61 at width 13) and the background subtract.
    - rank: ``rank_rounds + 1`` rounds of the ``rank_round`` composite
      (the bitwise rounds and the zeros sweep) and 2 adds of halfway
      correction.
    - threshold: per window w of 1, 2, 4, ...: log2 w ladder steps (shift
      and add), a compare, log2 w dilation steps (shift and or), and one
      noise scale.
    - output: the cast pair, 2 ops.
    """
    half_ladders = sum(int(w).bit_length() - 1 for w in (2 ** i for i in range(n_windows)))
    net = _rank_ops.selection_network(width, (width // 2, width // 2 + 1))
    net_ops = sum(2 if mode == "both" else 1 for _, _, mode in net)
    return [
        ("amplitude", "add", 2),
        ("amplitude", "sqrt", 1),
        ("median", "shift_ch", width - 1),
        ("median", "add", 2),  # edge parity fills
        ("median", "minmax", net_ops),  # selection network min/max ops
        ("median", "add", 1),  # background subtract
        ("rank", "rank_round", rank_rounds + 1),  # rounds + zeros sweep
        ("rank", "add", 2),  # halfway correction
        ("threshold", "shift_ch", half_ladders * 2),  # ladder + dilation shifts
        ("threshold", "add", half_ladders + n_windows + 1),  # adds + compares + scale
        ("threshold", "add", half_ladders),  # dilation ors
        ("output", "add", 2),
    ]


def compute_roofline(baselines: int, channels: int,
                     width: int = 13, n_windows: int = 4,
                     prim_table: Optional[Mapping[str, float]] = None,
                     rows: int = 256) -> Dict[str, float]:
    """Algorithm speed-of-light for a (baselines × channels) dump.

    Returns seconds per dump, vis/s, the per-stage ns per block and the
    fraction of the inventory's primitives the table measured.  The table
    (default :func:`prim_ns`) holds ns per operation of a ``rows * 1024``
    element block; every visibility is one element of one block, so the
    dump's cost is the block's times the dump's elements over the block's.
    """
    table = dict(prim_table) if prim_table is not None else prim_ns()
    measured = float(table.pop("__measured__", 0.0))
    measured_keys = set(table.pop("__measured_keys__", ()))
    stage_ns: Dict[str, float] = {}
    used_prims = set()
    for stage, prim, count in op_inventory(width, n_windows):
        used_prims.add(prim)
        stage_ns[stage] = stage_ns.get(stage, 0.0) + count * table[prim]
    block_ns = sum(stage_ns.values())
    if measured_keys:
        # The measured fraction over the primitives the inventory prices.
        measured = len(measured_keys & used_prims) / len(used_prims)
    n_vis = baselines * channels
    s_per_dump = block_ns * n_vis / (rows * 1024.0) * 1e-9
    return {
        "seconds_per_dump": s_per_dump,
        "vis_per_second": n_vis / s_per_dump,
        "block_ns": block_ns,
        "stage_ns": stage_ns,
        "prim_ns_measured": measured,
    }
