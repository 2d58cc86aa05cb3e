"""The yardstick's peaks and the least work of each measured kernel.

A kernel's roofline is the least time the card could take for one launch:
the larger of its bytes over the HBM rate and its operations over the
float32 instruction rate.  Both counts are per visibility and fixed by the
algorithm, not by how the program implements it, so they live here with
the benchmark and no change to the program moves them.

Peaks (one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit):

* :data:`HBM_BYTES_PER_S`, 3.35 TB/s of HBM3.
* :data:`F32_OPS_PER_S`, 33.5e12 float32 instructions a second: the
  published 67 TFLOP/s counts an FMA as two operations, and the flagger's
  operations (add, min, max, compare, select) are one instruction each.
"""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12

# Min/max operations of the pruned selection network that gives a window's
# two middle sorted ranks (width // 2 and width // 2 + 1), by window width:
# a compare-exchange counts 2, a one-sided min or max 1.  Frozen from the
# network the flagger's reference algorithm defines (the TPU package's
# ``ops/rank.py::selection_network``), so that the count cannot move with
# the program.
NETWORK_OPS = {
    3: 5, 5: 13, 7: 23, 9: 35, 11: 49, 13: 61, 15: 85, 17: 131, 19: 141, 21: 171,
    23: 187, 25: 211, 27: 227, 29: 257, 31: 275, 33: 373, 35: 383, 37: 423, 39: 447,
    41: 483, 43: 509, 45: 551, 47: 571, 49: 601, 51: 621, 53: 663, 55: 687, 57: 725,
    59: 751, 61: 793, 63: 817, 65: 1031,
}

# Rounds of the MAD noise's bitwise rank search over a float32's 31 value bits.
RANK_ROUNDS = 31


def k1_op_inventory(width: int, n_windows: int):
    """The least vector operations per visibility of the exact 1-D flagger.

    (stage, operations) pairs, the no-input-flags count (a lower bound
    where input flags are given):

    - amplitude: ``re * re + im * im`` (2) and a square root (1);
    - median: the window's ``width - 1`` shifted members, 2 edge parity
      fills, the selection network's min/max (:data:`NETWORK_OPS`) and the
      background subtract (1);
    - rank: ``RANK_ROUNDS + 1`` rounds of the MAD noise's search (the
      bitwise rounds and the zeros sweep) and 2 of halfway correction;
    - threshold: for each window w of 1, 2, 4, ...: log2 w ladder steps,
      each a shift and an add, log2 w dilation steps, each a shift and an
      or, a compare, and one noise scale in all;
    - output: the cast pair (2).
    """
    if width not in NETWORK_OPS:
        raise ValueError(f"no frozen selection-network count for width {width}")
    ladders = sum(w for w in range(n_windows))  # log2 of 1, 2, 4, ...
    return [
        ("amplitude", 2 + 1),
        ("median", (width - 1) + 2 + NETWORK_OPS[width] + 1),
        ("rank", RANK_ROUNDS + 1 + 2),
        ("threshold", 2 * ladders + (ladders + n_windows + 1) + ladders),
        ("output", 2),
    ]


def k1_ops_per_vis(width: int, n_windows: int) -> int:
    """Operations per visibility of :func:`k1_op_inventory` (144 at width 13, 4 windows)."""
    return sum(n for _, n in k1_op_inventory(width, n_windows))


# K1 reads each (re, im) float32 pair once and writes one flag byte.
K1_BYTES_PER_VIS = 8 + 1
# K5, the corner turn, reads and writes each (re, im) float32 pair once.
K5_BYTES_PER_VIS = 8 + 8


def k1_bound_s(n_vis: int, width: int, n_windows: int) -> float:
    """K1's least time for `n_vis` visibilities: bytes or operations, the larger."""
    return max(K1_BYTES_PER_VIS * n_vis / HBM_BYTES_PER_S,
               k1_ops_per_vis(width, n_windows) * n_vis / F32_OPS_PER_S)


def k5_bound_s(n_vis: int) -> float:
    """K5's least time for `n_vis` visibilities: it moves bytes and computes nothing."""
    return K5_BYTES_PER_VIS * n_vis / HBM_BYTES_PER_S
