"""Rank-statistic library: exact order statistics on positive float32 data.

Port of ``katsdpsigproc_tpu/ops/rank.py``.  Medians and other order
statistics come from a **bitwise binary search over IEEE-754 bit
patterns**: positive floats order the same as their int32 encodings, so
31 rank-count rounds locate any order statistic exactly.  Each round is a
compare-and-sum over the data, batched over any leading axes; the
``count_fn``/``max_below_fn`` hooks let a caller replace the local
reductions with collective ones (the later ``torch.distributed`` port).

The selection-network generator (:func:`selection_network` and its
helpers) is pure Python/numpy and is carried over unchanged, because the
JAX module imports jax at its top.  The CUDA flagger kernel is generated
from these networks, so the port and the reference run the same
comparators in the same order.

All functions treat NaN as "absent" (NaN comparisons are false) and
operate along the last axis unless an ``axis`` is given.
"""

import functools
from typing import Callable, Optional

import numpy as np
import torch


def _default_count(mask) -> torch.Tensor:
    return torch.sum(mask, dim=-1, dtype=torch.int32)


def batcher_pairs(n: int):
    """Compare-exchange pairs of a Batcher odd-even mergesort network.

    48 exchanges for n=13.  Straight-line min/max vector code — the
    reference's rank-maintained window (background_median_filter.mako:
    130-145) recast for SIMD; used by both the CUDA flagger kernel and
    the tensor windowed-median engine.
    """
    pairs = []
    t = 1
    while t < n:
        t *= 2

    def merge(lo, cnt, r):
        step = r * 2
        if step < cnt:
            merge(lo, cnt, step)
            merge(lo + r, cnt, step)
            for i in range(lo + r, lo + cnt - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, cnt):
        if cnt > 1:
            m = cnt // 2
            sort(lo, m)
            sort(lo + m, m)
            merge(lo, cnt, 1)

    sort(0, t)
    return [(i, j) for (i, j) in pairs if j < n]


# Optimal-size sorting networks where Batcher is not optimal (Batcher's
# odd-even mergesort gives 48 comparators at n=13 vs the known-optimal 45;
# for the other window sizes in use Batcher already matches the optimum).
# Source construction: the standard size-45 network for 13 inputs from the
# sorting-network literature; verified exhaustively by the 0-1 principle
# before use (_selection_network_cached).
_OPTIMAL_SORT = {
    13: [
        (0, 12), (1, 10), (2, 9), (3, 7), (5, 11), (6, 8),
        (1, 6), (2, 3), (4, 11), (7, 9), (8, 10),
        (0, 4), (1, 2), (3, 6), (7, 8), (9, 10), (11, 12),
        (4, 6), (5, 9), (8, 11), (10, 12),
        (0, 5), (3, 8), (4, 7), (6, 11), (9, 10),
        (0, 1), (2, 5), (6, 9), (7, 8), (10, 11),
        (1, 3), (2, 4), (5, 6), (9, 10),
        (1, 2), (3, 4), (5, 7), (6, 8),
        (2, 3), (4, 5), (6, 7), (8, 9),
        (3, 4), (5, 6),
    ],
}


def _cone_prune(pairs, outputs):
    """Backward cone-of-influence pruning of a comparator network.

    A comparator output wire that no later comparator reads and that is
    not a requested output carries a dead value, so that side of the
    exchange is elided (kind ``"min"``/``"max"``) or the comparator is
    dropped entirely.
    """
    live = set(outputs)
    kept = []
    for i, j in reversed(pairs):
        min_live, max_live = i in live, j in live
        if not (min_live or max_live):
            continue
        kind = "both" if (min_live and max_live) else ("min" if min_live else "max")
        kept.append((i, j, kind))
        live.add(i)
        live.add(j)
    return kept[::-1]


def _verify_01(n: int, net, outputs) -> bool:
    """Exhaustive 0-1-principle check that `net` selects `outputs` exactly.

    On binary inputs min = AND and max = OR, so each wire's final value is
    a monotone boolean function of the inputs; agreement with the sorted
    ranks on all ``2**n`` binary vectors implies agreement with the rank
    statistics on all reals (min/max commute with thresholding).
    """
    cases = np.arange(1 << n, dtype=np.uint32)
    wires = [((cases >> i) & 1).astype(bool) for i in range(n)]
    ones = sum(w.astype(np.int32) for w in wires)
    for i, j, kind in net:
        lo = wires[i] & wires[j]
        hi = wires[i] | wires[j]
        if kind != "max":
            wires[i] = lo
        if kind != "min":
            wires[j] = hi
    # sorted-ascending position k is 1 iff at least n - k inputs are 1
    return all(np.array_equal(wires[k], ones >= n - k) for k in outputs)


def _greedy_prune(n: int, net, outputs):
    """Demote/remove comparators while the 0-1 check still passes.

    Cone pruning is sound but not tight: a comparator inside the cone can
    still be useless because the wires it touches are already ordered on
    every input that matters.  Exhaustive re-verification per trial is
    cheap at window sizes (2^13 binary cases as vectorized bool ops), and
    the result is correct by construction — every accepted demotion ships
    only after the full network re-passes :func:`_verify_01`.
    """
    net = [list(c) for c in net]
    changed = True
    while changed:
        changed = False
        for idx in range(len(net) - 1, -1, -1):
            i, j, kind = net[idx]
            trials = [None] + (["min", "max"] if kind == "both" else [])
            for t in trials:
                if t is None:
                    cand = [tuple(c) for k, c in enumerate(net) if k != idx]
                else:
                    cand = [tuple(c) if k != idx else (i, j, t) for k, c in enumerate(net)]
                if _verify_01(n, cand, outputs):
                    if t is None:
                        del net[idx]
                    else:
                        net[idx][2] = t
                    changed = True
                    break
    return [tuple(c) for c in net]


# Best-known networks for the hot configurations, found by a randomized
# perturb-and-greedy-prune search (insert random comparators, re-prune in a
# random order, keep improvements — every candidate re-verified by the 0-1
# principle).  Greedy pruning alone bottoms at 67/78 ops for these; the
# annealed networks are re-verified at load below, so an invalid entry
# cannot ship.
_ANNEALED_SELECT = {
    # parity-fill median: the two middle ranks of a width-13 window (61 ops)
    (13, (6, 7)): [
        (0, 8, 'both'), (0, 12, 'both'), (4, 11, 'both'), (5, 12, 'both'),
        (3, 7, 'both'), (1, 10, 'both'), (2, 9, 'both'), (6, 8, 'both'),
        (1, 6, 'both'), (7, 9, 'both'), (8, 10, 'both'), (2, 3, 'both'),
        (0, 4, 'both'), (3, 6, 'both'), (7, 8, 'both'), (9, 10, 'min'),
        (0, 3, 'max'), (8, 9, 'both'), (11, 12, 'both'), (1, 2, 'max'),
        (8, 12, 'min'), (4, 6, 'both'), (4, 11, 'both'), (6, 9, 'min'),
        (8, 11, 'both'), (3, 8, 'both'), (4, 7, 'max'), (3, 5, 'max'),
        (5, 7, 'both'), (6, 11, 'min'), (6, 8, 'both'), (2, 5, 'max'),
        (5, 7, 'both'), (7, 8, 'min'), (5, 6, 'max'), (6, 7, 'both'),
    ],
    # masked median general path: the lower half of a width-13 window (72 ops)
    (13, (0, 1, 2, 3, 4, 5, 6)): [
        (1, 10, 'both'), (2, 9, 'both'), (3, 7, 'both'), (0, 4, 'both'),
        (5, 11, 'both'), (6, 8, 'both'), (8, 10, 'both'), (2, 3, 'both'),
        (1, 6, 'both'), (7, 9, 'both'), (1, 2, 'both'), (3, 6, 'both'),
        (7, 8, 'both'), (9, 10, 'min'), (8, 9, 'both'), (0, 12, 'both'),
        (8, 11, 'both'), (11, 12, 'min'), (8, 11, 'both'), (4, 7, 'both'),
        (0, 5, 'both'), (3, 8, 'both'), (6, 11, 'min'), (7, 9, 'min'),
        (2, 5, 'both'), (0, 1, 'both'), (7, 8, 'both'), (1, 3, 'both'),
        (2, 4, 'both'), (1, 2, 'both'), (3, 4, 'both'), (5, 7, 'both'),
        (4, 6, 'both'), (6, 8, 'min'), (4, 5, 'both'), (2, 3, 'both'),
        (6, 7, 'min'), (3, 4, 'both'), (5, 6, 'both'),
    ],
}


@functools.lru_cache(maxsize=None)
def _selection_network_cached(n: int, outputs):
    annealed = _ANNEALED_SELECT.get((n, outputs))
    if annealed is not None and _verify_01(n, annealed, outputs):
        return annealed
    pairs = _OPTIMAL_SORT.get(n, None) or batcher_pairs(n)
    net = _cone_prune(pairs, outputs)
    if n <= 16:  # 2^n exhaustive verification stays cheap
        # Guard the hand-entered _OPTIMAL_SORT tables the same way the
        # annealed entries are guarded: verify the cone-pruned base before
        # greedy pruning, falling back to Batcher (correct by construction)
        # if a table typo ever ships an invalid network.
        if not _verify_01(n, net, outputs):
            net = _cone_prune(batcher_pairs(n), outputs)
        net = _greedy_prune(n, net, outputs)
    return net


def selection_network(n: int, outputs):
    """Smallest-found min/max network computing sorted ranks `outputs` of `n`.

    Returns ``[(i, j, kind)]`` in execution order with kind ``"both"`` (full
    compare-exchange), ``"min"`` (only ``w[i] = min(w[i], w[j])``) or
    ``"max"`` (only ``w[j] = max(w[i], w[j])``).  Construction: a
    best-known annealed network from :data:`_ANNEALED_SELECT` when one
    exists for ``(n, outputs)`` (re-verified by the 0-1 principle at
    load), else an optimal-size sorting network (Batcher where that is
    already optimal) with backward cone-of-influence pruning followed by
    greedy 0-1-verified demotion/removal of every remaining comparator
    (:func:`_greedy_prune` — each step re-proves the whole network on all
    ``2**n`` binary inputs, so every result is exact by construction).
    For the fused flagger's parity-fill median (outputs ``{6, 7}`` at
    width 13) the annealed network is 61 vector ops vs 96 for the full
    sort, 73 cone-pruned and 67 greedy; the masked median's lower half
    (outputs ``0..6``) is 72 vs 78.  Results are cached per
    ``(n, outputs)``.
    """
    return list(_selection_network_cached(n, tuple(outputs)))


def apply_selection_network(arrs, net):
    """Run a :func:`selection_network` over a list of tensors, in place.

    ``torch.minimum``/``torch.maximum`` propagate NaN exactly as
    ``jnp.minimum``/``jnp.maximum`` do
    (``katsdpsigproc_tpu/ops/rank.py::apply_selection_network``).
    """
    for i, j, kind in net:
        a, b = arrs[i], arrs[j]
        if kind != "max":
            arrs[i] = torch.minimum(a, b)
        if kind != "min":
            arrs[j] = torch.maximum(a, b)
    return arrs


def rank(values, limit, count_fn: Callable = _default_count):
    """Count elements strictly less than `limit` (NaN-safe).

    Port of ``katsdpsigproc_tpu/ops/rank.py::rank``.  `values` has shape
    (..., N); `limit` has shape (...,) or is scalar; returns int32 (...,).
    """
    if isinstance(limit, torch.Tensor) and limit.ndim:
        limit = limit[..., None]
    return count_fn(values < limit)


def zeros(values, count_fn: Callable = _default_count):
    """Count zero elements (``katsdpsigproc_tpu/ops/rank.py::zeros``)."""
    return count_fn(values == 0)


def _default_count_axis(mask, axis):
    return torch.sum(mask, dim=axis, dtype=torch.int32)


def _digit_shifts(radix_bits: int):
    """(shift, width) of each digit over the 31 value bits, top digit first.

    Bit 31 is the sign, always 0; the top digit takes ``31 % radix_bits``
    bits when ``radix_bits`` does not divide 31.
    """
    shifts = []
    pos = 31
    while pos > 0:
        width = pos % radix_bits or radix_bits
        pos -= width
        shifts.append((pos, width))
    return shifts


def _find_rank_float_axis(values, target_rank, halfway, axis, radix_bits,
                          count_fn=_default_count_axis, max_below_fn=None):
    """`find_rank_float` along an arbitrary data axis.

    Port of ``katsdpsigproc_tpu/ops/rank.py::_find_rank_float_axis``.
    Candidate counts carry the candidate index on a new trailing axis, so
    the data axis never moves.  Custom hooks follow the AXIS-AWARE
    contract: ``count_fn(mask, axis)`` reduces `axis` of a values-shaped
    bool mask (which may carry an extra trailing candidate axis, never
    reduced); ``max_below_fn(values, limit, axis)`` returns the largest
    value strictly below `limit` along `axis` (0 if none), with `limit`
    already expanded to broadcast against `values`.
    """
    batch_shape = values.shape[:axis] + values.shape[axis + 1:]
    dev = values.device
    target_b = torch.as_tensor(target_rank, dtype=torch.int32, device=dev).broadcast_to(
        batch_shape)
    bits = values.view(torch.int32)
    cur = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    for shift, width in _digit_shifts(radix_bits):
        j = torch.arange(1, 1 << width, dtype=torch.int32, device=dev)
        rel = (bits - cur.unsqueeze(axis)) >> shift  # values.shape
        counts = count_fn(rel[..., None] < j, axis)  # batch + (k,)
        digit = torch.sum(counts <= target_b[..., None], dim=-1, dtype=torch.int32)
        cur = cur | (digit << shift)
    result = cur.view(torch.float32)

    below = values < result.unsqueeze(axis)
    r = count_fn(below, axis)
    if max_below_fn is None:
        prev = torch.amax(torch.where(below, values, 0.0), dim=axis)
    else:
        prev = max_below_fn(values, result.unsqueeze(axis), axis)
    halfway_b = torch.as_tensor(halfway, device=dev).broadcast_to(batch_shape)
    return torch.where(halfway_b & (r == target_b), (result + prev) * 0.5, result)


def find_rank_float(
    values,
    target_rank,
    halfway,
    count_fn: Callable = _default_count,
    max_below_fn: Optional[Callable] = None,
    radix_bits: int = 1,
    unroll: bool = True,
    axis: int = -1,
):
    """Exact order statistic of positive float32 data via bitwise radix search.

    Port of ``katsdpsigproc_tpu/ops/rank.py::find_rank_float``.  Returns
    the value with 0-based rank `target_rank` (the largest bit pattern
    whose strict-rank is <= `target_rank`).  When `halfway` is true and
    the element of rank `target_rank` is distinct from its predecessor,
    returns the average of ranks `target_rank` and ``target_rank - 1``.
    Each round resolves a ``radix_bits``-wide digit by counting against
    the ``2**radix_bits - 1`` candidate prefixes at once; every radix
    gives the bit-identical result.  ``unroll`` is accepted and ignored:
    the JAX flag chooses between two traced forms of one loop, and eager
    PyTorch has only one.

    Parameters
    ----------
    values
        (..., N) positive float32 (NaN = absent).  The search works on
        ``values.view(torch.int32)``.
    target_rank
        (...,) or scalar int.
    halfway
        (...,) or scalar bool.
    count_fn
        Maps a (..., N) bool mask to (...,) int32 counts (also called with
        an extra candidate axis: (..., K, N) -> (..., K)).  For
        ``axis != -1`` the contract is axis-aware instead:
        ``count_fn(mask, axis)``.
    max_below_fn
        Maps (values, limit) to the largest value strictly below `limit`
        (0 if none); defaults to a local masked max.  For ``axis != -1``:
        ``max_below_fn(values, limit, axis)`` with `limit` pre-expanded.
    radix_bits
        Bits resolved per data sweep (1 is the reference's binary search).
    axis
        The data axis.
    """
    del unroll
    values = torch.as_tensor(values)
    if axis % values.ndim != values.ndim - 1:
        kw = {}
        if count_fn is not _default_count:
            kw["count_fn"] = count_fn
        if max_below_fn is not None:
            kw["max_below_fn"] = max_below_fn
        return _find_rank_float_axis(
            values, target_rank, halfway, axis % values.ndim, radix_bits, **kw)
    batch_shape = values.shape[:-1]
    dev = values.device
    target_b = torch.as_tensor(target_rank, dtype=torch.int32, device=dev).broadcast_to(
        batch_shape)
    # v < cur|(j<<s)  <=>  (bits(v) - cur) >> s < j: the resolved digits of
    # cur sit above s, and the arithmetic shift floors v < cur below every j.
    bits = values.view(torch.int32)
    cur = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    for shift, width in _digit_shifts(radix_bits):
        j = torch.arange(1, 1 << width, dtype=torch.int32, device=dev)  # (k,)
        rel = (bits - cur[..., None]) >> shift  # (..., N)
        counts = count_fn(rel[..., None, :] < j[:, None])  # (..., k)
        # counts are non-decreasing in j, so the admissible j's form a
        # prefix and the chosen digit is their count.
        digit = torch.sum(counts <= target_b[..., None], dim=-1, dtype=torch.int32)
        cur = cur | (digit << shift)
    result = cur.view(torch.float32)

    # Halfway correction: if result's strict rank equals the target, the
    # predecessor is a distinct value; average with it.
    below = values < result[..., None]
    r = count_fn(below)
    if max_below_fn is None:
        # NaN < result is False, so NaNs drop out to 0 (positive data only).
        prev = torch.amax(torch.where(below, values, 0.0), dim=-1)
    else:
        prev = max_below_fn(values, result)
    halfway_b = torch.as_tensor(halfway, device=dev).broadcast_to(batch_shape)
    return torch.where(halfway_b & (r == target_b), (result + prev) * 0.5, result)


def fmin(values, reduce_fn: Optional[Callable] = None):
    """Smallest non-NaN value, or NaN if none.

    Port of ``katsdpsigproc_tpu/ops/rank.py::fmin``.
    """
    masked = torch.where(torch.isnan(values), torch.inf, values)
    result = torch.amin(masked, dim=-1) if reduce_fn is None else reduce_fn(masked, "min")
    return torch.where(result == torch.inf, torch.nan, result)


def fmax(values, reduce_fn: Optional[Callable] = None):
    """Largest non-NaN value, or NaN if none.

    Port of ``katsdpsigproc_tpu/ops/rank.py::fmax``.
    """
    masked = torch.where(torch.isnan(values), -torch.inf, values)
    result = torch.amax(masked, dim=-1) if reduce_fn is None else reduce_fn(masked, "max")
    return torch.where(result == -torch.inf, torch.nan, result)


def median_non_zero(values, n=None, count_fn: Callable = _default_count,
                    radix_bits: int = 4, unroll: bool = True, axis: int = -1):
    """Median of the non-zero values (positive float32; NaN = absent).

    Port of ``katsdpsigproc_tpu/ops/rank.py::median_non_zero``.  `n` is
    the count of present (non-NaN) elements; defaults to the length of
    `axis`.  With ``z`` zeros among ``n`` values, the median of the
    ``n - z`` non-zeros has strict-rank target ``(n + z) // 2``, averaged
    halfway when ``n - z`` is even, which matches ``np.median`` on the
    non-zero subset.  ``unroll`` is accepted and ignored, as in
    :func:`find_rank_float`.
    """
    del unroll
    values = torch.as_tensor(values)
    if n is None:
        n = values.shape[axis]
    if axis % values.ndim != values.ndim - 1:
        z = torch.sum(values == 0, dim=axis, dtype=torch.int32)
    else:
        z = zeros(values, count_fn)
    rank2 = torch.as_tensor(n, dtype=torch.int32, device=values.device) + z
    return find_rank_float(values, rank2 // 2, (rank2 & 1) == 0, count_fn,
                           radix_bits=radix_bits, axis=axis)
