"""Collective rank statistics and halo exchange over a mesh dim's ranks.

Port of ``katsdpsigproc_tpu/parallel/collectives.py`` (:22-162).  The
bitwise rank search of :mod:`..ops.rank` becomes an exact distributed
order statistic by replacing its local compare-count with an
``all_reduce`` SUM of the int32 counts over the ranks that share the data
axis, and its masked max with an ``all_reduce`` MAX: a few tiny
reductions a round, and no data ever gathered.

Where the JAX functions take the ``axis_name`` of a ``shard_map`` body,
these take the process group of the mesh dim (``mesh.get_group(name)``)
and are called by every rank of it on its local shard, in the same order
on every rank: each round's reduction is a collective.  Every reduction
works on a fresh tensor, since ``all_reduce`` writes its result in place.
"""

import math

import torch
import torch.distributed as dist

from ..ops import rank as rank_ops


def _all_reduce(local: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(local, op=op, group=group)
    return local


def collective_count(group):
    """A ``count_fn`` for :mod:`..ops.rank` whose counts are summed over `group`.

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::collective_count``.
    """

    def count(mask):
        return _all_reduce(torch.sum(mask, dim=-1, dtype=torch.int32), dist.ReduceOp.SUM, group)

    return count


def collective_max_below(group):
    """A ``max_below_fn`` whose local masked maxima are maxed over `group`.

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::collective_max_below``.
    Values at or above the limit (and NaN) are 0 before the reduction.
    """

    def max_below(values, limit):
        local = torch.amax(torch.where(values < limit[..., None], values, 0.0), dim=-1)
        return _all_reduce(local, dist.ReduceOp.MAX, group)

    return max_below


def collective_count_axis(group):
    """Axis-aware ``count_fn`` (straight layout, ``axis != -1``).

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::collective_count_axis``.
    """

    def count(mask, axis):
        return _all_reduce(torch.sum(mask, dim=axis, dtype=torch.int32), dist.ReduceOp.SUM,
                           group)

    return count


def collective_max_below_axis(group):
    """Axis-aware ``max_below_fn`` for the straight layout.

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::collective_max_below_axis``.
    """

    def max_below(values, limit, axis):
        local = torch.amax(torch.where(values < limit, values, 0.0), dim=axis)
        return _all_reduce(local, dist.ReduceOp.MAX, group)

    return max_below


def find_rank_float(values, target_rank, halfway, group, radix_bits: int = 4, axis: int = -1):
    """Distributed exact order statistic over the sharded data axis.

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::find_rank_float``.
    `values` is this rank's shard; the counts are summed over `group`, so
    every rank computes the same global result.  Radix-16 digits resolve
    4 bits a round: 8 rounds of reductions instead of 31.  ``axis``
    selects the locally sharded data axis: the default is the lane-major
    layout; any other axis runs the straight-layout search with no corner
    turn.
    """
    if axis % values.ndim != values.ndim - 1:
        return rank_ops.find_rank_float(
            values, target_rank, halfway, count_fn=collective_count_axis(group),
            max_below_fn=collective_max_below_axis(group), radix_bits=radix_bits, axis=axis)
    return rank_ops.find_rank_float(
        values, target_rank, halfway, count_fn=collective_count(group),
        max_below_fn=collective_max_below(group), radix_bits=radix_bits)


def median_non_zero(values, n_global, group):
    """Distributed median of the non-zero values along the sharded last axis.

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::median_non_zero``;
    `n_global` is the length of the whole (gathered) axis.
    """
    z = rank_ops.zeros(values, collective_count(group))
    rank2 = torch.as_tensor(n_global, dtype=torch.int32, device=values.device) + z
    return find_rank_float(values, rank2 // 2, (rank2 & 1) == 0, group)


def fmin(values, group):
    """Distributed NaN-ignoring min along the sharded last axis (+inf where all are NaN).

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::fmin``.
    """
    local = torch.amin(torch.where(torch.isnan(values), math.inf, values), dim=-1)
    return _all_reduce(local, dist.ReduceOp.MIN, group)


def fmax(values, group):
    """Distributed NaN-ignoring max along the sharded last axis (-inf where all are NaN).

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::fmax``.
    """
    local = torch.amax(torch.where(torch.isnan(values), -math.inf, values), dim=-1)
    return _all_reduce(local, dist.ReduceOp.MAX, group)


def percentile5(values, n_global: int, group):
    """Distributed [min, max, p25, p75, p50] with 'lower' interpolation, shape (5, ...).

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::percentile5``:
    equal to :func:`..ops.percentile.percentile5` on the gathered data,
    without gathering (positive data; NaN = absent).  One collective
    search resolves all three ranks.
    """
    n = int(n_global)
    targets = torch.tensor([(n - 1) // 4, (3 * (n - 1)) // 4, (n - 1) // 2], dtype=torch.int32,
                           device=values.device)
    vb = values[..., None, :].expand(values.shape[:-1] + (3, values.shape[-1]))
    p = find_rank_float(vb, targets, False, group)  # (..., 3)
    out = torch.stack([fmin(values, group), fmax(values, group), p[..., 0], p[..., 1],
                       p[..., 2]])
    return out.to(torch.float32)


def halo_exchange(x, h: int, group, pad_value=math.nan, axis: int = 0):
    """Extend the locally sharded `axis` of `x` with `h` entries from each neighbour.

    Port of ``katsdpsigproc_tpu/parallel/collectives.py::halo_exchange``.
    The left neighbour's last `h` entries go before, the right
    neighbour's first `h` after, by one ``batch_isend_irecv`` on the
    ring of `group`'s ranks; the shards at the global edges get
    `pad_value` there instead (the background filter wants NaN = absent;
    SumThreshold 0, which the caller crops).  A group of one rank only
    pads.
    """
    if h == 0:
        return x
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    size = x.shape[axis]
    tail = x.narrow(axis, size - h, h).contiguous()
    head = x.narrow(axis, 0, h).contiguous()
    pad = torch.full(tail.shape, pad_value, dtype=x.dtype, device=x.device)
    from_left, from_right = pad, pad
    if n > 1:
        left = dist.get_global_rank(group, (idx - 1) % n)
        right = dist.get_global_rank(group, (idx + 1) % n)
        recv_left, recv_right = torch.empty_like(tail), torch.empty_like(head)
        # Tag 0 carries tails rightwards, tag 1 heads leftwards, so that at
        # two ranks (left and right the same peer) the messages still match.
        ops = [dist.P2POp(dist.isend, tail, right, group, 0),
               dist.P2POp(dist.irecv, recv_left, left, group, 0),
               dist.P2POp(dist.isend, head, left, group, 1),
               dist.P2POp(dist.irecv, recv_right, right, group, 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if idx > 0:
            from_left = recv_left
        if idx < n - 1:
            from_right = recv_right
    return torch.cat([from_left, x, from_right], dim=axis)
