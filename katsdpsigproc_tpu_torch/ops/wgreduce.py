"""Reduction-operator library: named reductions and prefix scans.

Port of ``katsdpsigproc_tpu/ops/wgreduce.py``.  A :class:`ReduceOp` is a
named commutative operator (combine function, identity, NaN semantics)
shared by :mod:`.reduce` (``HReduce``); :func:`reduce` and :func:`scan`
apply one along an axis.

* ``plus``, ``max``, ``min``: NaN propagates through ``max``/``min``;
  ``fmax``/``fmin`` ignore NaN and give NaN only where every value is NaN.
* A user-defined operator's scan follows the odd/even recursion of
  ``jax.lax.associative_scan``, as the JAX package's does.  A ``plus``
  scan is ``torch.cumsum``, whose additions pair up in another order
  than XLA's; ``max``/``min`` scans are exact in any order.
* A user-defined operator's reduce is a pairwise tree over the axis,
  padded with the identity.
"""

from dataclasses import dataclass
from typing import Callable

import torch

from .base import torch_dtype


@dataclass(frozen=True)
class ReduceOp:
    """A commutative reduction operator (``katsdpsigproc_tpu/ops/wgreduce.py::ReduceOp``)."""

    name: str
    combine: Callable
    identity_for: Callable  # torch.dtype -> identity scalar tensor

    def identity(self, dtype):
        return self.identity_for(torch_dtype(dtype))


def _lowest(dt: torch.dtype):
    info = torch.finfo(dt) if dt.is_floating_point else torch.iinfo(dt)
    return torch.tensor(info.min, dtype=dt)


def _highest(dt: torch.dtype):
    info = torch.finfo(dt) if dt.is_floating_point else torch.iinfo(dt)
    return torch.tensor(info.max, dtype=dt)


def _nan_ignoring(pick: Callable) -> Callable:
    def combine(a, b):
        return torch.where(torch.isnan(a), b, torch.where(torch.isnan(b), a, pick(a, b)))

    return combine


#: a + b
plus = ReduceOp("plus", lambda a, b: a + b, lambda dt: torch.zeros((), dtype=dt))
#: max(a, b); NaN propagates
max_ = ReduceOp("max", torch.maximum, _lowest)
#: min(a, b); NaN propagates
min_ = ReduceOp("min", torch.minimum, _highest)
#: NaN-ignoring max
fmax = ReduceOp("fmax", _nan_ignoring(torch.maximum),
                lambda dt: torch.tensor(float("nan"), dtype=dt))
#: NaN-ignoring min
fmin = ReduceOp("fmin", _nan_ignoring(torch.minimum),
                lambda dt: torch.tensor(float("nan"), dtype=dt))

BY_NAME = {op.name: op for op in (plus, max_, min_, fmax, fmin)}


def _tree_reduce(values, op: ReduceOp, axis: int):
    """Pairwise fold along `axis`, padding an odd length with the identity."""
    while values.shape[axis] > 1:
        n = values.shape[axis]
        if n % 2:
            pad_shape = list(values.shape)
            pad_shape[axis] = 1
            ident = op.identity(values.dtype).to(values.device).expand(pad_shape)
            values = torch.cat([values, ident], dim=axis)
            n += 1
        values = op.combine(values.narrow(axis, 0, n // 2), values.narrow(axis, n // 2, n // 2))
    if values.shape[axis] == 0:
        shape = list(values.shape)
        del shape[axis]
        return op.identity(values.dtype).to(values.device).expand(shape).clone()
    return values.squeeze(axis)


def reduce(values, op: ReduceOp, axis=-1):
    """Reduce `values` along `axis` with `op` (``katsdpsigproc_tpu/ops/wgreduce.py::reduce``)."""
    axis %= values.ndim
    if op.name == "plus":
        return torch.sum(values, dim=axis)
    if op.name == "max":
        return torch.amax(values, dim=axis)
    if op.name == "min":
        return torch.amin(values, dim=axis)
    if op.name in ("fmax", "fmin"):
        nan = torch.isnan(values)
        if op.name == "fmax":
            result = torch.amax(torch.where(nan, -torch.inf, values), dim=axis)
        else:
            result = torch.amin(torch.where(nan, torch.inf, values), dim=axis)
        return torch.where(nan.all(dim=axis), torch.nan, result).to(values.dtype)
    return _tree_reduce(values, op, axis)


def _interleave(even, odd, axis: int):
    """even[0], odd[0], even[1], odd[1], ... along `axis` (len(even) - len(odd) in {0, 1})."""
    n = even.shape[axis] + odd.shape[axis]
    shape = list(even.shape)
    shape[axis] = n
    out = torch.empty(shape, dtype=even.dtype, device=even.device)
    idx = [slice(None)] * even.ndim
    idx[axis] = slice(0, n, 2)
    out[tuple(idx)] = even
    idx[axis] = slice(1, n, 2)
    out[tuple(idx)] = odd
    return out


def _associative_scan(combine: Callable, values, axis: int):
    """Inclusive scan by the odd/even recursion of ``jax.lax.associative_scan``."""
    n = values.shape[axis]
    if n < 2:
        return values

    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]

    reduced = combine(sl(values, 0, -1, 2), sl(values, 1, None, 2))
    odd = _associative_scan(combine, reduced, axis)
    if n % 2 == 0:
        even = combine(sl(odd, 0, -1), sl(values, 2, None, 2))
    else:
        even = combine(odd, sl(values, 2, None, 2))
    even = torch.cat([sl(values, 0, 1), even], dim=axis)
    return _interleave(even, odd, axis)


def scan(values, op: ReduceOp, axis=-1, reverse: bool = False, exclusive: bool = False):
    """Inclusive (or exclusive) prefix scan of `values` along `axis` with `op`.

    Port of ``katsdpsigproc_tpu/ops/wgreduce.py::scan``.  ``exclusive``
    shifts the inclusive scan by one and fills the vacated end with the
    operator's identity; ``reverse`` scans from the far end.
    """
    axis %= values.ndim
    n = values.shape[axis]
    if exclusive:
        inclusive = scan(values, op, axis=axis, reverse=reverse)
        pad_shape = list(values.shape)
        pad_shape[axis] = 1
        ident = op.identity(values.dtype).to(values.device).expand(pad_shape)
        if reverse:
            return torch.cat([inclusive.narrow(axis, 1, n - 1), ident], dim=axis)
        return torch.cat([ident, inclusive.narrow(axis, 0, n - 1)], dim=axis)
    if reverse:
        return torch.flip(scan(torch.flip(values, [axis]), op, axis=axis), [axis])
    if op.name == "plus":
        return torch.cumsum(values, dim=axis)
    if op.name == "max":
        return torch.cummax(values, dim=axis).values
    if op.name == "min":
        return torch.cummin(values, dim=axis).values
    if op.name in ("fmax", "fmin"):
        sentinel = -torch.inf if op.name == "fmax" else torch.inf
        masked = torch.where(torch.isnan(values), sentinel, values)
        cum = (torch.cummax if op.name == "fmax" else torch.cummin)(masked, dim=axis).values
        return torch.where(cum == sentinel, torch.nan, cum).to(values.dtype)
    return _associative_scan(op.combine, values, axis)
