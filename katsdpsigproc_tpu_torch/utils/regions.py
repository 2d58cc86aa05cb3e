"""Region copies with numpy-index syntax.

Port of ``katsdpsigproc_tpu/utils/regions.py`` (``canonical_region``,
``copy_region``, ``copy_region_donated``, ``get_region``,
``set_region``): rectangular sub-region transfers described by ``np.s_``
index expressions, with both regions checked to select the same shape and
dtype.

A tensor is mutable, so where the JAX functions return a new destination
array these write into `dest` in place (``copy_``), as the reference
library's ``DeviceArray.copy_region`` does, and return `dest`: a caller
written against the JAX API (``dest = copy_region(...)``) works unchanged.
Device-to-host copies slice on the device first, so only the region
travels.  The index dialect and the error contract are the JAX
package's:

- slices with positive strides, of length ``(stop - start) // stride``
  (the reference's truncating formula, which drops a ragged final element
  that numpy would include);
- integers (the axis is collapsed), negative values wrap;
- ``np.newaxis`` (inserts a length-1 axis into the selection);
- fewer indices than axes selects whole trailing axes;
- ``TypeError`` for a dtype mismatch or an invalid index type,
  ``ValueError`` for regions of different shapes, ``IndexError`` for
  out-of-range, empty or negative-stride selections.

A numpy array's dtype is compared as the torch dtype it maps to
(``float32`` to ``torch.float32``); a numpy dtype that torch lacks is a
``TypeError``.
"""

from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["canonical_region", "copy_region", "copy_region_donated",
           "get_region", "set_region"]

_Slice = Any  # int | slice | newaxis | tuple of same (np.s_ expression)


def canonical_region(region: _Slice, shape: Tuple[int, ...]):
    """Validate `region` against `shape`.

    Port of ``katsdpsigproc_tpu/utils/regions.py::canonical_region``.
    Returns ``(index, sel_shape)``: `index` is a tuple of ints and slices
    that selects the region by basic indexing (newaxis entries removed),
    and `sel_shape` is the shape of the selection (with the length-1 axes
    that newaxis inserts).
    """
    if not isinstance(region, tuple):
        region = (region,)
    index = []
    sel_shape = []
    axis = 0
    for ix in region:
        if ix is np.newaxis:
            sel_shape.append(1)
        elif isinstance(ix, slice):
            if axis >= len(shape):
                raise IndexError("Too many axes in index expression")
            start, stop, stride = ix.indices(shape[axis])
            if stride <= 0:
                raise IndexError("Only positive strides are supported")
            length = (stop - start) // stride
            if length <= 0:
                raise IndexError("Empty slice selection")
            index.append(slice(start, start + length * stride, stride))
            sel_shape.append(length)
            axis += 1
        elif isinstance(ix, (int, np.integer)) and not isinstance(ix, bool):
            if axis >= len(shape):
                raise IndexError("Too many axes in index expression")
            ix = int(ix)
            if ix < 0:
                ix += shape[axis]
            if not 0 <= ix < shape[axis]:
                raise IndexError("Index out of range")
            index.append(ix)
            axis += 1
        else:
            raise TypeError(f"Invalid type in slice: {type(ix)}")
    while axis < len(shape):
        index.append(slice(0, shape[axis], 1))
        sel_shape.append(shape[axis])
        axis += 1
    return tuple(index), tuple(sel_shape)


def _torch_dtype(x) -> torch.dtype:
    """The dtype of a tensor, or the torch dtype that a numpy array's maps to."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, dtype=x.dtype)).dtype


def _check_pair(src, dest, src_region, dest_region):
    if _torch_dtype(src) != _torch_dtype(dest):
        raise TypeError(f"dtype mismatch: {src.dtype} vs {dest.dtype}")
    src_index, src_sel = canonical_region(src_region, tuple(src.shape))
    dest_index, dest_sel = canonical_region(dest_region, tuple(dest.shape))
    if src_sel != dest_sel:
        raise ValueError(f"Source ({src_sel}) and destination ({dest_sel}) "
                         "regions select different shapes")
    return src_index, dest_index


def _check_tensor(x, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")


def copy_region(src: torch.Tensor, dest: torch.Tensor, src_region: _Slice,
                dest_region: _Slice) -> torch.Tensor:
    """Copy a region of `src` into a region of `dest`, in place; returns `dest`.

    Port of ``katsdpsigproc_tpu/utils/regions.py::copy_region``.  The two
    tensors may lie on different devices.  Where they share memory the
    region is read whole before it is written, as the JAX function's
    result would hold it.
    """
    _check_tensor(src, "src")
    _check_tensor(dest, "dest")
    src_index, dest_index = _check_pair(src, dest, src_region, dest_region)
    values = src[src_index]
    if values.untyped_storage().data_ptr() == dest.untyped_storage().data_ptr():
        values = values.clone()
    target = dest[dest_index]
    target.copy_(values.reshape(target.shape))
    return dest


def copy_region_donated(src: torch.Tensor, dest: torch.Tensor, src_region: _Slice,
                        dest_region: _Slice) -> torch.Tensor:
    """:func:`copy_region` under the JAX package's name for its in-place form.

    Port of ``katsdpsigproc_tpu/utils/regions.py::copy_region_donated``,
    which jits the copy with `dest` donated so that XLA can update it in
    place.  A tensor is updated in place already, so there is nothing to
    donate and nothing to cache: this is :func:`copy_region`, and `dest`
    stays valid after the call.
    """
    return copy_region(src, dest, src_region, dest_region)


def get_region(src: torch.Tensor, ary: np.ndarray, device_region: _Slice,
               ary_region: _Slice) -> None:
    """Copy a region of the tensor `src` into a region of the numpy array `ary`, in place.

    Port of ``katsdpsigproc_tpu/utils/regions.py::get_region``: the region
    is sliced on `src`'s device and only that sub-tensor is copied to the
    host.
    """
    _check_tensor(src, "src")
    src_index, ary_index = _check_pair(src, ary, device_region, ary_region)
    values = src[src_index].detach().cpu().numpy()
    ary[ary_index] = values.reshape(np.shape(ary[ary_index]))


def set_region(dest: torch.Tensor, ary: np.ndarray, device_region: _Slice,
               ary_region: _Slice) -> torch.Tensor:
    """Copy a region of the numpy array `ary` into a region of `dest`, in place; returns `dest`.

    Port of ``katsdpsigproc_tpu/utils/regions.py::set_region``: only the
    region is copied to `dest`'s device.
    """
    _check_tensor(dest, "dest")
    ary = np.asarray(ary)
    ary_index, dest_index = _check_pair(ary, dest, ary_region, device_region)
    target = dest[dest_index]
    values = torch.from_numpy(np.array(ary[ary_index], copy=True))
    target.copy_(values.reshape(target.shape))
    return dest
