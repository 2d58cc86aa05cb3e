"""Size rounding, padding and cropping.

Port of ``katsdpsigproc_tpu/utils/shapes.py`` (``divup``, ``roundup``,
``pad_to``, ``crop_to``).  The JAX module's TPU (8, 128) tile rule
(``LANES``, ``sublanes``, ``padded_shape``, ``pad_tiles``) has no
counterpart: a CUDA kernel masks its own ragged edges, so no buffer is
padded to a hardware tile.
"""

from typing import Sequence

import torch
import torch.nn.functional as F


def divup(x: int, y: int) -> int:
    """Ceiling division (``katsdpsigproc_tpu/utils/shapes.py::divup``)."""
    return (x + y - 1) // y


def roundup(x: int, y: int) -> int:
    """Round `x` up to a multiple of `y` (``katsdpsigproc_tpu/utils/shapes.py::roundup``)."""
    return divup(x, y) * y


def pad_to(x: torch.Tensor, shape: Sequence[int], pad_value=0) -> torch.Tensor:
    """Pad `x` at the end of each axis up to `shape` with `pad_value`.

    Port of ``katsdpsigproc_tpu/utils/shapes.py::pad_to``; returns `x`
    itself when no axis grows.
    """
    pads = [int(t) - int(s) for s, t in zip(x.shape, shape)]
    if not any(pads):
        return x
    # F.pad takes (last axis lo, hi, next-to-last lo, hi, ...)
    spec = []
    for p in reversed(pads):
        spec += [0, p]
    return F.pad(x, spec, value=pad_value)


def crop_to(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Slice the leading corner of `x` down to `shape` (inverse of :func:`pad_to`).

    Port of ``katsdpsigproc_tpu/utils/shapes.py::crop_to``; a view.
    """
    if tuple(x.shape) == tuple(shape):
        return x
    return x[tuple(slice(0, int(s)) for s in shape)]
