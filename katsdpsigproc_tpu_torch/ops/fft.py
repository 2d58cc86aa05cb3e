"""Batched N-D FFT operation.

Port of ``katsdpsigproc_tpu/ops/fft.py`` (``FftMode``, ``FftTemplate``,
``Fft``).  The JAX package leaves the transform to XLA; here it is
``torch.fft``, which is cuFFT on the card and pocketfft on the CPU.  The
template carries the shape and dtype contract: real-to-complex,
complex-to-real or complex-to-complex, in single or double precision,
over the last N axes, batched over the rest.

The transforms are unnormalised, cuFFT's convention: a forward then an
inverse transform scales by the number of transformed elements.  JAX
multiplies XLA's normalised inverse back up by that number; here the
inverse is asked for with ``norm="forward"``, which puts the whole
normalisation on the forward transform that this op never scales, so the
inverse is unscaled by construction.  Padded shapes are accepted and
recorded, as in JAX; the tensors an op takes and gives are the logical
ones.
"""

import enum
from typing import Any, Mapping, Optional, Tuple

import torch

from ..utils import backend
from . import base


class FftMode(enum.Enum):
    """Direction of the transform (``katsdpsigproc_tpu/ops/fft.py::FftMode``)."""

    FORWARD = enum.auto()
    INVERSE = enum.auto()


_VALID_COMBOS = {
    (torch.float32, torch.complex64): "r2c",
    (torch.complex64, torch.float32): "c2r",
    (torch.complex64, torch.complex64): "c2c",
    (torch.float64, torch.complex128): "r2c",
    (torch.complex128, torch.float64): "c2r",
    (torch.complex128, torch.complex128): "c2c",
}


class FftTemplate:
    r"""Operation template for a forward or inverse FFT.

    Port of ``katsdpsigproc_tpu/ops/fft.py::FftTemplate``.  The transform
    runs over the last `N` axes, the others batching arrays; the dtypes
    pick real-to-complex, complex-to-real or complex-to-complex, and in
    the last case the same template instantiates forward and inverse
    transforms.  For real<->complex transforms the complex side's last
    axis is :math:`\lfloor L/2\rfloor + 1`, where :math:`L` is the last
    element of `shape`.

    Parameters
    ----------
    context
        Placement context, or ``None`` for the best device.
    N
        Number of dimensions of the transform.
    shape
        Shape of the data (N or more dimensions); for real<->complex, the
        shape of the real side.
    dtype_src, dtype_dest
        Input and output dtypes (torch or numpy); the pair selects the kind.
    padded_shape_src, padded_shape_dest
        Recorded for API parity; batch axes must be unpadded, as in JAX.
    tuning
        Accepted for signature parity and ignored: nothing to tune.
    """

    def __init__(self, context, N: int, shape: Tuple[int, ...], dtype_src, dtype_dest,
                 padded_shape_src: Optional[Tuple[int, ...]] = None,
                 padded_shape_dest: Optional[Tuple[int, ...]] = None, tuning=None) -> None:
        dtype_src = base.torch_dtype(dtype_src)
        dtype_dest = base.torch_dtype(dtype_dest)
        kind = _VALID_COMBOS.get((dtype_src, dtype_dest))
        if kind is None:
            raise ValueError("Invalid combination of dtypes")
        if padded_shape_src is not None and len(padded_shape_src) != len(shape):
            raise ValueError("padded_shape_src and shape must have same length")
        if padded_shape_dest is not None and len(padded_shape_dest) != len(shape):
            raise ValueError("padded_shape_dest and shape must have same length")
        if padded_shape_src is not None and tuple(padded_shape_src[:-N]) != tuple(shape[:-N]):
            raise ValueError("Source must not be padded on batch dimensions")
        if padded_shape_dest is not None and tuple(padded_shape_dest[:-N]) != tuple(shape[:-N]):
            raise ValueError("Destination must not be padded on batch dimensions")
        self.context = context
        self.N = N
        self.shape = tuple(shape)
        self.kind = kind
        self.padded_shape_src = None if padded_shape_src is None else tuple(padded_shape_src)
        self.padded_shape_dest = None if padded_shape_dest is None else tuple(padded_shape_dest)
        self.dtype_src = dtype_src
        self.dtype_dest = dtype_dest
        if kind == "r2c":
            self.shape_src = self.shape
            self.shape_dest = self.shape[:-1] + (self.shape[-1] // 2 + 1,)
        elif kind == "c2r":
            self.shape_src = self.shape[:-1] + (self.shape[-1] // 2 + 1,)
            self.shape_dest = self.shape
        else:
            self.shape_src = self.shape
            self.shape_dest = self.shape

    def instantiate(self, command_queue=None, mode: FftMode = FftMode.FORWARD, allocator=None):
        return Fft(self, mode)


class Fft(base.Operation):
    """Concrete FFT operation (``katsdpsigproc_tpu/ops/fft.py::Fft``).

    .. rubric:: Slots

    **src** : input tensor
    **dest** : output tensor

    R2C transforms must use ``FftMode.FORWARD`` and C2R transforms
    ``FftMode.INVERSE``.
    """

    def __init__(self, template: FftTemplate, mode: FftMode) -> None:
        super().__init__(backend.context_device(template.context))
        self.template = template
        if template.kind == "r2c" and mode != FftMode.FORWARD:
            raise ValueError("R2C transform must use FftMode.FORWARD")
        if template.kind == "c2r" and mode != FftMode.INVERSE:
            raise ValueError("C2R transform must use FftMode.INVERSE")
        self.mode = mode
        self.slots["src"] = base.Slot(template.shape_src, template.dtype_src, base.Direction.IN)
        self.slots["dest"] = base.Slot(template.shape_dest, template.dtype_dest,
                                       base.Direction.OUT)

    def _run(self, src):
        n = self.template.N
        dims = tuple(range(src.ndim - n, src.ndim))
        lengths = self.template.shape[-n:]
        if self.template.kind == "r2c":
            out = torch.fft.rfftn(src, dim=dims)
        elif self.template.kind == "c2r":
            out = torch.fft.irfftn(src, s=lengths, dim=dims, norm="forward")
        elif self.mode == FftMode.FORWARD:
            out = torch.fft.fftn(src, dim=dims)
        else:
            out = torch.fft.ifftn(src, dim=dims, norm="forward")
        return {"dest": out.to(self.template.dtype_dest)}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "shape": self.template.shape,
            "N": self.template.N,
            "kind": self.template.kind,
            "mode": self.mode.name,
        }
