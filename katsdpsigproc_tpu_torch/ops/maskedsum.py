"""Masked column sum: per-column sum of rows weighted by a per-row mask.

Port of ``katsdpsigproc_tpu/ops/maskedsum.py``: each output column is
``sum_r mask[r] * src[r, c]``, optionally over amplitudes ``|src[r, c]|``.
It is a vector-matrix product, ``mask @ src``, left to ``torch.matmul``
as the JAX package leaves it to XLA (cuBLAS on the card, in full float32:
the port never enables TF32).  Nothing to tune, so the template has no
autotune and ``tuning`` is accepted for signature parity and ignored.
"""

from typing import Any, Mapping, Tuple

import torch

from ..utils import backend, numerics
from . import base


class MaskedSumTemplate:
    """Masked sums of the columns of a 2-D tensor.

    Parameters
    ----------
    context
        Placement context, or ``None`` for the best device.
    use_amplitudes
        If true, the amplitudes of the inputs are summed instead of the
        inputs themselves.
    tuning
        Accepted for signature parity and ignored.
    """

    def __init__(self, context, use_amplitudes: bool = False, tuning=None) -> None:
        self.context = context
        self.use_amplitudes = use_amplitudes

    def instantiate(self, command_queue=None, shape: Tuple[int, int] = (0, 0), allocator=None):
        return MaskedSum(self, shape)


class MaskedSum(base.Operation):
    """Concrete instance of :class:`MaskedSumTemplate`.

    .. rubric:: Slots

    **src** : (rows, cols) complex64 input
    **mask** : (rows,) float32 mask
    **dest** : (cols,) complex64, or float32 when ``use_amplitudes``
    """

    def __init__(self, template: MaskedSumTemplate, shape: Tuple[int, int]) -> None:
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.shape = tuple(shape)
        out_dtype = torch.float32 if template.use_amplitudes else torch.complex64
        self.slots["src"] = base.Slot(shape, torch.complex64, base.Direction.IN)
        self.slots["mask"] = base.Slot((shape[0],), torch.float32, base.Direction.IN)
        self.slots["dest"] = base.Slot((shape[1],), out_dtype, base.Direction.OUT)

    def _run(self, src, mask):
        return {"dest": maskedsum(src, mask, self.template.use_amplitudes)}

    def parameters(self) -> Mapping[str, Any]:
        return {"shape": self.shape, "use_amplitudes": self.template.use_amplitudes}


def maskedsum(src, mask, use_amplitudes: bool = False):
    """Functional masked column sum (a matrix-vector product).

    Port of ``katsdpsigproc_tpu/ops/maskedsum.py::maskedsum``.  `src` is
    complex64 (rows, cols) or planar (rows, cols, 2) float32; planar
    input without ``use_amplitudes`` gives planar (cols, 2) output.
    """
    if src.ndim == 3 and not src.is_complex():
        if use_amplitudes:
            amp = numerics.sqrt_rn(src[..., 0] * src[..., 0] + src[..., 1] * src[..., 1])
            return mask @ amp
        rows, cols = src.shape[0], src.shape[1]
        return (mask @ src.reshape(rows, cols * 2)).reshape(cols, 2)
    if use_amplitudes:
        return mask @ numerics.complex_abs(src)
    return mask.to(torch.complex64) @ src
