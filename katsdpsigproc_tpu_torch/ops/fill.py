"""Fill a tensor with a constant value.

Port of ``katsdpsigproc_tpu/ops/fill.py`` (``FillTemplate``/``Fill``).
A fill is one ``torch.full``: there is nothing to tune, so the template
has no autotune and ``tuning`` is accepted for signature parity and
ignored.  The operation fills exactly the logical shape.
"""

from typing import Any, Mapping, Optional, Sequence

import torch

from ..utils import backend
from . import base


class FillTemplate:
    """Fill a tensor with a constant value.

    Parameters
    ----------
    context
        Placement context (:class:`..utils.backend.DeviceContext`), or
        ``None`` for the best device (the card where there is one).
    dtype
        Element type.
    ctype
        Ignored (the reference library's C type name).
    tuning
        Accepted for signature parity and ignored.
    """

    def __init__(self, context, dtype, ctype: Optional[str] = None, tuning=None) -> None:
        self.context = context
        self.dtype = base.torch_dtype(dtype)
        self.ctype = ctype

    def instantiate(self, command_queue=None, shape: Sequence[int] = (), allocator=None) -> "Fill":
        return Fill(self, shape)


class Fill(base.Operation):
    """Concrete instance of :class:`FillTemplate`.

    .. rubric:: Slots

    **data** : output
        Tensor filled with the value set by :meth:`set_value`.
    """

    def __init__(self, template: FillTemplate, shape: Sequence[int]) -> None:
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.shape = tuple(shape)
        self.slots["data"] = base.Slot(shape, template.dtype, base.Direction.OUT)
        self.value = torch.zeros((), dtype=template.dtype)

    def set_value(self, value: Any) -> None:
        self.value = torch.as_tensor(value).to(self.template.dtype)
        self.invalidate()

    def _run(self):
        return {"data": torch.full(self.shape, self.value.item(), dtype=self.template.dtype,
                                   device=self.device)}

    def parameters(self) -> Mapping[str, Any]:
        return {"dtype": self.template.dtype, "shape": self.shape, "value": self.value}
