"""Row-wise reduction with a commutative operator.

Port of ``katsdpsigproc_tpu/ops/reduce.py`` (``HReduceTemplate``/
``HReduce``): each row of a 2-D tensor is reduced over a column range
with a named operator from :mod:`.wgreduce` or a binary torch callable
with its identity.  The reduction is one torch reduction over the row
axis (a pairwise tree for a callable), so the template has no autotune
and ``tuning`` is accepted for signature parity and ignored.
"""

from typing import Any, Callable, Mapping, Optional, Tuple, Union

import torch

from ..utils import backend
from . import base, wgreduce


class HReduceTemplate:
    """Reduction along the rows of a 2-D tensor.

    Only commutative operators are supported.

    Parameters
    ----------
    context
        Placement context, or ``None`` for the best device.
    dtype
        Element type.
    op
        A name from :mod:`katsdpsigproc_tpu_torch.ops.wgreduce`
        (``"plus"``, ``"max"``, ``"min"``, ``"fmin"``, ``"fmax"``) or a
        binary callable on tensors.
    identity
        Identity of `op` (required for a callable; named operators know
        their own).
    """

    def __init__(self, context, dtype, ctype: Optional[str] = None,
                 op: Union[str, Callable] = "plus", identity: Any = None, extra_code: str = "",
                 tuning=None) -> None:
        self.context = context
        self.dtype = base.torch_dtype(dtype)
        self.ctype = ctype
        self.extra_code = extra_code
        self.op = op
        self.identity = identity
        if isinstance(op, str):
            self.reduce_op = wgreduce.BY_NAME[op]
        else:
            self.reduce_op = wgreduce.ReduceOp("custom", op,
                                               lambda dt: torch.tensor(identity, dtype=dt))

    def instantiate(self, command_queue=None, shape: Tuple[int, int] = (0, 0),
                    column_range: Optional[Tuple[int, int]] = None, allocator=None):
        return HReduce(self, shape, column_range)


class HReduce(base.Operation):
    """Concrete instance of :class:`HReduceTemplate`.

    In each row, the elements in the column range are reduced with the
    template's operator.

    .. rubric:: Slots

    **src** : (rows, columns) input
    **dest** : (rows,) output
    """

    def __init__(self, template: HReduceTemplate, shape: Tuple[int, int],
                 column_range: Optional[Tuple[int, int]] = None) -> None:
        if len(shape) != 2:
            raise ValueError("shape must be 2-dimensional")
        if column_range is None:
            column_range = (0, shape[1])
        if column_range[0] < 0 or column_range[1] > shape[1]:
            raise ValueError("column range overflows the array")
        if column_range[0] >= column_range[1]:
            raise ValueError("column range is empty")
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.shape = tuple(shape)
        self.column_range = column_range
        self.slots["src"] = base.Slot(shape, template.dtype, base.Direction.IN)
        self.slots["dest"] = base.Slot((shape[0],), template.dtype, base.Direction.OUT)

    def _run(self, src):
        lo, hi = self.column_range
        result = wgreduce.reduce(src[:, lo:hi], self.template.reduce_op, axis=1)
        return {"dest": result.to(self.template.dtype)}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "dtype": self.template.dtype,
            "shape": self.shape,
            "column_range": self.column_range,
            "op": getattr(self.template.op, "__name__", self.template.op),
        }
