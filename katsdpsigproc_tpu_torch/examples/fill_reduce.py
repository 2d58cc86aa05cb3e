"""Compose Fill and HReduce into one OperationSequence.

Port of ``doc/examples/fill_reduce.py``: the same compound-slot wiring,
``fill:data`` feeding ``hreduce:src``.  The sequence runs its children in
order, eagerly.  Run::

    python -m katsdpsigproc_tpu_torch.examples.fill_reduce [--device cpu]
"""

import numpy as np

from ..ops import base, fill, reduce as reduce_op
from . import parse


class FillReduceTemplate:
    def __init__(self, context):
        self.fill = fill.FillTemplate(context, np.float32)
        self.hreduce = reduce_op.HReduceTemplate(context, np.float32, op="plus")

    def instantiate(self, queue=None, shape=()):
        return FillReduce(self, shape)


class FillReduce(base.OperationSequence):
    def __init__(self, template, shape):
        self.fill = template.fill.instantiate(shape=shape)
        self.hreduce = template.hreduce.instantiate(shape=shape)
        operations = [("fill", self.fill), ("hreduce", self.hreduce)]
        compounds = {"src": ["fill:data", "hreduce:src"], "dest": ["hreduce:dest"]}
        super().__init__(operations, compounds)
        self.template = template

    def __call__(self, fill_value):
        self.fill.set_value(fill_value)
        return super().__call__()


def main(argv=None) -> None:
    ctx = parse(__doc__, argv)
    op = FillReduceTemplate(ctx).instantiate(shape=(10, 5))
    op(42)
    dest = op.buffer("dest")
    if dest.device != ctx.device:
        raise AssertionError(f"the result is on {dest.device}, not {ctx.device}")
    result = dest.cpu().numpy()
    np.testing.assert_allclose(result, np.full(10, 42.0 * 5))
    print(result)


if __name__ == "__main__":
    main()
