"""Triple as an Operation with a Template and an autotuner hook.

Port of ``doc/examples/triple_op.py``: build a template once, instantiate
it per shape, then call it functionally or bind buffers and call.  The
operation runs the tutorial kernel K7 (:func:`.triple.multiply`), and the
template's tuned ``block`` is K7's CTA size.  As in the JAX example the
autotuner has no search to run (a real one would time candidates with
``tune.autotune(generate, block=[...])``); its result is cached as every
tuning result is (``KATSDPSIGPROC_TPU_TORCH_TUNE_DB``).  Run::

    python -m katsdpsigproc_tpu_torch.examples.triple_op [--device cpu]
"""

import numpy as np

from ..ops import base
from ..utils import tune
from . import parse, triple


class MultiplyTemplate:
    def __init__(self, context, tuning=None):
        if tuning is None:
            tuning = self.autotune(context)
        self.context = context
        self.block = tuning["block"]

    @classmethod
    @tune.autotuner(test={"block": 128})
    def autotune(cls, context):
        return {"block": 256}

    def instantiate(self, command_queue=None, size=0, scale=1.0):
        return Multiply(self, size, scale)


class Multiply(base.Operation):
    def __init__(self, template, size, scale):
        super().__init__(template.context.device)
        self.template = template
        self.scale = np.float32(scale)
        self.slots["data"] = base.Slot((size,), np.float32, base.Direction.IN)
        self.slots["out"] = base.Slot((size,), np.float32, base.Direction.OUT)

    def _run(self, data):
        return {"out": triple.multiply(data, self.scale, threads=self.template.block)}

    def parameters(self):
        return {"scale": float(self.scale), "block": self.template.block}


def main(argv=None) -> None:
    ctx = parse(__doc__, argv)
    op = MultiplyTemplate(ctx).instantiate(size=50, scale=3.0)
    host = np.random.RandomState(1).uniform(size=50).astype(np.float32)

    # Functional style:
    out = op(data=ctx.put(host))["out"]
    np.testing.assert_allclose(out.cpu().numpy(), host * 3)

    # Bind-then-call style:
    op.bind(data=ctx.put(host))
    op()
    np.testing.assert_allclose(op.buffer("out").cpu().numpy(), host * 3)
    print(op.buffer("out").cpu().numpy()[:5], op.parameters())


if __name__ == "__main__":
    main()
