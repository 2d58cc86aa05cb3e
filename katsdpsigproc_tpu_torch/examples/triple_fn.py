"""Triple an array: the simplest "kernel" is plain tensor code.

Port of ``doc/examples/triple_fn.py``, where it is a jitted function:
PyTorch runs ``x * 3`` as one elementwise kernel of its own.  Run::

    python -m katsdpsigproc_tpu_torch.examples.triple_fn [--device cpu]
"""

import numpy as np

from . import parse


def triple(x):
    return x * 3


def main(argv=None) -> None:
    ctx = parse(__doc__, argv)
    host = np.random.RandomState(1).uniform(size=50).astype(np.float32)
    out = triple(ctx.put(host)).cpu().numpy()
    np.testing.assert_allclose(out, host * 3)
    print(out[:5])


if __name__ == "__main__":
    main()
