"""katsdpsigproc_tpu_torch — the PyTorch/CUDA port of katsdpsigproc_tpu.

The JAX package (``katsdpsigproc_tpu``) is the reference; this package
mirrors its module paths so that each counterpart is easy to find, and
each port module names the JAX function it ports as
``katsdpsigproc_tpu/<file>::<function>``.  It imports ``torch`` and
numpy, never ``jax`` and never ``katsdpsigproc_tpu``.

Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas is a CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc``
on first use (:mod:`.utils.kernels`).  Each kernel wrapper takes its
plain PyTorch version for a tensor on the CPU and launches the kernel
for a tensor on the card.

Ported so far: the 1-D RFI flagger's main path (``models.rfi``) and the
rank-statistic library (``ops.rank``).
"""

__version__ = "0.5.0"

# MAD-to-sigma conversion factor (katsdpsigproc_tpu/__init__.py::MAD_NORMAL).
MAD_NORMAL = 1.4826

from . import models, ops  # noqa: E402,F401
from .models import rfi  # noqa: E402,F401

__all__ = ["MAD_NORMAL", "ops", "models", "rfi", "__version__"]
