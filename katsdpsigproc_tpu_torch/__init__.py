"""katsdpsigproc_tpu_torch — the PyTorch/CUDA port of katsdpsigproc_tpu.

The JAX package (``katsdpsigproc_tpu``) is the reference; this package
mirrors its module paths so that each counterpart is easy to find, and
each port module names the JAX function it ports as
``katsdpsigproc_tpu/<file>::<function>``.  It imports ``torch`` and
numpy, never ``jax`` and never ``katsdpsigproc_tpu``.

Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas is a CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc``
on first use (:mod:`.utils.kernels`), or, for the tutorial kernel of
``examples.triple_pallas``, a Triton kernel compiled at its first launch.  Each kernel wrapper takes its
plain PyTorch version for a tensor on the CPU and launches the kernel
for a tensor on the card.

Ported so far: the 1-D RFI flagger's main path, ``FusedFlaggerTemplate``
and the stage templates with the composed ``FlaggerDevice``, and the 2-D
SumThreshold flagger (``models.rfi``); the operation framework
(``ops.base``) and the primitive ops (``ops``: fill, masked sum, row
reduction, named reductions and scans, rank statistics, percentile5,
transpose and FFT); device contexts, the tuning table, shape
helpers, profiling and the asyncio resource layer (``utils``, with the
deprecated ``asyncio.resource`` alias and the ``abc`` protocols); the
examples of ``doc/examples`` (``examples``); the probes of the fused
flagger's stages and costs and the harnesses ``rfiflagtest`` and
``fftflagtest`` (``scripts``); the sharded flaggers on
``torch.distributed`` (``parallel``).
"""

__version__ = "0.5.0"

# MAD-to-sigma conversion factor (katsdpsigproc_tpu/__init__.py::MAD_NORMAL).
MAD_NORMAL = 1.4826

from . import models, ops  # noqa: E402,F401
from .models import rfi  # noqa: E402,F401

__all__ = ["MAD_NORMAL", "ops", "models", "rfi", "__version__"]
