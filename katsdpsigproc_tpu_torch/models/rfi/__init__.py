"""RFI flagging (port of ``katsdpsigproc_tpu.models.rfi``).

``host`` is the 1-D flagger's numpy oracle, ``device`` its stages as
PyTorch tensor code, and ``fused_flagger`` the wrappers around the
hand-written CUDA kernels (the counterparts of the JAX package's
``pallas_flagger``) with ``FusedFlaggerTemplate``; ``twodflag`` is the 2-D
SumThreshold flagger, plain PyTorch as XLA computes it in JAX.
"""

# MAD-to-sigma conversion (katsdpsigproc_tpu/models/rfi/__init__.py::MAD_NORMAL).
MAD_NORMAL = 1.4826

from . import host  # noqa: E402,F401
from . import device  # noqa: E402,F401
from . import fused_flagger  # noqa: E402,F401
from . import twodflag  # noqa: E402,F401

__all__ = ["MAD_NORMAL", "host", "device", "fused_flagger", "twodflag"]
