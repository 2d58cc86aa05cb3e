"""Deprecated alias for :mod:`katsdpsigproc_tpu_torch.utils.resource`.

Port of ``katsdpsigproc_tpu/asyncio/resource.py``, kept for code that
imports the old path.
"""

import warnings

from ..utils.resource import *  # noqa: F401,F403
from ..utils.resource import __all__  # noqa: F401

warnings.warn(
    "katsdpsigproc_tpu_torch.asyncio.resource is deprecated; "
    "use katsdpsigproc_tpu_torch.utils.resource",
    DeprecationWarning,
    stacklevel=2,
)
