"""Primitive operations (port of ``katsdpsigproc_tpu.ops``).

``base`` is the operation framework; ``percentile`` and ``transpose``
wrap the hand-written CUDA kernels K4 and K5; ``fill``, ``maskedsum``,
``reduce``, ``wgreduce`` and ``rank`` are plain PyTorch, as the JAX
package leaves them to XLA.
"""

from . import base, fill, maskedsum, percentile, rank, reduce, transpose, wgreduce  # noqa: F401

__all__ = ["base", "fill", "maskedsum", "percentile", "rank", "reduce", "transpose", "wgreduce"]
