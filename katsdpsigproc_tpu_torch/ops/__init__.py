"""Primitive operations (port of ``katsdpsigproc_tpu.ops``).

``base`` is the operation framework; ``percentile`` and ``transpose``
wrap the hand-written CUDA kernels K4 and K5; ``fill``, ``maskedsum``,
``reduce``, ``wgreduce``, ``rank`` and ``fft`` (``torch.fft``, cuFFT on
the card) are plain PyTorch, as the JAX package leaves them to XLA.
"""

from . import (base, fft, fill, maskedsum, percentile, rank, reduce, transpose,  # noqa: F401
               wgreduce)

__all__ = ["base", "fft", "fill", "maskedsum", "percentile", "rank", "reduce", "transpose",
           "wgreduce"]
