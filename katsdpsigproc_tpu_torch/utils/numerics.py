"""Float32 arithmetic pinned to what the JAX package computes.

PyTorch and XLA round some elementwise functions differently.  The port
computes these two the way the reference does, on every device, so that
stage outputs agree bit for bit:

* :func:`sqrt_rn`, the correctly rounded float32 square root.  XLA's and
  CUDA's ``sqrtf`` are correctly rounded; PyTorch's vectorized CPU
  ``sqrt`` for float32 is not (about 0.7% of random inputs differ by one
  ulp).
* :func:`complex_abs`, ``|z|`` of complex64 as XLA (and numpy) compute it:
  ``max * sqrt(fma(r, r, 1))`` with ``r = min / max`` over ``|re|`` and
  ``|im|``.  PyTorch's ``abs`` is the correctly rounded hypot, which
  differs from it by one ulp in about a third of random inputs.
"""

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    The float64 root rounded to float32 is the correctly rounded float32
    root (53 >= 2 * 24 + 2, so the double rounding is innocuous).
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def complex_abs(z: torch.Tensor) -> torch.Tensor:
    """``|z|`` of complex64 `z` as float32, rounded as XLA's ``abs`` rounds it.

    ``fma(r, r, 1)`` is taken in float64, where ``r * r`` is exact, and
    rounded once to float32 (a second rounding of the float64 sum could
    differ from a true fma only on an exact float32 midpoint).
    """
    re = z.real.to(torch.float32).abs()
    im = z.imag.to(torch.float32).abs()
    big = torch.maximum(re, im)
    small = torch.minimum(re, im)
    r = (small / big).to(torch.float64)
    scale = (1.0 + r * r).to(torch.float32)
    out = big * sqrt_rn(scale)
    out = torch.where(big == 0, 0.0, out)
    return torch.where(torch.isinf(re) | torch.isinf(im), torch.inf, out)
