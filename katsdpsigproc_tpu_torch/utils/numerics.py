"""Float32 arithmetic pinned to what the JAX package computes.

PyTorch and XLA round some elementwise functions differently.  The port
computes these two the way the reference does, on every device, so that
stage outputs agree bit for bit:

* :func:`sqrt_rn`, the correctly rounded float32 square root.  XLA's and
  CUDA's ``sqrtf`` are correctly rounded; PyTorch's vectorized CPU
  ``sqrt`` for float32 is not (about 0.7% of random inputs differ by one
  ulp), and its float64 ``sqrt`` is not always either.
* :func:`complex_abs`, ``|z|`` of complex64 as XLA (and numpy) compute it:
  ``max * sqrt(fma(r, r, 1))`` with ``r = min / max`` over ``|re|`` and
  ``|im|``.  PyTorch's ``abs`` is the correctly rounded hypot, which
  differs from it by one ulp in about a third of random inputs.
"""

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    The float64 root rounded to float32 is the candidate; it is then
    checked exactly and moved by one float32 step where it is not the
    correctly rounded root: the midpoints between the candidate and its
    float32 neighbours are exact in float64, and so are their squares (25
    significant bits squared), so ``x`` is compared with them exactly and
    the true root never lies on one.  The check makes the result
    independent of how the float64 root was rounded: on the CPU PyTorch
    takes it from MKL's vector math, whose first call in a process was seen
    to return roots off in their last bits in one thread's share of the
    elements, enough to move some float32 roots by one ulp.
    """
    x64 = x.to(torch.float64)
    y = torch.sqrt(x64).to(torch.float32)
    inf = y.new_full((), torch.inf)
    up, down = torch.nextafter(y, inf), torch.nextafter(y, -inf)
    y64 = y.to(torch.float64)
    hi = (y64 + up.to(torch.float64)) * 0.5
    lo = ((y64 + down.to(torch.float64)) * 0.5).clamp(min=0.0)  # sqrt(0) stays 0
    return torch.where(x64 > hi * hi, up, torch.where(x64 < lo * lo, down, y))


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
