"""Triple an array with a hand-written Triton kernel.

Port of ``doc/examples/triple_pallas.py``: the Pallas kernel
``triple_kernel`` (K6), run over a grid of ``BLOCK``-element blocks,
becomes a Triton kernel.  The TPU grid steps through ``BLOCK`` (256)
elements at a time; on the card a program of 256 elements at 4 warps
moves 8 bytes a thread, and launching and retiring 2**20 such programs
costs time.  So one program streams a tile of :data:`TILE` elements at
:data:`NUM_WARPS` warps, one 128-bit vector a thread, with the default
cache policy; the offsets carry ``tl.multiple_of``/``tl.max_contiguous``
hints.  The program masks the ragged tail, which the TPU grid
(``n // BLOCK`` steps) leaves out.

What bounds it: bytes.  Each element is read once and written once (8 B
for one multiply), so 2**28 elements take at least 0.64 ms at 3.35 TB/s.
The tile and warps were the fastest of six (tile, warps) points on the
H100, ahead of four vectors a thread with or without evict-first hints
and of ``BLOCK`` at 4 warps, the earlier design (PERF.md).

Triton is imported, and the kernel compiled, on the first launch (into
``TRITON_CACHE_DIR``, by default ``build/katsdpsigproc_tpu_torch/triton``
beside the package).

Run::

    python -m katsdpsigproc_tpu_torch.examples.triple_pallas [--device cpu]
"""

import functools
import os

import numpy as np
import torch

from . import parse

BLOCK = 256  # doc/examples/triple_pallas.py:20, the elements of one grid step
TILE = 4096  # the elements of one program
NUM_WARPS = 32

# Kernel launches since the count was last reset.  The wrapper adds one
# where it launches the kernel, and nowhere else.
launches = {"triple": 0}

# ``triton.language``, bound on the first launch (Triton is imported only
# where a kernel is launched); the kernel body finds it here.
tl = None


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    from ..utils import kernels

    os.environ.setdefault("TRITON_CACHE_DIR", str(kernels.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def triple_kernel(x_ptr, o_ptr, n, TILE: tl.constexpr):
        offsets = tl.program_id(0).to(tl.int64) * TILE + tl.arange(0, TILE)
        offsets = tl.max_contiguous(tl.multiple_of(offsets, TILE), TILE)
        mask = offsets < n
        x = tl.load(x_ptr + offsets, mask=mask)
        tl.store(o_ptr + offsets, x * 3.0, mask=mask)

    return triple_kernel


def triple_plain(x):
    """The plain PyTorch version of K6: ``x * 3``."""
    return x * 3.0


def _check(x) -> bool:
    """Whether `x` takes the plain version (a CPU tensor); raises on what K6 does not take."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.ndim != 1:
        raise TypeError("x must be a 1-D torch.float32 tensor")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the Triton kernel takes a contiguous tensor")
    return False


def triple(x):
    """``3 * x`` for a 1-D float32 tensor (K6 on a CUDA tensor).

    Port of ``doc/examples/triple_pallas.py::triple``: one program per
    :data:`TILE` elements.
    """
    if _check(x):
        return triple_plain(x)
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        launch = _kernel()[((n + TILE - 1) // TILE,)]
        # Triton launches on the current device; entering torch.cuda.device
        # costs the host a few microseconds, so only where it is another.
        index = x.get_device()
        if index == torch.cuda.current_device():
            launch(x, out, n, TILE=TILE, num_warps=NUM_WARPS)
        else:
            with torch.cuda.device(index):
                launch(x, out, n, TILE=TILE, num_warps=NUM_WARPS)
        launches["triple"] += 1
    return out


def main(argv=None) -> None:
    ctx = parse(__doc__, argv)
    host = np.random.RandomState(1).uniform(size=4 * BLOCK).astype(np.float32)
    out = triple(ctx.put(host)).cpu().numpy()
    np.testing.assert_allclose(out, host * 3)
    print(out[:5])


if __name__ == "__main__":
    main()
