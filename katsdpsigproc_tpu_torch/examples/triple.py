"""Hello-world: a hand-written CUDA kernel scaling an array.

Port of ``doc/examples/triple.py``: the Pallas kernel ``multiply_kernel``
(K7), which multiplies a block by a scalar held in SMEM, becomes
``csrc/examples.cu`` (one CTA per tile of one 16-byte load a thread),
built by ``nvcc`` on first use, with the scalar passed by value into the
kernel's constant bank.

Run::

    python -m katsdpsigproc_tpu_torch.examples.triple [--device cpu]
"""

import ctypes
import functools

import numpy as np
import torch

from . import parse

# Kernel launches since the count was last reset.  The wrapper adds one
# where it launches the kernel, and nowhere else.
launches = {"multiply": 0}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils import kernels

    lib = kernels.load("examples", ["examples.cu"], {})
    lib.ex_error_string.argtypes = [ctypes.c_int]
    lib.ex_error_string.restype = ctypes.c_char_p
    lib.ex_multiply.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ex_multiply.restype = ctypes.c_int
    return lib


def multiply_plain(data, scale):
    """The plain PyTorch version of K7: ``data * float32(scale)``."""
    return data * float(np.float32(scale))


def _check(data) -> bool:
    """Whether `data` takes the plain version (a CPU tensor); raises on what K7 does not take."""
    if not isinstance(data, torch.Tensor) or data.dtype != torch.float32:
        raise TypeError("data must be a torch.float32 tensor")
    if data.device.type == "cpu":
        return True
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if not data.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous tensor")
    return False


def multiply(data, scale, *, threads: int = 1024):
    """``data * scale`` for float32 `data` (K7 on a CUDA tensor).

    Port of ``doc/examples/triple.py::multiply``.  `threads` is the CTA
    size (a multiple of 32, at most 1024); each CTA streams a tile of
    `threads` float4s.  Returns a new tensor on the input's device.
    """
    if _check(data):
        return multiply_plain(data, scale)
    # The C entry sets the device itself, and the current stream is read as
    # a raw handle (as Triton's launcher reads it): ``torch.cuda.device`` and
    # ``torch.cuda.current_stream`` would cost the host more than the rest
    # of the call.  ctypes rounds `scale` to float32 to nearest, as
    # ``np.float32`` does.
    lib = _library()
    out = torch.empty_like(data)
    index = data.get_device()
    err = lib.ex_multiply(data.data_ptr(), out.data_ptr(), data.numel(), float(scale), threads,
                          index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(
            f"multiply launch failed: cudaError {err} ({lib.ex_error_string(err).decode()})")
    launches["multiply"] += 1
    return out


def main(argv=None) -> None:
    ctx = parse(__doc__, argv)
    host = np.random.RandomState(1).uniform(size=(8, 128)).astype(np.float32)
    out = multiply(ctx.put(host), 3.0).cpu().numpy()
    np.testing.assert_allclose(out, host * 3.0, rtol=1e-6)
    print(out)


if __name__ == "__main__":
    main()
