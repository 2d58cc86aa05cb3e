"""2-D transpose (corner turn).

Port of ``katsdpsigproc_tpu/ops/transpose.py``.  ``TransposeTemplate``'s
``engine`` is ``"torch"`` (the counterpart of ``"xla"``: a
``transpose(0, 1).contiguous()`` copy) or ``"cuda"``, the hand-written
kernel K5 in ``csrc/transpose.cu`` (the counterpart of ``"pallas"``):
32 x 32 tiles through shared memory, one float2 per complex64 element or
planar (re, im) pair.  The TPU block sides ``tile_r``/``tile_c`` have no
counterpart: the kernel fixes its CTA shape by the element size.

:func:`transpose_cuda` is K5's wrapper: a tensor on the CPU takes the
plain version beside it (:func:`transpose_plain`), a CUDA tensor goes to
the kernel or the call raises.  :data:`launches` counts its launches.
While a profiler session records, it records its host work as spans
(:func:`..utils.profiling.annotate`): ``ksp.transpose`` the whole call,
``ksp.launch.k5`` the launch alone.
"""

import ctypes
import functools
from typing import Any, Mapping, Optional, Tuple

import torch

from ..utils import backend, profiling, tune
from . import base

# Kernel launches since the count was last reset; the wrapper adds one
# where it launches the kernel, and nowhere else.
launches = {"transpose": 0}

#: The planar layout: a trailing (re, im) pair of 4-byte elements.
_PAIR = 2


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils import kernels

    lib = kernels.load("transpose", ["transpose.cu"], {})
    lib.tr_error_string.argtypes = [ctypes.c_int]
    lib.tr_error_string.restype = ctypes.c_char_p
    lib.tr_transpose.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.tr_transpose.restype = ctypes.c_int
    return lib


def _planar(src: torch.Tensor) -> bool:
    return src.ndim == 3 and src.shape[-1] == _PAIR


def _check_input(src) -> None:
    if not isinstance(src, torch.Tensor):
        raise TypeError("src must be a torch.Tensor")
    if src.ndim == 2:
        return
    if not _planar(src) or src.is_complex():
        raise ValueError("src must be 2-D (rows, cols) or planar (rows, cols, 2)")


def transpose_plain(src: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K5: ``src.transpose(0, 1).contiguous()``.

    Planar (rows, cols, 2) input keeps its trailing pair axis, as
    ``movedim(0, 1)`` would.
    """
    _check_input(src)
    return src.transpose(0, 1).contiguous()


def transpose_cuda(src: torch.Tensor) -> torch.Tensor:
    """Transpose a (rows, cols) or planar (rows, cols, 2) tensor with K5.

    Elements of 1, 4 or 8 bytes (uint8, float32, complex64, ...), or
    planar pairs of 4-byte elements; each source row contiguous, rows any
    stride apart (a column slice is not copied).  Returns a contiguous
    (cols, rows[, 2]) tensor on the input's device.
    """
    with profiling.annotate("ksp.transpose"):
        _check_input(src)
        if src.device.type == "cpu":
            return transpose_plain(src)
        if src.device.type != "cuda":
            raise ValueError(f"unsupported device {src.device}")
        planar = _planar(src)
        elem = src.element_size() * (_PAIR if planar else 1)
        if (planar and src.element_size() != 4) or elem not in (1, 4, 8):
            raise TypeError(f"K5 moves 1-, 4- or 8-byte elements or pairs of 4-byte elements; "
                            f"got {src.dtype}{' pairs' if planar else ''}")
        rows, cols = src.shape[:2]
        inner_ok = src.stride(1) == (_PAIR if planar else 1) and (not planar or src.stride(2) == 1)
        if cols > 1 and not inner_ok:
            raise ValueError("K5 takes rows whose elements are contiguous")
        row_stride = src.stride(0) // _PAIR if planar else src.stride(0)
        if rows > 1 and (row_stride < cols or (planar and src.stride(0) % _PAIR)):
            raise ValueError(f"row stride {src.stride(0)} does not hold a row of {cols} elements")
        if src.data_ptr() % elem:
            raise ValueError(f"src is not aligned to its {elem}-byte elements")
        out = torch.empty((cols, rows) + src.shape[2:], dtype=src.dtype, device=src.device)
        if rows == 0 or cols == 0:
            return out
        with torch.cuda.device(src.device):
            lib = _library()
            stream = torch.cuda.current_stream(src.device).cuda_stream
            with profiling.annotate("ksp.launch.k5"):
                err = lib.tr_transpose(src.data_ptr(), out.data_ptr(), elem, rows, cols,
                                       max(row_stride, cols), stream)
        if err != 0:
            raise RuntimeError(
                f"transpose launch failed: cudaError {err} ({lib.tr_error_string(err).decode()})")
        launches["transpose"] += 1
        return out


class TransposeTemplate:
    """Transposes a 2-D tensor.

    Parameters
    ----------
    context
        Placement context (:class:`..utils.backend.DeviceContext`), or
        ``None`` for the best device (the card where there is one).
    dtype
        Element type.
    ctype
        Ignored (API parity with the reference library).
    tuning
        ``engine``: ``"torch"`` or ``"cuda"``; autotuned when omitted.
    """

    autotune_version = 2

    def __init__(self, context, dtype, ctype: Optional[str] = None, tuning=None) -> None:
        self.context = context
        self.dtype = base.torch_dtype(dtype)
        self.ctype = ctype
        if tuning is None:
            tuning = self.autotune(context, base.dtype_name(self.dtype))
        self.engine = tuning.get("engine", "torch")

    @classmethod
    @tune.autotuner(test={"engine": "torch"})
    def autotune(cls, context, dtype) -> Mapping[str, Any]:
        device = backend.context_device(context)
        data = torch.zeros((2048, 2048), dtype=base.torch_dtype(dtype), device=device)

        def generate(engine: str):
            if engine == "cuda" and device.type != "cuda":
                raise tune.SkipConfig("the cuda engine needs a CUDA device")
            tmpl = cls(context, dtype, tuning={"engine": engine})
            return tune.make_measure(lambda d: transpose(d, tmpl), data)

        return tune.autotune(generate, engine=["torch", "cuda"])

    def instantiate(self, command_queue=None, shape: Tuple[int, int] = (0, 0), allocator=None):
        return Transpose(self, shape)


class Transpose(base.Operation):
    """Concrete instance of :class:`TransposeTemplate`.

    .. rubric:: Slots

    **src** : (rows, cols) input
    **dest** : (cols, rows) output
    """

    def __init__(self, template: TransposeTemplate, shape: Tuple[int, int]) -> None:
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.shape = tuple(shape)
        self.slots["src"] = base.Slot(shape, template.dtype, base.Direction.IN)
        self.slots["dest"] = base.Slot((shape[1], shape[0]), template.dtype, base.Direction.OUT)

    def _run(self, src):
        return {"dest": transpose(src, self.template)}

    def parameters(self) -> Mapping[str, Any]:
        return {"dtype": self.template.dtype, "shape": self.shape,
                "engine": self.template.engine}


def transpose(src: torch.Tensor, template: Optional[TransposeTemplate] = None,
              interpret: bool = False) -> torch.Tensor:
    """Transpose with a template's engine choice (default ``"torch"``).

    Port of ``katsdpsigproc_tpu/ops/transpose.py::transpose``: 2-D real
    or complex, or planar (rows, cols, 2) input.  ``interpret`` (the TPU
    kernel's interpret mode) is accepted and ignored: a tensor on the CPU
    takes K5's plain version, with the same result.
    """
    del interpret
    if template is not None and template.engine == "cuda":
        return transpose_cuda(src)
    if template is not None and template.engine != "torch":
        raise ValueError(f"unknown engine {template.engine!r}")
    return transpose_plain(src)
