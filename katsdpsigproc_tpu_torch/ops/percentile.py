"""Per-row [0, 100, 25, 75, 50] percentiles of positive data.

Port of ``katsdpsigproc_tpu/ops/percentile.py``: per row, the minimum,
the maximum, and the lower-element (non-interpolated) 25th, 75th and 50th
percentiles at ranks ``(n-1)//4``, ``3*(n-1)//4`` and ``(n-1)//2``,
matching ``np.percentile(..., method="lower")`` exactly.  Complex input is
reduced to amplitudes first.

``Percentile5Template``'s engines:

* ``"rank"``: the radix-16 bitwise rank search of :mod:`.rank`, all three
  targets in one sweep of the data per digit;
* ``"sort"``: ``torch.sort`` and a gather;
* ``"cuda"``: the hand-written kernel K4 in ``csrc/percentile.cu`` (the
  counterpart of ``"pallas"``), one CTA per row with the row's keys in
  registers and a radix select (:func:`launch_shape`).

:func:`percentile5_cuda` is K4's wrapper: a tensor on the CPU takes the
plain version beside it (:func:`percentile5_plain`, the 31-round binary
search of the TPU kernel), a CUDA tensor goes to the kernel or the call
raises.  :data:`launches` counts its launches.
:func:`percentile5_radix_plain` is K4's radix select step by step in
PyTorch, bit for bit :func:`percentile5_plain`.
"""

import ctypes
import functools
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils import backend, numerics, tune
from . import base, rank

# Kernel launches since the count was last reset; the wrapper adds one
# where it launches the kernel, and nowhere else.
launches = {"percentile5": 0}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils import kernels

    lib = kernels.load("percentile", ["percentile.cu"], {})
    lib.pc_error_string.argtypes = [ctypes.c_int]
    lib.pc_error_string.restype = ctypes.c_char_p
    lib.pc_max_shared_columns.argtypes = []
    lib.pc_max_shared_columns.restype = ctypes.c_int
    lib.pc_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    lib.pc_launch_shape.restype = ctypes.c_int
    lib.pc_percentile5.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.pc_percentile5.restype = ctypes.c_int
    return lib


def max_shared_columns() -> int:
    """The widest row whose keys K4 holds in shared memory on the current CUDA device."""
    return _library().pc_max_shared_columns()


def launch_shape(rows: int, n: int) -> Tuple[int, int]:
    """K4's CTA size and register slots a thread for `rows` rows of `n` columns.

    256 threads when the rows fill the SMs and a row fits 32 slots a
    thread, else 1024; slots 0 mean the row's keys sit in shared memory,
    -1 that the row is read from device memory on every pass.  Needs a
    CUDA device.
    """
    lib = _library()
    threads, per = ctypes.c_int(), ctypes.c_int()
    err = lib.pc_launch_shape(rows, n, ctypes.byref(threads), ctypes.byref(per))
    if err != 0:
        raise RuntimeError(f"no launch shape for {rows} x {n}: cudaError {err} "
                           f"({lib.pc_error_string(err).decode()})")
    return threads.value, per.value


def _targets(n: int) -> Tuple[int, int, int]:
    return (n - 1) // 4, (3 * (n - 1)) // 4, (n - 1) // 2


def _check_2d(values) -> None:
    if not isinstance(values, torch.Tensor) or values.ndim != 2:
        raise ValueError("values must be a 2-D (rows, cols) tensor")
    if values.dtype != torch.float32:
        raise TypeError(f"values must be torch.float32, got {values.dtype}")
    if values.shape[1] == 0:
        raise ValueError("values must have at least one column")


def percentile5_plain(values: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4: the TPU kernel's 31-round binary search.

    Port of ``katsdpsigproc_tpu/ops/percentile.py::_percentile5_kernel``
    on (rows, n) float32: NaN-ignoring min and max (an all-NaN row gives
    +inf and -inf), then for each target the largest bit pattern whose
    count of ``x < candidate`` is at most the target.  Counts are int32;
    the TPU kernel's float32 sums of 0/1 are the same integers below
    2**24 columns.  Returns (5, rows) float32.
    """
    _check_2d(values)
    nan = torch.isnan(values)
    mn = torch.amin(torch.where(nan, torch.inf, values), dim=1)
    mx = torch.amax(torch.where(nan, -torch.inf, values), dim=1)
    targets = torch.tensor(_targets(values.shape[1]), dtype=torch.int32, device=values.device)
    cur = torch.zeros((values.shape[0], 3), dtype=torch.int32, device=values.device)
    for i in range(31):
        test = cur | (1 << (30 - i))
        cand = test.view(torch.float32)  # (rows, 3)
        cnt = torch.sum(values[:, None, :] < cand[:, :, None], dim=-1, dtype=torch.int32)
        cur = torch.where(cnt <= targets, test, cur)
    p = cur.view(torch.float32)
    return torch.stack([mn, mx, p[:, 0], p[:, 1], p[:, 2]])


# K4's radix digits, from the top of the 31-bit key: (shift, bits) per pass.
RADIX_DIGITS = ((23, 8), (15, 8), (7, 8), (0, 7))
_INF_KEY, _END_STATE = 0x7F800000, 0x7FFFFFFF


def percentile5_radix_plain(values: torch.Tensor) -> torch.Tensor:
    """K4's radix select, step by step in PyTorch; bit for bit :func:`percentile5_plain`.

    Each non-NaN value becomes a 31-bit key whose order reproduces the
    binary search's count of ``x < candidate``: 0 for ``x <= +0`` (-0,
    negatives, -inf), the bit pattern for a positive ``x``.  Each target's
    key is then resolved digit by digit (:data:`RADIX_DIGITS`): a histogram
    of the digit of the keys under the target's prefix, and the bin where
    the running count passes the target's rank.  The search's end state:
    once it accepts +inf every later candidate is a NaN pattern and is
    accepted, so a key of +inf, or a rank beyond the non-NaN count, gives
    the pattern 0x7fffffff.  Returns (5, rows) float32.
    """
    _check_2d(values)
    rows, n = values.shape
    nan = torch.isnan(values)
    mn = torch.amin(torch.where(nan, torch.inf, values), dim=1)
    mx = torch.amax(torch.where(nan, -torch.inf, values), dim=1)
    bits = values.view(torch.int32).to(torch.int64)
    keys = torch.where(values > 0, bits, 0)
    out = [mn, mx]
    for target in _targets(n):
        rank = torch.full((rows,), target, dtype=torch.int64, device=values.device)
        prefix = torch.zeros_like(rank)
        found = torch.ones(rows, dtype=torch.bool, device=values.device)
        hi = 31
        for shift, nbits in RADIX_DIGITS:
            under = ~nan & ((keys >> hi) == prefix[:, None])
            digit = (keys >> shift) & ((1 << nbits) - 1)
            hist = torch.zeros((rows, 1 << nbits), dtype=torch.int64, device=values.device)
            hist.scatter_add_(1, digit, under.to(torch.int64))
            cum = torch.cumsum(hist, dim=1)
            d = (cum <= rank[:, None]).sum(dim=1)  # the bin where the count passes the rank
            found &= d < (1 << nbits)
            d = d.clamp(max=(1 << nbits) - 1)
            below = torch.where(d > 0, cum.gather(1, (d - 1).clamp(min=0)[:, None])[:, 0], 0)
            rank = rank - below
            prefix = (prefix << nbits) | d
            hi = shift
        key = torch.where(found & (prefix < _INF_KEY), prefix, _END_STATE)
        out.append(key.to(torch.int32).view(torch.float32))
    return torch.stack(out)


def percentile5_cuda(values: torch.Tensor) -> torch.Tensor:
    """[min, max, p25, p75, p50] of each row of (rows, n) float32 with K4.

    Each row's columns must be contiguous; rows may be any stride apart,
    so a column range of a wider tensor is passed as a view.  Returns
    (5, rows) float32 on the input's device.
    """
    _check_2d(values)
    if values.device.type == "cpu":
        return percentile5_plain(values)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    rows, n = values.shape
    if n > 1 and values.stride(1) != 1:
        raise ValueError("K4 takes rows whose columns are contiguous")
    row_stride = values.stride(0) if rows > 1 else n
    if row_stride < n:
        raise ValueError(f"row stride {row_stride} does not hold a row of {n} columns")
    out = torch.empty((5, rows), dtype=torch.float32, device=values.device)
    if rows == 0:
        return out
    # The C entry makes the tensor's device current itself, and the stream
    # is read as a raw handle: ``torch.cuda.device`` and
    # ``torch.cuda.current_stream`` would cost the host more than the
    # 64 x 4096 call takes on the card.
    lib = _library()
    index = values.get_device()
    err = lib.pc_percentile5(index, values.data_ptr(), row_stride, rows, n, out.data_ptr(),
                             torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(
            f"percentile5 launch failed: cudaError {err} ({lib.pc_error_string(err).decode()})")
    launches["percentile5"] += 1
    return out


def percentile5(values: torch.Tensor, engine: str = "rank",
                interpret: bool = False) -> torch.Tensor:
    """[min, max, p25, p75, p50] per row of positive data (..., n) -> (5, ...).

    Port of ``katsdpsigproc_tpu/ops/percentile.py::percentile5``.
    ``engine="cuda"`` takes 2-D (rows, cols) float32 only.  ``interpret``
    (the TPU kernel's interpret mode) is accepted and ignored: a tensor
    on the CPU takes K4's plain version, with the same result.
    """
    del interpret
    n = values.shape[-1]
    r25, r75, r50 = _targets(n)
    if engine == "cuda":
        return percentile5_cuda(values)
    if engine == "sort":
        s = torch.sort(values, dim=-1).values
        out = torch.stack([s[..., 0], s[..., n - 1], s[..., r25], s[..., r75], s[..., r50]])
    elif engine == "rank":
        # One radix search resolves all three ranks at once: the rank axis
        # broadcasts against a single read of the data per digit.
        targets = torch.tensor([r25, r75, r50], dtype=torch.int32, device=values.device)
        vb = values[..., None, :].expand(values.shape[:-1] + (3, n))
        p = rank.find_rank_float(vb, targets, False, radix_bits=4)  # (..., 3)
        out = torch.stack([rank.fmin(values), rank.fmax(values), p[..., 0], p[..., 1],
                           p[..., 2]])
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return out.to(torch.float32)


class Percentile5Template:
    """Percentiles of the rows of a 2-D tensor.

    5 percentiles [0, 100, 25, 75, 50] are calculated per row; the lower
    element, not an interpolation, is chosen.  Assumes positive values.

    Parameters
    ----------
    context
        Placement context (:class:`..utils.backend.DeviceContext`), or
        ``None`` for the best device (the card where there is one).
    max_columns
        Maximum number of columns of an instance.
    is_amplitude
        If true, the inputs are float32 amplitudes; if false they are
        complex64 and percentiles are computed on their absolute values.
    tuning
        ``engine``: ``"rank"``, ``"sort"`` or ``"cuda"``; autotuned when
        omitted.
    """

    autotune_version = 1

    def __init__(self, context, max_columns: int, is_amplitude: bool = True,
                 tuning=None) -> None:
        self.context = context
        self.max_columns = max_columns
        self.is_amplitude = is_amplitude
        if tuning is None:
            tuning = self.autotune(context, max_columns, is_amplitude)
        self.engine = tuning.get("engine", "rank")

    @classmethod
    @tune.autotuner(test={"engine": "rank"})
    def autotune(cls, context, max_columns, is_amplitude) -> Mapping[str, Any]:
        device = backend.context_device(context)
        shape = (4096, int(max_columns))
        rs = np.random.RandomState(seed=1)
        if is_amplitude:
            host = rs.uniform(size=shape).astype(np.float32)
        else:
            host = (rs.standard_normal(shape)
                    + 1j * rs.standard_normal(shape)).astype(np.complex64)
        data = torch.from_numpy(host).to(device)

        def generate(engine: str):
            if engine == "cuda" and device.type != "cuda":
                raise tune.SkipConfig("the cuda engine needs a CUDA device")
            tmpl = cls(context, max_columns, is_amplitude, tuning={"engine": engine})
            op = tmpl.instantiate(None, shape)
            return tune.make_measure(lambda d: op(src=d)["dest"], data)

        return tune.autotune(generate, engine=["rank", "sort", "cuda"])

    def instantiate(self, command_queue=None, shape: Tuple[int, int] = (0, 0),
                    column_range: Optional[Tuple[int, int]] = None, allocator=None):
        return Percentile5(self, shape, column_range)


class Percentile5(base.Operation):
    """Concrete instance of :class:`Percentile5Template`.

    .. rubric:: Slots

    **src** : (rows, cols) float32 or complex64 input
    **dest** : (5, rows) float32: [min, max, p25, p75, p50] per row
    """

    def __init__(self, template: Percentile5Template, shape: Tuple[int, int],
                 column_range: Optional[Tuple[int, int]] = None) -> None:
        if len(shape) != 2:
            raise ValueError("shape must be 2-dimensional")
        if column_range is None:
            column_range = (0, shape[1])
        if column_range[0] < 0 or column_range[1] > shape[1]:
            raise ValueError("column range overflows the array")
        if column_range[0] >= column_range[1]:
            raise ValueError("column range is empty")
        if column_range[1] - column_range[0] > template.max_columns:
            raise ValueError("columns exceeds max_columns")
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.shape = tuple(shape)
        self.column_range = column_range
        in_dtype = torch.float32 if template.is_amplitude else torch.complex64
        self.slots["src"] = base.Slot(shape, in_dtype, base.Direction.IN)
        self.slots["dest"] = base.Slot((5, shape[0]), torch.float32, base.Direction.OUT)

    def _run(self, src):
        lo, hi = self.column_range
        sub = src[:, lo:hi]  # a view: K4 takes the row stride
        if not self.template.is_amplitude:
            sub = numerics.complex_abs(sub)
        return {"dest": percentile5(sub, engine=self.template.engine)}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "max_columns": self.template.max_columns,
            "is_amplitude": self.template.is_amplitude,
            "shape": self.shape,
            "column_range": self.column_range,
        }
