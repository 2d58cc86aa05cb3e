"""Fused RFI flagger: wrappers around the hand-written CUDA kernels.

Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py``
(``flag_transposed`` :1073-1221, ``flag_dump`` :998-1065,
``madnz_threshold`` :794-881, ``flag_transposed_dma`` :1361-1436).  The
kernels live in ``csrc/fused_flagger.cu``:

* **K1** (``flagger``) replaces ``pallas_flagger.py::_flagger_body``: the
  whole pipeline (amplitude, masked median background, MAD noise,
  SumThreshold) with one CTA per row and the row resident in shared
  memory, so each visibility is read once and each flag written once.
* **K2** (``madnz_threshold``) replaces
  ``pallas_flagger.py::_madnz_threshold_block``: MAD noise + SumThreshold
  from deviations, for the hybrid engine.

Both run as one launch over all rows, which takes the place of the TPU's
in-kernel DMA block loop (``_dma_block_loop``).  The TPU layout knobs
(``bb``, ``fold``, ``nref``, ``pipeline``, ``layout``, ``ingest``,
``rank_radix``, ``slab``) have no counterpart: a row is one CTA.

A tensor on the CPU goes to the plain version beside each kernel
(:func:`flag_transposed_plain`, :func:`madnz_threshold_plain`), composed
of the :mod:`.device` stages; a CUDA tensor goes to the kernel, or the
call raises.  :data:`launches` counts the kernel launches.
"""

import ctypes
import functools

import numpy as np
import torch

from ...ops import rank as rank_ops
from . import device
from .device import BackgroundFlags

# Kernel launches since the counts were last reset, per kernel.  Each
# wrapper adds one where it launches its kernel, and nowhere else.
launches = {"flagger": 0, "madnz_threshold": 0}

MAX_WIDTH = 31  # the kernel holds a window's members in registers


def _network_header(width: int) -> str:
    """``ff_network.h`` for `width`: the selection networks as comparator macros.

    Rendered from :func:`..ops.rank.selection_network`, so the kernel runs
    the same comparators, in the same order, as the tensor code and the
    JAX reference.
    """
    h = width // 2
    macro = {"both": "FF_CE_BOTH", "min": "FF_CE_MIN", "max": "FF_CE_MAX"}

    def render(name, net):
        body = " ".join(f"{macro[kind]}(w, {i}, {j})" for i, j, kind in net)
        return f"#define {name}(w) do {{ {body} }} while (0)\n"

    return (
        "// Generated from katsdpsigproc_tpu_torch.ops.rank.selection_network.\n"
        f"#define FF_WIDTH {width}\n"
        + render("FF_NET_FAST", rank_ops.selection_network(width, (h, h + 1)))
        + render("FF_NET_LOWER", rank_ops.selection_network(width, range(h + 1)))
    )


@functools.lru_cache(maxsize=None)
def _library(width: int) -> ctypes.CDLL:
    from ...utils import kernels

    lib = kernels.load("fused_flagger", ["fused_flagger.cu"],
                       {"ff_network.h": _network_header(width)})
    lib.ff_max_channels.argtypes = []
    lib.ff_max_channels.restype = ctypes.c_int
    lib.ff_error_string.argtypes = [ctypes.c_int]
    lib.ff_error_string.restype = ctypes.c_char_p
    lib.ff_flagger.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.ff_flagger.restype = ctypes.c_int
    lib.ff_madnz_threshold.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ff_madnz_threshold.restype = ctypes.c_int
    return lib


def _check_params(n_windows: int, flag_value: int) -> None:
    if n_windows < 0:
        raise ValueError(f"n_windows must be >= 0, got {n_windows}")
    if not 0 <= flag_value <= 255:
        raise ValueError(f"flag_value must fit uint8, got {flag_value}")


def _check_tensor(name: str, t, dtype, shape, device_of) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device_of:
        raise ValueError(f"{name} is on {t.device}, expected {device_of}")


def _window_scales(falloff: float, n_windows: int, channels: int) -> np.ndarray:
    """float32(falloff ** -w), the power in double, for each window that fits."""
    return np.array([np.float32(falloff ** -w) for w in range(n_windows)
                     if (1 << w) <= channels], dtype=np.float32)


def _launch_args(lib, tensors, channels: int, n_sigma: float, falloff: float, n_windows: int):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors")
    limit = lib.ff_max_channels()
    if channels > limit:
        raise ValueError(
            f"{channels} channels exceed the kernel's limit of {limit} channels: one "
            f"row (5 B per channel) must fit one CTA's shared memory")
    scales = _window_scales(falloff, n_windows, channels)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    return scales, ctypes.c_float(np.float32(n_sigma)), stream


def _raise_on(lib, err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: cudaError {err} ({lib.ff_error_string(err).decode()})")


def flag_transposed_plain(vis_t, input_flags=None, *, width: int = 13, n_sigma: float = 11.0,
                          n_windows: int = 4, falloff: float = 1.2, flag_value: int = 1,
                          channel_flags=None):
    """The plain PyTorch version of K1, composed of the :mod:`.device` stages.

    Background on (rows, channels) with FULL/CHANNEL flags as NaN,
    ``madnz(axis=-1)`` and ``threshold_sum(transposed=True)``.  The
    background takes its edge-fill fast path exactly when the kernel does
    (no input flags, odd width, channels >= width).  On finite input the
    fast and general paths agree; on NaN input they do not (the general
    path treats NaN as absent).
    """
    vis = vis_t.transpose(0, 1)  # (channels, rows, 2) view
    if input_flags is not None:
        mode, flags = BackgroundFlags.FULL, input_flags.transpose(0, 1)
    elif channel_flags is not None:
        mode, flags = BackgroundFlags.CHANNEL, channel_flags
    else:
        mode, flags = BackgroundFlags.NONE, None
    dev = device.background_median_filter(vis, flags, width, False, mode, fast_path=True)
    return madnz_threshold_plain(dev.transpose(0, 1).contiguous(), n_sigma=n_sigma,
                                 n_windows=n_windows, falloff=falloff, flag_value=flag_value)


def madnz_threshold_plain(dev_t, *, n_sigma: float = 11.0, n_windows: int = 4,
                          falloff: float = 1.2, flag_value: int = 1):
    """The plain PyTorch version of K2: ``madnz`` then ``threshold_sum``."""
    noise = device.madnz(dev_t)
    return device.threshold_sum(dev_t, noise, n_sigma, n_windows, falloff, flag_value,
                                transposed=True)


def flag_transposed(vis_t, input_flags=None, *, width: int = 13, n_sigma: float = 11.0,
                    n_windows: int = 4, falloff: float = 1.2, flag_value: int = 1,
                    channel_flags=None):
    """Fused flagger on baseline-major planar visibilities (K1).

    Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py::flag_transposed``
    and ``::flag_transposed_dma``.

    Parameters
    ----------
    vis_t
        (rows, channels, 2) float32 (re, im) pairs, one row per baseline
        (and polarization).
    input_flags
        Optional (rows, channels) uint8 prior flags (FULL mode); non-zero
        samples are excluded from the background.
    channel_flags
        Optional (channels,) uint8 prior flags shared by every row
        (CHANNEL mode).  Mutually exclusive with ``input_flags``.
    width, n_sigma, n_windows, falloff, flag_value
        The flagger's parameters, as in the JAX function.

    Returns
    -------
    (rows, channels) uint8 flags on the input's device.
    """
    if input_flags is not None and channel_flags is not None:
        raise ValueError("pass either input_flags (FULL) or channel_flags (CHANNEL), not both")
    if width % 2 != 1 or not 3 <= width <= MAX_WIDTH:
        raise ValueError(f"width must be odd and in 3..{MAX_WIDTH}, got {width}")
    _check_params(n_windows, flag_value)
    if not isinstance(vis_t, torch.Tensor) or vis_t.ndim != 3 or vis_t.shape[-1] != 2:
        raise ValueError("vis_t must be a (rows, channels, 2) tensor")
    if vis_t.dtype != torch.float32:
        raise TypeError(f"vis_t must be torch.float32, got {vis_t.dtype}")
    rows, channels = vis_t.shape[:2]
    if input_flags is not None:
        _check_tensor("input_flags", input_flags, torch.uint8, (rows, channels), vis_t.device)
    if channel_flags is not None:
        _check_tensor("channel_flags", channel_flags, torch.uint8, (channels,), vis_t.device)
    kw = dict(width=width, n_sigma=n_sigma, n_windows=n_windows, falloff=falloff,
              flag_value=flag_value)
    if vis_t.device.type == "cpu":
        return flag_transposed_plain(vis_t, input_flags, channel_flags=channel_flags, **kw)
    if vis_t.device.type != "cuda":
        raise ValueError(f"unsupported device {vis_t.device}")
    out = torch.empty((rows, channels), dtype=torch.uint8, device=vis_t.device)
    if rows == 0 or channels == 0:
        return out
    with torch.cuda.device(vis_t.device):
        mode, flags = 0, None
        if input_flags is not None:
            mode, flags = 1, input_flags
        elif channel_flags is not None:
            mode, flags = 2, channel_flags
        lib = _library(width)
        scales, sigma, stream = _launch_args(
            lib, [t for t in (vis_t, flags) if t is not None], channels, n_sigma, falloff,
            n_windows)
        err = lib.ff_flagger(vis_t.data_ptr(), None if flags is None else flags.data_ptr(), mode,
                             out.data_ptr(), rows, channels, sigma, scales.ctypes.data,
                             len(scales), flag_value, stream)
    _raise_on(lib, err, "flagger")
    launches["flagger"] += 1
    return out


# The JAX package's flag_dump slabs a dump through a scan or an in-kernel
# DMA loop; here one launch already covers every row of any dump.
flag_dump = flag_transposed


def madnz_threshold(dev_t, *, n_sigma: float = 11.0, n_windows: int = 4, falloff: float = 1.2,
                    flag_value: int = 1):
    """Fused MAD noise + SumThreshold on (rows, channels) float32 deviations (K2).

    Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py::madnz_threshold``.
    Returns (rows, channels) uint8 flags on the input's device.
    """
    _check_params(n_windows, flag_value)
    if not isinstance(dev_t, torch.Tensor) or dev_t.ndim != 2:
        raise ValueError("dev_t must be a (rows, channels) tensor")
    if dev_t.dtype != torch.float32:
        raise TypeError(f"dev_t must be torch.float32, got {dev_t.dtype}")
    kw = dict(n_sigma=n_sigma, n_windows=n_windows, falloff=falloff, flag_value=flag_value)
    if dev_t.device.type == "cpu":
        return madnz_threshold_plain(dev_t, **kw)
    if dev_t.device.type != "cuda":
        raise ValueError(f"unsupported device {dev_t.device}")
    rows, channels = dev_t.shape
    out = torch.empty((rows, channels), dtype=torch.uint8, device=dev_t.device)
    if rows == 0 or channels == 0:
        return out
    with torch.cuda.device(dev_t.device):
        # K2 shares K1's library; the network header's width does not affect it.
        lib = _library(13)
        scales, sigma, stream = _launch_args(lib, [dev_t], channels, n_sigma, falloff, n_windows)
        err = lib.ff_madnz_threshold(dev_t.data_ptr(), out.data_ptr(), rows, channels, sigma,
                                     scales.ctypes.data, len(scales), flag_value, stream)
    _raise_on(lib, err, "madnz_threshold")
    launches["madnz_threshold"] += 1
    return out
