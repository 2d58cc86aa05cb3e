"""Fused RFI flagger: wrappers around the hand-written CUDA kernels.

Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py``
(``flag_transposed`` :1073-1221, ``flag_dump`` :998-1065,
``madnz_threshold`` :794-881, ``flag_transposed_dma`` :1361-1436).  The
kernels live in ``csrc/fused_flagger.cu``:

* **K1** (``flagger``) replaces ``pallas_flagger.py::_flagger_body``: the
  whole pipeline (amplitude, masked median background, MAD noise,
  SumThreshold) with one CTA per row and the row resident in shared
  memory, so each visibility is read once and each flag written once.
  Its row is in the run layout of ``csrc/ff_runs.cuh``
  (:func:`launch_config`, :func:`max_channels`), in a CTA sized to the
  row (:func:`k1_threads`); longer rows and wider windows take the
  wide-row path (below).
* **K2** (``madnz_threshold``) replaces
  ``pallas_flagger.py::_madnz_threshold_block``: MAD noise + SumThreshold
  from deviations, for the hybrid engine, on K1's run layout up to K1's
  channel limit (:func:`max_channels`), and on the wide-row path beyond
  it.
* **BG** (``background``, :func:`background_deviations`) replaces the
  hybrid engine's eager background pass (no Pallas kernel: XLA's in the
  JAX package): the masked median background of a (channels, rows) slab,
  read where it lies in the channel-major dump, written as (rows,
  channels) deviations, K2's layout; tiles of channels x rows in shared
  memory, one launch a slab.

K1 and K2 run as one launch over all rows, which takes the place of the
TPU's in-kernel DMA block loop (``_dma_block_loop``): :func:`flag_transposed`,
:func:`flag_transposed_dma` and :func:`flag_dump` are each one launch of
K1, and :func:`madnz_threshold` one of K2.  A row longer than
:func:`max_channels` does not fit one CTA's shared memory: it takes the
*wide-row path*, the same stages in ``csrc/ff_device.cuh``'s
channel-strided arithmetic on a slice of a device scratch buffer that the
wrapper allocates, one slice for each CTA of a grid of about one CTA per
SM that loops over the rows (:data:`wide_launches` counts these
launches).  The wrappers take the
JAX functions' parameters in their order.  The TPU layout knobs (``bb``,
``fold``, ``interpret``, ``nref``, ``pipeline``, ``rank_radix``,
``slab``) are accepted and ignored: a row is one CTA.  ``rank_radix`` is
checked as the JAX functions check it (1..4).  The JAX functions' other
input forms give the same flags there, and are taken here: a
``layout="leading"`` (2, rows, channels) input is read through its
(rows, channels, 2) view, and ``ingest="amp"`` (where the TPU streams
amplitudes made outside the kernel) is K1 on the planar pairs.

A tensor on the CPU goes to the plain version beside each kernel
(:func:`flag_transposed_plain`, :func:`madnz_threshold_plain`,
:func:`background_deviations_plain`), composed of the :mod:`.device`
stages; a CUDA tensor goes to the kernel, or the call raises.
:data:`launches` counts the kernel launches, :data:`k1_ctas` K1's by the
threads of its CTAs, :data:`k1_modes` K1's by its input-flag mode, and
:data:`row_major` how their rows were made
contiguous.  While a profiler session records, :func:`flag_transposed`
(and so :func:`flag_dump` and :func:`flag_transposed_dma`) records its
host work as spans (:func:`..utils.profiling.annotate`): ``ksp.flag_dump``
the whole call, ``ksp.flag_dump.check`` its checks and the flags'
allocation, ``ksp.flag_dump.input_flags`` the FULL flags' checks and their
turn to row-major (only where ``input_flags`` is given), and
``ksp.launch.k1`` (``ksp.launch.k1_wide``) K1's launch alone;
:func:`madnz_threshold` records K2's launch alone as ``ksp.launch.k2``
(``ksp.launch.k2_wide``), :func:`background_deviations` BG's as
``ksp.launch.bg``.
"""

import ctypes
import functools
from typing import Any, Mapping

import numpy as np
import torch

from ...ops import rank as rank_ops, transpose as transpose_ops
from ...utils import backend, profiling, tune
from . import device
from .device import BackgroundFlags

# Kernel launches since the counts were last reset, per kernel.  Each
# wrapper adds one where it launches its kernel, and nowhere else.
launches = {"flagger": 0, "madnz_threshold": 0, "background": 0}
# Of those, the launches on the wide-row path.
wide_launches = {"flagger": 0, "madnz_threshold": 0}
# K1's CTA sizes, fewest threads first: the instances ``ff_flagger`` launches.
K1_THREADS = (128, 256, 512, 1024)
# K1's launches, wide-row path included, by the threads of their CTAs.
k1_ctas = {threads: 0 for threads in K1_THREADS}
# K1's input-flag modes by the kernel's code (kMode 0, 1, 2).
K1_MODES = ("none", "full", "channel")
# K1's launches, wide-row path included, by mode.
k1_modes = {mode: 0 for mode in K1_MODES}
# How :func:`_row_major` gave the kernels their rows since the counts were
# last reset: corner-turned by K5, or copied whole by ``contiguous()``.
row_major = {"turned": 0, "copied": 0}

# The widest window whose members K1 holds in registers, sorted by a
# selection network without spilling at 64 registers (nvcc 12.9 for
# sm_90a: 51 spills 4 B on the wide-row path; ``chip_smoke.py`` phase 2
# checks each width it builds).  Wider windows take the median's ranks by
# counting, from the members in shared or device memory.
REGISTER_MAX_WIDTH = 49
# The widest window of the run layout's in-place median
# (``runs::kMaxInPlaceWidth``); wider ones take the wide-row path.
IN_PLACE_MAX_WIDTH = 65
# The channels a thread of K1 holds in registers for its rank search
# (``runs::kRankRegs``).
RANK_REGS = 32
# The widest window the background kernel's tile takes (``kBgMaxWidth``).
BACKGROUND_MAX_WIDTH = 255
# The background kernel's paths (``kBgGeneral``, ``kBgFast``, ``kBgKeepNan``).
_BG_GENERAL, _BG_FAST, _BG_KEEP_NAN = 0, 1, 2


def k1_threads(channels: int) -> int:
    """The threads of K1's CTA for a row of `channels`: the rule, and its only home.

    The fewest of :data:`K1_THREADS` whose rank search holds every channel
    of the row in registers, :data:`RANK_REGS` a thread, and 1024 for
    longer rows.  Each thread's run of SumThreshold is then at most 32
    channels, so every window up to 8 takes the register path where the
    run is at least 7 channels.  At 64 registers a thread, 1024 / threads
    rows share an SM: 128 threads and 8 rows at 4096 channels, 1024 and 1
    at 32768.
    """
    return next((t for t in K1_THREADS if channels <= RANK_REGS * t), K1_THREADS[-1])


def _network_header(width: int) -> str:
    """``ff_network.h`` for `width`: the selection networks as comparator macros.

    Rendered from :func:`..ops.rank.selection_network`, so the kernel runs
    the same comparators, in the same order, as the tensor code and the
    JAX reference.  Above :data:`REGISTER_MAX_WIDTH` it defines
    ``FF_MEDIAN_COUNT`` instead: the kernel takes the same ranks by
    counting.
    """
    if width > REGISTER_MAX_WIDTH:
        return ("// The median's ranks by counting (ff_device.cuh's count_deviation).\n"
                f"#define FF_WIDTH {width}\n#define FF_MEDIAN_COUNT 1\n")
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


# The out-parameters of a library's launch-configuration query: threads
# per CTA, dynamic shared memory in bytes, CTAs per SM.
_LAUNCH_CONFIG_OUT = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
                      ctypes.POINTER(ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _library(width: int) -> ctypes.CDLL:
    from ...utils import kernels

    lib = kernels.load("fused_flagger", ["fused_flagger.cu"],
                       {"ff_network.h": _network_header(width)})
    lib.ff_max_channels.argtypes = []
    lib.ff_max_channels.restype = ctypes.c_int
    lib.ff_error_string.argtypes = [ctypes.c_int]
    lib.ff_error_string.restype = ctypes.c_char_p
    for query in (lib.ff_max_in_place_width, lib.ff_wide_ctas):
        query.argtypes = []
        query.restype = ctypes.c_int
    lib.ff_wide_row_bytes.argtypes = [ctypes.c_int]
    lib.ff_wide_row_bytes.restype = ctypes.c_longlong
    lib.ff_launch_config.argtypes = [ctypes.c_int, ctypes.c_int] + _LAUNCH_CONFIG_OUT
    lib.ff_launch_config.restype = ctypes.c_int
    k1_args = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.ff_flagger.argtypes = k1_args + [ctypes.c_int, ctypes.c_void_p]
    lib.ff_flagger.restype = ctypes.c_int
    lib.ff_flagger_wide.argtypes = k1_args + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.ff_flagger_wide.restype = ctypes.c_int
    lib.ff_madnz_threshold_wide.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.ff_madnz_threshold_wide.restype = ctypes.c_int
    lib.ff_madnz_threshold.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ff_madnz_threshold.restype = ctypes.c_int
    lib.ff_background.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    lib.ff_background.restype = ctypes.c_int
    return lib


def _check_params(n_windows: int, flag_value: int) -> None:
    if n_windows < 0:
        raise ValueError(f"n_windows must be >= 0, got {n_windows}")
    if not 0 <= flag_value <= 255:
        raise ValueError(f"flag_value must fit uint8, got {flag_value}")


def _check_rank_radix(rank_radix: int) -> None:
    """``rank_radix`` as the JAX functions take it: 1..4 bits a rank round."""
    if rank_radix not in (1, 2, 3, 4):
        raise ValueError("rank_radix must be 1..4")


def _vis_dims(vis_t, layout: str):
    """(rows, channels) of planar visibilities in `layout`, checked as JAX's ``_vis_dims``.

    ``"trailing"``: (rows, channels, 2); ``"leading"``: (2, rows, channels).
    """
    if not isinstance(vis_t, torch.Tensor):
        raise ValueError(f"vis_t must be a tensor, got {type(vis_t).__name__}")
    if layout == "trailing":
        if vis_t.ndim != 3 or vis_t.shape[-1] != 2:
            raise ValueError(
                f"layout='trailing' expects (baselines, channels, 2), got {tuple(vis_t.shape)}: "
                f"vis_t must be a (rows, channels, 2) tensor")
        return vis_t.shape[0], vis_t.shape[1]
    if layout == "leading":
        if vis_t.ndim != 3 or vis_t.shape[0] != 2:
            raise ValueError(
                f"layout='leading' expects (2, baselines, channels), got {tuple(vis_t.shape)}: "
                f"vis_t must be a (2, rows, channels) tensor")
        return vis_t.shape[1], vis_t.shape[2]
    raise ValueError("layout must be 'trailing' or 'leading'")


def _check_ingest(ingest: str, nref: int) -> None:
    if ingest not in ("planar", "amp"):
        raise ValueError(f"unknown ingest {ingest!r}")
    if ingest == "amp" and nref != 1:
        raise ValueError("ingest='amp' supports nref=1 only")


def _check_tensor(name: str, t, dtype, shape, device_of) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device_of:
        raise ValueError(f"{name} is on {t.device}, expected {device_of}")


def _row_major(t):
    """`t` with its rows contiguous, as the kernels read them.

    The transposed view of a contiguous tensor (the JAX callers'
    ``swapaxes`` of a channel-major dump) is corner-turned by K5
    (:func:`..ops.transpose.transpose_cuda`); any other strided layout is
    copied by ``contiguous()``.  Either way the same kernel runs after.
    """
    if t.is_contiguous():
        return t
    if t.ndim >= 2 and t.transpose(0, 1).is_contiguous():
        row_major["turned"] += 1
        return transpose_ops.transpose_cuda(t.transpose(0, 1))
    row_major["copied"] += 1
    return t.contiguous()


def _window_scales(falloff: float, n_windows: int, channels: int) -> np.ndarray:
    """float32(falloff ** -w), the power in double, for each window that fits."""
    return np.array([np.float32(falloff ** -w) for w in range(n_windows)
                     if (1 << w) <= channels], dtype=np.float32)


def _check_limit(channels: int, limit: int) -> None:
    """The probes' and measurement builds' limit: their rows have no wide-row path."""
    if channels > limit:
        raise ValueError(
            f"{channels} channels exceed the kernel's limit of {limit} channels: one "
            f"row must fit one CTA's shared memory")


def _launch_args(tensors, channels: int, n_sigma: float, falloff: float, n_windows: int):
    """The window scales, n_sigma and stream of a launch; the tensors must be contiguous."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors")
    scales = _window_scales(falloff, n_windows, channels)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    return scales, ctypes.c_float(np.float32(n_sigma)), stream


def _wide_path(channels: int, limit: int, width: int = 13) -> bool:
    """Whether a row takes the wide-row path on the card.

    It does when it is longer than `limit` (:func:`max_channels`) or its
    window wider than :data:`IN_PLACE_MAX_WIDTH`.
    """
    return channels > limit or width > IN_PLACE_MAX_WIDTH


def _wide_scratch(lib, rows: int, channels: int, dev):
    """The wide-row path's grid and its scratch, one row's slice per CTA."""
    ctas = min(rows, lib.ff_wide_ctas())
    if ctas < 1:
        raise RuntimeError("no CTA of the wide-row path fits an SM of this device")
    nbytes = ctas * lib.ff_wide_row_bytes(channels)
    return ctas, torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _raise_on(lib, err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: cudaError {err} ({lib.ff_error_string(err).decode()})")


def _query_launch_config(lib, query, *args) -> dict:
    """Call a library's launch-configuration `query` with `args` and its out-parameters."""
    threads, smem, ctas = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    err = query(*args, ctypes.byref(threads), ctypes.byref(smem), ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"no launch configuration for {args}: cudaError {err} "
                           f"({lib.ff_error_string(err).decode()})")
    return {"threads": threads.value, "smem_bytes": smem.value, "ctas_per_sm": ctas.value}


def launch_config(channels: int) -> dict:
    """How K1 launches at `channels`, from the library itself.

    ``threads`` per CTA (:func:`k1_threads`), ``smem_bytes`` of dynamic
    shared memory and ``ctas_per_sm``, the CTAs the occupancy calculator
    fits on one SM.  K1 holds a row in the run layout of
    ``csrc/ff_runs.cuh``, as K2 and K1's stage and rank-search probes
    (K11, K13) do in the same shared memory at K1's 1024-thread instance
    (:func:`_launch_config_at`).  Needs a CUDA device.
    """
    return _launch_config_at(channels, k1_threads(channels))


def _launch_config_at(channels: int, threads: int) -> dict:
    """:func:`launch_config` of K1's instance of `threads` threads a CTA at `channels`."""
    lib = _library(13)  # the network header's width does not change the launch
    return _query_launch_config(lib, lib.ff_launch_config, channels, threads)


def max_channels() -> int:
    """The most channels of a row on K1's and K2's shared-memory path (the run layout).

    Longer rows take the wide-row path.  Needs a CUDA device.
    """
    return _library(13).ff_max_channels()


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


def _prepare(vis_t, input_flags, channel_flags, width: int, n_windows: int, flag_value: int,
             layout: str, ingest: str, nref: int, rank_radix: int):
    """:func:`flag_transposed`'s checks, and on the card its flags' allocation and K1's library.

    Returns the (rows, channels, 2) view of `vis_t`, the (rows, channels)
    uint8 flags to fill, the library and whether the rows take the
    wide-row path.  On the CPU the last three are None, None, False, and
    so are the last two for a dump with no rows or no channels.  FULL
    flags are checked after, by :func:`_full_flags`.
    """
    _check_rank_radix(rank_radix)
    if input_flags is not None and channel_flags is not None:
        raise ValueError("pass either input_flags (FULL) or channel_flags (CHANNEL), not both")
    _check_ingest(ingest, nref)
    if width % 2 != 1 or width < 3:
        raise ValueError(f"width must be odd and at least 3, got {width}")
    _check_params(n_windows, flag_value)
    rows, channels = _vis_dims(vis_t, layout)
    if vis_t.dtype != torch.float32:
        raise TypeError(f"vis_t must be torch.float32, got {vis_t.dtype}")
    if layout == "leading":
        vis_t = vis_t.permute(1, 2, 0)
    if channel_flags is not None:
        _check_tensor("channel_flags", channel_flags, torch.uint8, (channels,), vis_t.device)
    if vis_t.device.type == "cpu":
        return vis_t, None, None, False
    if vis_t.device.type != "cuda":
        raise ValueError(f"unsupported device {vis_t.device}")
    out = torch.empty((rows, channels), dtype=torch.uint8, device=vis_t.device)
    if rows == 0 or channels == 0:
        return vis_t, out, None, False
    lib = _library(width)
    return vis_t, out, lib, _wide_path(channels, lib.ff_max_channels(), width)


def _full_flags(input_flags, vis_t):
    """FULL mode's (rows, channels) uint8 flags, checked against the (rows, channels, 2) `vis_t`.

    On the card they are returned row-major, as K1 reads them: the
    transposed view of channel-major flags is corner-turned by K5's 1-byte
    instance (:func:`_row_major`).
    """
    _check_tensor("input_flags", input_flags, torch.uint8, vis_t.shape[:2], vis_t.device)
    if vis_t.device.type != "cuda" or input_flags.numel() == 0:
        return input_flags
    with torch.cuda.device(vis_t.device):
        return _row_major(input_flags)


def flag_transposed(vis_t, input_flags=None, width: int = 13, n_sigma: float = 11.0,
                    n_windows: int = 4, falloff: float = 1.2, flag_value: int = 1,
                    bb: int = 4, fold: int = 1024, interpret: bool = False,
                    channel_flags=None, nref: int = 1, rank_radix: int = 1,
                    layout: str = "trailing", ingest: str = "planar"):
    """Fused flagger on baseline-major planar visibilities (K1).

    Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py::flag_transposed``,
    with its parameters in its order.

    Parameters
    ----------
    vis_t
        (rows, channels, 2) float32 (re, im) pairs, one row per baseline
        (and polarization), in any layout: on the card the transposed view
        of a channel-major dump is corner-turned by K5 first, any other
        strided layout copied.  With ``layout="leading"``, (2, rows,
        channels).
    input_flags
        Optional (rows, channels) uint8 prior flags (FULL mode); non-zero
        samples are excluded from the background.
    channel_flags
        Optional (channels,) uint8 prior flags shared by every row
        (CHANNEL mode).  Mutually exclusive with ``input_flags``.
    width, n_sigma, n_windows, falloff, flag_value
        The flagger's parameters, as in the JAX function: any odd
        ``width >= 3``.  On the card the width picks K1's median path:
        up to :data:`REGISTER_MAX_WIDTH` (49) the window's members sit in
        registers and a selection network sorts them; up to
        :data:`IN_PLACE_MAX_WIDTH` (65) the kernel counts their ranks from
        the members in shared memory; wider windows, and rows longer than
        :func:`max_channels`, take the wide-row path, which counts (or,
        up to 49, sorts) from the members in device scratch.  Every path
        gives the plain version's flags.
    bb, fold, interpret, nref, rank_radix
        The TPU kernel's layout knobs.  Accepted and ignored: they do not
        change the result, and a row here is one CTA.  ``rank_radix``
        outside 1..4 raises ``ValueError``, as in the JAX function.
    layout
        ``"trailing"`` (rows, channels, 2) or ``"leading"`` (2, rows,
        channels); a leading input is read through its (rows, channels,
        2) view, so on the card it is copied to row-major first.
    ingest
        ``"planar"`` or ``"amp"``.  The TPU kernel's amplitude stream
        gives the same flags, so both are K1 reading the planar pairs;
        ``"amp"`` takes ``nref=1`` only, as in the JAX function.

    Returns
    -------
    (rows, channels) uint8 flags on the input's device.
    """
    del bb, fold, interpret
    with profiling.annotate("ksp.flag_dump"):
        with profiling.annotate("ksp.flag_dump.check"):
            vis_t, out, lib, wide = _prepare(vis_t, input_flags, channel_flags, width, n_windows,
                                             flag_value, layout, ingest, nref, rank_radix)
        if input_flags is not None:
            with profiling.annotate("ksp.flag_dump.input_flags"):
                input_flags = _full_flags(input_flags, vis_t)
        kw = dict(n_sigma=n_sigma, n_windows=n_windows, falloff=falloff, flag_value=flag_value)
        if vis_t.device.type == "cpu":
            return flag_transposed_plain(vis_t, input_flags, channel_flags=channel_flags,
                                         width=width, **kw)
        if out.numel() == 0:
            return out
        return _k1(vis_t, input_flags, channel_flags, out, lib, wide,
                   k1_threads(out.shape[1]), **kw)


def _k1(vis_t, input_flags, channel_flags, out, lib, wide: bool, threads: int, *,
        n_sigma: float, n_windows: int, falloff: float, flag_value: int):
    """K1's launch into `out`, from :func:`_prepare`'s results, in CTAs of `threads`.

    The wide-row path takes 1024 threads whatever `threads` says.
    """
    rows, channels = out.shape
    with torch.cuda.device(vis_t.device):
        mode, flags = 0, None
        if input_flags is not None:
            mode, flags = 1, input_flags
        elif channel_flags is not None:
            mode, flags = 2, channel_flags
        vis_t = _row_major(vis_t)
        flags = None if flags is None else _row_major(flags)
        scales, sigma, stream = _launch_args(
            [t for t in (vis_t, flags) if t is not None], channels, n_sigma, falloff, n_windows)
        args = (vis_t.data_ptr(), None if flags is None else flags.data_ptr(), mode,
                out.data_ptr(), rows, channels, sigma, scales.ctypes.data, len(scales),
                flag_value)
        if wide:
            threads = K1_THREADS[-1]
            ctas, scratch = _wide_scratch(lib, rows, channels, vis_t.device)
            with profiling.annotate("ksp.launch.k1_wide"):
                err = lib.ff_flagger_wide(*args, scratch.data_ptr(), ctas, stream)
        else:
            with profiling.annotate("ksp.launch.k1"):
                err = lib.ff_flagger(*args, threads, stream)
    _raise_on(lib, err, "flagger")
    launches["flagger"] += 1
    wide_launches["flagger"] += wide
    k1_ctas[threads] += 1
    k1_modes[K1_MODES[mode]] += 1
    return out


def _flag_at(vis_t, threads: int, input_flags=None, channel_flags=None, width: int = 13,
             n_sigma: float = 11.0, n_windows: int = 4, falloff: float = 1.2,
             flag_value: int = 1):
    """K1 on a CUDA `vis_t` in its instance of `threads` threads a CTA, rule or not.

    :func:`flag_transposed`'s flags, for holding every instance to the
    plain version and to the others, and for timing one against another.
    """
    vis_t, out, lib, wide = _prepare(vis_t, input_flags, channel_flags, width, n_windows,
                                     flag_value, "trailing", "planar", 1, 1)
    if input_flags is not None:
        input_flags = _full_flags(input_flags, vis_t)
    if lib is None or wide:
        raise ValueError("K1's instances need a CUDA dump whose rows fit the run layout")
    return _k1(vis_t, input_flags, channel_flags, out, lib, wide, threads, n_sigma=n_sigma,
               n_windows=n_windows, falloff=falloff, flag_value=flag_value)


def flag_transposed_dma(vis_t, input_flags=None, width: int = 13, n_sigma: float = 11.0,
                        n_windows: int = 4, falloff: float = 1.2, flag_value: int = 1,
                        bb: int = 1, fold: int = 1024, interpret: bool = False,
                        channel_flags=None, rank_radix: int = 1,
                        layout: str = "trailing", ingest: str = "planar"):
    """:func:`flag_transposed` as one launch over all rows (K1).

    Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py::flag_transposed_dma``,
    with its parameters in its order.  The JAX function runs its block
    loop inside one kernel (``_dma_block_loop``); K1's one launch over
    every row, a CTA a row, is that loop, so this is
    :func:`flag_transposed` with the same flags, checks and launch count.
    """
    return flag_transposed(vis_t, input_flags, width, n_sigma, n_windows, falloff, flag_value,
                           bb, fold, interpret, channel_flags, rank_radix=rank_radix,
                           layout=layout, ingest=ingest)


def flag_dump(vis_t, input_flags=None, slab: int = 256, width: int = 13,
              n_sigma: float = 11.0, n_windows: int = 4, falloff: float = 1.2,
              flag_value: int = 1, bb: int = 1, fold: int = 1024, interpret: bool = False,
              channel_flags=None, nref: int = 1, pipeline: str = "grid",
              layout: str = "trailing", ingest: str = "planar"):
    """Flag a whole dump with one launch of K1.

    Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py::flag_dump``,
    with its parameters in its order.  The JAX function slabs a dump
    through a scan (``pipeline="grid"``, :func:`flag_transposed`) or an
    in-kernel DMA loop (``"dma"``, :func:`flag_transposed_dma`); here
    one launch already covers every row, so ``slab`` is ignored, and
    ``pipeline`` only picks which of the two wrappers (the same launch)
    takes the call, as in the JAX function.
    """
    del slab
    kw = dict(width=width, n_sigma=n_sigma, n_windows=n_windows, falloff=falloff,
              flag_value=flag_value, bb=bb, fold=fold, interpret=interpret,
              channel_flags=channel_flags, layout=layout, ingest=ingest)
    if pipeline == "dma":
        return flag_transposed_dma(vis_t, input_flags, **kw)
    return flag_transposed(vis_t, input_flags, nref=nref, **kw)


def madnz_threshold(dev_t, n_sigma: float = 11.0, n_windows: int = 4, falloff: float = 1.2,
                    flag_value: int = 1, bb: int = 4, fold: int = 1024,
                    interpret: bool = False, nref: int = 1, pipeline: str = "grid",
                    rank_radix: int = 1):
    """Fused MAD noise + SumThreshold on (rows, channels) float32 deviations (K2).

    Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py::madnz_threshold``,
    with its parameters in its order; the TPU layout knobs (``bb`` to
    ``rank_radix``) are accepted and ignored, but a ``rank_radix`` outside
    1..4 raises ``ValueError`` as in the JAX function.  On the card the transposed
    view of a contiguous (channels, rows) array is corner-turned by K5
    first, any other strided layout copied.  A row of up to
    :func:`max_channels` channels runs on K1's run layout, a longer one on
    the wide-row path.  Returns (rows, channels) uint8 flags on the
    input's device.
    """
    _check_rank_radix(rank_radix)
    del bb, fold, interpret, nref, pipeline, rank_radix
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
        wide = _wide_path(channels, lib.ff_max_channels())
        dev_t = _row_major(dev_t)
        scales, sigma, stream = _launch_args([dev_t], channels, n_sigma, falloff, n_windows)
        args = (dev_t.data_ptr(), out.data_ptr(), rows, channels, sigma, scales.ctypes.data,
                len(scales), flag_value)
        if wide:
            ctas, scratch = _wide_scratch(lib, rows, channels, dev_t.device)
            with profiling.annotate("ksp.launch.k2_wide"):
                err = lib.ff_madnz_threshold_wide(*args, scratch.data_ptr(), ctas, stream)
        else:
            with profiling.annotate("ksp.launch.k2"):
                err = lib.ff_madnz_threshold(*args, stream)
    _raise_on(lib, err, "madnz_threshold")
    launches["madnz_threshold"] += 1
    wide_launches["madnz_threshold"] += wide
    return out


def background_deviations_plain(vis, flags, width: int, is_amplitude: bool,
                                use_flags: BackgroundFlags, fast_path=None):
    """The plain PyTorch version of the background kernel: the background pass, then its turn.

    :func:`.device.background_median_filter` of the (channels, rows) slab,
    its deviations turned to (rows, channels) by ``transpose(0, 1).contiguous()``.
    """
    dev = device.background_median_filter(vis, flags, width, is_amplitude, use_flags,
                                           fast_path=fast_path)
    return dev.transpose(0, 1).contiguous()


def _check_background(vis, flags, width: int, is_amplitude: bool, use_flags) -> None:
    """:func:`background_deviations`' checks of what the kernel takes."""
    if not isinstance(vis, torch.Tensor):
        raise TypeError(f"vis must be a tensor, got {type(vis).__name__}")
    if not isinstance(use_flags, BackgroundFlags):
        raise TypeError(f"use_flags must be a BackgroundFlags, got {use_flags!r}")
    if width % 2 != 1 or not 3 <= width <= BACKGROUND_MAX_WIDTH:
        raise ValueError(f"width must be odd, from 3 to {BACKGROUND_MAX_WIDTH}, got {width}")
    what = "amplitudes" if is_amplitude else "planar (re, im) pairs"
    if vis.dtype != torch.float32:
        raise TypeError(f"vis must be torch.float32 {what}, got {vis.dtype}")
    if vis.ndim != (2 if is_amplitude else 3) or (not is_amplitude and vis.shape[-1] != 2):
        raise ValueError(f"vis must be (channels, rows{'' if is_amplitude else ', 2'}) {what}, "
                         f"got {tuple(vis.shape)}")
    if use_flags == BackgroundFlags.NONE:
        return
    if not isinstance(flags, torch.Tensor):
        raise ValueError(f"use_flags={use_flags.name} needs a flags tensor")
    if flags.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"flags must be torch.uint8 or torch.bool, got {flags.dtype}")
    shape = tuple(vis.shape[:2]) if use_flags == BackgroundFlags.FULL else tuple(vis.shape[:1])
    if tuple(flags.shape) != shape:
        raise ValueError(f"{use_flags.name} flags must have shape {shape}, got "
                         f"{tuple(flags.shape)}")
    if flags.device != vis.device:
        raise ValueError(f"flags are on {flags.device}, expected {vis.device}")


def background_deviations(vis, flags, width: int, is_amplitude: bool,
                          use_flags: BackgroundFlags, fast_path=None):
    """The hybrid engine's background pass: (rows, channels) float32 deviations (BG).

    Bit for bit :func:`background_deviations_plain`, the deviations of
    :func:`.device.background_median_filter` on the (channels, rows) slab
    `vis` (float32 ``(channels, rows, 2)`` planar pairs, or ``(channels,
    rows)`` amplitudes where `is_amplitude`), turned to K2's layout.
    `flags` are ``(channels, rows)`` (FULL) or ``(channels,)`` (CHANNEL)
    uint8 or bool.  `fast_path` (None: True) takes the edge-fill fast
    path where the plain version does (no flags, visibilities).

    On the card this is one launch of ``csrc/fused_flagger.cu::background_kernel``
    in K1's library: it reads the slab where it lies (a column range of a
    channel-major dump included: only a channel's rows must be dense, or
    the slab is copied first) and writes the deviations baseline-major.  It
    counts its launches in :data:`launches` (``"background"``) and records
    its launch as the span ``ksp.launch.bg``.  Any odd width from 3 to
    :data:`BACKGROUND_MAX_WIDTH` is taken; other widths, complex or
    non-float32 input and flags that do not fit raise ``ValueError`` or
    ``TypeError``.
    """
    _check_background(vis, flags, width, is_amplitude, use_flags)
    fast = True if fast_path is None else bool(fast_path)
    if vis.device.type == "cpu":
        return background_deviations_plain(vis, flags, width, is_amplitude, use_flags,
                                           fast_path=fast)
    if vis.device.type != "cuda":
        raise ValueError(f"unsupported device {vis.device}")
    channels, rows = vis.shape[:2]
    out = torch.empty((rows, channels), dtype=torch.float32, device=vis.device)
    if out.numel() == 0:
        return out
    path = _BG_GENERAL
    if fast and not is_amplitude and use_flags == BackgroundFlags.NONE:
        path = _BG_FAST if channels >= width else _BG_KEEP_NAN
    mode = K1_MODES.index(use_flags.name.lower())  # K1's codes: none 0, full 1, channel 2
    with torch.cuda.device(vis.device):
        pair = 1 if is_amplitude else 2
        if (vis.stride(1) != pair or vis.stride(-1) != 1 or vis.stride(0) % pair
                or vis.data_ptr() % (4 * pair)):
            vis = vis.contiguous()  # a channel's rows dense, whole pairs
        f = None
        if mode:
            f = flags.view(torch.uint8)
            if f.stride(-1) != 1:
                f = f.contiguous()
        lib = _library(width)
        stream = torch.cuda.current_stream(vis.device).cuda_stream
        with profiling.annotate("ksp.launch.bg"):
            err = lib.ff_background(vis.data_ptr(), None if f is None else f.data_ptr(), mode,
                                    int(is_amplitude), path, out.data_ptr(), channels, rows,
                                    vis.stride(0) // pair, f.stride(0) if mode == 1 else 0,
                                    stream)
    _raise_on(lib, err, "background")
    launches["background"] += 1
    return out


class FusedFlaggerTemplate:
    """Template wrapper for :func:`flag_transposed` (K1) with the tuning convention.

    Port of ``katsdpsigproc_tpu/models/rfi/pallas_flagger.py::FusedFlaggerTemplate``.
    The JAX template's knobs (``bb``, ``nref``, ``pipeline``, ``ingest``,
    ``fold``) lay the row out on the TPU; K1 takes a row a CTA and has no
    knob, so :func:`...utils.tune.from_jax_tuning` drops them and a JAX
    tuning dict is taken as it is.  The search measures K1's one
    configuration; the shipped table holds its H100 record, so building
    the template never searches on that card.  ``interpret`` has no
    counterpart: a tensor on the CPU takes K1's plain version.
    """

    autotune_version = 1

    def __init__(self, context, width: int = 13, n_windows: int = 4,
                 threshold_falloff: float = 1.2, flag_value: int = 1, tuning=None):
        self.context = context
        self.width = width
        self.n_windows = n_windows
        self.threshold_falloff = threshold_falloff
        self.flag_value = flag_value
        if tuning is None:
            tuning = self.autotune(context, width, n_windows)
        self.tuning = tune.from_jax_tuning(tuning)

    @classmethod
    @tune.autotuner(test={})
    def autotune(cls, context, width, n_windows) -> Mapping[str, Any]:
        rs = np.random.RandomState(seed=1)
        vis_t = torch.from_numpy(rs.standard_normal((1024, 32768, 2)).astype(np.float32))
        vis_t = vis_t.to(backend.context_device(context))

        def generate():
            return tune.make_measure(
                lambda v: flag_transposed(v, width=width, n_windows=n_windows), vis_t)

        return tune.autotune(generate)

    def __call__(self, vis_t, input_flags=None, n_sigma: float = 11.0, channel_flags=None):
        return flag_transposed(
            vis_t,
            input_flags,
            width=self.width,
            n_sigma=n_sigma,
            n_windows=self.n_windows,
            falloff=self.threshold_falloff,
            flag_value=self.flag_value,
            channel_flags=channel_flags,
        )
