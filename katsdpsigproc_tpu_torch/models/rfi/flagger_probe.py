"""Stage probes of the fused flagger K1: wrappers around ``csrc/flagger_probe.cu``.

Hopper counterparts of the TPU probes in ``scripts/``, which time or A/B
the stages of ``pallas_flagger.py::_flagger_body`` on the TPU.  Here they
are variants of K1 in the strided layout (``csrc/ff_device.cuh``: thread t
owns channels t, t + 1024, ... of a row held at 5 B per channel), the
layout K1 and K2 had before the run layout (``csrc/ff_runs.cuh``), and
where K2's strided design stays.  ``full`` is that K1, flag for flag the current one.  Every variant
launches with that layout's block (1024 threads) and dynamic shared
memory (:func:`.fused_flagger.strided_launch_config`), one CTA per SM, so
a difference of two times is the cost of one stage:

* **K11** ``stage_ablate.py::make_fn.kernel`` (:52): :data:`STAGE_ABLATE`,
  K1 (``full``) and K1 with one stage replaced by a near-free stand-in;
* **K13** ``rankpair_ab.py::make.kernel`` (:47): ``rank_pair`` and
  ``zeros_fold``, other rank searches, bit for bit K1;
* **K9** ``rollchain_ab.py::make.kernel`` (:81): ``shfl_median``, the
  median's members by warp shuffles, bit for bit K1;
* **K12** ``deinterleave_probe.py::make.kernel`` (:41): :func:`amp_pairs`,
  amplitudes from interleaved pairs, baseline-major or channel-major.

The TPU probes' layout knobs (``bb``, ``fold``, ``interpret``) have no
counterpart.  As in the TPU probes there are no input flags, a row holds
at least ``width`` channels, and the threshold's parameters are K1's
defaults (:data:`PARAMS`).

A tensor on the CPU goes to the plain version beside each kernel
(:func:`probe_plain`, :func:`amp_pairs_plain`), composed of the
:mod:`.device` stages; a CUDA tensor goes to the kernel, or the call
raises.  :data:`launches` counts the kernel launches per variant.
"""

import ctypes
import functools

import torch

from . import device, fused_flagger as ff

STAGE_ABLATE = ("full", "no_median", "no_rank", "no_thresh", "skeleton")
# Variants whose flags must equal K1's, flag for flag.
EXACT = ("full", "rank_pair", "zeros_fold", "shfl_median")
VARIANTS = STAGE_ABLATE + ("rank_pair", "zeros_fold", "shfl_median")
# The TPU probe each variant ports, under the probe's name.
PROBES = {
    "stage_ablate": STAGE_ABLATE,
    "rankpair": ("rank_pair", "zeros_fold"),
    "rollchain": ("shfl_median",),
    "deinterleave": ("amp_pairs",),
}
_CODE = {name: i for i, name in enumerate(VARIANTS)}
# The threshold's parameters, fixed as the TPU probes fix them.
PARAMS = dict(n_sigma=11.0, n_windows=4, falloff=1.2, flag_value=1)
_AMP_PAIRS, _AMP_PAIRS_CHANNEL_MAJOR = 8, 9

# Kernel launches since the counts were last reset, per variant.  Each
# wrapper adds one where it launches its kernel, and nowhere else.
launches = {name: 0 for name in VARIANTS + ("amp_pairs",)}


@functools.lru_cache(maxsize=None)
def _library(width: int) -> ctypes.CDLL:
    from ...utils import kernels

    lib = kernels.load("flagger_probe", ["flagger_probe.cu"],
                       {"ff_network.h": ff._network_header(width)})
    lib.ff_max_channels.argtypes = []
    lib.ff_max_channels.restype = ctypes.c_int
    lib.ff_error_string.argtypes = [ctypes.c_int]
    lib.ff_error_string.restype = ctypes.c_char_p
    lib.fp_launch_config.argtypes = [ctypes.c_int, ctypes.c_int] + ff._LAUNCH_CONFIG_OUT
    lib.fp_launch_config.restype = ctypes.c_int
    lib.fp_probe.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fp_probe.restype = ctypes.c_int
    lib.fp_amp_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.fp_amp_pairs.restype = ctypes.c_int
    return lib


def _check_vis(vis, name: str):
    if not isinstance(vis, torch.Tensor) or vis.ndim != 3 or vis.shape[-1] != 2:
        raise ValueError(f"{name} must be a 3-D tensor of (re, im) pairs")
    if vis.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {vis.dtype}")
    if vis.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vis.device}")


def launch_config(variant: str, channels: int) -> dict:
    """How the kernel of `variant` launches at `channels`, from the library itself.

    The same keys as :func:`.fused_flagger.strided_launch_config`: every
    variant must launch as the strided layout's launch says.  Needs a CUDA
    device.
    """
    code = _AMP_PAIRS if variant == "amp_pairs" else _CODE.get(variant)
    if code is None:
        raise ValueError(f"unknown variant {variant!r}")
    lib = _library(13)  # the network header's width does not change the launch
    return ff._query_launch_config(lib, lib.fp_launch_config, code, channels)


def probe_plain(vis_t, variant: str, *, width: int = 13):
    """The plain PyTorch version of `variant`, composed of the :mod:`.device` stages.

    ``full`` and the bit-exact variants are K1's plain version
    (:func:`.fused_flagger.flag_transposed_plain`); the stand-ins follow
    ``stage_ablate.py:61-80``.
    """
    if variant in EXACT:
        return ff.flag_transposed_plain(vis_t, width=width, **PARAMS)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    amp = device.amplitude(vis_t)
    if variant == "skeleton":
        return device._flags_u8(amp > 1.0, PARAMS["flag_value"])
    if variant == "no_median":
        dev = amp - amp * 0.5
    else:
        dev = device.background_median_filter(
            vis_t.transpose(0, 1), None, width, False, device.BackgroundFlags.NONE,
            fast_path=True).transpose(0, 1)
    if variant == "no_rank":
        noise = torch.ones(dev.shape[0], dtype=torch.float32, device=dev.device)
    else:
        noise = device.madnz(dev)
    if variant == "no_thresh":
        return device._flags_u8(dev > noise[:, None], PARAMS["flag_value"])
    return device.threshold_sum(dev, noise, PARAMS["n_sigma"], PARAMS["n_windows"],
                                PARAMS["falloff"], PARAMS["flag_value"], transposed=True)


def probe(vis_t, variant: str, *, width: int = 13):
    """Run the probe `variant` on baseline-major planar visibilities.

    Parameters
    ----------
    vis_t
        (rows, channels, 2) float32 (re, im) pairs, channels >= width.
    variant
        One of :data:`VARIANTS`.
    width
        The median's window, as K1's (:func:`.fused_flagger.flag_transposed`).

    Returns
    -------
    (rows, channels) uint8 flags on the input's device.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if width % 2 != 1 or not 3 <= width <= ff.MAX_WIDTH:
        raise ValueError(f"width must be odd and in 3..{ff.MAX_WIDTH}, got {width}")
    _check_vis(vis_t, "vis_t")
    rows, channels = vis_t.shape[:2]
    if channels < width:
        raise ValueError(f"the probes take at least width={width} channels, got {channels}")
    if vis_t.device.type == "cpu":
        return probe_plain(vis_t, variant, width=width)
    out = torch.empty((rows, channels), dtype=torch.uint8, device=vis_t.device)
    if rows == 0:
        return out
    with torch.cuda.device(vis_t.device):
        lib = _library(width)
        ff._check_limit(channels, lib.ff_max_channels())
        scales, sigma, stream = ff._launch_args([vis_t], channels, PARAMS["n_sigma"],
                                                PARAMS["falloff"], PARAMS["n_windows"])
        err = lib.fp_probe(_CODE[variant], vis_t.data_ptr(), out.data_ptr(), rows, channels,
                           sigma, scales.ctypes.data, len(scales), PARAMS["flag_value"],
                           stream)
    ff._raise_on(lib, err, variant)
    launches[variant] += 1
    return out


def amp_pairs_plain(vis, *, channel_major: bool = False):
    """The plain version of K12: :func:`.device.amplitude`, as (rows, channels)."""
    amp = device.amplitude(vis)
    return amp.transpose(0, 1).contiguous() if channel_major else amp


def amp_pairs(vis, *, channel_major: bool = False):
    """Amplitudes of interleaved (re, im) float32 pairs, one CTA per row (K12).

    `vis` is (rows, channels, 2), or (channels, rows, 2) with
    ``channel_major`` (the main path's input, read in place with no corner
    turn).  Returns (rows, channels) float32 on the input's device.
    """
    _check_vis(vis, "vis")
    if channel_major:
        channels, rows = vis.shape[:2]
    else:
        rows, channels = vis.shape[:2]
    if vis.device.type == "cpu":
        return amp_pairs_plain(vis, channel_major=channel_major)
    if not vis.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors")
    out = torch.empty((rows, channels), dtype=torch.float32, device=vis.device)
    if rows == 0 or channels == 0:
        return out
    with torch.cuda.device(vis.device):
        lib = _library(13)  # the network header's width does not affect K12
        limit = lib.ff_max_channels()
        if channels > limit:
            raise ValueError(f"{channels} channels exceed the strided layout's limit of "
                             f"{limit} channels")
        err = lib.fp_amp_pairs(vis.data_ptr(), int(channel_major), out.data_ptr(), rows,
                               channels, torch.cuda.current_stream(vis.device).cuda_stream)
    ff._raise_on(lib, err, "amp_pairs")
    launches["amp_pairs"] += 1
    return out
