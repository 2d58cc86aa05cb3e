"""Stage probes of the fused flagger K1: wrappers around ``csrc/flagger_probe.cu``.

Hopper counterparts of the TPU probes in ``scripts/``, which time or A/B
the stages of ``pallas_flagger.py::_flagger_body`` on the TPU.  Each
variant launches as the kernel it varies (1024 threads, one CTA per SM at
32768 channels), so a difference of two times is the cost of one stage:

* **K11** ``stage_ablate.py::make_fn.kernel`` (:52): :data:`STAGE_ABLATE`,
  K1 (``full``) and K1 with one stage replaced by a near-free stand-in;
* **K13** ``rankpair_ab.py::make.kernel`` (:47): :data:`RANK_SEARCHES`,
  K1 with another rank search, bit for bit K1: ``rank_pair``,
  ``zeros_fold`` and ``radix_select`` (K4's radix select, whose search is
  :func:`madnz_radix_plain` step by step);
* **K9** ``rollchain_ab.py::make.kernel`` (:81): :data:`MEDIANS`, K1 with
  the median's shifted members built another way than by 12 shared-memory
  loads, bit for bit K1: ``shfl_median`` (warp shuffles) and
  ``window_median`` (a thread's 4 consecutive channels from one load of
  their members as 16-byte words: the TPU probe's roll-by-1 chains, where
  member d of channel c + 1 is member d + 1 of channel c);
* **K12** ``deinterleave_probe.py::make.kernel`` (:41): :func:`amp_pairs`,
  amplitudes from interleaved pairs, baseline-major or channel-major, the
  latter read in place by a thread-block cluster of rows (:data:`CLUSTERS`);
  and :data:`INPLACE`, ``channel_major``: K1 with its load stage replaced
  by that in-place read of the channel-major dump, flag for flag K1 on the
  corner-turned dump.

K9, K11, K13 and ``channel_major`` (:data:`VARIANTS`) are K1 on its run
layout (``csrc/ff_runs.cuh``) and launch exactly as K1 does
(:func:`.fused_flagger.launch_config`), up to K1's channel limit
(:func:`.fused_flagger.max_channels`); so does K12 (:func:`amp_pairs`),
whose row passes through K1's amplitude words.

The TPU probes' layout knobs (``bb``, ``fold``, ``interpret``) have no
counterpart.  As in the TPU probes there are no input flags, a row holds
at least ``width`` channels, and the threshold's parameters are K1's
defaults (:data:`PARAMS`).

A tensor on the CPU goes to the plain version beside each kernel
(:func:`probe_plain`, :func:`amp_pairs_plain`), composed of the
:mod:`.device` stages; a CUDA tensor goes to the kernel, or the call
raises.  :data:`launches` counts the kernel launches per variant and K12
kernel, :data:`cluster_launches` the channel-major launches of K12 and
``channel_major`` per cluster.
"""

import ctypes
import functools

import torch

from ...ops.percentile import RADIX_DIGITS
from . import MAD_NORMAL, device, fused_flagger as ff

STAGE_ABLATE = ("full", "no_median", "no_rank", "no_thresh", "skeleton")
RANK_SEARCHES = ("rank_pair", "zeros_fold", "radix_select")
MEDIANS = ("shfl_median", "window_median")
# K1 reading the channel-major dump in place by K12's cluster read.
INPLACE = ("channel_major",)
# Every variant: on K1's run layout, launched as K1 is.
VARIANTS = STAGE_ABLATE + RANK_SEARCHES + MEDIANS + INPLACE
# Those whose flags must equal K1's, flag for flag.
EXACT = ("full",) + RANK_SEARCHES + MEDIANS + INPLACE
# The TPU probe each variant ports, under the probe's name.
PROBES = {
    "stage_ablate": STAGE_ABLATE,
    "rankpair": RANK_SEARCHES,
    "rollchain": MEDIANS,
    "deinterleave": ("amp_pairs",) + INPLACE,
}
# The cluster sizes of K12's channel-major read, template instances in the
# library of K12 and of ``channel_major``; CLUSTER
# is the one they take by default, ``channel_major``'s fastest on the H100:
# 66 clusters of 2 fill its 132 SMs, where clusters of 4 or 8 fill 120.
CLUSTERS = (1, 2, 4, 8)
CLUSTER = 2
# The probes' median variants hold a window's members in registers.
MAX_WIDTH = 31
_CODE = {name: i for i, name in enumerate(VARIANTS)}
# The threshold's parameters, fixed as the TPU probes fix them.
PARAMS = dict(n_sigma=11.0, n_windows=4, falloff=1.2, flag_value=1)

# Kernel launches since the counts were last reset, per variant and of K12
# (``amp_pairs``), and the launches of K12's channel-major read (K12's and
# `channel_major`'s) per cluster.
# Each wrapper adds one where it launches its kernel, and nowhere else.
launches = {name: 0 for name in VARIANTS + ("amp_pairs",)}
cluster_launches = {g: 0 for g in CLUSTERS}


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
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.fp_probe.restype = ctypes.c_int
    lib.fp_amp_pairs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fp_amp_pairs.restype = ctypes.c_int
    lib.fp_amp_launch_config.argtypes = ([ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
                                         + ff._LAUNCH_CONFIG_OUT)
    lib.fp_amp_launch_config.restype = ctypes.c_int
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

    The keys of :func:`.fused_flagger.launch_config`.  Every variant of
    :data:`VARIANTS`, and ``amp_pairs``, must launch as K1 does.  For K12
    see also :func:`amp_launch_config`.  Needs a CUDA device.
    """
    if variant == "amp_pairs":
        cfg = amp_launch_config(channels)
        del cfg["clusters"]
        return cfg
    code = _CODE.get(variant)
    if code is None:
        raise ValueError(f"unknown variant {variant!r}")
    lib = _library(13)  # the network header's width does not change the launch
    return ff._query_launch_config(lib, lib.fp_launch_config, code, channels)


def amp_launch_config(channels: int, *, channel_major: bool = False,
                      cluster: int = CLUSTER) -> dict:
    """How K12 launches at `channels`: :func:`launch_config`'s keys and ``clusters``.

    ``clusters`` is how many clusters of `cluster` rows fit the device at
    once for the channel-major read (``cudaOccupancyMaxActiveClusters``),
    0 for a launch without a cluster.  Needs a CUDA device.
    """
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cluster}")
    lib = _library(13)
    code = int(channel_major)  # the library's AmpKernel
    clusters = ctypes.c_int()
    cfg = ff._query_launch_config(lib, lib.fp_amp_launch_config, code, cluster, channels,
                                  ctypes.byref(clusters))
    return dict(cfg, clusters=clusters.value)


def max_channels(variant: str) -> int:
    """The most channels a row may hold in `variant` (or ``amp_pairs``): K1's limit.

    Needs a CUDA device.
    """
    if variant not in launches:
        raise ValueError(f"unknown variant {variant!r}")
    return _library(13).ff_max_channels()


def madnz_radix_plain(dev_t):
    """``radix_select``'s MAD noise, step by step in PyTorch: (rows,) float32.

    K4's radix select (:func:`..ops.percentile.percentile5_radix_plain`)
    of one target on the rows of (rows, channels) deviations.  A key is
    the bit pattern of ``|dev|``, NaN counted nowhere; the target is K1's,
    the strict rank ``(channels + zeros) // 2``, halfway when that sum is
    even.  Each pass of :data:`..ops.percentile.RADIX_DIGITS` takes a
    histogram of the digit of the keys still under the prefix, and the bin
    where the running count passes the rank.  It ends where K1's 31-round
    float-compare search ends, not at the order statistic: once the search
    accepts +inf every later candidate is a NaN pattern and is accepted, so
    a key of +inf, or a target at or past the non-NaN count, gives the
    pattern 0x7fffffff (a NaN noise), the last accepted count 0; otherwise
    the last accepted count, which the halfway rule compares with the
    target, is the keys below the result: the target less its rank within
    the last bin.  ``device.madnz`` counts by integer digits, which end at
    +inf instead on a row whose target lies on +inf: a noise that flags
    nothing either way.
    """
    absdev = dev_t.abs().to(torch.float32)
    rows, channels = absdev.shape
    nan = torch.isnan(absdev)
    keys = absdev.view(torch.int32).to(torch.int64)
    zeros = (absdev == 0).sum(dim=1)
    target = (channels + zeros) // 2
    halfway = (channels + zeros) % 2 == 0
    rank, prefix = target.clone(), torch.zeros_like(target)
    found = torch.ones(rows, dtype=torch.bool, device=absdev.device)
    hi = 31
    for shift, nbits in RADIX_DIGITS:
        under = ~nan & ((keys >> hi) == prefix[:, None])
        digit = (keys >> shift) & ((1 << nbits) - 1)
        hist = torch.zeros((rows, 1 << nbits), dtype=torch.int64, device=absdev.device)
        hist.scatter_add_(1, digit, under.to(torch.int64))
        cum = torch.cumsum(hist, dim=1)
        d = (cum <= rank[:, None]).sum(dim=1)  # the bin where the count passes the rank
        found &= d < (1 << nbits)
        d = d.clamp(max=(1 << nbits) - 1)
        rank = rank - torch.where(d > 0, cum.gather(1, (d - 1).clamp(min=0)[:, None])[:, 0], 0)
        prefix = (prefix << nbits) | d
        hi = shift
    finite = found & (prefix < 0x7F800000)
    result = torch.where(finite, prefix, 0x7FFFFFFF).to(torch.int32).view(torch.float32)
    r_cur = torch.where(finite, target - rank, 0)
    lim = torch.where(finite, prefix, 0)  # no |dev| lies below a NaN pattern
    prev = torch.amax(torch.where(~nan & (keys < lim[:, None]), absdev, 0.0), dim=1)
    med = torch.where(halfway & (r_cur == target), (result + prev) * 0.5, result)
    return (MAD_NORMAL * med).to(torch.float32)


def probe_plain(vis_t, variant: str, *, width: int = 13):
    """The plain PyTorch version of `variant`, composed of the :mod:`.device` stages.

    ``full`` and the bit-exact variants are K1's plain version
    (:func:`.fused_flagger.flag_transposed_plain`), but ``radix_select``,
    whose noise is :func:`madnz_radix_plain`; the stand-ins follow
    ``stage_ablate.py:61-80``.
    """
    radix = variant == "radix_select"
    if variant in EXACT and not radix:
        return ff.flag_transposed_plain(vis_t, width=width, **PARAMS)
    if variant not in _CODE:
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
    elif radix:
        noise = madnz_radix_plain(dev)
    else:
        noise = device.madnz(dev)
    if variant == "no_thresh":
        return device._flags_u8(dev > noise[:, None], PARAMS["flag_value"])
    return device.threshold_sum(dev, noise, PARAMS["n_sigma"], PARAMS["n_windows"],
                                PARAMS["falloff"], PARAMS["flag_value"], transposed=True)


def probe(vis_t, variant: str, *, width: int = 13, cluster: int = CLUSTER):
    """Run the probe `variant` on baseline-major planar visibilities.

    Parameters
    ----------
    vis_t
        (rows, channels, 2) float32 (re, im) pairs, channels >= width.
        ``channel_major`` reads the channel-major dump that
        ``vis_t.transpose(0, 1)`` is, in place when that view is contiguous
        (the bench's ``vis.transpose(0, 1)``), else from a contiguous copy
        of it.
    variant
        One of :data:`VARIANTS`.
    width
        The median's window, as K1's (:func:`.fused_flagger.flag_transposed`).
    cluster
        ``channel_major``'s rows read together, one of :data:`CLUSTERS`;
        the other variants ignore it.

    Returns
    -------
    (rows, channels) uint8 flags on the input's device.
    """
    if variant not in _CODE:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if width % 2 != 1 or not 3 <= width <= MAX_WIDTH:
        raise ValueError(f"width must be odd and in 3..{MAX_WIDTH}, got {width}")
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cluster}")
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
        ff._check_limit(channels, max_channels(variant))
        lib = _library(width)
        src = vis_t
        if variant in INPLACE:
            src = vis_t.transpose(0, 1)
            src = src if src.is_contiguous() else src.contiguous()
        scales, sigma, stream = ff._launch_args([src], channels, PARAMS["n_sigma"],
                                                PARAMS["falloff"], PARAMS["n_windows"])
        err = lib.fp_probe(_CODE[variant], cluster, src.data_ptr(), out.data_ptr(), rows,
                           channels, sigma, scales.ctypes.data, len(scales),
                           PARAMS["flag_value"], stream)
    ff._raise_on(lib, err, variant)
    launches[variant] += 1
    if variant in INPLACE:
        cluster_launches[cluster] += 1
    return out


def amp_pairs_plain(vis, *, channel_major: bool = False):
    """The plain version of K12: :func:`.device.amplitude`, as (rows, channels)."""
    amp = device.amplitude(vis)
    return amp.transpose(0, 1).contiguous() if channel_major else amp


def amp_pairs(vis, *, channel_major: bool = False, cluster: int = CLUSTER):
    """Amplitudes of interleaved (re, im) float32 pairs at K1's launch (K12).

    `vis` is (rows, channels, 2), or (channels, rows, 2) with
    ``channel_major`` (the main path's input, read in place with no corner
    turn, by clusters of `cluster` rows, one of :data:`CLUSTERS`: 1 reads
    one row a CTA).  Each row passes through its CTA's amplitude words, as
    K1's load stage leaves them.  Returns (rows, channels) float32 on the
    input's device.
    """
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cluster}")
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
            raise ValueError(f"{channels} channels exceed amp_pairs's limit of {limit} channels")
        err = lib.fp_amp_pairs(int(channel_major), cluster, vis.data_ptr(), out.data_ptr(), rows,
                               channels, torch.cuda.current_stream(vis.device).cuda_stream)
    ff._raise_on(lib, err, "amp_pairs")
    launches["amp_pairs"] += 1
    if channel_major:
        cluster_launches[cluster] += 1
    return out
