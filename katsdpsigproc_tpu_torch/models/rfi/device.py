"""The RFI flagging stages as PyTorch tensor code.

Port of ``katsdpsigproc_tpu/models/rfi/device.py``: the functional stages
and ``make_flagger_fn`` (:50-565), then the stage templates, the composed
``FlaggerDevice`` and the ``*HostFromDevice`` wrappers (:573-1169) on the
operation framework of :mod:`...ops.base`.  Every function takes and
returns tensors on the caller's device.

* **Background median filter**: a vectorized windowed median over the
  ``width`` shifted copies of the amplitude array, through the same
  min/max selection networks as the reference (:mod:`..ops.rank`).
  Flagged samples become NaN and drop out of the valid count.
* **MAD noise**: the bitwise IEEE-754 rank search of
  :func:`..ops.rank.median_non_zero`.
* **SumThreshold**: shifted-window sums in Kogge-Stone order and boolean
  dilations along the channel axis.

These stages are also the plain versions that the CUDA kernels of
:mod:`.fused_flagger` are held against.
"""

import contextlib
import enum
from typing import Any, Mapping, Optional, Type, Union

import numpy as np
import torch

from ...ops import base, rank as rank_ops, transpose as transpose_ops
from ...utils import backend, numerics, profiling, tune
from . import MAD_NORMAL, host


class BackgroundFlags(enum.Enum):
    """Input-flag modes (``katsdpsigproc_tpu/models/rfi/device.py::BackgroundFlags``)."""

    NONE = 0
    CHANNEL = 1
    FULL = 2

    def __bool__(self):
        return self != BackgroundFlags.NONE


def masked_median_filter(amp, width: int, engine: str = "network",
                         edges_only: bool = False):
    """Centred windowed median along axis 0, NaN = absent, min_periods=1.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::masked_median_filter``.
    `amp` is (channels, ...) float32 with NaN marking flagged/absent
    samples.  Returns (median, valid_count) where `median` is NaN for
    windows with no valid samples; even valid counts average the two
    middle values.

    ``edges_only=True`` asserts `amp` itself is NaN-free, so members are
    absent only where the window truncates at the channel edges.  The
    pads are then a static alternating +-inf vector that pins the
    truncated-window median at the fixed sorted ranks ``width//2`` and
    ``width//2 + 1`` (the fast path of the fused kernel; bit-identical to
    the general path on NaN-free input).

    ``engine`` is ``"network"`` (a selection network over the +inf-masked
    members, then rank-indexed selection) or ``"count"`` (compare-count
    ranking, ties to the earlier position).
    """
    h = width // 2
    c = amp.shape[0]
    dev = amp.device
    trail = (1,) * (amp.ndim - 1)
    if edges_only and engine == "network" and width % 2 == 1 and c >= width:
        # An absent member's fill is -inf iff its out-of-range distance is
        # odd, which in pad coordinates is a static function of the pad
        # index: left pad p fills -inf iff (h - p) is odd, right pad q iff
        # (q + 1) is odd.
        inf = np.float32(np.inf)
        left = np.where((h - np.arange(h)) % 2 == 1, -inf, inf).astype(np.float32)
        right = np.where((np.arange(h) + 1) % 2 == 1, -inf, inf).astype(np.float32)
        bshape = (h,) + amp.shape[1:]
        padded = torch.cat([
            torch.from_numpy(left).to(dev).reshape((h,) + trail).expand(bshape),
            amp,
            torch.from_numpy(right).to(dev).reshape((h,) + trail).expand(bshape),
        ], dim=0)
        arrs = [padded[k:k + c] for k in range(width)]
        rank_ops.apply_selection_network(arrs, rank_ops.selection_network(width, (h, h + 1)))
        col = torch.arange(c, dtype=torch.int32, device=dev)
        k_abs = torch.clamp(h - col, min=0) + torch.clamp(col - (c - 1 - h), min=0)
        n = (width - k_abs).reshape((c,) + trail).expand(amp.shape)
        n_odd = ((k_abs & 1) == 0).reshape((c,) + trail)
        med = torch.where(n_odd, arrs[h], (arrs[h] + arrs[h + 1]) * 0.5)
        return med, n
    nan_pad = torch.full((h,) + amp.shape[1:], torch.nan, dtype=amp.dtype, device=dev)
    padded = torch.cat([nan_pad, amp, nan_pad], dim=0)
    win = [padded[k:k + c] for k in range(width)]
    nan = [torch.isnan(w) for w in win]
    n = sum((~m).to(torch.int32) for m in nan)
    lo = (n - 1) // 2
    hi = n // 2
    zero = torch.zeros(amp.shape, dtype=amp.dtype, device=dev)
    v_lo = zero
    v_hi = zero
    if engine == "network":
        arrs = [torch.where(m, torch.inf, w) for w, m in zip(win, nan)]
        # Only the lower half of the sort is ever selected (hi = n//2 <=
        # width//2), so run the network pruned to those outputs.  A
        # selected rank k < n holds a finite member; +inf is selected only
        # when n == 0, where the n > 0 guard below gives NaN anyway.
        rank_ops.apply_selection_network(
            arrs, rank_ops.selection_network(width, range(width // 2 + 1)))
        for k in range(width // 2 + 1):
            v_lo = v_lo + torch.where(lo == k, arrs[k], 0.0)
            v_hi = v_hi + torch.where(hi == k, arrs[k], 0.0)
    elif engine == "count":
        for j in range(width):
            # Stable rank of win[j] among valid members: NaN comparisons
            # are False, so invalid members never count; ties go to the
            # earlier position.
            r = torch.zeros(amp.shape, dtype=torch.int32, device=dev)
            for k in range(width):
                if k < j:
                    r = r + (win[k] <= win[j])
                elif k > j:
                    r = r + (win[k] < win[j])
            vj = torch.where(nan[j], 0.0, win[j])
            v_lo = v_lo + torch.where(~nan[j] & (r == lo), vj, 0.0)
            v_hi = v_hi + torch.where(~nan[j] & (r == hi), vj, 0.0)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    med = (v_lo + v_hi) * 0.5
    return torch.where(n > 0, med, torch.nan), n


def amplitude(vis):
    """|vis| for complex or planar (trailing-pair float32) visibilities.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::amplitude``.  For
    planar input ``re*re + im*im`` is rounded after each operation, as the
    CUDA kernel and the TPU kernel compute it; complex input is rounded as
    XLA's ``abs`` rounds it (:func:`..utils.numerics.complex_abs`).
    """
    if vis.is_complex():
        return numerics.complex_abs(vis)
    if vis.shape[-1] == 2:
        re = vis[..., 0].to(torch.float32)
        im = vis[..., 1].to(torch.float32)
        return numerics.sqrt_rn(re * re + im * im)
    raise TypeError("expected complex input or a trailing (re, im) pair axis")


def to_planar(vis, leading: bool = False):
    """Complex numpy array or tensor -> planar float32.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::to_planar``.
    ``leading=False`` gives the trailing (..., 2) layout (the planar image
    of interleaved complex64); ``leading=True`` gives (2, ...).
    """
    axis = 0 if leading else -1
    if isinstance(vis, np.ndarray):
        return np.stack([vis.real.astype(np.float32), vis.imag.astype(np.float32)], axis=axis)
    return torch.stack([vis.real.to(torch.float32), vis.imag.to(torch.float32)], dim=axis)


def background_median_filter(vis, flags, width: int, is_amplitude: bool,
                             use_flags: BackgroundFlags, engine: str = "network",
                             fast_path: Optional[bool] = None):
    """Deviations from a windowed-median background (channels, baselines).

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::background_median_filter``.
    Flagged inputs (and, for amplitude input, negative values) are
    excluded from the median and map to 0 in the output; elsewhere the
    output is ``amp - median(valid window)``.  Complex visibilities may be
    complex64 or planar (channels, baselines, 2) float32.

    ``fast_path`` (default on) takes the edge-fill fast path when there
    are no input flags and the input is not amplitudes; it is
    bit-identical to the general path on finite input.
    """
    if fast_path is None:
        fast_path = True
    if fast_path and not is_amplitude and use_flags == BackgroundFlags.NONE:
        amp = amplitude(vis)
        med, _ = masked_median_filter(amp, width, engine, edges_only=True)
        return (amp - med).to(torch.float32)
    if is_amplitude:
        amp = vis.to(torch.float32)
        invalid = amp < 0
    else:
        amp = amplitude(vis)
        invalid = torch.zeros(amp.shape, dtype=torch.bool, device=amp.device)
    if use_flags == BackgroundFlags.CHANNEL:
        invalid = invalid | (flags != 0)[:, None]
    elif use_flags == BackgroundFlags.FULL:
        invalid = invalid | (flags != 0)
    amp = torch.where(invalid, torch.nan, amp)
    med, _ = masked_median_filter(amp, width, engine)
    deviations = amp - med
    return torch.where(torch.isnan(deviations), 0.0, deviations).to(torch.float32)


def madnz(deviations_t, n_channels: Optional[int] = None, axis: int = -1,
          radix_bits: int = 4):
    """MAD noise per baseline from deviations, channels along `axis`.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::madnz``:
    ``MAD_NORMAL * median(nonzero |deviations|)`` by the exact rank
    search.  ``axis=-1`` takes (baselines, channels); ``axis=0`` the
    straight (channels, baselines) layout.  Every `radix_bits` gives the
    bit-identical median.
    """
    values = deviations_t.abs().to(torch.float32)
    med = rank_ops.median_non_zero(values, n_channels, axis=axis, radix_bits=radix_bits)
    return (MAD_NORMAL * med).to(torch.float32)


def _flags_u8(hot, flag_value: int):
    return hot.to(torch.uint8) * flag_value


def threshold_simple(deviations, noise, n_sigma: float, flag_value: int = 1, transposed=False):
    """Elementwise ``deviations > n_sigma * noise``.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::threshold_simple``.
    """
    noise_b = noise[:, None] if transposed else noise[None, :]
    return _flags_u8(deviations > n_sigma * noise_b, flag_value)


def threshold_sum(
    deviations_t,
    noise,
    n_sigma: float,
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    transposed: bool = True,
):
    """SumThreshold on deviations; channels along the last axis when
    `transposed` (baselines, channels), else along axis 0.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::threshold_sum``:
    full windows only; flagged samples are clamped to the current
    threshold; flags disperse over every sample covered by an outlier
    window.  Window sums are built in Kogge-Stone order,
    ``s8 = ((x0+x1)+(x2+x3))+((x4+x5)+(x6+x7))``, and each window's
    threshold scale is ``float32(threshold_falloff ** -w)`` with the power
    taken in double.
    """
    ax = deviations_t.ndim - 1 if transposed else 0
    channels = deviations_t.shape[ax]

    def sl(x, start, stop):
        return x.narrow(ax, start, stop - start)

    flags = torch.zeros(deviations_t.shape, dtype=torch.bool, device=deviations_t.device)
    base_threshold = (n_sigma * noise).to(torch.float32).unsqueeze(ax)
    for w in range(n_windows):
        window = 1 << w
        if window > channels:
            break
        threshold = base_threshold * float(np.float32(threshold_falloff ** -w))
        clamped = torch.where(flags, threshold, deviations_t)
        # sums[k] = sum(clamped[k : k + window]), k in [0, channels - window]
        sums = clamped
        length = channels
        done = 1
        while done < window:
            length -= done
            sums = sl(sums, 0, length) + sl(sums, done, length + done)
            done *= 2
        sum_flags = sums > threshold * window
        # flag[c] |= any(sum_flags[max(0, c-window+1) : min(c, channels-window) + 1])
        pad_shape = list(sum_flags.shape)
        pad_shape[ax] = window - 1
        pad = torch.zeros(pad_shape, dtype=torch.bool, device=sum_flags.device)
        new_flags = torch.cat([pad, sum_flags, pad], dim=ax)
        length = channels + window - 1
        done = 1
        while done < window:
            length -= done
            new_flags = sl(new_flags, 0, length) | sl(new_flags, done, length + done)
            done *= 2
        flags = flags | new_flags
    return _flags_u8(flags, flag_value)


def make_flagger_fn(
    width: int = 13,
    n_sigma: float = 11.0,
    is_amplitude: bool = False,
    use_flags: Optional[BackgroundFlags] = None,
    threshold: str = "sum",
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    baseline_block: Optional[int] = None,
    engine: str = "torch",
    pallas_kw: Optional[dict] = None,
    layout: str = "straight",
    block_impl: str = "pad",
    background_fast: Optional[bool] = None,
):
    """Build the single-device flagger ``fn(vis[, input_flags]) -> flags``.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::make_flagger_fn``
    on (channels, baselines[, 2]) input, channel-major throughout.

    ``engine="torch"`` (the counterpart of ``"xla"``) runs every stage as
    tensor code.  ``engine="hybrid"`` (threshold ``"sum"`` only) runs the
    background pass, then MAD noise + SumThreshold, as two CUDA kernels a
    slab: :func:`.fused_flagger.background_deviations` (BG, the deviations
    written baseline-major) and :func:`.fused_flagger.madnz_threshold`
    (K2); a tensor on the CPU takes :func:`background_median_filter`, the
    deviations' turn and K2's plain version.  On the card the hybrid
    engine takes what BG takes: float32 input and an odd ``width`` from 3
    to :data:`.fused_flagger.BACKGROUND_MAX_WIDTH` (255); another raises
    ``ValueError`` or ``TypeError`` at the call, where the CPU route still
    takes it.  ``pallas_kw`` is passed on to
    K2's call, so its TPU layout knobs (``bb``, ``fold``, ``interpret``, ``nref``,
    ``pipeline``, ``rank_radix``) are taken and an unknown key raises
    ``TypeError``.  ``baseline_block`` processes the baseline axis in
    column slabs of that many baselines to bound peak memory.  The JAX
    package's stage layouts (``layout``: ``"straight"``, ``"transposed"``)
    and slab implementations (``block_impl``: ``"pad"``, ``"slice"``,
    ``"scan"``, ``"unroll"``) work around TPU layout and slicing costs and
    give identical flags there, so each is checked as in JAX and all of
    them run this one channel-major slab loop.  ``background_fast``
    (``None`` means ``False``, as in the JAX engines) takes the
    background's edge-fill fast path where it applies (no input flags,
    visibilities rather than amplitudes); it is bit-identical to the
    general path on finite input.

    While a profiler session records, the hybrid engine's flagger records
    its host work as spans (:func:`...utils.profiling.annotate`):
    ``ksp.hybrid`` the whole call and, for each slab, keyed by its first
    baseline, ``ksp.hybrid.background`` (the background pass; on the card
    BG's launch, ``ksp.launch.bg``, inside it), on the CPU
    ``ksp.hybrid.turn`` (the deviations made baseline-major), and
    ``ksp.hybrid.store`` (the slab's flags written into the output); K2's
    launch is ``ksp.launch.k2`` inside :func:`.fused_flagger.madnz_threshold`.
    """
    use_flags = BackgroundFlags.NONE if use_flags is None else use_flags
    if engine not in ("torch", "hybrid"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "hybrid" and threshold != "sum":
        raise ValueError("engine='hybrid' implements threshold='sum' only")
    if threshold not in ("sum", "simple"):
        raise ValueError(f"unknown threshold {threshold!r}")
    if layout not in ("transposed", "straight"):
        raise ValueError(f"unknown layout {layout!r}")
    if baseline_block is not None and block_impl not in ("slice", "scan", "unroll", "pad"):
        raise ValueError(f"unknown block_impl {block_impl!r}")
    background_fast = bool(background_fast)
    hybrid = engine == "hybrid"
    from . import fused_flagger  # it imports this module

    def span(name, key=None):
        return profiling.annotate(name, key) if hybrid else contextlib.nullcontext()

    def k2(deviations_t):
        flags_t = fused_flagger.madnz_threshold(
            deviations_t, n_sigma=n_sigma, n_windows=n_windows, falloff=threshold_falloff,
            flag_value=flag_value, **(pallas_kw or {}))
        return flags_t.transpose(0, 1)

    def block_fn(vis, input_flags=None, key=None):
        if hybrid and vis.device.type == "cuda":
            with span("ksp.hybrid.background", key):
                deviations_t = fused_flagger.background_deviations(
                    vis, input_flags, width, is_amplitude, use_flags, fast_path=background_fast)
            return k2(deviations_t)
        with span("ksp.hybrid.background", key):
            deviations = background_median_filter(
                vis, input_flags, width, is_amplitude, use_flags, fast_path=background_fast)
        if hybrid:
            with span("ksp.hybrid.turn", key):
                deviations_t = deviations.transpose(0, 1).contiguous()
            return k2(deviations_t)
        noise = madnz(deviations, axis=0)
        if threshold == "simple":
            return threshold_simple(deviations, noise, n_sigma, flag_value, False)
        return threshold_sum(deviations, noise, n_sigma, n_windows, threshold_falloff,
                             flag_value, transposed=False)

    def flagger(vis, input_flags=None):
        with span("ksp.hybrid"):
            c, b = vis.shape[:2]
            block = b if baseline_block is None else baseline_block
            out = torch.empty((c, b), dtype=torch.uint8, device=vis.device)
            for start in range(0, b, block):
                stop = min(start + block, b)
                f = input_flags
                if use_flags == BackgroundFlags.FULL and input_flags is not None:
                    f = input_flags[:, start:stop]
                flags = block_fn(vis[:, start:stop], f, start)
                with span("ksp.hybrid.store", start):
                    out[:, start:stop] = flags
                del flags  # not held through the next slab's work
            return out

    return flagger


# ---------------------------------------------------------------------------
# Stage templates / operations
# ---------------------------------------------------------------------------


class AbstractBackgroundDevice(base.Operation):
    """Instance-level background-stage contract."""


class AbstractNoiseEstDevice(base.Operation):
    """Instance-level noise-estimate contract."""


class AbstractThresholdDevice(base.Operation):
    """Instance-level threshold contract."""


class AbstractBackgroundDeviceTemplate:
    use_flags: BackgroundFlags
    host_class: Type[host.AbstractBackgroundHost]

    def instantiate(self, command_queue, channels, baselines, allocator=None):
        raise NotImplementedError  # pragma: nocover


class AbstractNoiseEstDeviceTemplate:
    transposed: bool
    host_class: Type[host.AbstractNoiseEstHost]

    def instantiate(self, command_queue, channels, baselines, allocator=None):
        raise NotImplementedError  # pragma: nocover


class AbstractThresholdDeviceTemplate:
    transposed: bool
    host_class: Type[host.AbstractThresholdHost]

    def instantiate(self, command_queue, channels, baselines, n_sigma, *, allocator=None):
        raise NotImplementedError  # pragma: nocover


class BackgroundMedianFilterDeviceTemplate(AbstractBackgroundDeviceTemplate):
    """Background stage: windowed median filter per baseline, by amplitude.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::BackgroundMedianFilterDeviceTemplate``.
    The tuning knob is the windowed median's ``engine``, selection
    ``"network"`` or compare-``"count"`` (see :func:`masked_median_filter`).

    Parameters
    ----------
    context
        Placement context (:class:`...utils.backend.DeviceContext`), or
        ``None`` for the best device (the card where there is one).
    width
        The window width (odd).
    is_amplitude
        If true, inputs are float32 amplitudes rather than complex64
        visibilities.
    use_flags
        NONE / CHANNEL / FULL input-flag mode (a bool is accepted: True
        means CHANNEL).
    """

    host_class = host.BackgroundMedianFilterHost
    autotune_version = 1

    def __init__(self, context, width: int, is_amplitude: bool = False,
                 use_flags: Union[BackgroundFlags, bool] = BackgroundFlags.NONE, tuning=None):
        self.context = context
        self.width = width
        self.is_amplitude = is_amplitude
        if use_flags is True:
            use_flags = BackgroundFlags.CHANNEL
        elif use_flags is False:
            use_flags = BackgroundFlags.NONE
        if not isinstance(use_flags, BackgroundFlags):
            raise TypeError("use_flags must be an instance of BackgroundFlags or bool")
        self.use_flags = use_flags
        if tuning is None:
            tuning = self.autotune(context, width)
        self.engine = tuning.get("engine", "network")

    @classmethod
    @tune.autotuner(test={"engine": "network"})
    def autotune(cls, context, width) -> Mapping[str, Any]:
        rs = np.random.RandomState(2021)
        amp = torch.from_numpy(np.abs(rs.standard_normal((4096, 512))).astype(np.float32))
        amp = amp.to(backend.context_device(context))

        def generate(engine):
            return tune.make_measure(
                lambda a: masked_median_filter(a, width, engine=engine), amp)

        return tune.autotune(generate, engine=["network", "count"])

    def instantiate(self, command_queue=None, channels=0, baselines=0, allocator=None):
        return BackgroundMedianFilterDevice(self, channels, baselines)


class BackgroundMedianFilterDevice(AbstractBackgroundDevice):
    """Concrete background stage.

    .. rubric:: Slots

    **vis** : (channels, baselines) complex64, or float32 amplitudes
    **flags** : (channels, baselines) or (channels,) uint8, only with use_flags
    **deviations** : (channels, baselines) float32, output
    """

    def __init__(self, template: BackgroundMedianFilterDeviceTemplate, channels, baselines):
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.channels = channels
        self.baselines = baselines
        vis_type = torch.float32 if template.is_amplitude else torch.complex64
        shape = (channels, baselines)
        self.slots["vis"] = base.Slot(shape, vis_type, base.Direction.IN)
        self.slots["deviations"] = base.Slot(shape, torch.float32, base.Direction.OUT)
        if template.use_flags == BackgroundFlags.FULL:
            self.slots["flags"] = base.Slot(shape, torch.uint8, base.Direction.IN)
        elif template.use_flags == BackgroundFlags.CHANNEL:
            self.slots["flags"] = base.Slot((channels,), torch.uint8, base.Direction.IN)

    def _run(self, vis, flags=None):
        deviations = background_median_filter(
            vis, flags, self.template.width, self.template.is_amplitude,
            self.template.use_flags, self.template.engine)
        return {"deviations": deviations}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "width": self.template.width,
            "use_flags": self.template.use_flags.name,
            "channels": self.channels,
            "baselines": self.baselines,
        }


def _madnz_radix_search(context, axis: int, channels: int,
                        baselines: int = 128) -> Mapping[str, Any]:
    """Measured ``radix_bits`` search shared by the noise-estimate templates."""
    rs = np.random.RandomState(2021)
    shape = (baselines, channels) if axis == -1 else (channels, baselines)
    dev = torch.from_numpy(np.abs(rs.standard_normal(shape)).astype(np.float32))
    dev = dev.to(backend.context_device(context))

    def generate(radix_bits):
        return tune.make_measure(lambda d: madnz(d, axis=axis, radix_bits=radix_bits), dev)

    return tune.autotune(generate, radix_bits=[1, 2, 4, 8])


class NoiseEstMADTDeviceTemplate(AbstractNoiseEstDeviceTemplate):
    """Transposed-layout (baseline-major) MAD noise estimator.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::NoiseEstMADTDeviceTemplate``.
    The tuning knob is the rank search's ``radix_bits`` (every width gives
    the same value); ``max_channels`` bounds an instance's channels.
    """

    host_class = host.NoiseEstMADHost
    transposed = True
    autotune_version = 1

    def __init__(self, context, max_channels: int = 32768, tuning=None):
        self.context = context
        self.max_channels = max_channels
        if tuning is None:
            tuning = self.autotune(context, max_channels)
        self.radix_bits = tuning.get("radix_bits", 4)

    @classmethod
    @tune.autotuner(test={"radix_bits": 4})
    def autotune(cls, context, max_channels) -> Mapping[str, Any]:
        return _madnz_radix_search(context, axis=-1, channels=min(max_channels, 8192))

    def instantiate(self, command_queue=None, channels=0, baselines=0, allocator=None):
        if channels > self.max_channels:
            raise ValueError("channels exceeds max_channels")
        return NoiseEstMADTDevice(self, channels, baselines)


class NoiseEstMADTDevice(AbstractNoiseEstDevice):
    """.. rubric:: Slots

    **deviations** : (baselines, channels) float32 (transposed layout)
    **noise** : (baselines,) float32, output
    """

    transposed = True

    def __init__(self, template, channels, baselines):
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.channels = channels
        self.baselines = baselines
        self.slots["deviations"] = base.Slot((baselines, channels), torch.float32,
                                             base.Direction.IN)
        self.slots["noise"] = base.Slot((baselines,), torch.float32, base.Direction.OUT)

    def _run(self, deviations):
        return {"noise": madnz(deviations, radix_bits=self.template.radix_bits)}

    def parameters(self) -> Mapping[str, Any]:
        return {"channels": self.channels, "baselines": self.baselines, "transposed": True}


class NoiseEstMADDeviceTemplate(AbstractNoiseEstDeviceTemplate):
    """Straight-layout (channel-major) MAD noise estimator.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::NoiseEstMADDeviceTemplate``:
    the same arithmetic along axis 0.  Tuning knob: ``radix_bits``.
    """

    host_class = host.NoiseEstMADHost
    transposed = False
    autotune_version = 1

    def __init__(self, context, tuning=None):
        self.context = context
        if tuning is None:
            tuning = self.autotune(context)
        self.radix_bits = tuning.get("radix_bits", 4)

    @classmethod
    @tune.autotuner(test={"radix_bits": 4})
    def autotune(cls, context) -> Mapping[str, Any]:
        return _madnz_radix_search(context, axis=0, channels=8192)

    def instantiate(self, command_queue=None, channels=0, baselines=0, allocator=None):
        return NoiseEstMADDevice(self, channels, baselines)


class NoiseEstMADDevice(AbstractNoiseEstDevice):
    """.. rubric:: Slots

    **deviations** : (channels, baselines) float32
    **noise** : (baselines,) float32, output
    """

    transposed = False

    def __init__(self, template, channels, baselines):
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.channels = channels
        self.baselines = baselines
        self.slots["deviations"] = base.Slot((channels, baselines), torch.float32,
                                             base.Direction.IN)
        self.slots["noise"] = base.Slot((baselines,), torch.float32, base.Direction.OUT)

    def _run(self, deviations):
        return {"noise": madnz(deviations, axis=0, radix_bits=self.template.radix_bits)}

    def parameters(self) -> Mapping[str, Any]:
        return {"channels": self.channels, "baselines": self.baselines, "transposed": False}


class ThresholdSimpleDeviceTemplate(AbstractThresholdDeviceTemplate):
    """Elementwise threshold.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::ThresholdSimpleDeviceTemplate``.
    One comparison: no autotune, and ``tuning`` is accepted for signature
    parity and ignored.
    """

    host_class = host.ThresholdSimpleHost

    def __init__(self, context, transposed: bool = False, flag_value: int = 1, tuning=None):
        self.context = context
        self.transposed = transposed
        self.flag_value = flag_value

    def instantiate(self, command_queue=None, channels=0, baselines=0, n_sigma=11.0, *,
                    allocator=None):
        return ThresholdSimpleDevice(self, channels, baselines, n_sigma)


class ThresholdSimpleDevice(AbstractThresholdDevice):
    """.. rubric:: Slots

    **deviations** : (channels, baselines) float32, or (baselines, channels) if transposed
    **noise** : (baselines,) float32
    **flags** : the shape of deviations, uint8, output
    """

    def __init__(self, template, channels, baselines, n_sigma):
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.transposed = template.transposed
        self.channels = channels
        self.baselines = baselines
        self.n_sigma = n_sigma
        shape = (baselines, channels) if template.transposed else (channels, baselines)
        self.slots["deviations"] = base.Slot(shape, torch.float32, base.Direction.IN)
        self.slots["noise"] = base.Slot((baselines,), torch.float32, base.Direction.IN)
        self.slots["flags"] = base.Slot(shape, torch.uint8, base.Direction.OUT)

    def _run(self, deviations, noise):
        return {"flags": threshold_simple(deviations, noise, self.n_sigma,
                                          self.template.flag_value, self.transposed)}

    def parameters(self) -> Mapping[str, Any]:
        return {"n_sigma": self.n_sigma, "flag_value": self.template.flag_value,
                "transposed": self.transposed}


class ThresholdSumDeviceTemplate(AbstractThresholdDeviceTemplate):
    """SumThreshold on transposed (baseline-major) deviations.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::ThresholdSumDeviceTemplate``.

    Parameters
    ----------
    n_windows
        Number of power-of-two window sizes.
    threshold_falloff
        Per-window thresholds are ``n_sigma * threshold_falloff**-i``.
    tuning
        Accepted for signature parity and ignored: the window sums are
        pinned to the oracle's order.
    """

    host_class = host.ThresholdSumHost
    transposed = True

    def __init__(self, context, n_windows: int = 4, threshold_falloff: float = 1.2,
                 flag_value: int = 1, tuning=None):
        self.context = context
        self.n_windows = n_windows
        self.threshold_falloff = threshold_falloff
        self.flag_value = flag_value

    def instantiate(self, command_queue=None, channels=0, baselines=0, n_sigma=11.0, *,
                    allocator=None):
        return ThresholdSumDevice(self, channels, baselines, n_sigma)


class ThresholdSumDevice(AbstractThresholdDevice):
    """.. rubric:: Slots

    **deviations** : (baselines, channels) float32 (transposed layout)
    **noise** : (baselines,) float32
    **flags** : (baselines, channels) uint8, output
    """

    transposed = True

    def __init__(self, template, channels, baselines, n_sigma):
        super().__init__(backend.context_device(template.context))
        self.template = template
        self.channels = channels
        self.baselines = baselines
        self.n_sigma = n_sigma
        shape = (baselines, channels)
        self.slots["deviations"] = base.Slot(shape, torch.float32, base.Direction.IN)
        self.slots["noise"] = base.Slot((baselines,), torch.float32, base.Direction.IN)
        self.slots["flags"] = base.Slot(shape, torch.uint8, base.Direction.OUT)

    def _run(self, deviations, noise):
        flags = threshold_sum(deviations, noise, self.n_sigma, self.template.n_windows,
                              self.template.threshold_falloff, self.template.flag_value)
        return {"flags": flags}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "n_sigma": self.n_sigma,
            "n_windows": self.template.n_windows,
            "threshold_falloff": self.template.threshold_falloff,
            "flag_value": self.template.flag_value,
        }


# ---------------------------------------------------------------------------
# Composed flagger
# ---------------------------------------------------------------------------


class FlaggerDeviceTemplate:
    """Compose background, noise estimation and thresholding stages.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::FlaggerDeviceTemplate``.
    Corner turns are inserted where the stages' ``transposed`` attributes
    disagree; each is a materialized copy (eager PyTorch has no compiler
    to fold it into the next stage).
    """

    def __init__(self, background: BackgroundMedianFilterDeviceTemplate,
                 noise_est: AbstractNoiseEstDeviceTemplate,
                 threshold: AbstractThresholdDeviceTemplate):
        self.background = background
        self.noise_est = noise_est
        self.threshold = threshold

    def instantiate(self, command_queue=None, channels: int = 0, baselines: int = 0,
                    background_args: Mapping[str, Any] = {},
                    noise_est_args: Mapping[str, Any] = {},
                    threshold_args: Mapping[str, Any] = {}, allocator=None):
        return FlaggerDevice(self, channels, baselines, background_args, noise_est_args,
                             threshold_args)


class FlaggerDevice(base.OperationSequence):
    """Concrete composed flagger, an :class:`...ops.base.OperationSequence`.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::FlaggerDevice``.

    .. rubric:: Slots

    **vis** : (channels, baselines) input visibilities
    **input_flags** : input flags (only when the background uses flags)
    **flags** : (channels, baselines) uint8 output flags
    """

    def __init__(self, template, channels, baselines, background_args={},
                 noise_est_args={}, threshold_args={}):
        self.template = template
        self.channels = channels
        self.baselines = baselines

        background = template.background.instantiate(None, channels, baselines,
                                                     **dict(background_args))
        noise_est = template.noise_est.instantiate(None, channels, baselines,
                                                   **dict(noise_est_args))
        threshold = template.threshold.instantiate(None, channels, baselines,
                                                   **dict(threshold_args))
        # The corner turns stay plain torch copies: the JAX package's are
        # XLA transposes, not its Pallas kernel.
        plain = {"engine": "torch"}
        context = template.background.context
        corner_turn = transpose_ops.TransposeTemplate(context, torch.float32, tuning=plain)
        flags_turn = transpose_ops.TransposeTemplate(context, torch.uint8, tuning=plain)

        noise_t = getattr(noise_est, "transposed", template.noise_est.transposed)
        thresh_t = getattr(threshold, "transposed", template.threshold.transposed)

        operations = [("background", background)]
        compounds = {"vis": ["background:vis"], "deviations": ["background:deviations"]}
        if template.background.use_flags:
            compounds["input_flags"] = ["background:flags"]

        if noise_t or thresh_t:
            operations.append(("transpose_deviations",
                               corner_turn.instantiate(None, (channels, baselines))))
            compounds["deviations"].append("transpose_deviations:src")
            compounds["deviations_t"] = ["transpose_deviations:dest"]

        operations.append(("noise_est", noise_est))
        dev_name = "deviations_t" if noise_t else "deviations"
        compounds[dev_name] = compounds.get(dev_name, []) + ["noise_est:deviations"]
        compounds["noise"] = ["noise_est:noise"]

        operations.append(("threshold", threshold))
        dev_name = "deviations_t" if thresh_t else "deviations"
        compounds[dev_name] = compounds.get(dev_name, []) + ["threshold:deviations"]
        compounds["noise"].append("threshold:noise")

        if thresh_t:
            compounds["flags_t"] = ["threshold:flags"]
            operations.append(("transpose_flags",
                               flags_turn.instantiate(None, (baselines, channels))))
            compounds["flags_t"].append("transpose_flags:src")
            compounds["flags"] = ["transpose_flags:dest"]
        else:
            compounds["flags"] = ["threshold:flags"]

        super().__init__(operations, compounds)

    def parameters(self) -> Mapping[str, Any]:
        return {
            "channels": self.channels,
            "baselines": self.baselines,
            # The stages' parameters; the corner turns carry none in the JAX package.
            **{f"{name}:{k}": v for name, op in self.operations
               if name in ("background", "noise_est", "threshold")
               for k, v in op.parameters().items()},
        }


# ---------------------------------------------------------------------------
# Host-interface wrappers (the oracle adapters of the parity tests)
# ---------------------------------------------------------------------------


def _to_device(template, array: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(
        device=backend.context_device(template.context), dtype=dtype)


class BackgroundHostFromDevice(host.AbstractBackgroundHost):
    """The host API over a device background template.

    Port of ``katsdpsigproc_tpu/models/rfi/device.py::BackgroundHostFromDevice``.
    """

    def __init__(self, template: AbstractBackgroundDeviceTemplate, command_queue=None):
        self.template = template
        self.command_queue = command_queue

    def __call__(self, vis: np.ndarray, flags: Optional[np.ndarray] = None) -> np.ndarray:
        if flags is not None and not self.template.use_flags:
            raise TypeError("flags were provided but not included in the template")
        if flags is None and self.template.use_flags:
            raise TypeError("flags were expected but not provided")
        channels, baselines = vis.shape
        fn = self.template.instantiate(self.command_queue, channels, baselines)
        inputs = {"vis": _to_device(self.template, vis, fn.slots["vis"].dtype)}
        if flags is not None:
            inputs["flags"] = _to_device(self.template, flags.astype(np.uint8), torch.uint8)
        return fn(**inputs)["deviations"].cpu().numpy()


class NoiseEstHostFromDevice(host.AbstractNoiseEstHost):
    """Port of ``katsdpsigproc_tpu/models/rfi/device.py::NoiseEstHostFromDevice``."""

    def __init__(self, template: AbstractNoiseEstDeviceTemplate, command_queue=None):
        self.template = template

    def __call__(self, deviations: np.ndarray) -> np.ndarray:
        channels, baselines = deviations.shape
        fn = self.template.instantiate(None, channels, baselines)
        dev = deviations.astype(np.float32)
        if self.template.transposed:
            dev = dev.T
        return fn(deviations=_to_device(self.template, dev, torch.float32))["noise"].cpu().numpy()


class ThresholdHostFromDevice(host.AbstractThresholdHost):
    """Port of ``katsdpsigproc_tpu/models/rfi/device.py::ThresholdHostFromDevice``."""

    def __init__(self, template: AbstractThresholdDeviceTemplate, command_queue=None, **kwargs):
        self.template = template
        self.kwargs = kwargs

    def __call__(self, deviations: np.ndarray, noise: np.ndarray) -> np.ndarray:
        channels, baselines = deviations.shape
        fn = self.template.instantiate(None, channels, baselines, **self.kwargs)
        dev = deviations.astype(np.float32)
        if self.template.transposed:
            dev = dev.T
        out = fn(deviations=_to_device(self.template, dev, torch.float32),
                 noise=_to_device(self.template, noise, torch.float32))["flags"].cpu().numpy()
        return out.T if self.template.transposed else out


class FlaggerHostFromDevice(host.AbstractFlaggerHost):
    """Port of ``katsdpsigproc_tpu/models/rfi/device.py::FlaggerHostFromDevice``."""

    def __init__(self, template: FlaggerDeviceTemplate, command_queue=None,
                 background_args: Mapping[str, Any] = {},
                 noise_est_args: Mapping[str, Any] = {},
                 threshold_args: Mapping[str, Any] = {}):
        self.template = template
        self.background_args = dict(background_args)
        self.noise_est_args = dict(noise_est_args)
        self.threshold_args = dict(threshold_args)

    def __call__(self, vis: np.ndarray, input_flags: Optional[np.ndarray] = None) -> np.ndarray:
        channels, baselines = vis.shape
        fn = self.template.instantiate(None, channels, baselines, self.background_args,
                                       self.noise_est_args, self.threshold_args)
        background = self.template.background
        inputs = {"vis": _to_device(background, vis, fn.slots["vis"].dtype)}
        if input_flags is not None:
            inputs["input_flags"] = _to_device(background, input_flags.astype(np.uint8),
                                               torch.uint8)
        return fn(**inputs)["flags"].cpu().numpy()
