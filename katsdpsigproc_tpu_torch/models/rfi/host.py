"""RFI flagging algorithms that run on the CPU (numpy).

A copy of ``katsdpsigproc_tpu/models/rfi/host.py`` (the whole file:
``_rolling_median_nan``, ``BackgroundMedianFilterHost``,
``NoiseEstMADHost``, ``ThresholdSimpleHost``, ``ThresholdSumHost``,
``FlaggerHost``).  It is copied, not imported, because importing the JAX
module imports jax, and the port's on-card checks need the oracle where
jax is absent.

This module is the *oracle layer*: every device implementation in
:mod:`katsdpsigproc_tpu_torch.models.rfi.device` and the CUDA kernels are
validated against these classes, exactly as the reference validates its
CUDA/OpenCL pipeline against its host classes (reference:
src/katsdpsigproc/rfi/host.py:118-273 and test/rfi/test_flagger.py:55-107).

Unlike the reference, these implementations are pure numpy (the reference
uses pandas for the rolling median, host.py:148); the semantics are
identical: a centred rolling median with ``min_periods=1`` NaN-skipping
behaviour.
"""

from abc import ABC, abstractmethod
from typing import Optional

import numpy as np

from . import MAD_NORMAL


class AbstractBackgroundHost(ABC):
    """Subtract an estimate of the background (RFI-free) signal.

    Reference: src/katsdpsigproc/rfi/host.py:28-49.
    """

    @abstractmethod
    def __init__(self, width: int, amplitudes: bool = False) -> None:
        pass  # pragma: nocover

    @abstractmethod
    def __call__(self, vis: np.ndarray, flags: Optional[np.ndarray] = None) -> np.ndarray:
        """Return deviations (amplitude minus background estimate)."""


class AbstractNoiseEstHost(ABC):
    """Estimate the noise standard deviation per baseline.

    Reference: src/katsdpsigproc/rfi/host.py:52-67.
    """

    @abstractmethod
    def __call__(self, deviations: np.ndarray) -> np.ndarray:
        """Return a 1-D per-baseline noise estimate."""


class AbstractThresholdHost(ABC):
    """Flag deviations that exceed a noise-scaled threshold.

    Reference: src/katsdpsigproc/rfi/host.py:70-91.
    """

    @abstractmethod
    def __init__(self, n_sigma: float) -> None:
        pass  # pragma: nocover

    @abstractmethod
    def __call__(self, deviations: np.ndarray, noise: np.ndarray) -> np.ndarray:
        """Return uint8 flags (``flag_value`` where RFI is detected, else 0)."""


class AbstractFlaggerHost(ABC):
    """Full background → noise → threshold pipeline.

    Reference: src/katsdpsigproc/rfi/host.py:94-115.
    """

    @abstractmethod
    def __call__(self, vis: np.ndarray, input_flags: Optional[np.ndarray] = None) -> np.ndarray:
        """Return flags with the same shape as ``vis``."""


def _rolling_median_nan(amp: np.ndarray, width: int) -> np.ndarray:
    """Centred rolling median along axis 0, skipping NaNs, min_periods=1.

    For odd ``width`` the window at row ``i`` covers rows
    ``[i - width//2, i + width//2]`` clipped to the array; NaN entries are
    ignored; a window with no valid entries yields NaN.  This reproduces
    ``pandas.DataFrame.rolling(width, center=True, min_periods=1).median()``
    (reference: src/katsdpsigproc/rfi/host.py:148).
    """
    h = width // 2
    n = amp.shape[0]
    padded = np.full((n + 2 * h,) + amp.shape[1:], np.nan, amp.dtype)
    padded[h : h + n] = amp
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=0)
    with np.errstate(all="ignore"):
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            med = np.nanmedian(windows, axis=-1)
    return med


class BackgroundMedianFilterHost(AbstractBackgroundHost):
    """Host backgrounder that applies a median filter to each baseline (by amplitude).

    Semantics match the reference's pandas implementation
    (src/katsdpsigproc/rfi/host.py:118-151): amplitudes of flagged
    visibilities are masked out of the median; the output deviation is
    ``amp - rolling_median`` with NaNs (flagged inputs or empty windows)
    replaced by zero.

    Parameters
    ----------
    width
        The kernel width (must be odd)
    amplitudes
        If `True`, the inputs are amplitudes rather than complex visibilities
    """

    def __init__(self, width: int, amplitudes: bool = False) -> None:
        self.width = width
        self.amplitudes = amplitudes

    def __call__(self, vis: np.ndarray, flags: Optional[np.ndarray] = None) -> np.ndarray:
        if self.amplitudes:
            amp = np.asarray(vis, dtype=np.float64).copy()
        else:
            amp = np.abs(vis).astype(np.float64)
        if flags is not None:
            mask = flags.astype(np.bool_)
            if mask.ndim < 2:
                mask = mask[:, np.newaxis]
            mask = np.broadcast_to(mask, vis.shape)
            amp[mask] = np.nan
        med = _rolling_median_nan(amp, self.width)
        deviation = amp - med
        deviation = np.where(np.isnan(deviation), 0.0, deviation)
        return deviation


class NoiseEstMADHost(AbstractNoiseEstHost):
    """Estimate noise using the median of non-zero absolute deviations.

    Reference: src/katsdpsigproc/rfi/host.py:154-163.
    """

    def __call__(self, deviations: np.ndarray) -> np.ndarray:
        # Vectorized over baselines (columns), unlike the reference's
        # per-column loop: zeros become NaN so ``nanmedian`` sees only the
        # non-zero magnitudes.  The median itself is computed in the input
        # dtype (a float32 even-count midpoint stays float32), which keeps
        # the result bit-identical to a per-column ``np.median`` of the
        # filtered values.  A baseline with no non-zero deviations yields
        # NaN (all-NaN column) rather than the reference's empty-median
        # error.
        import warnings

        mag = np.abs(deviations)
        mag = np.where(mag > 0, mag, np.asarray(np.nan, mag.dtype))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            per_baseline = np.nanmedian(mag, axis=0)
        return MAD_NORMAL * per_baseline.astype(np.float64)


class ThresholdSimpleHost(AbstractThresholdHost):
    """Threshold each element independently.

    Reference: src/katsdpsigproc/rfi/host.py:166-183.

    Parameters
    ----------
    n_sigma
        Number of (estimated) standard deviations for the threshold
    flag_value
        Number stored in returned value to indicate RFI
    """

    def __init__(self, n_sigma: float, flag_value: int = 1) -> None:
        self.n_sigma = n_sigma
        self.flag_value = flag_value

    def __call__(self, deviations: np.ndarray, noise: np.ndarray) -> np.ndarray:
        # ``n_sigma * noise`` keeps numpy's weak scalar promotion (a
        # float32 noise row stays float32), so the comparison matches the
        # device path's dtype chain.
        hot = deviations > self.n_sigma * noise
        return np.where(hot, np.uint8(self.flag_value), np.uint8(0))


class ThresholdSumHost(AbstractThresholdHost):
    """Offringa (2010) SumThreshold with power-of-two window sizes.

    Reference: src/katsdpsigproc/rfi/host.py:186-254.  For each window size
    ``2**i`` (i < n_windows), already-flagged samples are clamped to the
    current threshold, full-window rolling sums are compared against
    ``threshold * window``, and flags are dispersed back over every sample
    covered by an outlier window.

    Parameters
    ----------
    n_sigma
        Number of (estimated) standard deviations for the threshold
    n_windows
        Number of window sizes to use
    threshold_falloff
        Controls rate at which thresholds decrease (ρ in Offringa 2010)
    flag_value
        Number stored in returned value to indicate RFI
    """

    def __init__(
        self,
        n_sigma: float,
        n_windows: int = 4,
        threshold_falloff: float = 1.2,
        flag_value: int = 1,
    ) -> None:
        self.n_sigma = n_sigma
        self.flag_value = flag_value
        # Window i is 2^i samples wide with its threshold relaxed by
        # ρ^-i (Offringa 2010): doubling windows, geometric falloff.
        self.windows = []
        self.threshold_scales = []
        for i in range(n_windows):
            self.windows.append(1 << i)
            self.threshold_scales.append(threshold_falloff**-i)

    def apply_baseline(self, deviations: np.ndarray, threshold1: float) -> np.ndarray:
        """Apply the thresholding to a single baseline; returns bool flags."""
        return self._apply(deviations[:, np.newaxis], np.asarray([threshold1]))[:, 0]

    def _apply(self, deviations: np.ndarray, threshold1: np.ndarray) -> np.ndarray:
        """SumThreshold every baseline (column) at once; `threshold1` is the
        per-baseline single-sample threshold.  Window sums run in float64
        via shifted adds — the same per-element accumulation order as the
        device path's float32 ladders (device.threshold_sum)."""
        channels = deviations.shape[0]
        dev = deviations.astype(np.float64)
        flags = np.zeros(dev.shape, dtype=np.bool_)
        for window, scale in zip(self.windows, self.threshold_scales):
            if window > channels:
                break
            # np.float32(threshold1 * scale), the reference's expression
            # (host.py:235): with the f32 threshold1 __call__ passes, the
            # product stays f32 (weak python-float promotion), matching
            # every device path's f32 chain bit for bit.
            threshold = (threshold1 * scale).astype(np.float32)
            np.copyto(dev, threshold[np.newaxis, :], where=flags)
            n_out = channels - window + 1
            sums = dev[:n_out].copy()
            for j in range(1, window):
                sums += dev[j:n_out + j]
            sum_flags = sums > threshold[np.newaxis, :].astype(np.float64) * window
            for j in range(window):
                flags[j:n_out + j] |= sum_flags
        return flags

    def __call__(self, deviations: np.ndarray, noise: np.ndarray) -> np.ndarray:
        threshold1 = np.float32(self.n_sigma) * np.asarray(noise, dtype=np.float32)
        flags = self._apply(deviations, threshold1)
        return np.where(flags, np.uint8(self.flag_value), np.uint8(0))


class FlaggerHost(AbstractFlaggerHost):
    """Combine host background and thresholding implementations to make a flagger.

    Reference: src/katsdpsigproc/rfi/host.py:257-273.
    """

    def __init__(
        self,
        background: AbstractBackgroundHost,
        noise_est: AbstractNoiseEstHost,
        threshold: AbstractThresholdHost,
    ):
        # Attribute names are API surface (mirrored by FlaggerDevice and
        # the HostFromDevice wrappers); the stages themselves are
        # interchangeable duck-typed callables.
        self.background = background
        self.noise_est = noise_est
        self.threshold = threshold

    def __call__(self, vis: np.ndarray, input_flags: Optional[np.ndarray] = None) -> np.ndarray:
        dev = self.background(vis, input_flags)
        return self.threshold(dev, self.noise_est(dev))
