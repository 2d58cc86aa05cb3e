"""FFT-path spectral flagging benchmark (``bench.py`` config 4).

Port of ``scripts/fftflagtest.py``: an r2c FFT over each baseline's time
series, spectral amplitudes thresholded against an MAD noise estimate,
flagged bins zeroed, a c2r inverse.  It composes the port's
:class:`..ops.fft.Fft` r2c and c2r operations with
:func:`..ops.rank.median_non_zero` and
:func:`..utils.numerics.complex_abs` (256 baselines x 32768 channels by
default).

Run::

    python -m katsdpsigproc_tpu_torch.scripts.fftflagtest [--device cpu] [options]

It runs on the card, and exits without one, unless given ``--device
cpu``.  Besides the JAX harness's lines it holds the flags to a numpy
float64 run of the same pipeline: FFT output differs in its last bits
between pocketfft, MKL and cuFFT, so bins whose amplitude lies within
:data:`NEAR` (relative) of their threshold are counted apart and not held
("Mask mismatches: N / M; K bins near the threshold not held").
"""

import argparse
import sys
import time

import numpy as np
import torch

from katsdpsigproc_tpu_torch import MAD_NORMAL
from katsdpsigproc_tpu_torch.ops import fft, rank
from katsdpsigproc_tpu_torch.utils import backend, numerics

from . import common

#: Relative distance to its threshold within which a bin's flag may
#: differ between FFT libraries and is not held.
NEAR = 1e-5


def make_data(baselines: int, channels: int) -> np.ndarray:
    """Seed-1 noise with strong sinusoids planted in every 7th baseline."""
    rs = np.random.RandomState(seed=1)
    data = rs.standard_normal((baselines, channels)).astype(np.float32)
    t = np.arange(channels)
    for i in range(0, baselines, 7):
        data[i] += 20.0 * np.sin(2 * np.pi * (0.1 + 0.3 * i / baselines) * t).astype(np.float32)
    return data


def make_spectral_flag(context, baselines: int, channels: int, nsigma: float):
    """``spectral_flag(x) -> (uint8 flags, float32 cleaned series)`` over the port's Fft ops."""
    shape = (baselines, channels)
    r2c = fft.FftTemplate(context, 1, shape, np.float32, np.complex64).instantiate(
        None, fft.FftMode.FORWARD)
    c2r = fft.FftTemplate(context, 1, shape, np.complex64, np.float32).instantiate(
        None, fft.FftMode.INVERSE)
    mad_normal = float(np.float32(MAD_NORMAL))
    nsigma32 = float(np.float32(nsigma))
    inv_n = float(np.float32(1.0 / channels))

    def spectral_flag(x):
        spectrum = r2c(src=x)["dest"]
        amp = numerics.complex_abs(spectrum)
        noise = mad_normal * rank.median_non_zero(amp)
        flags = amp > nsigma32 * noise[:, None]
        cleaned = torch.where(flags, 0.0, spectrum)
        # The op's inverse is unnormalised (cuFFT's convention); the JAX
        # harness's irfft is normalised, so scale back for the same output.
        out = c2r(src=cleaned)["dest"] * inv_n
        return flags.to(torch.uint8), out

    return spectral_flag


def reference_flags(data: np.ndarray, nsigma: float):
    """numpy float64 flags of the same pipeline, and the bins within :data:`NEAR` of
    their threshold."""
    amp = np.abs(np.fft.rfft(data.astype(np.float64), axis=-1))
    noise = np.array([MAD_NORMAL * np.median(row[row != 0]) for row in amp])
    threshold = nsigma * noise[:, None]
    return amp > threshold, np.abs(amp - threshold) <= NEAR * threshold


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--baselines", type=int, default=256)
    parser.add_argument("--channels", type=int, default=32768)
    parser.add_argument("--nsigma", type=float, default=5.0)
    parser.add_argument("--iters", type=int, default=5)
    common.add_device_option(parser)
    args = parser.parse_args(argv)
    context = backend.DeviceContext(common.harness_device(args.device))

    b, c = args.baselines, args.channels
    data = make_data(b, c)
    spectral_flag = make_spectral_flag(context, b, c, args.nsigma)
    x = context.put(data)
    flags, cleaned = spectral_flag(x)
    flags = flags.cpu().numpy()
    print(f"flagged spectral bins: {flags.sum()} ({flags.mean() * 100:.3f}%)", file=sys.stderr)
    assert flags[0].sum() > 0, "planted narrowband RFI not detected"
    assert flags[1].sum() < flags[0].sum(), "clean baseline over-flagged"

    expected, near = reference_flags(data, args.nsigma)
    mismatch = int(((flags != 0) != expected)[~near].sum())
    print(f"Mask mismatches: {mismatch} / {flags.size}; {int(near.sum())} bins near the "
          f"threshold not held", file=sys.stderr)

    times = []
    for _ in range(args.iters):
        start = time.perf_counter()
        spectral_flag(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        times.append(time.perf_counter() - start)
    dt = float(np.median(times))
    print(f"{dt * 1e3:.3f} ms/iter, {b * c / dt / 1e9:.2f} Gsamples/s", file=sys.stderr)
    sys.exit(0 if mismatch == 0 else 1)


if __name__ == "__main__":
    main()
